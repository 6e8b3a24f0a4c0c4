"""TrainingMesh: the named device mesh and the batch placement helpers
(counterpart of deeplearning4j_tpu/parallel/mesh.py).

The reference's mesh is a ``jax.sharding.Mesh`` over ``AXES`` (``data``,
``model``, ``seq``, ``pipe``). The port holds a list of ``torch.device``s
in the same grid. This slice supports the one-device mesh, every axis 1:
the data-parallel worker count (``replicas`` in the wrapper and the
masters) is a lane count independent of the devices, as in the reference
(``wrapper.py:103-105``), and the lanes run one after another on the one
device. A mesh of more than one device, and ``tensor_shard_params``, raise
``NotImplementedError`` naming ROADMAP item 10c (process groups, NCCL).

The ragged-batch padding (``_pad_ragged``, reference ``:67``) is the
reference's array for array: the last row repeated up to the divisor, with
0/1 loss weights over the padded rows, so a weighted loss divides by the
real example count. ``pad_shard_batch`` and ``pad_lane_batch`` place the
padded arrays on the mesh's device, the lane form reshaped to
``(replicas, b, ...)``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import as_tensor, resolve_device
from deeplearning4j_tpu_torch.tree import tree_map

#: the ROADMAP item that brings what a one-device mesh cannot do
ITEM_10C = ("ROADMAP Queue 1 item 10c (a mesh of several devices, ranks "
            "as lanes over torch.distributed, ZeRO sharding, tensor "
            "parallelism, ring attention, NCCL collectives)")


def multi_device_error(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} needs more than one device and is not ported yet: "
        f"{ITEM_10C}")


def _rep_last(v, pad: int):
    """``v`` with its last row repeated ``pad`` times (numpy or tensor)."""
    if isinstance(v, torch.Tensor):
        return torch.cat([v, v[-1:].expand((pad,) + tuple(v.shape[1:]))],
                         dim=0)
    v = np.asarray(v)
    return np.concatenate([v, np.repeat(v[-1:], pad, axis=0)], axis=0)


class TrainingMesh:
    AXES = ("data", "model", "seq", "pipe")

    def __init__(self, data: int = 0, model: int = 1, seq: int = 1,
                 pipe: int = 1, devices: Optional[Sequence] = None):
        devices = ([resolve_device(None)] if devices is None
                   else [resolve_device(d) for d in devices])
        n = len(devices)
        fixed = model * seq * pipe
        if data <= 0:
            if n % fixed != 0:
                raise ValueError(
                    f"{n} devices not divisible by model*seq*pipe={fixed}")
            data = n // fixed
        total = data * fixed
        if total > n:
            raise ValueError(f"mesh {data}x{model}x{seq}x{pipe} needs "
                             f"{total} devices, have {n}")
        if total > 1 or n > 1:
            raise multi_device_error(
                f"a mesh of {max(total, n)} devices "
                f"({data}x{model}x{seq}x{pipe})")
        self.devices = devices[:total]
        self.device = self.devices[0]
        self.data, self.model, self.seq, self.pipe = data, model, seq, pipe

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model, "seq": self.seq,
                "pipe": self.pipe}

    # -- placement ----------------------------------------------------------
    def shard_batch(self, *arrays):
        """The arrays as tensors on the mesh's device (the batch axis over
        ``data``, which is 1 here)."""
        out = tuple(as_tensor(a, self.device) for a in arrays)
        return out if len(out) > 1 else out[0]

    @staticmethod
    def _pad_ragged(x, y, divisor: int, extras):
        """Pad (x, y, extras) to ``divisor`` divisibility by repeating the
        last row, with a 0/1 loss-weight vector over the padded rows.
        Returns (xs, ys, w, extras, multi_x, multi_y) (reference ``:67``):
        numpy stays numpy, tensors stay tensors, ``w`` is fp32 numpy."""
        multi_x = isinstance(x, (list, tuple))
        multi_y = isinstance(y, (list, tuple))
        keep = lambda v: v if isinstance(v, torch.Tensor) \
            else np.asarray(v)  # noqa: E731
        xs = [keep(v) for v in (x if multi_x else [x])]
        ys = [keep(v) for v in (y if multi_y else [y])]
        n = len(xs[0])
        pad = (divisor - n % divisor) % divisor
        w = np.ones(n + pad, np.float32)
        if pad:
            xs = [_rep_last(v, pad) for v in xs]
            ys = [_rep_last(v, pad) for v in ys]
            w[n:] = 0.0
        if extras is not None:
            extras = tree_map(lambda v: _rep_last(keep(v), pad) if pad
                              else keep(v), extras)
        return xs, ys, w, extras, multi_x, multi_y

    def pad_shard_batch(self, x, y, extras=None):
        """Pad (x, y) to ``data`` divisibility and place them; returns
        (x, y, weights[, extras]) (reference ``:95``). A list/tuple x or y
        (a graph's inputs or outputs) comes back as a tuple."""
        xs, ys, w, extras, multi_x, multi_y = self._pad_ragged(
            x, y, self.data, extras)
        sx = tuple(as_tensor(v, self.device) for v in xs)
        sy = tuple(as_tensor(v, self.device) for v in ys)
        out = (sx if multi_x else sx[0], sy if multi_y else sy[0],
               as_tensor(w, self.device))
        if extras is None:
            return out
        return out + (tree_map(lambda v: as_tensor(v, self.device),
                               extras),)

    def replicate(self, tree, keep_existing: bool = True):
        """The tree's tensors on the mesh's device (one device holds the
        one replica; tensors already there are kept as they are)."""
        def place(v):
            t = v if isinstance(v, torch.Tensor) else as_tensor(v,
                                                                self.device)
            return t if t.device == self.device else t.to(self.device)
        return tree_map(place, tree)

    def pad_lane_batch(self, x, y, replicas: int, extras=None,
                       micro: int = 1):
        """The lane form of :meth:`pad_shard_batch` (reference ``:131``):
        the same ragged padding to ``replicas * micro`` divisibility, then
        every array reshaped to ``(replicas, b, ...)``. Returns
        (x, y, weights[, extras]), weights ``(replicas, b)``."""
        xs, ys, w, extras, multi_x, multi_y = self._pad_ragged(
            x, y, replicas * max(1, int(micro)), extras)

        def lane(v):
            t = as_tensor(v, self.device)
            return t.reshape((replicas, t.shape[0] // replicas)
                             + tuple(t.shape[1:]))

        sx = tuple(lane(v) for v in xs)
        sy = tuple(lane(v) for v in ys)
        out = (sx if multi_x else sx[0], sy if multi_y else sy[0], lane(w))
        if extras is None:
            return out
        return out + (tree_map(lane, extras),)

    def tensor_shard_params(self, tree, rules):
        """Tensor parallelism (reference ``:160``): needs a ``model`` axis
        of more than one device."""
        raise multi_device_error("tensor_shard_params")

    def dcn_hosts(self) -> int:
        """The host factor of the ``data`` axis (reference ``:192``): one
        process, so 1."""
        return 1

    def layout_signature(self, extra=None) -> str:
        from deeplearning4j_tpu_torch.parallel import gspmd

        return gspmd.layout_signature(self, extra=extra)

    @property
    def n_devices(self) -> int:
        return self.data * self.model * self.seq * self.pipe

    def __repr__(self):
        return (f"TrainingMesh(data={self.data}, model={self.model}, "
                f"seq={self.seq}, pipe={self.pipe}, device={self.device})")
