"""Weight-only int8 serving (counterpart of
deeplearning4j_tpu/serving/quantize.py).

Serving keeps the fp32 archive as the master and holds resident int8
weights with per-channel fp32 scales on the device, dequantizing inside
the forward (one multiply a weight, ``ops/compression.py``'s
``dequantize_per_channel``): the dequantize is part of every serving
program, not a copy made once at load.

What quantizes: floating leaves with ``ndim >= 2`` and at least
``min_size`` elements (weight matrices, embedding tables, conv filters).
Biases, layer-norm and batch-norm vectors pass through as they are.

The tree is flattened in the archive's (``jax.tree_util``) order, so the
leaf lists are the reference's and an int8 archive's members; the paths
are kept to put the tree back together (``tree.tree_with``).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops.compression import (channel_scale,
                                                      dequantize_np,
                                                      dequantize_per_channel,
                                                      quantize_per_channel)
from deeplearning4j_tpu_torch.tree import tree_map, tree_with
from deeplearning4j_tpu_torch.util import telemetry as tm
from deeplearning4j_tpu_torch.util.model_serializer import (fingerprint,
                                                            jax_items)

#: |logit| tolerance of int8 against fp32 (the reference's ``:44``, set
#: for its test-sized zoo nets)
INT8_LOGIT_TOL = 0.15

__all__ = ["QuantizedParams", "INT8_LOGIT_TOL", "maybe_quantize"]


def _flat(params):
    """(paths, leaves) of a param tree in the archive's order."""
    items = jax_items(params)
    return [p for p, _ in items], [v for _, v in items]


def _host(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32 if t.is_floating_point()
                             else t.dtype).cpu().numpy()
    return np.asarray(t)


class QuantizedParams:
    """A parameter tree quantized for serving (reference ``:49``).

    ``qleaves``: int8 for quantized leaves, the original array for the
    pass-through ones; ``scales``: the fp32 per-channel scale (keepdims
    shape) or None, in parallel. ``treedef`` is the tree's structure
    string (``model_serializer.fingerprint``); ``paths`` and ``template``
    put the leaves back. :meth:`rebuild` runs inside the serving programs
    and is the dequantize."""

    def __init__(self, treedef: str, qleaves: List, scales: List, paths,
                 template):
        self.treedef = treedef
        self.qleaves = list(qleaves)
        self.scales = list(scales)
        self.paths = paths
        self.template = template

    # --------------------------------------------------------------- build
    @classmethod
    def from_params(cls, params, *, min_size: int = 256
                    ) -> "QuantizedParams":
        """Quantize a live parameter tree on the host (reference ``:67``):
        the scale from ``channel_scale``, the rounding by
        ``quantize_per_channel`` on CPU tensors."""
        paths, leaves = _flat(params)
        qleaves, scales = [], []
        for leaf in leaves:
            a = _host(leaf)
            if (np.issubdtype(a.dtype, np.floating) and a.ndim >= 2
                    and a.size >= min_size):
                s = channel_scale(a)
                qleaves.append(quantize_per_channel(
                    torch.from_numpy(a), torch.from_numpy(s)).numpy())
                scales.append(s)
            else:
                qleaves.append(a)
                scales.append(None)
        return cls(fingerprint(params), qleaves, scales, paths,
                   tree_map(lambda v: 0, params))

    @classmethod
    def from_stored(cls, treedef, qleaves, scales, params
                    ) -> "QuantizedParams":
        """The exact stored quantization of an int8 archive (reference
        ``:84``), laid out as ``params``."""
        paths, _ = _flat(params)
        return cls(treedef, qleaves, scales, paths,
                   tree_map(lambda v: 0, params))

    # ------------------------------------------------------------ programs
    def device_put(self, device) -> "QuantizedParams":
        """Move the resident weights to ``device`` once (serving boot)."""
        def put(a):
            t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(a))
            return t.to(device)

        self.qleaves = [put(q) for q in self.qleaves]
        self.scales = [None if s is None else put(s) for s in self.scales]
        return self

    def rebuild(self):
        """The dequantized parameter tree (reference ``:104``): run inside
        the serving programs, so the dequantize is part of the forward."""
        leaves = {p: (q if s is None else dequantize_per_channel(q, s))
                  for p, q, s in zip(self.paths, self.qleaves, self.scales)}
        return tree_with(self.template, leaves)

    # ----------------------------------------------------------- accounting
    def resident_bytes(self) -> int:
        """Bytes the serving programs hold (int8 leaves + scales)."""
        return sum(_nbytes(q) + (0 if s is None else _nbytes(s))
                   for q, s in zip(self.qleaves, self.scales))

    def fp32_bytes(self) -> int:
        """What the same tree costs resident in fp32."""
        return sum(int(np.prod(tuple(q.shape))) * 4 for q in self.qleaves)

    def quantized_fraction(self) -> float:
        n = sum(1 for s in self.scales if s is not None)
        return n / max(1, len(self.scales))

    def publish_gauges(self, model_id: str):
        tm.gauge("serving.weight_bytes", self.resident_bytes(),
                 model=model_id, kind="resident")
        tm.gauge("serving.weight_bytes", self.fp32_bytes(),
                 model=model_id, kind="fp32_equiv")
        tm.gauge("serving.weight_quantized_fraction",
                 self.quantized_fraction(), model=model_id)


def _nbytes(a) -> int:
    if isinstance(a, torch.Tensor):
        return int(a.numel() * a.element_size())
    return int(a.nbytes)


def _stash_matches(stored, params) -> bool:
    """Whether a restore's ``net._int8_archive`` stash still describes
    the live ``params`` (reference ``:145``): the restore set the params
    to the stash's exact dequantization, so anything that wrote them since
    (fine-tuning, a transfer copy, a hand edit) makes it stale, and a
    stale stash falls through to a fresh quantization."""
    treedef, qleaves, scales = stored
    _, live = _flat(params)
    if fingerprint(params) != treedef or len(live) != len(qleaves):
        return False
    for p, q, s in zip(live, qleaves, scales):
        deq = q if s is None else dequantize_np(q, s)
        if not np.array_equal(_host(p), deq):
            return False
    return True


def maybe_quantize(net, quantize: Optional[str], model_id: str = ""
                   ) -> Optional[QuantizedParams]:
    """The serving tier's entry (reference ``:167``): ``None`` leaves the
    fp32 path as it is (returns None); ``"int8"`` gives a
    :class:`QuantizedParams` on the net's device, taking an int8
    archive's stored quantization as it is when the net was restored from
    one and has not changed since."""
    if quantize is None:
        return None
    if quantize != "int8":
        raise ValueError(f"unknown quantize mode {quantize!r} "
                         "(supported: None, 'int8')")
    stored = getattr(net, "_int8_archive", None)
    if stored is not None and _stash_matches(stored, net.params):
        qp = QuantizedParams.from_stored(*stored, net.params)
    else:
        qp = QuantizedParams.from_params(net.params)
    qp.device_put(net.device)
    if model_id:
        qp.publish_gauges(model_id)
    return qp
