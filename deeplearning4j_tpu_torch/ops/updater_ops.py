"""Updater (learning-rule) ops, libnd4j's ``generic/updaters`` family
(counterpart of deeplearning4j_tpu/ops/updater_ops.py).

Each op runs the same rule as ``nn/updaters.py`` on one tensor, so the op
table and the training loop cannot disagree. Signature:
``<name>_updater(gradient, *state, lr=..., ...hyperparams, iteration=0)``
returns ``(update, *new_state)``; the caller applies ``param -= update``.
``apply_sgd`` takes the parameter and returns it updated.

The fused-update buffers (reference ``:60-160``) serve
``nn/updaters.py``'s ``FusedUpdateEngine``: every float param leaf is
grouped by (updater rule, dtype) (:func:`build_groups`), each group's
leaves concatenate into one 1-D buffer padded to a multiple of
:data:`_GROUP_PAD` elements (:func:`flatten_group`), and the rule runs once
a group over its buffer; :func:`unflatten_group` slices a buffer back into
the leaves' shapes. Elementwise rules are position-independent, so an fp32
group steps bit for bit as the per-leaf walk does.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, List, Tuple

import torch

from deeplearning4j_tpu_torch.nn import updaters as U
from deeplearning4j_tpu_torch.ops import _compat as C
from deeplearning4j_tpu_torch.ops.registry import op


_GROUP_PAD = 512


@dataclasses.dataclass(frozen=True)
class LeafRef:
    """One parameter leaf's place inside a fused group buffer."""

    coll_key: Any          # layer index (MLN) or node name (CG)
    leaf_idx: int          # index into the collection's tree_leaves order
    shape: Tuple[int, ...]
    offset: int            # element offset into the group buffer

    @property
    def size(self) -> int:
        return int(math.prod(self.shape or (1,)))


@dataclasses.dataclass(frozen=True)
class ParamGroup:
    """One (updater rule, dtype) fused buffer: metadata only, no tensors."""

    updater: Any
    dtype: torch.dtype     # the param storage dtype of every leaf in here
    leaves: Tuple[LeafRef, ...]
    total: int             # padded buffer length (multiple of _GROUP_PAD)

    @property
    def needs_master(self) -> bool:
        """Sub-fp32 groups step an fp32 master buffer; an fp32 group's
        master holds the params' own values."""
        return self.dtype != torch.float32


def updater_signature(updater) -> str:
    """Stable grouping key of an updater (same rule, hyperparameters and
    schedule: same group)."""
    return json.dumps(updater.to_dict(), sort_keys=True, default=repr)


def build_groups(keyed_params, keyed_updaters) -> List[ParamGroup]:
    """``keyed_params``: ordered [(coll_key, param_tree)];
    ``keyed_updaters``: {coll_key: updater}. Groups every leaf by (updater
    signature, dtype), in first-seen order; a non-float leaf has no fused
    rule and raises."""
    from deeplearning4j_tpu_torch.tree import tree_leaves

    buckets: dict = {}
    order: list = []
    for coll_key, tree in keyed_params:
        updater = keyed_updaters[coll_key]
        for leaf_idx, leaf in enumerate(tree_leaves(tree)):
            if not leaf.is_floating_point():
                raise ValueError(
                    f"fused updater: non-float param leaf {coll_key}/"
                    f"{leaf_idx} ({leaf.dtype}) has no fused rule")
            gkey = (updater_signature(updater), str(leaf.dtype))
            if gkey not in buckets:
                buckets[gkey] = (updater, leaf.dtype, [])
                order.append(gkey)
            buckets[gkey][2].append(
                (coll_key, leaf_idx, tuple(int(d) for d in leaf.shape)))
    groups = []
    for gkey in order:
        updater, dt, entries = buckets[gkey]
        refs, offset = [], 0
        for coll_key, leaf_idx, shape in entries:
            refs.append(LeafRef(coll_key, leaf_idx, shape, offset))
            offset += int(math.prod(shape or (1,)))
        total = -(-max(offset, 1) // _GROUP_PAD) * _GROUP_PAD
        groups.append(ParamGroup(updater, dt, tuple(refs), total))
    return groups


def flatten_group(group: ParamGroup, leaves_by_key, cast_dtype=None
                  ) -> torch.Tensor:
    """The group's leaves (``leaves_by_key[coll_key][leaf_idx]``)
    concatenated into one padded 1-D buffer, cast to ``cast_dtype``."""
    parts = [leaves_by_key[r.coll_key][r.leaf_idx].reshape(-1)
             for r in group.leaves]
    if cast_dtype is not None:
        parts = [p.to(cast_dtype) for p in parts]
    pad = group.total - sum(p.shape[0] for p in parts)
    if pad:
        parts.append(parts[0].new_zeros((pad,)))
    return torch.cat(parts)


def unflatten_group(group: ParamGroup, buf, out, cast_dtype=None):
    """Slice ``buf`` back into leaves, written as
    ``out[coll_key][leaf_idx]`` (a dict of leaf lists); views of ``buf``
    unless cast."""
    for r in group.leaves:
        leaf = buf[r.offset:r.offset + r.size].view(r.shape)
        if cast_dtype is not None:
            leaf = leaf.to(cast_dtype)
        out[r.coll_key][r.leaf_idx] = leaf
    return out


def _single(updater, grad, state, iteration):
    """One rule on one tensor: the step sizes the training loop writes,
    as fp32 0-d tensors, then ``apply``."""
    grad = C.t(grad)
    sizes = [torch.tensor(v, dtype=torch.float32, device=grad.device)
             for v in updater.step_sizes(iteration)]
    slots = {k: [C.t(v, grad)] for k, v in state.items()}
    upd, new = updater.apply([grad], slots, sizes, [torch.zeros_like(grad)])
    return upd[0], {k: v[0] for k, v in new.items()}


@op("sgd_updater", "updater", aliases=("sgdUpdater",))
def sgd_updater(gradient, lr=1e-3):
    """update = lr * g."""
    g = C.t(gradient)
    return torch.tensor(lr, dtype=g.dtype, device=g.device) * g


@op("apply_sgd", "updater", aliases=("applyGradientDescent",))
def apply_sgd(parameters, gradient, lr=1e-3):
    p = C.t(parameters)
    return p - torch.tensor(lr, dtype=p.dtype, device=p.device) * C.t(
        gradient, p)


@op("nesterovs_updater", "updater", aliases=("nesterovsUpdater",))
def nesterovs_updater(gradient, state_v, lr=0.1, momentum=0.9, iteration=0):
    upd, st = _single(U.Nesterovs(learning_rate=lr, momentum=momentum),
                      gradient, {"v": state_v}, iteration)
    return upd, st["v"]


@op("ada_grad_updater", "updater", aliases=("adaGradUpdater",))
def ada_grad_updater(gradient, state_h, lr=0.1, epsilon=1e-6, iteration=0):
    upd, st = _single(U.AdaGrad(learning_rate=lr, epsilon=epsilon),
                      gradient, {"h": state_h}, iteration)
    return upd, st["h"]


@op("rms_prop_updater", "updater", aliases=("rmsPropUpdater",))
def rms_prop_updater(gradient, state_g, lr=0.1, rms_decay=0.95, epsilon=1e-8,
                     iteration=0):
    upd, st = _single(U.RmsProp(learning_rate=lr, rms_decay=rms_decay,
                                epsilon=epsilon), gradient,
                      {"g2": state_g}, iteration)
    return upd, st["g2"]


@op("ada_delta_updater", "updater", aliases=("adaDeltaUpdater",))
def ada_delta_updater(gradient, state_msg, state_msdx, rho=0.95,
                      epsilon=1e-6, iteration=0):
    upd, st = _single(U.AdaDelta(rho=rho, epsilon=epsilon), gradient,
                      {"g2": state_msg, "dx2": state_msdx}, iteration)
    return upd, st["g2"], st["dx2"]


@op("adam_updater", "updater", aliases=("adamUpdater",))
def adam_updater(gradient, state_m, state_v, lr=1e-3, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, iteration=0):
    upd, st = _single(U.Adam(learning_rate=lr, beta1=beta1, beta2=beta2,
                             epsilon=epsilon), gradient,
                      {"m": state_m, "v": state_v}, iteration)
    return upd, st["m"], st["v"]


@op("ada_max_updater", "updater", aliases=("adaMaxUpdater",))
def ada_max_updater(gradient, state_m, state_u, lr=1e-3, beta1=0.9,
                    beta2=0.999, epsilon=1e-8, iteration=0):
    upd, st = _single(U.AdaMax(learning_rate=lr, beta1=beta1, beta2=beta2,
                               epsilon=epsilon), gradient,
                      {"m": state_m, "v": state_u}, iteration)
    return upd, st["m"], st["v"]


@op("ams_grad_updater", "updater", aliases=("amsGradUpdater",))
def ams_grad_updater(gradient, state_m, state_v, state_vhat, lr=1e-3,
                     beta1=0.9, beta2=0.999, epsilon=1e-8, iteration=0):
    upd, st = _single(U.AMSGrad(learning_rate=lr, beta1=beta1, beta2=beta2,
                                epsilon=epsilon), gradient,
                      {"m": state_m, "v": state_v, "vhat": state_vhat},
                      iteration)
    return upd, st["m"], st["v"], st["vhat"]


@op("nadam_updater", "updater", aliases=("nadamUpdater",))
def nadam_updater(gradient, state_m, state_v, lr=1e-3, beta1=0.9,
                  beta2=0.999, epsilon=1e-8, iteration=0):
    upd, st = _single(U.Nadam(learning_rate=lr, beta1=beta1, beta2=beta2,
                              epsilon=epsilon), gradient,
                      {"m": state_m, "v": state_v}, iteration)
    return upd, st["m"], st["v"]
