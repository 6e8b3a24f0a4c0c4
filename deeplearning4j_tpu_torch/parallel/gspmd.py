"""Lane decomposition and deterministic combines: the lane half of
deeplearning4j_tpu/parallel/gspmd.py (``:69-285``, ``:332-366``).

**Lanes.** Data parallelism is a leading ``replicas`` axis: the global
batch reshapes to ``(R, b, ...)`` and each lane runs the network's own
training forward and backward (``_gradients``: MultiLayerNetwork
``nn/multilayer.py``, ComputationGraph ``nn/computation_graph.py``) on its
slice, with the shared params and layer states. The reference vmaps the
lane body over one device, unpartitioned; the port runs the R lanes one
after another on the device's stream. Batchnorm therefore takes per-lane
statistics, as the reference's vmapped lanes do: the lanes are not the
full batch run once.

**Deterministic combines.** :func:`pairwise_sum` is the reference's
balanced tree of adds over the lane axis, odd remainders folded in at the
end of each level, so an fp32 combine equals the reference's bit for bit
on the same inputs.

**Updates.** :func:`apply_updaters` and :func:`apply_updaters_flat` are the
shared tail of every lane step: the network's updaters (or its fused
engine) applied in place with the step sizes the network's ``StepSizes``
buffer holds for this iteration. ZeRO placement (reference ``:287-330``)
needs a ``data`` axis of more than one device: ROADMAP item 10c.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from deeplearning4j_tpu_torch.nn import updaters as upd
from deeplearning4j_tpu_torch.tree import tree_items, tree_leaves, tree_map
from deeplearning4j_tpu_torch.util import cost_model as cmod

# ---------------------------------------------------------------------------
# deterministic cross-lane combines
# ---------------------------------------------------------------------------


def pairwise_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over axis 0 as a balanced tree of adds, ((x0+x1)+(x2+x3))...,
    odd remainders folded in at the end of each level (reference
    ``:69``)."""
    while t.shape[0] > 1:
        half = t.shape[0] // 2
        even = t[0:2 * half:2] + t[1:2 * half:2]
        t = even if t.shape[0] % 2 == 0 else torch.cat([even, t[-1:]],
                                                       dim=0)
    return t[0]


def pairwise_mean(t: torch.Tensor) -> torch.Tensor:
    return pairwise_sum(t) * (1.0 / t.shape[0])


def tree_pairwise_sum(tree):
    return tree_map(pairwise_sum, tree)


def tree_pairwise_mean(tree):
    return tree_map(pairwise_mean, tree)


def stack_lanes(trees):
    """R trees of one structure -> one tree of (R, ...) stacked leaves."""
    return tree_map(lambda *ls: torch.stack(ls), trees[0], *trees[1:])


def combine_states(stacked_states):
    """Cross-lane combine of non-trainable state (batchnorm statistics):
    floating leaves average, everything else takes lane 0's copy
    (reference ``:101``)."""
    return tree_map(lambda v: pairwise_mean(v) if v.is_floating_point()
                    else v[0], stacked_states)


# ---------------------------------------------------------------------------
# per-lane loss/grad for MultiLayerNetwork and ComputationGraph
# ---------------------------------------------------------------------------


def is_graph(model) -> bool:
    return isinstance(model._updaters, dict)


def _lane_scaled(model) -> bool:
    """Whether this model's lane bodies run under loss scaling: its fused
    engine's policy (the gradients then come out scaled, and the fused
    apply unscales them)."""
    engine = getattr(model, "_fused", None)
    return engine is not None and engine.loss_scale != "none"


class _bound:
    """Bind ``model.params``/``states``/``opt_states`` to the given trees
    for the extent (a lane's own copies), restoring the model's after."""

    def __init__(self, model, params=None, states=None, opt_states=None):
        self.model = model
        self.new = {"params": params, "states": states,
                    "opt_states": opt_states}

    def __enter__(self):
        self.old = {k: getattr(self.model, k) for k in self.new}
        for k, v in self.new.items():
            if v is not None:
                setattr(self.model, k, v)
        return self.model

    def __exit__(self, *exc):
        for k, v in self.old.items():
            setattr(self.model, k, v)


def _lane_value_and_grad(model, args, carries=None):
    """The shared tail of every lane body: the network's ``_gradients``
    (loss scaling included: the engine's scale multiplies the loss before
    the backward, the loss returned is unscaled). Returns (loss,
    new_states, grads, new_carries)."""
    x, y, weights, fm, lm = args
    if is_graph(model):
        loss, grads, new_states, new_carries = model._gradients(
            x, y, weights, fm, lm, carries)
    else:
        loss, grads, new_states, new_carries = model._gradients(
            carries, x, y, weights, fm, lm)
    return loss, new_states, grads, new_carries


def _lane_feed(model, x, y):
    """A lane's inputs/labels in the form the network's loss takes: a
    graph's dicts by input/output name (raw tensors or lists zip with the
    declared order), a layer stack's tensors."""
    if not is_graph(model):
        return x, y
    ins, outs = list(model.conf.inputs), list(model.conf.outputs)
    feed = (dict(zip(ins, x)) if isinstance(x, (list, tuple))
            else {ins[0]: x})
    labs = (dict(zip(outs, y)) if isinstance(y, (list, tuple))
            else {outs[0]: y})
    return feed, labs


def make_lane_value_and_grad(model) -> Callable:
    """fn(params, states, x, y, weights, fm, lm) -> ((loss, weight_sum),
    (new_states, grads)) for ONE lane (reference ``:134``): the network's
    own training forward and backward with ``params``/``states`` bound in
    place of its own. ``weight_sum`` is the lane's loss-weight mass, which
    the combine recombines lane means into the global weighted mean with.
    Dropout draws from the network's generator, lane after lane."""
    def lane(params, states, x, y, weights, fm, lm):
        feed, labs = _lane_feed(model, x, y)
        with _bound(model, params, states):
            loss, new_states, grads, _ = _lane_value_and_grad(
                model, (feed, labs, weights, fm, lm))
        wsum = weights.sum() if weights is not None \
            else torch.ones((), dtype=torch.float32, device=loss.device)
        return (loss, wsum), (new_states, grads)

    return lane


def make_lane_tbptt_value_and_grad(model) -> Callable:
    """The TBPTT-segment variant (MultiLayerNetwork only, reference
    ``:180``): fn(params, states, carries, x, y, weights, fm, lm) ->
    ((loss, weight_sum), (new_states, new_carries, grads))."""
    if is_graph(model):
        raise NotImplementedError(
            "sharded TBPTT is implemented for MultiLayerNetwork; fit the "
            "ComputationGraph through its own fit() or without tbptt_length")

    def lane(params, states, carries, x, y, weights, fm, lm):
        with _bound(model, params, states):
            loss, new_states, grads, new_carries = _lane_value_and_grad(
                model, (x, y, weights, fm, lm), carries)
        wsum = weights.sum() if weights is not None \
            else torch.ones((), dtype=torch.float32, device=loss.device)
        return (loss, wsum), (new_states, new_carries, grads)

    return lane


def grad_template(model, dtype=torch.float32):
    """Zeros shaped as one lane's gradient tree (``_gradients``' keys:
    every float param of a layer or node whose updater is not NoOp)."""
    from deeplearning4j_tpu_torch.tree import tree_set

    keys = (model._updaters.items() if is_graph(model)
            else enumerate(model._updaters))
    out: Dict[Any, dict] = {}
    for k, u in keys:
        if isinstance(u, upd.NoOp):
            continue
        for path, t in tree_items(model.params[k]):
            if t.is_floating_point():
                tree_set(out.setdefault(k, {}), path,
                         torch.zeros(t.shape, dtype=dtype, device=t.device))
    return out


def apply_updaters(model, params, grads, opt_states, sizes,
                   scaled_grads: bool = False):
    """One updater application over the model's updaters, in place
    (reference ``:229``): the fused engine when the model has one, else
    the per-rule groups. ``sizes``: the step sizes of each group
    (``model._step_sizes().views``). ``scaled_grads``: the caller scaled
    its lane losses, so the engine's unscale is right; callers that compute
    unscaled gradients (the masters) leave it False, and a scaling policy
    is refused. Returns (params, opt_states)."""
    engine = getattr(model, "_fused", None)
    if engine is not None:
        if engine.loss_scale != "none" and not scaled_grads:
            raise NotImplementedError(
                "loss_scale under this master is not wired: its lane "
                "value-and-grad computes unscaled gradients, so the fused "
                "unscale would corrupt them: use ParallelWrapper (which "
                "scales the lane loss), or keep loss_scale='none' here")
        with cmod.optimizer_scope():
            engine.apply(params, grads, opt_states, sizes)
        return params, opt_states
    with cmod.optimizer_scope():
        upd.step_groups(model._update_groups, params, grads, opt_states,
                        sizes)
    return params, opt_states


def apply_updaters_flat(model, params, grad_bufs, opt_states, sizes):
    """:func:`apply_updaters` over the fused engine's flat group buffers
    (reference ``:268``): the compressed combine's decode output feeds the
    fused update directly."""
    engine = getattr(model, "_fused", None)
    if engine is None:
        raise ValueError(
            "apply_updaters_flat needs a fused_update model: only the "
            "FusedUpdateEngine defines the flat buffer layout")
    with cmod.optimizer_scope():
        engine.apply_flat(params, grad_bufs, opt_states, sizes)
    return params, opt_states


# ---------------------------------------------------------------------------
# ZeRO optimizer-state sharding (reference :287-330): item 10c
# ---------------------------------------------------------------------------


def zero_shardings(mesh, tree, axis: str = "data", min_elements: int = 1024):
    """ZeRO's per-leaf placement over the ``data`` axis: it needs that
    axis to span more than one device."""
    from deeplearning4j_tpu_torch.parallel.mesh import multi_device_error

    raise multi_device_error("ZeRO optimizer-state sharding")


def place_tree(tree, shardings):
    """Placing a tree by ZeRO's shardings: see :func:`zero_shardings`."""
    from deeplearning4j_tpu_torch.parallel.mesh import multi_device_error

    raise multi_device_error("ZeRO optimizer-state placement")


# ---------------------------------------------------------------------------
# layout table (reference :332-377)
# ---------------------------------------------------------------------------


def tree_bytes(tree) -> int:
    return sum(int(t.numel()) * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def tree_bytes_per_device(tree) -> int:
    """Bytes one device holds: on a one-device mesh, all of them."""
    return tree_bytes(tree)


def _keystr(path) -> str:
    return "".join(f"[{k!r}]" for k in path)


def describe_shardings(tree) -> Dict[str, str]:
    """{key path: placement} of a placed tree (the layout table the wrapper
    keeps on ``layout``); every leaf is replicated on its device."""
    return {_keystr(path): f"replicated({t.device})"
            for path, t in tree_items(tree) if isinstance(t, torch.Tensor)}


def layout_signature(mesh, extra: Any = None) -> str:
    """The mesh layout as a stable string (reference ``:368``)."""
    shape = dict(getattr(mesh, "shape", {})) or {}
    sig = ",".join(f"{k}={v}" for k, v in sorted(shape.items()))
    return f"mesh({sig})|extra({extra})"
