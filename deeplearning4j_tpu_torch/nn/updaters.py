"""Updaters (learning rules), counterpart of deeplearning4j_tpu/nn/updaters.py
(ND4J's IUpdater/GradientUpdater pairs).

The dataclasses, their fields, defaults and JSON dicts are the reference's,
so an updater moves between the two packages unchanged. ``init_state``
gives the reference's state tree for one node's params (``()`` for a
stateless rule, else ``{slot: {key: zeros}}``), so optimizer states carry
across leaf for leaf (``interop``).

``apply`` computes the update to subtract (the ND4J convention: params -=
update) over flat lists of tensors with PyTorch's multi-tensor ``_foreach``
ops, in the reference's order of operations, so one call serves every node
that shares an updater. :func:`apply_updates` subtracts the updates from
the params and copies the new state into the state tensors, both IN PLACE:
the params, the optimizer states and their trees stay the same tensors, so
a captured step (``nn/capture.py``) that reads them keeps reading the
live ones, and a cached bf16 copy of a param sees the change through its
version counter.

Step sizes: what depends on the iteration (the learning rate, a float or a
schedule of the iteration; Adam's bias-corrected step; AdamW's decay) is
worked out on the host in double precision by :meth:`Updater.step_sizes`
and written, as fp32, into one small tensor on the params' device before
each step (:class:`StepSizes`); ``apply`` reads it there as 0-d tensors.
A replayed program therefore steps with its own iteration's sizes, and the
eager step does the same arithmetic: a size rounds to fp32 once, as a
Python float does where a ``_foreach`` op takes it as a scalar.

:class:`FusedUpdateEngine` (reference ``:286-500``, the conf's
``fused_update``) steps the whole network as a few flat buffers, one per
(rule, dtype) group, with the fp32 master buffers resident in the
optimizer state, and owns the ``loss_scale`` policy (none, static,
dynamic); its finite check and scale automaton run on the device, so a
captured step holds them.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from deeplearning4j_tpu_torch.nn import schedules as sched
from deeplearning4j_tpu_torch.tree import tree_get, tree_items, tree_map, \
    tree_set

_add, _sub = torch._foreach_add, torch._foreach_sub
_mul, _div = torch._foreach_mul, torch._foreach_div
_sqrt = torch._foreach_sqrt

Leaves = List[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Updater:
    """IUpdater parity base. ``learning_rate`` may be a float or a
    Schedule; ``slots`` names the state a rule keeps per param."""

    learning_rate: Any = 1e-3
    slots = ()

    def lr(self, iteration, epoch=0) -> float:
        return float(sched.resolve(self.learning_rate)(iteration, epoch))

    def step_sizes(self, iteration, epoch=0) -> Tuple[float, ...]:
        """The iteration's scalars that :meth:`apply` reads, in double
        precision: the learning rate, unless a rule says otherwise."""
        return (self.lr(iteration, epoch),)

    def init_state(self, params: dict):
        """The reference's state tree for one node's params."""
        if not self.slots:
            return ()
        return {s: tree_map(torch.zeros_like, params) for s in self.slots}

    def apply(self, grads: Leaves, state: Dict[str, Leaves], s: Leaves,
              params: Leaves):
        """-> (updates to subtract, new state as slot -> leaves). ``s``:
        :meth:`step_sizes` as 0-d fp32 tensors on the params' device."""
        raise NotImplementedError

    def to_dict(self):
        d = dataclasses.asdict(self)
        if isinstance(self.learning_rate, sched.Schedule):
            d["learning_rate"] = self.learning_rate.to_dict()
        d["@updater"] = type(self).__name__
        return d


_UPDATERS: Dict[str, type] = {}


def _register(cls):
    _UPDATERS[cls.__name__] = cls
    return cls


def updater_from_dict(d) -> Updater:
    """An updater from the reference's JSON dict (a schedule dict as its
    learning rate included); an Updater passes through."""
    if isinstance(d, Updater):
        return d
    d = dict(d)
    name = d.pop("@updater")
    if name not in _UPDATERS:
        raise KeyError(f"updater {name!r} is not ported; ported: "
                       f"{sorted(_UPDATERS)}")
    if isinstance(d.get("learning_rate"), dict):
        d["learning_rate"] = sched.schedule_from_dict(d["learning_rate"])
    return _UPDATERS[name](**d)


@_register
@dataclasses.dataclass(frozen=True)
class NoOp(Updater):
    """Frozen params (DL4J NoOp updater for pretrained/frozen layers)."""

    def step_sizes(self, iteration, epoch=0):
        return ()

    def apply(self, grads, state, s, params):
        return [torch.zeros_like(g) for g in grads], state


@_register
@dataclasses.dataclass(frozen=True)
class Sgd(Updater):
    learning_rate: Any = 0.1

    def apply(self, grads, state, s, params):
        return _mul(grads, s[0]), state


@_register
@dataclasses.dataclass(frozen=True)
class Nesterovs(Updater):
    """Nesterov momentum, DL4J formulation:
    v' = mu*v - lr*g; update = -(mu*v' - lr*g) = lr*g - mu*v'."""

    learning_rate: Any = 0.1
    momentum: float = 0.9
    slots = ("v",)

    def apply(self, grads, state, s, params):
        mu = self.momentum
        lg = _mul(grads, s[0])
        v_new = _sub(_mul(state["v"], mu), lg)
        updates = torch._foreach_neg(_sub(_mul(v_new, mu), lg))
        return updates, {"v": v_new}


@_register
@dataclasses.dataclass(frozen=True)
class AdaGrad(Updater):
    learning_rate: Any = 0.1
    epsilon: float = 1e-6
    slots = ("h",)

    def apply(self, grads, state, s, params):
        h_new = _add(state["h"], _mul(grads, grads))
        updates = _div(_mul(grads, s[0]), _add(_sqrt(h_new), self.epsilon))
        return updates, {"h": h_new}


@_register
@dataclasses.dataclass(frozen=True)
class RmsProp(Updater):
    learning_rate: Any = 0.1
    rms_decay: float = 0.95
    epsilon: float = 1e-8
    slots = ("g2",)

    def apply(self, grads, state, s, params):
        d = self.rms_decay
        g2_new = _add(_mul(state["g2"], d), _mul(_mul(grads, 1 - d), grads))
        updates = _div(_mul(grads, s[0]),
                       _sqrt(_add(g2_new, self.epsilon)))
        return updates, {"g2": g2_new}


@_register
@dataclasses.dataclass(frozen=True)
class AdaDelta(Updater):
    """Adadelta has no learning rate (rho/epsilon only) — DL4J parity."""

    learning_rate: Any = 1.0  # unused; kept for interface uniformity
    rho: float = 0.95
    epsilon: float = 1e-6
    slots = ("g2", "dx2")

    def step_sizes(self, iteration, epoch=0):
        return ()

    def apply(self, grads, state, s, params):
        rho, eps = self.rho, self.epsilon
        g2 = _add(_mul(state["g2"], rho), _mul(_mul(grads, 1 - rho), grads))
        updates = _div(_mul(grads, _sqrt(_add(state["dx2"], eps))),
                       _sqrt(_add(g2, eps)))
        dx2 = _add(_mul(state["dx2"], rho),
                   _mul(_mul(updates, 1 - rho), updates))
        return updates, {"g2": g2, "dx2": dx2}


@_register
@dataclasses.dataclass(frozen=True)
class Adam(Updater):
    learning_rate: Any = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    slots = ("m", "v")

    def _moments(self, grads, state):
        m = _add(_mul(state["m"], self.beta1), _mul(grads, 1 - self.beta1))
        v = _add(_mul(state["v"], self.beta2),
                 _mul(_mul(grads, 1 - self.beta2), grads))
        return m, v

    def step_sizes(self, iteration, epoch=0):
        """(alpha,): lr * sqrt(1 - beta2^t) / (1 - beta1^t), t =
        iteration + 1."""
        t = iteration + 1
        return (self.lr(iteration, epoch) * math.sqrt(1 - self.beta2 ** t)
                / (1 - self.beta1 ** t),)

    def apply(self, grads, state, s, params):
        m, v = self._moments(grads, state)
        updates = _div(_mul(m, s[0]), _add(_sqrt(v), self.epsilon))
        return updates, {"m": m, "v": v}


@_register
@dataclasses.dataclass(frozen=True)
class AdamW(Adam):
    """Adam with decoupled weight decay (update += lr * wd * param)."""

    weight_decay: float = 0.01

    def step_sizes(self, iteration, epoch=0):
        """(alpha, lr * weight_decay)."""
        return super().step_sizes(iteration, epoch) + (
            self.lr(iteration, epoch) * self.weight_decay,)

    def apply(self, grads, state, s, params):
        updates, new_state = super().apply(grads, state, s, params)
        return _add(updates, _mul(params, s[1])), new_state


@_register
@dataclasses.dataclass(frozen=True)
class AMSGrad(Adam):
    slots = ("m", "v", "vhat")

    def apply(self, grads, state, s, params):
        m, v = self._moments(grads, state)
        vhat = torch._foreach_maximum(state["vhat"], v)
        updates = _div(_mul(m, s[0]), _add(_sqrt(vhat), self.epsilon))
        return updates, {"m": m, "v": v, "vhat": vhat}


@_register
@dataclasses.dataclass(frozen=True)
class AdaMax(Adam):
    def step_sizes(self, iteration, epoch=0):
        """(lr, 1 - beta1^t), t = iteration + 1."""
        return (self.lr(iteration, epoch), 1 - self.beta1 ** (iteration + 1))

    def apply(self, grads, state, s, params):
        m = _add(_mul(state["m"], self.beta1), _mul(grads, 1 - self.beta1))
        u = torch._foreach_maximum(_mul(state["v"], self.beta2),
                                   torch._foreach_abs(grads))
        updates = _div(_mul(m, s[0]), _mul(_add(u, self.epsilon), s[1]))
        return updates, {"m": m, "v": u}


@_register
@dataclasses.dataclass(frozen=True)
class Nadam(Adam):
    def step_sizes(self, iteration, epoch=0):
        """(lr, 1 - beta1^t, 1 - beta2^t), t = iteration + 1."""
        t = iteration + 1
        return (self.lr(iteration, epoch), 1 - self.beta1 ** t,
                1 - self.beta2 ** t)

    def apply(self, grads, state, s, params):
        m, v = self._moments(grads, state)
        num = _add(_div(_mul(m, self.beta1), s[1]),
                   _div(_mul(grads, 1 - self.beta1), s[1]))
        updates = _div(_mul(num, s[0]),
                       _add(_sqrt(_div(v, s[2])), self.epsilon))
        return updates, {"m": m, "v": v}


def apply_updates(updater: Updater, params: Sequence[dict],
                  grads: Sequence[dict], states: Sequence[Any],
                  s: Leaves) -> None:
    """One optimizer step for several nodes that share ``updater``:
    ``params``/``grads`` are the nodes' param trees (nested dicts of
    tensors), ``states`` their state trees, ``s`` the updater's step sizes
    for this iteration as 0-d tensors. Each param is updated in place,
    ``p -= update`` in p's type, and each state leaf takes its new value in
    place."""
    paths = [[path for path, _ in tree_items(p) if _has(g, path)]
             for p, g in zip(params, grads)]
    leaves_p = [tree_get(p, path) for p, ps in zip(params, paths)
                for path in ps]
    if not leaves_p or isinstance(updater, NoOp):
        return
    leaves_g = [tree_get(g, path) for g, ps in zip(grads, paths)
                for path in ps]
    slot_in = {slot: [tree_get(st[slot], path)
                      for st, ps in zip(states, paths) for path in ps]
               for slot in updater.slots}
    updates, slot_out = updater.apply(leaves_g, slot_in, s, leaves_p)
    with torch.no_grad():
        torch._foreach_sub_(leaves_p,
                            [u.to(p.dtype) for u, p in zip(updates, leaves_p)])
        for slot in updater.slots:
            torch._foreach_copy_(slot_in[slot], slot_out[slot])


def _has(tree, path) -> bool:
    for k in path:
        if not isinstance(tree, dict) or k not in tree:
            return False
        tree = tree[k]
    return True


def step_size_tensors(updater: Updater, iteration, device, epoch=0
                      ) -> Leaves:
    """:meth:`Updater.step_sizes` as 0-d fp32 tensors on ``device``."""
    return list(torch.tensor(updater.step_sizes(iteration, epoch),
                             dtype=torch.float32, device=device))


def apply_updater(updater: Updater, params: dict, grads: dict, state,
                  iteration, epoch=0):
    """One optimizer step on one node: ``params -= update`` and the state
    updated, in place. Returns (params, state), the reference's
    signature."""
    device = next(t for _, t in tree_items(params)).device
    apply_updates(updater, [params], [grads], [state],
                  step_size_tensors(updater, iteration, device, epoch))
    return params, state


def group_by_rule(updaters: Dict[Any, Updater]
                  ) -> List[Tuple[Updater, List[Any]]]:
    """``(updater, [keys])`` for each distinct rule of ``updaters`` (key ->
    Updater), in first-seen order: nodes or layers with equal updaters
    step together in one multi-tensor call."""
    groups: Dict[str, Tuple[Updater, List[Any]]] = {}
    for key, u in updaters.items():
        groups.setdefault(json.dumps(u.to_dict(), sort_keys=True),
                          (u, []))[1].append(key)
    return list(groups.values())


class StepSizes:
    """The step sizes of every group of :func:`group_by_rule` for the
    iteration about to run, in one fp32 tensor on the network's device.
    :meth:`write` works them out on the host and copies them over before
    the step (from pinned memory on CUDA, so the host does not wait);
    ``views`` are each group's 0-d views of the tensor, which the step
    reads, eager or captured."""

    def __init__(self, groups, device):
        self._updaters = [u for u, _ in groups]
        counts = [len(u.step_sizes(0)) for u in self._updaters]
        self.buf = torch.zeros(max(1, sum(counts)), dtype=torch.float32,
                               device=device)
        self.views, at = [], 0
        for n in counts:
            self.views.append([self.buf[at + j] for j in range(n)])
            at += n
        self._n = at

    def write(self, iteration, epoch=0) -> None:
        if not self._n:
            return
        vals = [v for u in self._updaters
                for v in u.step_sizes(iteration, epoch)]
        host = torch.tensor(vals, dtype=torch.float32,
                            pin_memory=self.buf.is_cuda)
        self.buf[:self._n].copy_(host, non_blocking=True)


def step_groups(groups, params, grads: dict, opt_states, sizes) -> None:
    """One optimizer step over :func:`group_by_rule`'s groups, with
    :class:`StepSizes`' ``views`` (``sizes``, one list per group).
    ``params`` and ``opt_states`` are indexed by the groups' keys (a dict by
    node name, or a list by layer index); both are updated in place. Keys
    without gradients (``grads.get(key)`` empty) are left as they are."""
    for (updater, keys), s in zip(groups, sizes):
        keys = [k for k in keys if grads.get(k)]
        if keys:
            apply_updates(updater, [params[k] for k in keys],
                          [grads[k] for k in keys],
                          [opt_states[k] for k in keys], s)


# ---------------------------------------------------------------------------
# Fused update engine (reference nn/updaters.py:286-500)
# ---------------------------------------------------------------------------

LOSS_SCALE_MAX = 2.0 ** 24
LOSS_SCALE_MIN = 1.0


class FusedUpdateEngine:
    """The whole network's optimizer step as one update per flat buffer
    instead of a walk over the leaves.

    Every (updater rule, param dtype) group of the float leaves flattens
    into one 1-D buffer padded to 512 elements
    (``ops/updater_ops.build_groups``); the rule's ``apply`` runs once a
    group over it, and the result is copied back into the param tensors in
    place. Each group's **master buffer stays resident in the optimizer
    state** (fp32, for a bf16 group too): a step flattens only the
    gradients. An fp32 group steps bit for bit as the per-leaf walk does.
    The invariant this buys costs a rule: params and masters move
    together, so code that writes ``net.params`` outside the step must call
    :meth:`resync_masters` (the serializer, the transfer builder and
    ``ModelRouter.reload`` through the serializer do). Layers whose updater
    is ``NoOp`` (frozen) are left out: they never move.

    ``loss_scale``: ``"none"``; ``"static"`` (the loss is multiplied by
    ``loss_scale_value`` before the backward, the gradients divided by it
    here); ``"dynamic"``: static scaling plus the automaton: a step with
    any non-finite gradient applies nothing (params, moments and masters
    keep their bits) and halves the scale; after ``growth_interval`` good
    steps in a row the scale doubles; it stays within [2^0, 2^24]. The
    automaton's state (``scale``, ``good``) lives in the optimizer state on
    the device, and every decision is a ``torch.where`` there: no value
    comes to the host, so the step can be captured as a CUDA graph.

    The state tree: ``{"groups": [{"master", "opt"}, ...]}`` plus
    ``"scale": {"good", "scale"}`` under ``dynamic``. Step sizes: one list
    per group, as :class:`StepSizes` writes them for :attr:`rule_groups`.
    """

    def __init__(self, updaters, params, *, loss_scale: str = "none",
                 loss_scale_value: float = 2.0 ** 15,
                 growth_interval: int = 2000):
        from deeplearning4j_tpu_torch.ops import updater_ops as uo

        if loss_scale not in ("none", "static", "dynamic"):
            raise ValueError(
                f"loss_scale must be none|static|dynamic, got {loss_scale!r}")
        self.loss_scale = loss_scale
        self.loss_scale_value = float(loss_scale_value)
        self.growth_interval = int(growth_interval)
        self._is_dict = isinstance(params, dict)
        upd_map = updaters if self._is_dict else dict(enumerate(updaters))
        keys = params if self._is_dict else range(len(params))
        self.keys = [k for k in keys if k in upd_map
                     and not isinstance(upd_map[k], NoOp)]
        self.groups = uo.build_groups(
            [(k, params[k]) for k in self.keys], upd_map)
        #: (updater, [group index]) per group, for :class:`StepSizes`
        self.rule_groups = [(g.updater, [i])
                            for i, g in enumerate(self.groups)]
        self._static_scale = None

    # ------------------------------------------------------------- state
    def _leaves(self, trees) -> Dict[Any, list]:
        from deeplearning4j_tpu_torch.tree import tree_leaves

        return {k: tree_leaves(trees.get(k) if isinstance(trees, dict)
                               else trees[k])
                for k in self.keys}

    def init_state(self, params) -> dict:
        """The optimizer state: each group's master (its params as fp32)
        and the rule's state over it; the scale automaton under
        ``dynamic``."""
        from deeplearning4j_tpu_torch.ops import updater_ops as uo

        leaves = self._leaves(params)
        groups_state = []
        device = None
        for g in self.groups:
            master = uo.flatten_group(g, leaves, cast_dtype=torch.float32)
            device = master.device
            groups_state.append({"master": master,
                                 "opt": g.updater.init_state(master)})
        state = {"groups": groups_state}
        if device is None:
            device = next((t.device for v in leaves.values() for t in v),
                          torch.device("cpu"))
        self._static_scale = torch.tensor(self.loss_scale_value,
                                          dtype=torch.float32, device=device)
        if self.loss_scale == "dynamic":
            state["scale"] = {
                "good": torch.zeros((), dtype=torch.int32, device=device),
                "scale": torch.tensor(self.loss_scale_value,
                                      dtype=torch.float32, device=device)}
        return state

    def resync_masters(self, params, state) -> dict:
        """Copy the params into the resident master buffers (in place:
        captured programs keep reading the same tensors) after the params
        were written outside the step. Moments are kept. Returns
        ``state``."""
        from deeplearning4j_tpu_torch.ops import updater_ops as uo

        leaves = self._leaves(params)
        with torch.no_grad():
            for g, gs in zip(self.groups, state["groups"]):
                gs["master"].copy_(uo.flatten_group(
                    g, leaves, cast_dtype=torch.float32))
        return state

    def current_scale(self, state) -> Optional[torch.Tensor]:
        """The loss multiplier of this step as a 0-d device tensor (None
        when scaling is off)."""
        if self.loss_scale == "none":
            return None
        if self.loss_scale == "static":
            return self._static_scale
        return state["scale"]["scale"]

    @staticmethod
    def wrap_scaled(loss_fn, scale):
        """``args -> (loss, aux)`` as ``args -> (scaled loss, (aux, loss))``:
        the gradients of the first come out ``scale`` x true, and the aux
        carries the unscaled loss. ``scale=None`` scales nothing."""
        def wrapped(*args):
            loss, aux = loss_fn(*args)
            scaled = loss if scale is None else loss * scale.to(loss.dtype)
            return scaled, (aux, loss)

        return wrapped

    # ------------------------------------------------------------- apply
    def flatten_grads(self, grads) -> List[torch.Tensor]:
        """The gradients, one fp32 padded 1-D buffer per group (the one
        flatten a step makes). No unscaling here: :meth:`apply_flat` owns
        the loss-scale policy."""
        from deeplearning4j_tpu_torch.ops import updater_ops as uo

        return [uo.flatten_group(g, self._leaves(grads),
                                 cast_dtype=torch.float32)
                for g in self.groups]

    def apply(self, params, grads, state, sizes) -> None:
        """One fused step, in place: ``grads`` keyed as ``params``,
        ``sizes`` the step sizes of each group (``StepSizes.views``)."""
        self.apply_flat(params, self.flatten_grads(grads), state, sizes)

    def apply_flat(self, params, g_bufs, state, sizes) -> None:
        """:meth:`apply` over gradients already flattened per group."""
        leaves_p = self._leaves(params)
        scale = self.current_scale(state)
        if scale is not None:
            inv = torch.reciprocal(scale)
            g_bufs = [buf * inv.to(buf.dtype) for buf in g_bufs]
        finite = None
        if self.loss_scale == "dynamic":
            finite = torch.stack([torch.isfinite(b).all()
                                  for b in g_bufs]).all()
        with torch.no_grad():
            for g, buf, gs, s in zip(self.groups, g_bufs, state["groups"],
                                     sizes):
                master = gs["master"]
                slot_in = {k: [gs["opt"][k]] for k in g.updater.slots}
                updates, slot_out = g.updater.apply([buf], slot_in, s,
                                                    [master])
                upd = updates[0].to(master.dtype)
                if finite is None:
                    master.sub_(upd)
                    for k in g.updater.slots:
                        slot_in[k][0].copy_(slot_out[k][0])
                else:
                    # a skipped step: every buffer keeps its old bits (each
                    # where writes into the buffer it keeps)
                    torch.where(finite, master - upd, master, out=master)
                    for k in g.updater.slots:
                        torch.where(finite, slot_out[k][0], slot_in[k][0],
                                    out=slot_in[k][0])
                dst = [leaves_p[r.coll_key][r.leaf_idx] for r in g.leaves]
                src = [master[r.offset:r.offset + r.size].view(r.shape)
                       for r in g.leaves]
                torch._foreach_copy_(dst, src)
            if finite is not None:
                st = state["scale"]
                sc, good = st["scale"], st["good"]
                grown = (good + 1) >= self.growth_interval
                sc.copy_(torch.where(
                    finite,
                    torch.where(grown, torch.clamp(sc * 2.0,
                                                   max=LOSS_SCALE_MAX), sc),
                    torch.clamp(sc * 0.5, min=LOSS_SCALE_MIN)))
                good.copy_(torch.where(
                    finite, torch.where(grown, torch.zeros_like(good),
                                        good + 1),
                    torch.zeros_like(good)))
