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

Not ported: ``FusedUpdateEngine`` (the reference's flat-buffer optimizer
with loss scaling); ``fused_update=True`` or a ``loss_scale`` on the conf
raises in ``ComputationGraph`` naming the slice that brings it.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, List, Sequence, Tuple

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
