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
the params IN PLACE (the params stay the same leaf tensors, and a cached
bf16 copy of a param sees the change through its version counter) and
returns the new state trees. The learning rate, a float or a schedule of
the iteration, is a Python float per step.

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

    def init_state(self, params: dict):
        """The reference's state tree for one node's params."""
        if not self.slots:
            return ()
        return {s: tree_map(torch.zeros_like, params) for s in self.slots}

    def apply(self, grads: Leaves, state: Dict[str, Leaves], iteration,
              epoch=0):
        """-> (updates to subtract, new state as slot -> leaves)."""
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

    def apply(self, grads, state, iteration, epoch=0):
        return [torch.zeros_like(g) for g in grads], state


@_register
@dataclasses.dataclass(frozen=True)
class Sgd(Updater):
    learning_rate: Any = 0.1

    def apply(self, grads, state, iteration, epoch=0):
        return _mul(grads, self.lr(iteration, epoch)), state


@_register
@dataclasses.dataclass(frozen=True)
class Nesterovs(Updater):
    """Nesterov momentum, DL4J formulation:
    v' = mu*v - lr*g; update = -(mu*v' - lr*g) = lr*g - mu*v'."""

    learning_rate: Any = 0.1
    momentum: float = 0.9
    slots = ("v",)

    def apply(self, grads, state, iteration, epoch=0):
        mu = self.momentum
        lg = _mul(grads, self.lr(iteration, epoch))
        v_new = _sub(_mul(state["v"], mu), lg)
        updates = torch._foreach_neg(_sub(_mul(v_new, mu), lg))
        return updates, {"v": v_new}


@_register
@dataclasses.dataclass(frozen=True)
class AdaGrad(Updater):
    learning_rate: Any = 0.1
    epsilon: float = 1e-6
    slots = ("h",)

    def apply(self, grads, state, iteration, epoch=0):
        h_new = _add(state["h"], _mul(grads, grads))
        updates = _div(_mul(grads, self.lr(iteration, epoch)),
                       _add(_sqrt(h_new), self.epsilon))
        return updates, {"h": h_new}


@_register
@dataclasses.dataclass(frozen=True)
class RmsProp(Updater):
    learning_rate: Any = 0.1
    rms_decay: float = 0.95
    epsilon: float = 1e-8
    slots = ("g2",)

    def apply(self, grads, state, iteration, epoch=0):
        d = self.rms_decay
        g2_new = _add(_mul(state["g2"], d), _mul(_mul(grads, 1 - d), grads))
        updates = _div(_mul(grads, self.lr(iteration, epoch)),
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

    def apply(self, grads, state, iteration, epoch=0):
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

    def _alpha(self, iteration, epoch):
        """lr * sqrt(1 - beta2^t) / (1 - beta1^t), t = iteration + 1."""
        t = iteration + 1
        return (self.lr(iteration, epoch) * math.sqrt(1 - self.beta2 ** t)
                / (1 - self.beta1 ** t))

    def apply(self, grads, state, iteration, epoch=0):
        m, v = self._moments(grads, state)
        updates = _div(_mul(m, self._alpha(iteration, epoch)),
                       _add(_sqrt(v), self.epsilon))
        return updates, {"m": m, "v": v}


@_register
@dataclasses.dataclass(frozen=True)
class AdamW(Adam):
    """Adam with decoupled weight decay (update += lr * wd * param)."""

    weight_decay: float = 0.01

    def apply_with_params(self, grads, state, params, iteration, epoch=0):
        updates, new_state = super().apply(grads, state, iteration, epoch)
        decay = self.lr(iteration, epoch) * self.weight_decay
        return _add(updates, _mul(params, decay)), new_state


@_register
@dataclasses.dataclass(frozen=True)
class AMSGrad(Adam):
    slots = ("m", "v", "vhat")

    def apply(self, grads, state, iteration, epoch=0):
        m, v = self._moments(grads, state)
        vhat = torch._foreach_maximum(state["vhat"], v)
        updates = _div(_mul(m, self._alpha(iteration, epoch)),
                       _add(_sqrt(vhat), self.epsilon))
        return updates, {"m": m, "v": v, "vhat": vhat}


@_register
@dataclasses.dataclass(frozen=True)
class AdaMax(Adam):
    def apply(self, grads, state, iteration, epoch=0):
        t = iteration + 1
        m = _add(_mul(state["m"], self.beta1), _mul(grads, 1 - self.beta1))
        u = torch._foreach_maximum(_mul(state["v"], self.beta2),
                                   torch._foreach_abs(grads))
        bc1 = 1 - self.beta1 ** t
        updates = _div(_mul(m, self.lr(iteration, epoch)),
                       _mul(_add(u, self.epsilon), bc1))
        return updates, {"m": m, "v": u}


@_register
@dataclasses.dataclass(frozen=True)
class Nadam(Adam):
    def apply(self, grads, state, iteration, epoch=0):
        t = iteration + 1
        m, v = self._moments(grads, state)
        bc1 = 1 - self.beta1 ** t
        bc2 = 1 - self.beta2 ** t
        num = _add(_div(_mul(m, self.beta1), bc1),
                   _div(_mul(grads, 1 - self.beta1), bc1))
        updates = _div(_mul(num, self.lr(iteration, epoch)),
                       _add(_sqrt(_div(v, bc2)), self.epsilon))
        return updates, {"m": m, "v": v}


def apply_updates(updater: Updater, params: Sequence[dict],
                  grads: Sequence[dict], states: Sequence[Any], iteration,
                  epoch=0) -> list:
    """One optimizer step for several nodes that share ``updater``:
    ``params``/``grads`` are the nodes' param trees (nested dicts of
    tensors), ``states`` their state trees. Each param is updated in
    place, ``p -= update`` in p's type; returns the nodes' new state
    trees."""
    paths = [[path for path, _ in tree_items(p) if _has(g, path)]
             for p, g in zip(params, grads)]
    leaves_p = [tree_get(p, path) for p, ps in zip(params, paths)
                for path in ps]
    if not leaves_p or isinstance(updater, NoOp):
        return list(states)
    leaves_g = [tree_get(g, path) for g, ps in zip(grads, paths)
                for path in ps]
    slot_in = {s: [tree_get(st[s], path) for st, ps in zip(states, paths)
                   for path in ps]
               for s in updater.slots}
    if hasattr(updater, "apply_with_params"):
        updates, slot_out = updater.apply_with_params(
            leaves_g, slot_in, leaves_p, iteration, epoch)
    else:
        updates, slot_out = updater.apply(leaves_g, slot_in, iteration, epoch)
    with torch.no_grad():
        torch._foreach_sub_(leaves_p,
                            [u.to(p.dtype) for u, p in zip(updates, leaves_p)])
    if not updater.slots:
        return list(states)
    new_states, i = [], 0
    for st, ps in zip(states, paths):
        tree = {s: tree_map(lambda t: t, st[s]) for s in updater.slots}
        for path in ps:
            for s in updater.slots:
                tree_set(tree[s], path, slot_out[s][i])
            i += 1
        new_states.append(tree)
    return new_states


def _has(tree, path) -> bool:
    for k in path:
        if not isinstance(tree, dict) or k not in tree:
            return False
        tree = tree[k]
    return True


def apply_updater(updater: Updater, params: dict, grads: dict, state,
                  iteration, epoch=0):
    """One optimizer step on one node: ``params -= update`` in place.
    Returns (params, new_state), the reference's signature."""
    return params, apply_updates(updater, [params], [grads], [state],
                                 iteration, epoch)[0]


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


def step_groups(groups, params, grads: dict, opt_states, iteration) -> None:
    """One optimizer step over :func:`group_by_rule`'s groups. ``params``
    and ``opt_states`` are indexed by the groups' keys (a dict by node
    name, or a list by layer index); the params are updated in place and
    each stepped key's state replaced in ``opt_states``. Keys without
    gradients (``grads.get(key)`` empty) are left as they are."""
    for updater, keys in groups:
        keys = [k for k in keys if grads.get(k)]
        new = apply_updates(updater, [params[k] for k in keys],
                            [grads[k] for k in keys],
                            [opt_states[k] for k in keys], iteration)
        for k, state in zip(keys, new):
            opt_states[k] = state
