"""The updaters' step sizes as device scalars (``nn/updaters.py``), on the
CPU.

A captured step must read the learning rate and Adam's bias-corrected step
of the iteration it replays, so the port works each size out on the host
and hands it to the ``_foreach`` ops as a 0-d fp32 tensor
(``Updater.step_sizes``, ``StepSizes``), and updates the optimizer state
in place. Each updater, under a step schedule over 5 iterations, against:

- the Python-float form it had before (kept below as it was: each size a
  Python float of the iteration, the state trees replaced), bit for bit;
- the reference's ``apply_updater``, within 1e-6 relative.

``StepSizes`` writes one buffer for a net's groups, and its views follow
each write.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.nn import updaters as jupd  # noqa: E402
from deeplearning4j_tpu_torch.nn import updaters as tupd  # noqa: E402
from deeplearning4j_tpu_torch.tree import tree_leaves  # noqa: E402

_add, _sub = torch._foreach_add, torch._foreach_sub
_mul, _div = torch._foreach_mul, torch._foreach_div
_sqrt = torch._foreach_sqrt

_STEP = {"@schedule": "StepSchedule", "initial_value": 0.1,
         "decay_rate": 0.5, "step": 2}
_ADAM = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}
_UPDATERS = [
    {"@updater": "Sgd", "learning_rate": _STEP},
    {"@updater": "Nesterovs", "learning_rate": _STEP, "momentum": 0.9},
    {"@updater": "AdaGrad", "learning_rate": _STEP, "epsilon": 1e-6},
    {"@updater": "RmsProp", "learning_rate": _STEP, "rms_decay": 0.95,
     "epsilon": 1e-8},
    {"@updater": "AdaDelta", "learning_rate": 1.0, "rho": 0.95,
     "epsilon": 1e-6},
    {"@updater": "Adam", "learning_rate": _STEP, **_ADAM},
    {"@updater": "AdamW", "learning_rate": _STEP, **_ADAM,
     "weight_decay": 0.01},
    {"@updater": "AMSGrad", "learning_rate": _STEP, **_ADAM},
    {"@updater": "AdaMax", "learning_rate": _STEP, **_ADAM},
    {"@updater": "Nadam", "learning_rate": _STEP, **_ADAM},
]


# ------------------------------------------- the Python-float form, as it was
def _float_apply(u, grads, state, params, iteration):
    """(updates, new state) of the previous ``apply``: every size a Python
    float of ``iteration``."""
    name = type(u).__name__
    lr = u.lr(iteration)
    if name == "Sgd":
        return _mul(grads, lr), state
    if name == "Nesterovs":
        mu = u.momentum
        lg = _mul(grads, lr)
        v_new = _sub(_mul(state["v"], mu), lg)
        return torch._foreach_neg(_sub(_mul(v_new, mu), lg)), {"v": v_new}
    if name == "AdaGrad":
        h_new = _add(state["h"], _mul(grads, grads))
        return _div(_mul(grads, lr), _add(_sqrt(h_new), u.epsilon)), \
            {"h": h_new}
    if name == "RmsProp":
        d = u.rms_decay
        g2 = _add(_mul(state["g2"], d), _mul(_mul(grads, 1 - d), grads))
        return _div(_mul(grads, lr), _sqrt(_add(g2, u.epsilon))), \
            {"g2": g2}
    if name == "AdaDelta":
        rho, eps = u.rho, u.epsilon
        g2 = _add(_mul(state["g2"], rho), _mul(_mul(grads, 1 - rho), grads))
        upd = _div(_mul(grads, _sqrt(_add(state["dx2"], eps))),
                   _sqrt(_add(g2, eps)))
        dx2 = _add(_mul(state["dx2"], rho), _mul(_mul(upd, 1 - rho), upd))
        return upd, {"g2": g2, "dx2": dx2}
    t = iteration + 1
    b1, b2 = u.beta1, u.beta2
    m = _add(_mul(state["m"], b1), _mul(grads, 1 - b1))
    v = _add(_mul(state["v"], b2), _mul(_mul(grads, 1 - b2), grads))
    alpha = lr * math.sqrt(1 - b2 ** t) / (1 - b1 ** t)
    if name in ("Adam", "AdamW"):
        upd = _div(_mul(m, alpha), _add(_sqrt(v), u.epsilon))
        if name == "AdamW":
            upd = _add(upd, _mul(params, lr * u.weight_decay))
        return upd, {"m": m, "v": v}
    if name == "AMSGrad":
        vhat = torch._foreach_maximum(state["vhat"], v)
        return _div(_mul(m, alpha), _add(_sqrt(vhat), u.epsilon)), \
            {"m": m, "v": v, "vhat": vhat}
    if name == "AdaMax":
        mm = _add(_mul(state["m"], b1), _mul(grads, 1 - b1))
        uu = torch._foreach_maximum(_mul(state["v"], b2),
                                    torch._foreach_abs(grads))
        bc1 = 1 - b1 ** t
        return _div(_mul(mm, lr), _mul(_add(uu, u.epsilon), bc1)), \
            {"m": mm, "v": uu}
    assert name == "Nadam"
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    num = _add(_div(_mul(m, b1), bc1), _div(_mul(grads, 1 - b1), bc1))
    return _div(_mul(num, lr), _add(_sqrt(_div(v, bc2)), u.epsilon)), \
        {"m": m, "v": v}


def _float_step(u, params, grads, state, iteration):
    """The previous ``apply_updater``: params in place, a new state tree."""
    keys = list(params)
    slot_in = {s: [state[s][k] for k in keys] for s in u.slots}
    upd, out = _float_apply(u, [grads[k] for k in keys], slot_in,
                            [params[k] for k in keys], iteration)
    torch._foreach_sub_([params[k] for k in keys], upd)
    return {s: dict(zip(keys, out[s])) for s in u.slots} if u.slots else ()


def _tree(rng):
    return {"W": rng.normal(size=(3, 4)).astype(np.float32),
            "b": rng.normal(size=4).astype(np.float32)}


def _id(d):
    return d["@updater"]


@pytest.mark.parametrize("d", _UPDATERS, ids=[_id(d) for d in _UPDATERS])
def test_device_step_sizes_equal_python_floats_and_the_reference(d):
    tu, ju = tupd.updater_from_dict(d), jupd.updater_from_dict(d)
    rng = np.random.default_rng(3)
    p0 = _tree(rng)
    mine = {k: torch.tensor(v) for k, v in p0.items()}
    old = {k: torch.tensor(v) for k, v in p0.items()}
    ref = {k: jnp.asarray(v) for k, v in p0.items()}
    st = tu.init_state(mine)
    st_ids = [id(t) for t in tree_leaves(st)]
    old_st, ref_st = tu.init_state(old), ju.init_state(ref)
    sizes = tupd.StepSizes([(tu, ["n"])], torch.device("cpu"))
    for it in range(5):
        g = _tree(rng)
        sizes.write(it)
        tupd.step_groups([(tu, ["n"])], {"n": mine},
                         {"n": {k: torch.tensor(v) for k, v in g.items()}},
                         {"n": st}, sizes.views)
        old_st = _float_step(tu, old, {k: torch.tensor(v)
                                       for k, v in g.items()}, old_st, it)
        ref, ref_st = jupd.apply_updater(
            ju, ref, {k: jnp.asarray(v) for k, v in g.items()}, ref_st, it)
        for k in p0:
            assert torch.equal(mine[k], old[k]), (it, k)
            np.testing.assert_allclose(mine[k].numpy(), np.asarray(ref[k]),
                                       rtol=1e-6, atol=1e-7)
        for s in tu.slots:
            for k in p0:
                assert torch.equal(st[s][k], old_st[s][k]), (it, s, k)
                np.testing.assert_allclose(
                    st[s][k].numpy(), np.asarray(ref_st[s][k]), rtol=1e-6,
                    atol=1e-7)
    # the state's tensors were updated in place, not replaced
    assert [id(t) for t in tree_leaves(st)] == st_ids


def test_step_sizes_buffer_holds_every_group_in_order():
    groups = [(tupd.Sgd(learning_rate=tupd.updater_from_dict(
        {"@updater": "Sgd", "learning_rate": _STEP}).learning_rate), [0]),
        (tupd.AdaDelta(), [1]), (tupd.Nadam(learning_rate=0.01), [2])]
    sizes = tupd.StepSizes(groups, torch.device("cpu"))
    assert [len(v) for v in sizes.views] == [1, 0, 3]
    for it in (0, 3):
        sizes.write(it)
        want = [float(np.float32(x)) for u, _ in groups
                for x in u.step_sizes(it)]
        assert [float(t) for v in sizes.views for t in v] == want
        assert sizes.views[0][0].dim() == 0
