"""The port's ResNet-50 training slice against the JAX package, on the CPU:

- ``batchnorm_train`` (values, EMA update, gradients, the EMA outputs'
  cotangents) against the reference op within 1e-5;
- ``softmax_cross_entropy`` with 0/1 row weights, and the padded-batch
  invariant of its weighted mean;
- every updater, three steps on a random tree against the reference's
  (1e-6 relative), schedule-dict learning rates among them; the
  schedules' values and the updaters' JSON;
- the max-pool gradient on tied windows (a relu-zero window) against
  ``jax.grad``;
- on the narrow ResNet of tests/test_torch_slice.py (params copied with
  ``interop``): a 4-step ``fit`` trajectory against the reference's
  ``fit`` under Sgd, Nesterovs and Adam (losses and final params within
  1e-4 relative, docs/KERNELS.md), the training state carried both ways
  through ``interop``, ``score`` and ``output(train=True)``;
- ``fit`` with ``batch_buckets`` equals ``fit`` without; the ``fit`` entry
  forms; what is not ported raises naming its slice; entry points never
  drift to the CPU.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deeplearning4j_tpu_torch.nn.layers as TL  # noqa: E402
import deeplearning4j_tpu_torch.nn.vertices as TV  # noqa: E402
from deeplearning4j_tpu.nn import ComputationGraph as JGraph  # noqa: E402
from deeplearning4j_tpu.nn import layers as JL  # noqa: E402
from deeplearning4j_tpu.nn import losses as JLOSSES  # noqa: E402
from deeplearning4j_tpu.nn import schedules as jsched  # noqa: E402
from deeplearning4j_tpu.nn import updaters as jupd  # noqa: E402
from deeplearning4j_tpu.nn.computation_graph import (  # noqa: E402
    ComputationGraphConfiguration as JConf)
from deeplearning4j_tpu.ops import nn as jnn  # noqa: E402
from deeplearning4j_tpu_torch import interop  # noqa: E402
from deeplearning4j_tpu_torch.data import DataSet  # noqa: E402
from deeplearning4j_tpu_torch.nn import ComputationGraph as TGraph  # noqa: E402
from deeplearning4j_tpu_torch.nn import NeuralNetConfiguration as TNNC  # noqa: E402
from deeplearning4j_tpu_torch.nn import losses as tlosses  # noqa: E402
from deeplearning4j_tpu_torch.nn import schedules as tsched  # noqa: E402
from deeplearning4j_tpu_torch.nn import updaters as tupd  # noqa: E402
from deeplearning4j_tpu_torch.ops import nn as tnn  # noqa: E402
from test_torch_slice import _narrow_conf, narrow  # noqa: E402,F401

TRAJ_RTOL = 1e-4


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


# ------------------------------------------------------------- batchnorm


_BN = [  # (case, shape, EMA-output cotangents)
    ("nhwc", (3, 5, 4, 6), False),
    ("nhwc-ema-cotangents", (3, 5, 4, 6), True),
    ("nc", (7, 5), False),
]


@pytest.mark.parametrize("case", _BN, ids=[c[0] for c in _BN])
def test_batchnorm_train_matches_reference(case):
    _, shape, ema_cts = case
    rng = np.random.default_rng(3)
    c = shape[-1]
    x = (rng.normal(size=shape) * 2 + 1).astype(np.float32)
    gamma, beta = (rng.normal(size=c).astype(np.float32) for _ in range(2))
    rm = rng.normal(size=c).astype(np.float32) * 0.1
    rv = rng.uniform(0.5, 2, c).astype(np.float32)
    dout = rng.normal(size=shape).astype(np.float32)
    dm, dv = (rng.normal(size=c).astype(np.float32) if ema_cts
              else np.zeros(c, np.float32) for _ in range(2))
    jout, vjp = jax.vjp(lambda *a: jnn.batchnorm_train(*a, momentum=0.9,
                                                       eps=1e-5),
                        *map(jnp.asarray, (x, gamma, beta, rm, rv)))
    jgrads = vjp(tuple(map(jnp.asarray, (dout, dm, dv))))
    ins = [_t(a, grad=True) for a in (x, gamma, beta, rm, rv)]
    out = tnn.batchnorm_train(*ins, momentum=0.9, eps=1e-5)
    if ema_cts:
        grads = torch.autograd.grad(out, ins, [_t(a) for a in (dout, dm,
                                                                dv)])
    else:  # only the output is differentiated: no EMA cotangents at all
        grads = torch.autograd.grad(out[0], ins[:3], _t(dout))
        grads = grads + (torch.zeros(c), torch.zeros(c))
    for got, want in zip(list(out) + list(grads), list(jout) + list(jgrads)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ loss


_CE = [  # (case, weights, label smoothing)
    ("unweighted", None, 0.0),
    ("zero-one-weights", [1, 1, 1, 1, 0, 0], 0.0),
    ("all-zero-weights", [0, 0, 0, 0, 0, 0], 0.0),
    ("label-smoothing", None, 0.1),
]


@pytest.mark.parametrize("case", _CE, ids=[c[0] for c in _CE])
def test_softmax_cross_entropy_matches_reference(case):
    _, weights, smooth = case
    rng = np.random.default_rng(4)
    logits = (rng.normal(size=(6, 5)) * 3).astype(np.float32)
    labels = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 6)]
    w = None if weights is None else np.asarray(weights, np.float32)

    def jloss(lg):
        return jnn.softmax_cross_entropy(
            lg, jnp.asarray(labels), None if w is None else jnp.asarray(w),
            label_smoothing=smooth)

    jval, jgrad = jax.value_and_grad(jloss)(jnp.asarray(logits))
    tl = _t(logits, grad=True)
    val = tnn.softmax_cross_entropy(tl, _t(labels),
                                    None if w is None else _t(w),
                                    label_smoothing=smooth)
    (grad,) = torch.autograd.grad(val, tl)
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-6)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-6,
                               atol=1e-7)


def test_zero_one_weights_give_the_unpadded_mean():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(4, 5)).astype(np.float32)
    labels = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 4)]
    pad = np.zeros((2, 5), np.float32)
    plain = tnn.softmax_cross_entropy(_t(logits), _t(labels))
    padded = tnn.softmax_cross_entropy(
        _t(np.concatenate([logits, pad])), _t(np.concatenate([labels, pad])),
        torch.tensor([1.0, 1, 1, 1, 0, 0]))
    assert torch.equal(plain, padded)


def test_losses_resolve_mcxent_and_name_later_slices():
    assert tlosses.resolve("MCXENT")[2] == "softmax"
    assert tlosses.resolve("negativeloglikelihood")[0] is not None
    # every loss of the reference is ported now (the LeNet slice brought
    # the rest): each resolves to the reference's fused activation
    for name, fused in (("mse", None), ("xent", "sigmoid"),
                        ("sparse_mcxent", "softmax")):
        assert tlosses.resolve(name)[2] == fused
    assert tlosses.available() == sorted(JLOSSES.available())
    with pytest.raises(ValueError):
        tlosses.resolve("nope")


def test_regularization_matches_reference():
    rng = np.random.default_rng(6)
    params = {"W": rng.normal(size=(3, 3, 2, 4)).astype(np.float32),
              "b": rng.normal(size=4).astype(np.float32)}
    kw = dict(n_out=4, kernel_size=(3, 3), l1=1e-3, l2=1e-2)
    want = JL.ConvolutionLayer(**kw).regularization(
        {k: jnp.asarray(v) for k, v in params.items()})
    got = TL.ConvolutionLayer(**kw).regularization(
        {k: _t(v) for k, v in params.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert TL.ConvolutionLayer(n_out=4).regularization(
        {k: _t(v) for k, v in params.items()}) == 0.0


# -------------------------------------------------------------- updaters


_STEP = {"@schedule": "StepSchedule", "initial_value": 0.1,
         "decay_rate": 0.5, "step": 2}
_MAP = {"@schedule": "MapSchedule", "values": {"0": 0.1, "2": 0.03}}
_UPDATERS = [  # the reference's updater dicts
    {"@updater": "NoOp", "learning_rate": 0.001},
    {"@updater": "Sgd", "learning_rate": 0.1},
    {"@updater": "Sgd", "learning_rate": _STEP},
    {"@updater": "Nesterovs", "learning_rate": 0.1, "momentum": 0.9},
    {"@updater": "Nesterovs", "learning_rate": _MAP, "momentum": 0.9},
    {"@updater": "AdaGrad", "learning_rate": 0.1, "epsilon": 1e-6},
    {"@updater": "RmsProp", "learning_rate": 0.1, "rms_decay": 0.95,
     "epsilon": 1e-8},
    {"@updater": "AdaDelta", "learning_rate": 1.0, "rho": 0.95,
     "epsilon": 1e-6},
    {"@updater": "Adam", "learning_rate": 1e-2, "beta1": 0.9,
     "beta2": 0.999, "epsilon": 1e-8},
    {"@updater": "Adam", "learning_rate": {
        "@schedule": "ExponentialSchedule", "initial_value": 1e-2,
        "gamma": 0.9}, "beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8},
    {"@updater": "AdamW", "learning_rate": 1e-2, "beta1": 0.9,
     "beta2": 0.999, "epsilon": 1e-8, "weight_decay": 0.01},
    {"@updater": "AMSGrad", "learning_rate": 1e-2, "beta1": 0.9,
     "beta2": 0.999, "epsilon": 1e-8},
    {"@updater": "AdaMax", "learning_rate": 1e-2, "beta1": 0.9,
     "beta2": 0.999, "epsilon": 1e-8},
    {"@updater": "Nadam", "learning_rate": 1e-2, "beta1": 0.9,
     "beta2": 0.999, "epsilon": 1e-8},
]


def _upd_id(d):
    lr = d["learning_rate"]
    return d["@updater"] + (f"-{lr['@schedule']}" if isinstance(lr, dict)
                            else "")


def _tree(rng):
    return {"W": rng.normal(size=(3, 4)).astype(np.float32),
            "b": rng.normal(size=4).astype(np.float32)}


def _flat(tree, prefix=""):
    """(path, array) leaves of a nested dict/tuple tree, in key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in _flat(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (tuple, list)):
        return [leaf for i, v in enumerate(tree)
                for leaf in _flat(v, f"{prefix}/{i}")]
    return [(prefix, np.asarray(tree.detach() if hasattr(tree, "detach")
                                else tree))]


@pytest.mark.parametrize("d", _UPDATERS, ids=[_upd_id(d) for d in _UPDATERS])
def test_updater_matches_reference(d):
    ju, tu = jupd.updater_from_dict(d), tupd.updater_from_dict(d)
    assert tu.to_dict() == ju.to_dict()
    rng = np.random.default_rng(7)
    p0 = _tree(rng)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: _t(v) for k, v in p0.items()}
    js, ts = ju.init_state(jp), tu.init_state(tp)
    for it in range(3):
        g = _tree(rng)
        jp, js = jupd.apply_updater(ju, jp, {k: jnp.asarray(v)
                                             for k, v in g.items()}, js, it)
        tp, ts = tupd.apply_updater(tu, tp, {k: _t(v) for k, v in g.items()},
                                    ts, it)
    for (pa, a), (pb, b) in zip(_flat((tp, ts)), _flat((jp, js))):
        assert pa == pb
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7, err_msg=pa)


def test_apply_updates_steps_nodes_in_place_together():
    """One call over two nodes equals one call per node, and updates the
    param and optimizer-state tensors themselves."""
    u = tupd.updater_from_dict(_UPDATERS[8])
    rng = np.random.default_rng(8)
    trees = [{k: _t(v) for k, v in _tree(rng).items()} for _ in range(2)]
    grads = [{k: _t(v) for k, v in _tree(rng).items()} for _ in range(2)]
    ids = [id(t["W"]) for t in trees]
    copies = [{k: v.clone() for k, v in t.items()} for t in trees]
    states = [u.init_state(t) for t in trees]
    state_ids = [id(st["m"]["W"]) for st in states]
    tupd.apply_updates(u, trees, grads, states,
                       tupd.step_size_tensors(u, 0, torch.device("cpu")))
    per_node = []
    for c, g in zip(copies, grads):
        _, s = tupd.apply_updater(u, c, g, u.init_state(c), 0)
        per_node.append(s)
    assert [id(t["W"]) for t in trees] == ids
    assert [id(st["m"]["W"]) for st in states] == state_ids
    for t, c in zip(trees, copies):
        for k in t:
            assert torch.equal(t[k], c[k])
    for st, s in zip(states, per_node):
        for slot in ("m", "v"):
            for k in st[slot]:
                assert torch.equal(st[slot][k], s[slot][k])
    assert set(states[0]) == {"m", "v"}


_SCHEDULES = [
    {"@schedule": "FixedSchedule", "value": 0.1},
    _STEP,
    {"@schedule": "ExponentialSchedule", "initial_value": 0.1, "gamma": 0.9},
    {"@schedule": "InverseSchedule", "initial_value": 0.1, "gamma": 0.5,
     "power": 2.0},
    {"@schedule": "PolySchedule", "initial_value": 0.1, "power": 2.0,
     "max_iter": 8},
    {"@schedule": "SigmoidSchedule", "initial_value": 0.1, "gamma": 0.5,
     "step_size": 4},
    {"@schedule": "WarmupCosineSchedule", "peak_value": 0.1,
     "warmup_steps": 3, "total_steps": 10, "end_value": 0.01},
    _MAP,
]


@pytest.mark.parametrize("d", _SCHEDULES,
                         ids=[d["@schedule"] for d in _SCHEDULES])
def test_schedule_matches_reference(d):
    js, ts = jsched.schedule_from_dict(d), tsched.schedule_from_dict(d)
    assert ts.to_dict() == js.to_dict()
    for it in range(12):
        np.testing.assert_allclose(ts(it), float(js(it)), rtol=1e-6)


# --------------------------------------------------------------- pooling


def test_max_pool_gradient_on_tied_windows_matches_reference():
    """stem_pool follows a relu: windows of zeros tie, and windows with two
    equal maxima. The gradient goes to the first maximum in row-major
    order in both packages."""
    rng = np.random.default_rng(9)
    x = np.maximum(rng.normal(size=(2, 7, 8, 3)), 0).astype(np.float32)
    x[:, :4, :4] = 0.0           # all-zero (relu-dead) windows
    x[0, 5, 5, :] = x[0, 5, 6, :] = 2.0  # two equal maxima in a window
    r = rng.normal(size=(2, 4, 4, 3)).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(jnn.max_pool2d(
        a, (3, 3), (2, 2), "SAME") * r))(jnp.asarray(x))
    tx = _t(x, grad=True)
    out = tnn.max_pool2d(tx, (3, 3), (2, 2), "SAME")
    (got,) = torch.autograd.grad((out * _t(r)).sum(), tx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------- the narrow ResNet


_TRAJ_UPDATERS = [
    {"@updater": "Sgd", "learning_rate": 0.1},
    {"@updater": "Nesterovs", "learning_rate": 0.05, "momentum": 0.9},
    # epsilon 1e-3: stem_bn's beta has a gradient near zero (the 1x1 convs
    # behind stem_relu and stem_pool are followed by batch-statistic
    # batchnorms, which absorb a shift; only the windows where the relu or
    # the pool is inactive contribute), so its computed gradient is at the
    # level of rounding noise, about 1e-8, in either package; Adam's
    # per-element normalisation with epsilon 1e-8 would turn that noise
    # into +-lr steps. At 1e-3 the noise stays noise and every real
    # gradient (1e-3 and up) is still normalised as Adam does.
    {"@updater": "Adam", "learning_rate": 1e-2, "beta1": 0.9,
     "beta2": 0.999, "epsilon": 1e-3},
]


def _reference_net(conf_json, params, states):
    """The reference's graph for ``conf_json`` with the given weights,
    initialized on a PRNG that compiles fast (the values are replaced)."""
    jnet = JGraph(JConf.from_json(conf_json))
    prng = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", "unsafe_rbg")
    try:
        jnet.init()
    finally:
        jax.config.update("jax_default_prng_impl", prng)
    jnet.params = jax.tree_util.tree_map(jnp.asarray, params)
    jnet.states = jax.tree_util.tree_map(jnp.asarray, states)
    return jnet


def _batch(seed, n=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 32, 32, 3)).astype(np.float32)
    return x, np.eye(5, dtype=np.float32)[rng.integers(0, 5, n)]


def _with(jnet, **conf):
    d = json.loads(jnet.conf.to_json())
    d.update(conf)
    return json.dumps(d)


def _assert_trees_close(port_tree, ref_tree, rtol=TRAJ_RTOL):
    """Each leaf within ``rtol`` relative L2 of the reference's."""
    ref = jax.tree_util.tree_map(np.asarray, ref_tree)
    for (pa, a), (pb, b) in zip(_flat(port_tree), _flat(ref)):
        assert pa == pb
        err = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        assert err <= rtol, (pa, err)


@pytest.mark.parametrize("updater", _TRAJ_UPDATERS,
                         ids=[u["@updater"] for u in _TRAJ_UPDATERS])
def test_fit_trajectory_matches_reference(narrow, updater):
    jnet0, params, states, _ = narrow
    conf = _with(jnet0, updater=updater)
    jnet = _reference_net(conf, params, states)
    net = interop.from_reference_json(conf, params, states, device="cpu")
    x, y = _batch(1)
    for _ in range(4):
        jnet.fit(jnp.asarray(x), jnp.asarray(y))
        net.fit(x, y)
        np.testing.assert_allclose(net.get_score(), float(jnet.score_value),
                                   rtol=TRAJ_RTOL)
    assert (net.iteration, net.epoch) == (jnet.iteration, jnet.epoch) == (4, 4)
    out = interop.to_numpy(net)
    _assert_trees_close(out["params"], jnet.params)
    _assert_trees_close(out["states"], jnet.states)
    _assert_trees_close(out["opt_states"], jnet.opt_states)


def test_training_state_round_trips_through_interop(narrow):
    """Adam state and iteration carried from the reference into the port,
    back into the reference, and port to port; each continuation tracks."""
    jnet0, params, states, _ = narrow
    conf = _with(jnet0, updater=_TRAJ_UPDATERS[2])
    jnet = _reference_net(conf, params, states)
    x, y = _batch(2)
    for _ in range(2):
        jnet.fit(jnp.asarray(x), jnp.asarray(y))
    ref = {k: jax.tree_util.tree_map(np.asarray, getattr(jnet, k))
           for k in ("params", "states", "opt_states")}
    net = interop.from_reference_json(conf, ref["params"], ref["states"],
                                      device="cpu")
    interop.load_reference(net, ref["params"], ref["states"],
                           ref["opt_states"], iteration=jnet.iteration,
                           epoch=jnet.epoch)
    jnet.fit(jnp.asarray(x), jnp.asarray(y))
    net.fit(x, y)
    _assert_trees_close(interop.to_numpy(net)["params"], jnet.params)
    # port -> reference: the reference continues from the port's state
    out = interop.to_numpy(net)
    for k in ("params", "states", "opt_states"):
        setattr(jnet, k, jax.tree_util.tree_map(jnp.asarray, out[k]))
    jnet.iteration = out["iteration"]
    # port -> port
    twin = interop.from_reference_json(conf, out["params"], out["states"],
                                       device="cpu")
    interop.load_reference(twin, out["params"], out["states"],
                           out["opt_states"], out["iteration"],
                           out["epoch"])
    jnet.fit(jnp.asarray(x), jnp.asarray(y))
    net.fit(x, y)
    twin.fit(x, y)
    _assert_trees_close(interop.to_numpy(net)["params"], jnet.params)
    for a, b in zip(_flat(interop.to_numpy(twin)), _flat(interop.to_numpy(
            net))):
        np.testing.assert_array_equal(a[1], b[1])
    with pytest.raises(ValueError, match="opt_states"):
        interop.load_reference(twin, out["params"], out["states"],
                               {"stem_conv": ()})


def test_score_and_train_output_match_reference(narrow):
    jnet, params, states, _ = narrow
    net = interop.from_reference_json(jnet.conf.to_json(), params, states,
                                      device="cpu")
    x, y = _batch(3, n=3)
    np.testing.assert_allclose(net.score(x=x, y=y),
                               jnet.score(x=jnp.asarray(x), y=jnp.asarray(y)),
                               rtol=TRAJ_RTOL)
    np.testing.assert_allclose(net.score(DataSet(x, y)),
                               net.score(x=x, y=y), rtol=1e-7)
    np.testing.assert_allclose(
        net.output(x, train=True).numpy(),
        np.asarray(jnet.output(jnp.asarray(x), train=True)),
        rtol=TRAJ_RTOL, atol=1e-7)
    before = interop.to_numpy(net)
    grads, loss = net.compute_gradient_and_score(x, y)
    assert set(grads["stem_bn"]) == {"gamma", "beta"} and loss.dim() == 0
    after = interop.to_numpy(net)  # nothing was applied
    for (_, a), (_, b) in zip(_flat(before), _flat(after)):
        np.testing.assert_array_equal(a, b)


def test_bf16_fit_keeps_fp32_params_and_tracks_the_fp32_step(narrow):
    """compute_dtype=bfloat16: the step casts the fp32 params inside
    autograd, so the update reaches them and they stay fp32 (as do the
    batchnorm statistics and the optimizer state); the serving path's
    cached bf16 copies are refreshed after the in-place update. bf16
    rounding through batch-statistic batchnorm at batch 4 moves single
    tensors' updates by tens of percent, so the step is held to the fp32
    one as a whole: the concatenated updates point the same way (cosine
    above 0.9; 0.97 on this batch; a cast that cut the gradient off would
    give 0) and the losses agree within 2e-2."""
    jnet, params, states, _ = narrow
    nets = {dt: interop.from_reference_json(_with(jnet, compute_dtype=dt),
                                            params, states, device="cpu")
            for dt in ("float32", "bfloat16")}
    x, y = _batch(4)
    before = nets["bfloat16"].output(x)
    for net in nets.values():
        net.fit(x, y)
    p0 = np.concatenate([a.ravel() for _, a in _flat(params)])
    upd = {}
    for dt, net in nets.items():
        out = interop.to_numpy(net)
        leaves = [a for _, a in _flat(out["params"]) + _flat(out["states"])]
        assert all(a.dtype == np.float32 for a in leaves), dt
        upd[dt] = np.concatenate([a.ravel() for _, a in
                                  _flat(out["params"])]) - p0
    cos = upd["bfloat16"] @ upd["float32"] / (
        np.linalg.norm(upd["bfloat16"]) * np.linalg.norm(upd["float32"]))
    assert cos > 0.9, cos
    np.testing.assert_allclose(nets["bfloat16"].get_score(),
                               nets["float32"].get_score(), rtol=2e-2)
    after = nets["bfloat16"].output(x)
    assert after.dtype == torch.bfloat16 and not torch.equal(after, before)


def _small_conf(buckets=None):
    """conv -> relu -> global pool -> softmax output: no batchnorm, whose
    batch statistics would see the padding rows."""
    gb = (TNNC.builder().seed(3).updater({"@updater": "Sgd",
                                          "learning_rate": 0.5})
          .graph_builder().add_inputs("in"))
    gb.add_layer("conv", TL.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                             activation="relu"), "in")
    gb.add_layer("pool", TL.GlobalPoolingLayer(), "conv")
    gb.add_layer("out", TL.OutputLayer(n_in=4, n_out=3), "pool")
    conf = gb.set_outputs("out").set_input_types((6, 6, 2)).build()
    conf.batch_buckets = buckets
    return conf


def test_fit_with_batch_buckets_equals_fit_without():
    rng = np.random.default_rng(10)
    x = rng.normal(size=(3, 6, 6, 2)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[[0, 2, 1]]
    plain = TGraph(_small_conf()).init(device="cpu")
    bucketed = TGraph(_small_conf(buckets=(4, 8))).init(device="cpu")
    for _ in range(2):
        plain.fit(x, y)
        bucketed.fit(x, y)  # runs at 4 rows, the 4th weighted 0
        np.testing.assert_allclose(bucketed.get_score(), plain.get_score(),
                                   rtol=1e-6)
    for (_, a), (_, b) in zip(_flat(interop.to_numpy(bucketed)),
                              _flat(interop.to_numpy(plain))):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


def test_fit_entry_forms_take_the_same_steps():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 6, 6, 2)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[[0, 2]]
    nets = [TGraph(_small_conf()).init(device="cpu") for _ in range(4)]
    nets[0].fit(x, y, epochs=2)
    nets[1].fit(DataSet(x, y), epochs=2)
    nets[2].fit([DataSet(x, y), DataSet(x, y)])
    nets[3].fit([x], [y])
    nets[3].fit(torch.from_numpy(x), torch.from_numpy(y))
    assert [n.iteration for n in nets] == [2, 2, 2, 2]
    assert [n.epoch for n in nets] == [2, 2, 1, 2]
    for other in nets[1:]:
        for (_, a), (_, b) in zip(_flat(other.params), _flat(nets[0].params)):
            np.testing.assert_array_equal(a, b)


def test_unported_training_paths_name_their_slice():
    x = np.zeros((2, 6, 6, 2), np.float32)
    y = np.eye(3, dtype=np.float32)[[0, 1]]
    conf = _small_conf()
    conf.knobs["fused_update"] = True
    with pytest.raises(NotImplementedError, match="slice"):
        TGraph(conf).init(device="cpu").fit(x, y)
    # a masked DataSet trains as the reference
    # does; on this CNN the (B, T) masks reach no node (the shape rule)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 6, 6, 2)).astype(np.float32)
    m = np.array([[1, 1, 1, 1, 1, 1], [1, 1, 1, 0, 0, 0]], np.float32)
    jnet = JGraph(JConf.from_json(_small_conf().to_json())).init()
    net = TGraph(_small_conf()).init(device="cpu")
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    interop.load_reference(net, tree(jnet.params), tree(jnet.states),
                           tree(jnet.opt_states), jnet.iteration)
    from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
    for _ in range(2):
        net.fit(DataSet(x, y, features_mask=m, labels_mask=m))
        jnet.fit(JDataSet(x, y, features_mask=m, labels_mask=m))
        np.testing.assert_allclose(net.get_score(), jnet.get_score(),
                                   rtol=TRAJ_RTOL)
    for (_, a), (_, b) in zip(_flat(interop.to_numpy(net)["params"]),
                              _flat(tree(jnet.params))):
        np.testing.assert_allclose(a, b, rtol=TRAJ_RTOL, atol=1e-6)


def test_fit_never_drifts_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((2, 6, 6, 2), np.float32)
    y = np.eye(3, dtype=np.float32)[[0, 1]]
    with pytest.raises(RuntimeError, match="CUDA"):
        TGraph(_small_conf()).init().fit(x, y)
    with pytest.raises(ValueError, match="init"):
        TGraph(_small_conf()).fit(x, y)


# ----------------------------------------------------- the chip smoke's rules


def _smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_counts_52_dgrad_launches_per_step():
    from deeplearning4j_tpu_torch.zoo.models import ResNet50

    dg = _smoke().dgrad_launches(ResNet50().conf(), batch=8)
    assert sum(dg.values()) == 52
    assert dg[(8, 224, 224, 3, 7, 7, 64, (2, 2), "SAME", (1, 1), 1)] == 0


@pytest.mark.parametrize("name,cls", [
    ("void (anonymous namespace)::conv2d_fwd_f32<128>(float const*)", "fwd"),
    ("void (anonymous namespace)::conv2d_fwd_f32<64>(float const*)", "fwd"),
    ("void (anonymous namespace)::conv2d_fwd_bf16(__nv_bfloat16 const*)",
     "fwd"),
    ("void (anonymous namespace)::conv2d_wgrad_bf16(__nv_bfloat16 const*)",
     "wgrad"),
    ("void (anonymous namespace)::reduce_splits<float>(float const*)",
     "split_reduce"),
    ("void (anonymous namespace)::reduce_conv_splits<__nv_bfloat16>("
     "float const*)", "split_reduce"),
    ("void (anonymous namespace)::conv2d_fwd_wgmma<128, true>(CUtensorMap)",
     "fwd"),
    ("void (anonymous namespace)::conv2d_wgrad_wgmma<128, 0>(CUtensorMap, "
     "CUtensorMap, float*, float*, (anonymous namespace)::WgmmaGeom)", "wgrad"),
    ("void (anonymous namespace)::reduce_splits<float4>(float4 const*, "
     "float4*, long long, int, int)", "split_reduce"),
    ("void at::native::reduce_kernel<128, 4>()", None),
])
def test_chip_smoke_profile_buckets(name, cls):
    assert _smoke()._kernel_class(name) == cls


def test_chip_smoke_classes_every_conv_kernel(monkeypatch):
    """Every device kernel of the conv library's sources falls in a profile
    class, and a library kernel with no class fails the profile rather
    than going into its "other" time unseen."""
    smoke = _smoke()
    names = smoke.conv_kernel_names()
    assert {"conv2d_fwd_f32", "conv2d_fwd_bf16", "conv2d_fwd_wgmma",
            "conv2d_wgrad_f32", "conv2d_wgrad_wgmma", "reduce_conv_splits",
            "reduce_splits"} <= names
    for k in names:
        assert smoke._kernel_class(
            f"void (anonymous namespace)::{k}<float>(float const*)"), k
    assert smoke._by_class([
        (1.0, 2, "void (anonymous namespace)::reduce_conv_splits<float>()"),
        (0.5, 1, "void (anonymous namespace)::reduce_splits<float>()"),
        (2.0, 1, "void (anonymous namespace)::conv2d_fwd_wgmma<64, false>()"),
        (4.0, 9, "void at::native::vectorized_elementwise_kernel<4>()"),
    ]) == {"split_reduce": 1.5, "fwd": 2.0}
    monkeypatch.setattr(smoke, "conv_kernel_names",
                        lambda root=None: {"fresh_kernel"})
    with pytest.raises(AssertionError, match="no class"):
        smoke._by_class([(1.0, 1, "void (anonymous namespace)::"
                                  "fresh_kernel<float>()")])


def test_chip_smoke_range_kernels_take_outermost_ranges_whole():
    """A profile's kernels under a named range, its nested ops' included,
    counted once when the name repeats inside itself."""
    from types import SimpleNamespace as NS

    def ev(name, kernels=(), children=()):
        e = NS(name=name, kernels=[NS(name=k, duration=us)
                                   for k, us in kernels],
               cpu_children=list(children), cpu_parent=None)
        for c in children:
            c.cpu_parent = e
        return e

    copy = ev("aten::copy_", [("elementwise", 2.0)])
    inner = ev("_BatchNormTrain", [("reduce_kernel", 5.0)])
    outer = ev("_BatchNormTrainBackward", [("conv2d_fwd_f32<64>", 1.0)],
               [copy, inner])
    other = ev("aten::mm", [("gemm", 7.0)])
    got = list(_smoke()._range_kernels([outer, copy, inner, other],
                                       "_BatchNormTrain"))
    assert sorted(got) == [("conv2d_fwd_f32<64>", 1.0),
                           ("elementwise", 2.0), ("reduce_kernel", 5.0)]


def test_chip_smoke_check_every_launch_holds_each_call(monkeypatch):
    """The smoke's per-launch check counts each wrapper call under its
    type, lets agreeing results through, fails a wrapper that disagrees
    with its plain version, and puts the wrappers back."""
    from deeplearning4j_tpu_torch.ops.kernels import conv as kconv

    smoke = _smoke()
    rng = np.random.default_rng(12)
    x = _t(rng.normal(size=(2, 6, 5, 4)).astype(np.float32))
    w = _t(rng.normal(size=(3, 3, 4, 6)).astype(np.float32))
    dy = _t(rng.normal(size=(2, 3, 3, 6)).astype(np.float32))
    geo = ((2, 2), ((1, 1), (1, 1)), (1, 1), 1)
    originals = {n: getattr(kconv, n) for n in smoke.PLAIN_OF}
    checked = {}
    with smoke.check_every_launch(torch, checked):
        kconv.conv2d_fwd(x, w, *geo)
        kconv.conv2d_fwd(x.bfloat16(), w.bfloat16(), *geo, row_tile=None)
        kconv.conv2d_dgrad(dy, w, (6, 5), *geo)
        kconv.conv2d_wgrad(x, dy, 3, 3, *geo)
    assert {k: v["calls"] for k, v in checked.items()} == {
        ("conv2d_fwd", "fp32"): 1, ("conv2d_fwd", "bf16"): 1,
        ("conv2d_dgrad", "fp32"): 1, ("conv2d_wgrad", "fp32"): 1}
    assert {n: getattr(kconv, n) for n in smoke.PLAIN_OF} == originals
    monkeypatch.setattr(kconv, "conv2d_wgrad",
                        lambda *a: originals["conv2d_wgrad"](*a) * 1.01)
    with pytest.raises(AssertionError, match="conv2d_wgrad fp32"):
        with smoke.check_every_launch(torch, {}):
            kconv.conv2d_wgrad(x, dy, 3, 3, *geo)


def test_chip_smoke_gradient_gate():
    """A tensor passes within 1e-3 of the fp64 gradient, or no farther
    from it than 3x the plain path (cancelling gradients), or under 1e-6
    of the largest gradient (vanishing ones); else it fails."""
    smoke = _smoke()
    g64 = {"a": {"W": torch.ones(4) * 10}, "b": {"beta": torch.ones(4)},
           "c": {"beta": torch.full((4,), 1e-9)}}
    exact = {"a": {"W": g64["a"]["W"] * (1 + 1e-6)},
             "b": {"beta": g64["b"]["beta"] + 0.01},
             "c": {"beta": torch.full((4,), 2e-9)}}
    auto = {"a": {"W": g64["a"]["W"] * (1 + 5e-4)},
            "b": {"beta": g64["b"]["beta"] - 0.02},
            "c": {"beta": torch.full((4,), -3e-6)}}
    worst, rows, failures = smoke._grad_parity(auto, exact, g64)
    assert failures == [] and worst[0] == "c.beta" and len(rows) == 3
    auto["b"]["beta"] = g64["b"]["beta"] + 0.05
    assert [f["tensor"] for f in smoke._grad_parity(auto, exact, g64)[2]] \
        == ["b.beta"]
