"""The fused optimizer step and loss scaling (``nn/updaters.py``
``FusedUpdateEngine``, ``ops/updater_ops.py``'s flat buffers, the conf's
``fused_update``/``loss_scale``) on the CPU, against the JAX package and
against the port's per-leaf updaters.

- fp32: a fused ``fit`` equals the per-leaf one bit for bit, for every
  updater rule, on a layer stack with batchnorm (3 steps), and static
  power-of-two scaling changes no bit;
- a 3-step fused trajectory against the reference's fused ``fit``
  within 1e-4 relative (an absolute floor of 1e-6);
- the dynamic scale's sequence (scale and good-step counter) over two
  injected non-finite steps and a growth interval of 2, equal to the
  reference engine's step for step; a skipped step leaves params, moments
  and masters bit-equal; the scale's clamps;
- bf16 params: fp32 masters, against the reference engine within 1e-6
  (the masters) and one bf16 rounding (the params);
- the flat-buffer helpers against the reference's (groups, offsets,
  padding to 512);
- a captured (program) step with an injected non-finite input skips its
  update on the device, as the eager step does;
- archives and checkpoints with masters: restore with the optimizer state
  continues bit for bit, restore without it resyncs the masters to the
  loaded params; the transfer builder resyncs too; ``loss_scale`` without
  ``fused_update`` is refused, as in the reference.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.nn import layers as JL  # noqa: E402
from deeplearning4j_tpu.nn import updaters as jupd  # noqa: E402
from deeplearning4j_tpu.nn.conf import \
    NeuralNetConfiguration as JNNC  # noqa: E402
from deeplearning4j_tpu.nn.multilayer import \
    MultiLayerNetwork as JMLN  # noqa: E402
from deeplearning4j_tpu.ops import updater_ops as juo  # noqa: E402
from deeplearning4j_tpu_torch import interop  # noqa: E402
from deeplearning4j_tpu_torch.nn import capture  # noqa: E402
from deeplearning4j_tpu_torch.nn import layers as TL  # noqa: E402
from deeplearning4j_tpu_torch.nn import updaters as tupd  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import \
    MultiLayerConfiguration as TMConf  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import \
    NeuralNetConfiguration as TNNC  # noqa: E402
from deeplearning4j_tpu_torch.nn.multilayer import \
    MultiLayerNetwork as TMLN  # noqa: E402
from deeplearning4j_tpu_torch.ops import updater_ops as tuo  # noqa: E402

RTOL, FLOOR = 1e-4, 1e-6
RULES = ["Sgd", "Nesterovs", "AdaGrad", "RmsProp", "AdaDelta", "Adam",
         "AdamW", "AMSGrad", "AdaMax", "Nadam"]


def _batch(seed=0, n=8):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 5)).astype(np.float32),
            np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)])


def _port_net(rule="Adam", fused=False, scale="none", growth=2000,
              value=2.0 ** 15):
    b = TNNC.builder().seed(3).updater({"@updater": rule,
                                        "learning_rate": 0.05})
    if fused:
        b.fused_update(True)
    if scale != "none":
        b.loss_scale(scale, value=value, growth_interval=growth)
    conf = (b.list()
            .layer(TL.DenseLayer(n_out=7, activation="tanh"))
            .layer(TL.BatchNormalization())
            .layer(TL.OutputLayer(n_out=3))
            .set_input_type((5,)).build())
    return TMLN(conf).init(device="cpu")


def _params(net):
    return [(i, k, v.detach().clone()) for i, p in enumerate(net.params)
            for k, v in sorted(p.items())]


def _assert_params_equal(a, b):
    for (_, k, x), (_, _, y) in zip(_params(a), _params(b)):
        assert torch.equal(x, y), k


# ------------------------------------------------------- fp32 bit parity
@pytest.mark.parametrize("rule", RULES)
def test_fused_fp32_equals_per_leaf(rule):
    x, y = _batch()
    plain, fused = _port_net(rule), _port_net(rule, fused=True)
    assert fused._fused is not None and plain._fused is None
    for _ in range(3):
        plain.fit(x, y)
        fused.fit(x, y)
        assert float(plain.score_value) == float(fused.score_value)
    _assert_params_equal(plain, fused)
    # the masters hold the params' values
    for g, gs in zip(fused._fused.groups, fused.opt_states["groups"]):
        flat = tuo.flatten_group(g, fused._fused._leaves(fused.params),
                                 cast_dtype=torch.float32)
        assert torch.equal(flat, gs["master"])


def test_static_power_of_two_scaling_changes_no_bit():
    x, y = _batch(1)
    plain = _port_net("Adam")
    for scale in ("static", "dynamic"):
        net = _port_net("Adam", fused=True, scale=scale)
        for _ in range(3):
            net.fit(x, y)
        if scale == "static":
            for _ in range(3):
                plain.fit(x, y)
        _assert_params_equal(plain, net)


# ------------------------------------------------ against the reference
def _ref_conf(fused=True):
    b = JNNC.builder().seed(3).updater(jupd.Adam(0.05))
    if fused:
        b.fused_update(True)
    return (b.list()
            .layer(JL.DenseLayer(n_out=7, activation="tanh"))
            .layer(JL.BatchNormalization())
            .layer(JL.OutputLayer(n_out=3))
            .set_input_type((5,)).build())


def test_fused_trajectory_matches_reference():
    x, y = _batch(2)
    jnet = JMLN(_ref_conf()).init()
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    net = TMLN(TMConf.from_json(jnet.conf.to_json())).init(device="cpu")
    assert net._fused is not None
    interop.load_reference_mln(net, tree(jnet.params), tree(jnet.states))
    for _ in range(3):
        jnet.fit(x, y)
        net.fit(x, y)
        np.testing.assert_allclose(float(net.score_value),
                                   float(jnet.score_value), rtol=RTOL,
                                   atol=FLOOR)
    for i, p in enumerate(tree(jnet.params)):
        for k, v in p.items():
            np.testing.assert_allclose(net.params[i][k].numpy(), v,
                                       rtol=RTOL, atol=FLOOR)


def _engines(dtype, loss_scale, growth, value):
    rng = np.random.default_rng(7)
    shapes = [{"W": (5, 4), "b": (4,)}, {"W": (4, 3)}]
    np_params = [{k: rng.normal(size=s).astype(np.float32)
                  for k, s in d.items()} for d in shapes]
    rules = [("Adam", jupd.Adam(0.01), {"@updater": "Adam",
                                        "learning_rate": 0.01}),
             ("Sgd", jupd.Sgd(0.1), {"@updater": "Sgd",
                                     "learning_rate": 0.1})]
    jp = [{k: jnp.asarray(v, dtype) for k, v in d.items()}
          for d in np_params]
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tp = [{k: torch.tensor(v).to(tdt) for k, v in d.items()}
          for d in np_params]
    je = jupd.FusedUpdateEngine([r[1] for r in rules], jp,
                                loss_scale=loss_scale,
                                loss_scale_value=value,
                                growth_interval=growth)
    te = tupd.FusedUpdateEngine([tupd.updater_from_dict(r[2])
                                 for r in rules], tp,
                                loss_scale=loss_scale,
                                loss_scale_value=value,
                                growth_interval=growth)
    return rng, shapes, (je, jp, je.init_state(jp)), \
        (te, tp, te.init_state(tp))


def test_dynamic_scale_sequence_matches_reference():
    rng, shapes, (je, jp, js), (te, tp, ts) = _engines(
        jnp.float32, "dynamic", 2, 4.0)
    sizes = tupd.StepSizes(te.rule_groups, torch.device("cpu"))
    seen = []
    for it in range(7):
        g = [{k: rng.normal(size=s).astype(np.float32) * 4.0
              for k, s in d.items()} for d in shapes]
        if it in (2, 5):  # non-finite gradients: the step must skip
            g[1]["W"][0, 0] = np.inf if it == 2 else np.nan
        before = ([{k: v.clone() for k, v in d.items()} for d in tp],
                  [{"master": gs["master"].clone(),
                    "opt": {s: t.clone() for s, t in dict(gs["opt"]).items()}}
                   for gs in ts["groups"]])
        jp, js = je.apply(jp, [{k: jnp.asarray(v) for k, v in d.items()}
                               for d in g], js, it)
        sizes.write(it)
        te.apply(tp, [{k: torch.tensor(v) for k, v in d.items()}
                      for d in g], ts, sizes.views)
        seen.append((float(ts["scale"]["scale"]), int(ts["scale"]["good"])))
        assert seen[-1] == (float(js["scale"]["scale"]),
                            int(js["scale"]["good"])), it
        if it in (2, 5):
            for a, b in zip(before[0], tp):
                for k in a:
                    assert torch.equal(a[k], b[k])
            for a, b in zip(before[1], ts["groups"]):
                assert torch.equal(a["master"], b["master"])
                for s in a["opt"]:
                    assert torch.equal(a["opt"][s], b["opt"][s])
        for a, b in zip(jp, tp):
            for k in a:
                np.testing.assert_allclose(b[k].numpy(), np.asarray(a[k]),
                                           rtol=1e-6, atol=1e-7)
    # good steps double the scale every 2, a skip halves it
    assert seen == [(4.0, 1), (8.0, 0), (4.0, 0), (4.0, 1), (8.0, 0),
                    (4.0, 0), (4.0, 1)]


def test_scale_stays_within_its_clamps():
    te = tupd.FusedUpdateEngine([tupd.Sgd(0.1)], [{"W": torch.ones(3)}],
                                loss_scale="dynamic", loss_scale_value=1.0,
                                growth_interval=1)
    params = [{"W": torch.ones(3)}]
    st = te.init_state(params)
    sizes = tupd.StepSizes(te.rule_groups, torch.device("cpu"))
    sizes.write(0)
    te.apply(params, [{"W": torch.full((3,), np.nan)}], st, sizes.views)
    assert float(st["scale"]["scale"]) == tupd.LOSS_SCALE_MIN
    st["scale"]["scale"].fill_(tupd.LOSS_SCALE_MAX)
    te.apply(params, [{"W": torch.zeros(3)}], st, sizes.views)
    assert float(st["scale"]["scale"]) == tupd.LOSS_SCALE_MAX


def test_bf16_masters_match_reference():
    rng, shapes, (je, jp, js), (te, tp, ts) = _engines(
        jnp.bfloat16, "none", 2000, 1.0)
    assert all(g.needs_master and g.dtype == torch.bfloat16
               for g in te.groups)
    assert all(gs["master"].dtype == torch.float32 for gs in ts["groups"])
    sizes = tupd.StepSizes(te.rule_groups, torch.device("cpu"))
    for it in range(3):
        g = [{k: rng.normal(size=s).astype(np.float32) for k, s in
              d.items()} for d in shapes]
        jp, js = je.apply(jp, [{k: jnp.asarray(v, jnp.bfloat16)
                                for k, v in d.items()} for d in g], js, it)
        sizes.write(it)
        te.apply(tp, [{k: torch.tensor(v).to(torch.bfloat16)
                       for k, v in d.items()} for d in g], ts, sizes.views)
    # the masters' layout differs (leaf order), their contents by leaf do
    # not: compare the params they round to, and the masters by leaf
    for a, b in zip(jp, tp):
        for k in a:
            want = np.asarray(a[k].astype(jnp.float32))
            got = b[k].float().numpy()
            np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)
    for g, gs in zip(te.groups, ts["groups"]):
        for r in g.leaves:
            m = gs["master"][r.offset:r.offset + r.size].view(r.shape)
            assert torch.equal(m.to(torch.bfloat16),
                               tp[r.coll_key][list(
                                   tp[r.coll_key])[r.leaf_idx]])


def test_flat_buffers_match_the_reference_helpers():
    rng = np.random.default_rng(1)
    np_params = [{"W": rng.normal(size=(37, 5)).astype(np.float32),
                  "b": rng.normal(size=(5,)).astype(np.float32)},
                 {"W": rng.normal(size=(5, 600)).astype(np.float32)}]
    ups = {0: jupd.Adam(0.01), 1: jupd.Adam(0.01)}
    tups = {0: tupd.Adam(0.01), 1: tupd.Adam(0.01)}
    jg = juo.build_groups([(i, {k: jnp.asarray(v) for k, v in p.items()})
                           for i, p in enumerate(np_params)], ups)
    tg = tuo.build_groups([(i, {k: torch.tensor(v) for k, v in p.items()})
                           for i, p in enumerate(np_params)], tups)
    assert [g.total for g in tg] == [g.total for g in jg] == [3584]
    assert [(r.coll_key, r.leaf_idx, r.shape, r.offset)
            for r in tg[0].leaves] == [(r.coll_key, r.leaf_idx, r.shape,
                                        r.offset) for r in jg[0].leaves]
    assert tuo.updater_signature(tupd.Adam(0.01)) == \
        juo.updater_signature(jupd.Adam(0.01))
    leaves = {i: [torch.tensor(v) for v in p.values()]
              for i, p in enumerate(np_params)}
    buf = tuo.flatten_group(tg[0], leaves)
    jbuf = juo.flatten_group(jg[0], {i: [jnp.asarray(v) for v in p.values()]
                                     for i, p in enumerate(np_params)})
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    out = {0: [None, None], 1: [None]}
    tuo.unflatten_group(tg[0], buf, out)
    for i, p in enumerate(np_params):
        for got, want in zip(out[i], p.values()):
            np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="non-float"):
        tuo.build_groups([(0, {"i": torch.zeros(3, dtype=torch.int32)})],
                         {0: tupd.Sgd(0.1)})


# ------------------------------------------- the captured program path
@pytest.mark.parametrize("captured", [True, False],
                         ids=["program", "eager"])
def test_non_finite_step_skips_on_the_device(captured):
    x, y = _batch(3)
    net = _port_net("Adam", fused=True, scale="dynamic", growth=100)
    ctx = capture.disabled() if not captured else _nullcontext()
    with ctx:
        net.fit(x, y)
        before = _params(net)
        masters = [gs["master"].clone() for gs in net.opt_states["groups"]]
        moments = [{k: v.clone() for k, v in gs["opt"].items()}
                   for gs in net.opt_states["groups"]]
        bad = x.copy()
        bad[0, 0] = np.inf
        net.fit(bad, y)
    for (_, k, a), (_, _, b) in zip(before, _params(net)):
        assert torch.equal(a, b), k
    for gs, m, mo in zip(net.opt_states["groups"], masters, moments):
        assert torch.equal(gs["master"], m)
        for k in mo:
            assert torch.equal(gs["opt"][k], mo[k])
    assert float(net.opt_states["scale"]["scale"]) == 2.0 ** 14
    assert int(net.opt_states["scale"]["good"]) == 0
    assert bool(captured) == bool(net.programs())


class _nullcontext:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


# --------------------------------------------- archives and checkpoints
def test_serializer_round_trip_with_masters(tmp_path):
    from deeplearning4j_tpu_torch.util import ModelSerializer

    x, y = _batch(4)
    net = _port_net("Adam", fused=True, scale="dynamic")
    for _ in range(2):
        net.fit(x, y)
    path = str(tmp_path / "m.zip")
    ModelSerializer.write_model(net, path, save_updater=True)
    back = ModelSerializer.restore_model(path, device="cpu")
    for a, b in zip(net.opt_states["groups"], back.opt_states["groups"]):
        assert torch.equal(a["master"], b["master"])
    net.fit(x, y)
    back.fit(x, y)
    _assert_params_equal(net, back)
    # without the optimizer state the masters follow the loaded params
    fresh = ModelSerializer.restore_model(path, load_updater=False,
                                          device="cpu")
    for g, gs in zip(fresh._fused.groups, fresh.opt_states["groups"]):
        flat = tuo.flatten_group(g, fresh._fused._leaves(fresh.params),
                                 cast_dtype=torch.float32)
        assert torch.equal(flat, gs["master"])


def test_checkpoint_and_transfer_keep_masters(tmp_path):
    from deeplearning4j_tpu_torch.nn.transfer import TransferLearning
    from deeplearning4j_tpu_torch.util import ShardedCheckpointer

    x, y = _batch(5)
    net = _port_net("Adam", fused=True)
    net.fit(x, y)
    ck = ShardedCheckpointer(str(tmp_path / "ck"), log_fn=lambda *a: None)
    ck.save(1, net)
    twin = _port_net("Adam", fused=True)
    ck.restore(twin)
    net.fit(x, y)
    twin.fit(x, y)
    _assert_params_equal(net, twin)
    new = TransferLearning.Builder(net).build()
    assert new._fused is not None
    for g, gs in zip(new._fused.groups, new.opt_states["groups"]):
        flat = tuo.flatten_group(g, new._fused._leaves(new.params),
                                 cast_dtype=torch.float32)
        assert torch.equal(flat, gs["master"])


def test_loss_scale_requires_fused_update():
    with pytest.raises(ValueError, match="fused_update"):
        TNNC.builder().loss_scale("dynamic")
    with pytest.raises(ValueError, match="none|static|dynamic"):
        TNNC.builder().fused_update(True).loss_scale("sometimes")
    conf = _port_net().conf
    conf.knobs["loss_scale"] = "static"
    with pytest.raises(ValueError, match="fused_update"):
        TMLN(conf)
    with pytest.raises(ValueError, match="fused_update"):
        JNNC.builder().loss_scale("dynamic")
