"""The encoded gradient exchange of the port (``parallel/compression.py``,
``parallel/accumulator.py``) against the JAX package's, on the CPU.

- ``GradCompressor.encode_combine`` for ``threshold``, ``bitmap`` and
  ``onebit``, hosts 1 and 2, on the same stacked fp32 gradients over 10
  iterations: the combined tree, the residual, the threshold and every
  stats value bit-equal to the reference's (the reference's call jitted,
  as its wrapper runs it: XLA turns a division by a constant into a
  multiply by its fp32 reciprocal, and the port does the same);
- ``EncodedGradientsAccumulator`` with the three threshold algorithms and
  with and without ``ResidualClippingPostProcessor``, 10 iterations, bit
  for bit;
- the error-feedback conservation of the power-of-two encode, bit for bit;
- the knobs: the builder's ``grad_compression`` on both networks' confs
  and their JSON both ways between the packages, the
  ``DL4J_TPU_GRAD_COMPRESSION`` default, scheme validation;
- the checkpointer's sidecar npz round trip, and ``CompressionHostsSpace``'s
  candidates against the reference's.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.parallel import accumulator as JA  # noqa: E402
from deeplearning4j_tpu.parallel import compression as JC  # noqa: E402
from deeplearning4j_tpu_torch.nn import layers as TL  # noqa: E402
from deeplearning4j_tpu_torch.nn.computation_graph import \
    ComputationGraphConfiguration as TCGConf  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import \
    MultiLayerConfiguration as TMConf  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import \
    NeuralNetConfiguration as TNNC  # noqa: E402
from deeplearning4j_tpu_torch.parallel import accumulator as TA  # noqa: E402
from deeplearning4j_tpu_torch.parallel import compression as TC  # noqa: E402

SHAPES = {"a": {"W": (5, 7), "b": (7,)}, "c": {"W": (3,)},
          "d": {"W": (4, 3, 2)}}


def _grads(rng, lanes, scale=2e-3):
    return {k: {kk: rng.normal(scale=scale, size=(lanes,) + s)
                .astype(np.float32) for kk, s in d.items()}
            for k, d in SHAPES.items()}


def _torch(tree):
    return {k: {kk: torch.from_numpy(np.array(v)) for kk, v in d.items()}
            for k, d in tree.items()}


def _equal(j, t, what):
    for k in j:
        for kk in j[k]:
            a, b = np.asarray(j[k][kk]), t[k][kk].numpy()
            assert a.shape == b.shape and (a == b).all(), (what, k, kk)


@pytest.mark.parametrize("hosts", [1, 2])
@pytest.mark.parametrize("scheme", ["threshold", "bitmap", "onebit"])
def test_encode_combine_bit_equal(scheme, hosts):
    rng = np.random.default_rng(
        10 * ["threshold", "bitmap", "onebit"].index(scheme) + hosts)
    jc = JC.GradCompressor(scheme=scheme, hosts=hosts)
    tc = TC.GradCompressor(scheme=scheme, hosts=hosts)
    tmpl = {k: {kk: np.zeros(s, np.float32) for kk, s in d.items()}
            for k, d in SHAPES.items()}
    js = jc.init_state(tmpl, 4)
    ts = tc.init_state(_torch(tmpl), 4)
    j_step = jax.jit(jc.encode_combine)
    moved = False
    for it in range(10):
        g = _grads(rng, 4, scale=2e-3 * (1 + it % 3))
        inv = np.float32(1.0 / 29.0)
        jo, js, jst = j_step(jax.tree_util.tree_map(jnp.asarray, g), js,
                             jnp.asarray(inv))
        to, ts, tst = tc.encode_combine(_torch(g), ts, torch.tensor(inv))
        _equal(jo, to, f"combined {it}")
        _equal(js["residual"], ts["residual"], f"residual {it}")
        assert float(js["threshold"]) == float(ts["threshold"]), it
        assert set(jst) == set(tst)
        for k in jst:
            assert float(jst[k]) == float(tst[k]), (it, k)
        moved |= float(ts["threshold"]) != 1e-3
    assert moved or scheme == "onebit"  # the adaptive threshold moved


@pytest.mark.parametrize("post", [True, False])
@pytest.mark.parametrize("algo", ["Adaptive", "Fixed", "TargetSparsity"])
def test_accumulator_bit_equal(algo, post):
    rng = np.random.default_rng(7)
    kw = {} if post else {"residual_post_processor": None}
    ja = JA.EncodedGradientsAccumulator(
        threshold_algorithm=getattr(JA, f"{algo}ThresholdAlgorithm")(), **kw)
    ta = TA.EncodedGradientsAccumulator(
        threshold_algorithm=getattr(TA, f"{algo}ThresholdAlgorithm")(), **kw)
    tmpl = {k: {kk: np.zeros(s, np.float32) for kk, s in d.items()}
            for k, d in SHAPES.items()}
    jr = jax.tree_util.tree_map(jnp.asarray, tmpl)
    tr = ta.init_residual(_torch(tmpl))
    jt = ja.threshold_algorithm.init_state()
    tt = ta.threshold_algorithm.init_state()
    j_enc = jax.jit(ja.encode)
    clipped = False
    for it in range(10):
        g = {k: {kk: v[0] for kk, v in d.items()}
             for k, d in _grads(rng, 1, scale=4e-3).items()}
        jq, jr2, jt2, jrat = j_enc(jax.tree_util.tree_map(jnp.asarray, g),
                                   jr, jt, jnp.asarray(it))
        tq, tr2, tt2, trat = ta.encode(_torch(g), tr, tt, it)
        _equal(jq, tq, f"quantized {it}")
        _equal(jr2, tr2, f"residual {it}")
        assert float(jt2) == float(tt2) and float(jrat) == float(trat), it
        if post and it % 5 == 0:
            raw = {k: {kk: (g[k][kk] + np.asarray(jr[k][kk]))
                       - np.asarray(jq[k][kk]) for kk in g[k]} for k in g}
            clipped |= any(not np.array_equal(raw[k][kk],
                                              np.asarray(jr2[k][kk]))
                           for k in g for kk in g[k])
        jr, jt, tr, tt = jr2, jt2, tr2, tt2
    assert clipped or not post  # the post-processor acted at least once


def test_threshold_algorithms_bounds():
    algo = TA.TargetSparsityThresholdAlgorithm(initial=1e-3,
                                               target_ratio=1e-2, gain=1.5)
    t = algo.init_state()
    assert float(algo.update(t, torch.tensor(0.5))) == pytest.approx(1.5e-3)
    assert float(algo.update(t, torch.tensor(1e-4))) == pytest.approx(
        1e-3 / 1.5)
    for _ in range(200):
        t = algo.update(t, torch.tensor(1.0))
    assert float(t) == algo.max_threshold


@pytest.mark.parametrize("scale", [1e-4, 1e-2, 1.0])
def test_power_of_two_encode_conserves_bitwise(scale):
    rng = np.random.default_rng(3)
    comp = TC.GradCompressor(scheme="threshold", initial_threshold=1e-3)
    g = {"a": {"W": torch.from_numpy(rng.normal(scale=scale, size=(4, 300))
                                     .astype(np.float32))}}
    state = comp.init_state({"a": {"W": torch.zeros(300)}}, 4)
    state["residual"]["a"]["W"].copy_(torch.from_numpy(
        rng.normal(scale=1e-3, size=(4, 300)).astype(np.float32)))
    carried = g["a"]["W"] + state["residual"]["a"]["W"]
    q, r = comp._encode_leaf(carried, state["threshold"])
    assert torch.equal(q + r, carried)
    assert bool((q != 0).any())


def test_sparse_wire_bytes_and_identity_mode():
    tc = TC.GradCompressor(scheme="threshold", initial_threshold=0.0)
    tmpl = {"a": {"W": torch.zeros(10)}}
    st = tc.init_state(tmpl, 2)
    g = {"a": {"W": torch.arange(20, dtype=torch.float32).reshape(2, 10)}}
    out, st2, stats = tc.encode_combine(g, st, torch.tensor(0.5))
    assert torch.equal(out["a"]["W"], (g["a"]["W"][0] + g["a"]["W"][1])
                       * 0.5)
    assert float(stats["ratio"]) == 1.0  # identity mode ships dense fp32
    assert not st2["residual"]["a"]["W"].any()
    assert float(st2["threshold"]) == 0.0


def test_scheme_validation_and_hosts():
    assert TC.validate_scheme(None) is None
    assert TC.validate_scheme("bitmap") == "bitmap"
    with pytest.raises(ValueError, match="grad_compression"):
        TC.validate_scheme("zstd")
    with pytest.raises(ValueError, match="divide"):
        TC.GradCompressor(scheme="threshold", hosts=3).exchange_axis(8)
    with pytest.raises(ValueError, match="active scheme"):
        TC.GradCompressor(scheme="none")


# ------------------------------------------------------------------ knobs


def _mln_conf(**kw):
    b = TNNC.builder().seed(3)
    if kw:
        b.grad_compression(**kw)
    return (b.list().layer(TL.DenseLayer(n_in=4, n_out=3))
            .layer(TL.OutputLayer(n_in=3, n_out=2))
            .set_input_type((4,)).build())


def test_conf_json_round_trip_between_packages():
    from deeplearning4j_tpu.nn.computation_graph import \
        ComputationGraphConfiguration as JCGConf
    from deeplearning4j_tpu.nn.conf import MultiLayerConfiguration as JMConf

    conf = _mln_conf(scheme="bitmap", threshold=5e-3, target_sparsity=1e-2)
    assert conf.knobs["grad_compression"] == "bitmap"
    ref = JMConf.from_json(conf.to_json())
    assert (ref.grad_compression, ref.grad_compression_threshold,
            ref.grad_compression_target) == ("bitmap", 5e-3, 1e-2)
    back = TMConf.from_json(ref.to_json())
    assert back.knobs["grad_compression"] == "bitmap"
    assert back.knobs["grad_compression_threshold"] == 5e-3
    assert back.knobs["grad_compression_target"] == 1e-2
    g = (TNNC.builder().seed(3).grad_compression("onebit").graph_builder()
         .add_inputs("in")
         .add_layer("out", TL.OutputLayer(n_in=4, n_out=2), "in")
         .set_outputs("out").set_input_types((4,)).build())
    jg = JCGConf.from_json(g.to_json())
    assert jg.grad_compression == "onebit"
    assert TCGConf.from_json(jg.to_json()).knobs["grad_compression"] == \
        "onebit"
    with pytest.raises(ValueError, match="grad_compression"):
        TNNC.builder().grad_compression("zstd")


def test_env_default_flows_into_builder():
    from deeplearning4j_tpu_torch.config import get_environment

    env = get_environment()
    old = env.default_grad_compression
    try:
        env.default_grad_compression = "bitmap"
        assert _mln_conf().knobs["grad_compression"] == "bitmap"
        env.default_grad_compression = "zstd"
        with pytest.raises(ValueError, match="DL4J_TPU_GRAD_COMPRESSION"):
            _mln_conf()
    finally:
        env.default_grad_compression = old
    assert _mln_conf().knobs["grad_compression"] == "none"


def test_env_variable_is_read(monkeypatch):
    from deeplearning4j_tpu_torch.config import Environment

    monkeypatch.setenv("DL4J_TPU_GRAD_COMPRESSION", "onebit")
    assert Environment().default_grad_compression == "onebit"


def test_sidecar_npz_round_trip(tmp_path):
    from deeplearning4j_tpu_torch.util.checkpoint import (load_tree_npz,
                                                          save_tree_npz)

    tree = {"residual": {0: {"W": np.arange(6, dtype=np.float32)
                             .reshape(2, 3)}, 2: {}},
            "threshold": np.float32(0.25), "none_slot": None}
    path = str(tmp_path / "comp.npz")
    save_tree_npz(path, tree)
    back = load_tree_npz(path)
    assert back["none_slot"] is None
    np.testing.assert_array_equal(back["residual"][0]["W"],
                                  tree["residual"][0]["W"])
    assert float(back["threshold"]) == 0.25 and back["residual"][2] == {}


def test_compression_hosts_space_matches_reference():
    from deeplearning4j_tpu.tuning import space as jspace
    from deeplearning4j_tpu_torch.tuning import space as tspace

    t = tspace.get_space("compression_hosts")
    j = jspace.CompressionHostsSpace()
    assert (t.name, t.op, t.scope, t.measurable) == (j.name, j.op, j.scope,
                                                     j.measurable)
    assert t.signature({}) == j.signature({}) == "conf-default"
    tc, jc = t.enumerate({}), j.enumerate({})
    assert [(c.label, c.impl, c.params, c.is_default) for c in tc] == \
        [(c.label, c.impl, c.params, c.is_default) for c in jc]
    assert "compression_hosts" not in tspace.measurable_spaces()
    assert json.dumps([c.params for c in tc])
