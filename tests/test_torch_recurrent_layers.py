"""The port's recurrent layers, wrappers, heads and vertices against the JAX
package's, called directly (the reference's own tests/test_recurrent.py
fails at collection), on the CPU.

Each case builds the layer in both packages from the same fields, draws
the reference's params from a ``jax.random`` key and copies them into the
port as numpy, and feeds both the same seeded input and (B, T) ragged mask
(row 0 full, the others 1 to T steps). Tolerances:

- forward, fp32: 2e-5 absolute on outputs of order 1 (the same fp32
  arithmetic summed in other orders over a few steps);
- gradients of a fixed random projection of the output with respect to
  every param and the input: 2e-4 of the largest gradient of the tensor
  (the backward sums the forward's rounding over the time chain);
- bf16 (one case per layer kind): four bf16 steps of the largest output
  (2^-6): both round every op's result to bf16, XLA after its fusions and
  torch after each op, so a value can land some ulps apart after a few
  recurrent steps.

Also: the conf JSON both ways with a nested Bidirectional; params of a
nested wrapper through ``interop`` and the nested l1/l2 penalty, with the
reference's fault that Bidirectional reads only its own rates; the
reference's fault that GravesBidirectionalLSTM never applies its dropout;
a GRU's one-tensor carry through ``rnn_time_step``; Bidirectional refused
by ``rnn_time_step`` in both networks; the param-tree helper.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.nn import layers as JL  # noqa: E402
from deeplearning4j_tpu.nn import recurrent as JR  # noqa: E402
from deeplearning4j_tpu.nn import vertices as JV  # noqa: E402
from deeplearning4j_tpu.nn.computation_graph import (  # noqa: E402
    ComputationGraph as JGraph)
from deeplearning4j_tpu.nn.computation_graph import (  # noqa: E402
    ComputationGraphConfiguration as JGConf)
from deeplearning4j_tpu.nn.conf import (  # noqa: E402
    MultiLayerConfiguration as JConf)
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC  # noqa: E402
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JMLN)
from deeplearning4j_tpu_torch import interop  # noqa: E402
from deeplearning4j_tpu_torch import tree as ttree  # noqa: E402
from deeplearning4j_tpu_torch.nn import ComputationGraph  # noqa: E402
from deeplearning4j_tpu_torch.nn import MultiLayerNetwork  # noqa: E402
from deeplearning4j_tpu_torch.nn import NeuralNetConfiguration  # noqa: E402
from deeplearning4j_tpu_torch.nn import layers as TL  # noqa: E402
from deeplearning4j_tpu_torch.nn import recurrent as TR  # noqa: E402
from deeplearning4j_tpu_torch.nn import vertices as TV  # noqa: E402
from deeplearning4j_tpu_torch.nn.computation_graph import (  # noqa: E402
    ComputationGraphConfiguration as TGConf)
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration as TConf)

B, T, F, H = 3, 5, 4, 6
FWD_ATOL, GRAD_RTOL, BF16_TOL = 2e-5, 2e-4, 2.0 ** -6


def _mask(b=B, t=T, seed=7):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, t + 1, size=b)
    lens[0] = t
    return (np.arange(t)[None] < lens[:, None]).astype(np.float32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree, dtype=torch.float32):
    return ttree.tree_map(lambda a: torch.tensor(np.asarray(a), dtype=dtype),
                          tree)


def _rec(mod, kind, **kw):
    """A layer of ``mod`` (JR/JL or TR/TL) by the case's kind."""
    if kind.startswith("bidir"):
        inner = kw.pop("inner")
        return mod.Bidirectional(layer=_rec(mod, inner, n_in=F, n_out=H),
                                 **kw)
    cls = getattr(mod, kind, None) or getattr(
        JL if mod is JR else TL, kind)
    return cls(**kw)


# (id, kind, fields, input shape)
_SEQ = (B, T, F)
_CASES = [
    ("graves", "GravesLSTM", {"n_in": F, "n_out": H}, _SEQ),
    ("gru", "GRU", {"n_in": F, "n_out": H}, _SEQ),
    ("gru-b_rec", "GRU", {"n_in": F, "n_out": H, "recurrent_bias": True},
     _SEQ),
    ("simple-rnn", "SimpleRnn", {"n_in": F, "n_out": H}, _SEQ),
    ("lstm", "LSTM", {"n_in": F, "n_out": H}, _SEQ),
    ("bidir-concat", "bidir", {"inner": "LSTM", "mode": "concat"}, _SEQ),
    ("bidir-add", "bidir", {"inner": "LSTM", "mode": "add"}, _SEQ),
    ("bidir-mul", "bidir", {"inner": "LSTM", "mode": "mul"}, _SEQ),
    ("bidir-ave", "bidir", {"inner": "LSTM", "mode": "ave"}, _SEQ),
    ("bidir-gru", "bidir", {"inner": "GRU", "mode": "concat"}, _SEQ),
    ("graves-bidir", "GravesBidirectionalLSTM", {"n_in": F, "n_out": H},
     _SEQ),
    ("last-time-step", "LastTimeStep", {}, _SEQ),
    ("pool-avg", "GlobalPoolingLayer", {"pooling_type": "avg"}, _SEQ),
    ("pool-sum", "GlobalPoolingLayer", {"pooling_type": "sum"}, _SEQ),
    ("pool-pnorm", "GlobalPoolingLayer", {"pooling_type": "pnorm",
                                          "pnorm": 3}, _SEQ),
    ("pool-max", "GlobalPoolingLayer", {"pooling_type": "max"}, _SEQ),
    ("rnn-loss-act", "RnnLossLayer", {"activation": "tanh"}, _SEQ),
    ("convlstm-seq", "ConvLSTM2D", {"n_in": 2, "n_out": 3},
     (2, 3, 6, 5, 2)),
    ("convlstm-last", "ConvLSTM2D", {"n_in": 2, "n_out": 3,
                                     "return_sequences": False},
     (2, 3, 6, 5, 2)),
    ("convlstm-valid-stride", "ConvLSTM2D",
     {"n_in": 2, "n_out": 3, "padding": "VALID", "stride": (2, 1)},
     (2, 3, 7, 5, 2)),
]


def _pair(kind, fields, shape, seed=3):
    jl = _rec(JR, kind, **dict(fields))
    tl = _rec(TR, kind, **dict(fields))
    params, _ = jl.initialize(jax.random.PRNGKey(seed), shape[1:])
    params = _np(params)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    return jl, tl, params, x


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
@pytest.mark.parametrize("case", _CASES, ids=[c[0] for c in _CASES])
def test_layer_forward_and_gradients_match_reference(case, masked):
    _, kind, fields, shape = case
    jl, tl, params, x = _pair(kind, fields, shape)
    m = _mask(shape[0], shape[1]) if masked else None
    jm = None if m is None else jnp.asarray(m)
    y_ref = jax.jit(lambda p, xx: jl.apply(p, {}, xx, mask=jm)[0])(
        params, jnp.asarray(x))
    tp = _t(params)
    y, _ = tl.apply(tp, {}, torch.tensor(x),
                    mask=None if m is None else torch.tensor(m))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=FWD_ATOL,
                               rtol=0)

    r = np.random.default_rng(11).normal(size=y.shape).astype(np.float32)

    def jloss(p, xx):
        out, _ = jl.apply(p, {}, xx, mask=jm)
        return jnp.sum(out * r)

    g_ref = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params, jnp.asarray(x))
    tp = ttree.tree_map(lambda v: v.requires_grad_(True), tp)
    tx = torch.tensor(x, requires_grad=True)
    y, _ = tl.apply(tp, {}, tx, mask=None if m is None else torch.tensor(m))
    leaves = ttree.tree_leaves(tp) + [tx]
    gs = torch.autograd.grad((y * torch.tensor(r)).sum(), leaves,
                             allow_unused=True)
    refs = [np.asarray(ttree.tree_get(g_ref[0], p))
            for p, _ in ttree.tree_items(tp)] + [np.asarray(g_ref[1])]
    for g, ref in zip(gs, refs):
        got = np.zeros_like(ref) if g is None else g.numpy()
        scale = max(float(np.abs(ref).max()), 1e-6)
        assert float(np.abs(got - ref).max()) <= GRAD_RTOL * scale


_BF16 = [c for c in _CASES if c[0] in ("graves", "gru-b_rec", "simple-rnn",
                                       "bidir-concat", "pool-max",
                                       "convlstm-seq")]


@pytest.mark.parametrize("case", _BF16, ids=[c[0] for c in _BF16])
def test_layer_bf16_forward_matches_reference(case):
    """The nets' bf16 compute: input and params cast to bf16, a mask."""
    _, kind, fields, shape = case
    jl, tl, params, x = _pair(kind, fields, shape)
    m = _mask(shape[0], shape[1])
    y_ref, _ = jl.apply(
        jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                               params), {},
        jnp.asarray(x, jnp.bfloat16), mask=jnp.asarray(m))
    y, _ = tl.apply(_t(params, torch.bfloat16), {},
                    torch.tensor(x).to(torch.bfloat16),
                    mask=torch.tensor(m))
    assert y.dtype == torch.bfloat16
    ref = np.asarray(y_ref, np.float32)
    err = float(np.abs(y.float().numpy() - ref).max())
    assert err <= BF16_TOL * max(float(np.abs(ref).max()), 1.0)


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
def test_rnn_loss_layer_matches_reference(masked):
    """RnnLossLayer's mcxent on softmax logits (the fused path) under the
    label mask and row weights together, and, without a mask, mse on
    identity (the reference's mse takes (B,) weights only)."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, T, F)).astype(np.float32)
    y = np.eye(F, dtype=np.float32)[rng.integers(0, F, size=(B, T))]
    w = np.array([1.0, 0.5, 0.0], np.float32)
    m = _mask() if masked else None
    pairs = [("mcxent", "softmax")] + ([] if masked else [("mse",
                                                           "identity")])
    for loss, a in pairs:
        jl = JR.RnnLossLayer(loss=loss, activation=a)
        tl = TR.RnnLossLayer(loss=loss, activation=a)
        ref = jl.compute_loss({}, {}, jnp.asarray(x), jnp.asarray(y),
                              weights=jnp.asarray(w),
                              mask=None if m is None else jnp.asarray(m))
        got = tl.compute_loss({}, {}, torch.tensor(x), torch.tensor(y),
                              weights=torch.tensor(w),
                              mask=None if m is None else torch.tensor(m))
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


def test_vertices_match_reference():
    rng = np.random.default_rng(9)
    seq = rng.normal(size=(B, T, F)).astype(np.float32)
    vec = rng.normal(size=(B, H)).astype(np.float32)
    np.testing.assert_array_equal(
        TV.LastTimeStepVertex().apply(torch.tensor(seq)).numpy(),
        np.asarray(JV.LastTimeStepVertex().apply(jnp.asarray(seq))))
    dup = TV.DuplicateToTimeSeriesVertex().apply(torch.tensor(vec),
                                                torch.tensor(seq))
    np.testing.assert_array_equal(
        dup.numpy(), np.asarray(JV.DuplicateToTimeSeriesVertex().apply(
            jnp.asarray(vec), jnp.asarray(seq))))
    assert TV.LastTimeStepVertex().output_shape((T, F)) == (F,)
    assert TV.DuplicateToTimeSeriesVertex().output_shape((H,), (T, F)) == (
        T, H)


def test_output_shapes_match_reference():
    for _, kind, fields, shape in _CASES:
        jl, tl = _rec(JR, kind, **dict(fields)), _rec(TR, kind, **dict(fields))
        assert tuple(tl.output_shape(shape[1:])) == tuple(
            jl.output_shape(shape[1:])), kind


# --------------------------------------------------------------- conf JSON


def _jconf():
    return (JNNC.builder().seed(7).list()
            .layer(JR.Bidirectional(layer=JR.LSTM(n_in=F, n_out=H),
                                    mode="add", l2=1e-3))
            .layer(JR.GravesLSTM(n_in=H, n_out=H, dropout=0.1))
            .layer(JR.GRU(n_in=H, n_out=H, recurrent_bias=True))
            .layer(JR.SimpleRnn(n_in=H, n_out=H))
            .layer(JR.GravesBidirectionalLSTM(n_in=H, n_out=H))
            .layer(JR.RnnOutputLayer(n_in=2 * H, n_out=3))
            .set_input_type((T, F)).build())


def test_conf_json_both_ways_with_nested_wrapper():
    jconf = _jconf()
    tconf = TConf.from_json(jconf.to_json())
    assert isinstance(tconf.layers[0].layer, TR.LSTM)
    assert json.loads(tconf.to_json()) == json.loads(jconf.to_json())
    back = JConf.from_json(tconf.to_json())
    assert json.loads(back.to_json()) == json.loads(jconf.to_json())
    # a graph conf: ConvLSTM2D, pooling over time, the vertices, TBPTT
    gb = (JNNC.builder().seed(3).graph_builder().add_inputs("seq", "img")
          .add_layer("bi", JR.Bidirectional(layer=JR.GRU(n_in=F, n_out=H)),
                     "seq")
          .add_vertex("last", JV.LastTimeStepVertex(), "bi")
          .add_vertex("dup", JV.DuplicateToTimeSeriesVertex(), "last", "seq")
          .add_layer("pool", JL.GlobalPoolingLayer(pooling_type="max"),
                     "dup")
          .add_layer("conv", JR.ConvLSTM2D(n_in=1, n_out=2,
                                           return_sequences=False), "img")
          .add_layer("out", JL.OutputLayer(n_in=2 * H, n_out=2), "pool")
          .add_layer("lts", JR.LastTimeStep(), "bi")
          .add_layer("out2", JL.OutputLayer(n_in=2 * H, n_out=2), "lts")
          .add_layer("out3", JR.RnnLossLayer(loss="mse",
                                             activation="identity"), "bi")
          .set_outputs("out", "out2", "out3")
          .set_input_types((T, F), (T, 4, 4, 1))
          .tbptt_length(4))
    jg = gb.build()
    tg = TGConf.from_json(jg.to_json())
    assert tg.tbptt_length == 4
    assert json.loads(tg.to_json()) == json.loads(jg.to_json())
    assert json.loads(JGConf.from_json(tg.to_json()).to_json()) == \
        json.loads(jg.to_json())
    mine = (NeuralNetConfiguration.builder().seed(3).graph_builder()
            .add_inputs("seq").add_layer("r", TR.GRU(n_in=F, n_out=H), "seq")
            .add_layer("out", TR.RnnOutputLayer(n_in=H, n_out=2), "r")
            .set_outputs("out").set_input_types((T, F)).tbptt_length(5)
            .build())
    assert JGConf.from_json(mine.to_json()).tbptt_length == 5


# ---------------------------------------------- interop and the penalties


def test_nested_params_through_interop_and_the_penalty():
    """A nested Bidirectional's and a GravesLSTM's params copy across and
    back leaf for leaf; ``score`` (which adds the l1/l2 penalty on the MLN)
    agrees; the wrapper's l2 reaches both directions' W and U."""
    jnet = JMLN(_jconf()).init()
    net = MultiLayerNetwork(TConf.from_json(jnet.conf.to_json())).init(
        device="cpu")
    interop.load_reference_mln(net, _np(jnet.params), _np(jnet.states))
    assert set(net.params[0]) == {"fwd", "bwd"}
    assert set(net.params[1]) == {"W", "U", "peep", "b"}
    back = interop.to_numpy(net)["params"]
    for mine, ref in zip(back, _np(jnet.params)):
        for (path, a) in ttree.tree_items(mine):
            np.testing.assert_array_equal(a, ttree.tree_get(ref, path))
    reg = float(net.layers[0].regularization(net.params[0]))
    want = sum(0.5 * 1e-3 * float((p ** 2).sum())
               for d in ("fwd", "bwd") for k, p in net.params[0][d].items()
               if k in ("W", "U"))
    np.testing.assert_allclose(reg, want, rtol=1e-6)
    np.testing.assert_allclose(
        reg, float(jnet.layers[0].regularization(jnet.params[0])), rtol=1e-6)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, T, F)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, size=(B, T))]
    from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
    from deeplearning4j_tpu_torch.data import DataSet
    np.testing.assert_allclose(net.score(DataSet(x, y)),
                               jnet.score(JDataSet(x, y)), rtol=1e-5)


def test_bidirectional_reads_only_its_own_rates_in_both_packages():
    """Reference fault (ROADMAP.md Queue 3): the wrapped layer's l1/l2 are
    not read. Pinned in both packages: l2 on the inner LSTM gives 0.0, on
    the wrapper the penalty of both directions."""
    params, _ = JR.Bidirectional(layer=JR.LSTM(n_in=F, n_out=H)).initialize(
        jax.random.PRNGKey(1), (T, F))
    tp = _t(_np(params))
    for mod, p in ((JR, params), (TR, tp)):
        inner_l2 = mod.Bidirectional(layer=mod.LSTM(n_in=F, n_out=H, l2=1e-3))
        assert float(inner_l2.regularization(p)) == 0.0
        outer = mod.Bidirectional(layer=mod.LSTM(n_in=F, n_out=H), l2=1e-3)
        assert float(outer.regularization(p)) > 0.0
    np.testing.assert_allclose(
        float(TR.Bidirectional(layer=TR.LSTM(n_in=F, n_out=H), l1=1e-2,
                               l2=1e-3).regularization(tp)),
        float(JR.Bidirectional(layer=JR.LSTM(n_in=F, n_out=H), l1=1e-2,
                               l2=1e-3).regularization(params)), rtol=1e-6)


def test_graves_bidirectional_never_applies_its_dropout_in_both_packages():
    """Reference fault (ROADMAP.md Queue 3): GravesBidirectionalLSTM hands
    its rate to the inner GravesLSTM, whose apply_seq never drops, so at
    dropout 0.9 training equals inference; a plain Bidirectional drops."""
    _, _, params, x = _pair("GravesBidirectionalLSTM",
                            {"n_in": F, "n_out": H}, _SEQ)
    gen = torch.Generator().manual_seed(0)
    tp = _t(params)
    g = TR.GravesBidirectionalLSTM(n_in=F, n_out=H, dropout=0.9)
    jg = JR.GravesBidirectionalLSTM(n_in=F, n_out=H, dropout=0.9)
    train, _ = g.apply(tp, {}, torch.tensor(x), training=True, gen=gen)
    infer, _ = g.apply(tp, {}, torch.tensor(x))
    np.testing.assert_array_equal(train.numpy(), infer.numpy())
    jtrain, _ = jg.apply(params, {}, jnp.asarray(x), training=True,
                         key=jax.random.PRNGKey(0))
    jinfer, _ = jg.apply(params, {}, jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(jtrain), np.asarray(jinfer))
    bi = TR.Bidirectional(layer=TR.GravesLSTM(n_in=F, n_out=H), dropout=0.9)
    dropped, _ = bi.apply(tp, {}, torch.tensor(x), training=True, gen=gen)
    assert not np.allclose(dropped.numpy(), infer.numpy())
    jbi = JR.Bidirectional(layer=JR.GravesLSTM(n_in=F, n_out=H), dropout=0.9)
    jdropped, _ = jbi.apply(params, {}, jnp.asarray(x), training=True,
                            key=jax.random.PRNGKey(0))
    assert not np.allclose(np.asarray(jdropped), np.asarray(jinfer))


# ------------------------------------------------------ stateful inference


def _gru_conf(mod, nnc):
    return (nnc.builder().seed(4).list()
            .layer(mod.GRU(n_in=F, n_out=H, recurrent_bias=True))
            .layer(mod.SimpleRnn(n_in=H, n_out=H))
            .layer(mod.RnnOutputLayer(n_in=H, n_out=3))
            .set_input_type((T, F)).build())


def test_gru_single_tensor_carry_through_rnn_time_step():
    jnet = JMLN(_gru_conf(JR, JNNC)).init()
    net = MultiLayerNetwork(TConf.from_json(jnet.conf.to_json())).init(
        device="cpu")
    interop.load_reference_mln(net, _np(jnet.params), _np(jnet.states))
    x = np.random.default_rng(6).normal(size=(2, 7, F)).astype(np.float32)
    whole = net.output(x).numpy()
    steps = [net.rnn_time_step(x[:, :3]).numpy()]
    assert isinstance(net._rnn_carries[0], torch.Tensor)
    steps += [net.rnn_time_step(x[:, t])[:, None].numpy()
              for t in range(3, 7)]
    np.testing.assert_allclose(np.concatenate(steps, 1), whole, atol=2e-6)
    jsteps = [np.asarray(jnet.rnn_time_step(x[:, :3]))]
    jsteps += [np.asarray(jnet.rnn_time_step(x[:, t]))[:, None]
               for t in range(3, 7)]
    np.testing.assert_allclose(np.concatenate(steps, 1),
                               np.concatenate(jsteps, 1), atol=2e-6)
    with pytest.raises(ValueError, match="batch size"):
        net.rnn_time_step(x[:1, 0])
    net.rnn_clear_previous_state()
    np.testing.assert_allclose(net.rnn_time_step(x[:1, 0]).numpy(),
                               whole[:1, 0], atol=2e-6)


def test_rnn_time_step_refuses_bidirectional_in_both_networks():
    jnet = JMLN(_jconf()).init()
    net = MultiLayerNetwork(TConf.from_json(jnet.conf.to_json())).init(
        device="cpu")
    x = np.zeros((2, 3, F), np.float32)
    for n in (jnet, net):
        with pytest.raises(ValueError, match="Bidirectional"):
            n.rnn_time_step(x)
    gconf = (NeuralNetConfiguration.builder().graph_builder()
             .add_inputs("in")
             .add_layer("bi", TR.Bidirectional(layer=TR.LSTM(n_in=F,
                                                            n_out=H)), "in")
             .add_layer("out", TR.RnnOutputLayer(n_in=2 * H, n_out=2), "bi")
             .set_outputs("out").set_input_types((T, F)).build())
    graph = ComputationGraph(gconf).init(device="cpu")
    jgraph = JGraph(JGConf.from_json(gconf.to_json())).init()
    for g in (jgraph, graph):
        with pytest.raises(ValueError, match="Bidirectional"):
            g.rnn_time_step(x)


# ------------------------------------------------------------- tree helper


def test_tree_helper_walks_nested_dicts_and_carries():
    tree = {"fwd": {"W": 1, "b": 2}, "bwd": {"W": 3, "b": 4}, "x": (5, 6)}
    assert ttree.tree_leaves(tree) == [1, 2, 3, 4, 5, 6]
    assert ttree.tree_items(tree)[2] == (("bwd", "W"), 3)
    assert ttree.tree_map(lambda a, b: a + b, tree, tree)["x"] == (10, 12)
    assert ttree.tree_map(lambda a: -a, 7) == -7
    assert ttree.tree_map(lambda a: a, None) is None
    assert ttree.tree_leaves(()) == []
    out = {}
    ttree.tree_set(out, ("fwd", "W"), 1)
    assert out == {"fwd": {"W": 1}}
    assert ttree.tree_get(tree, ("x", 1)) == 6
