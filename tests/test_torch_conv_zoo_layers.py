"""The conv zoo's layers and vertices against the JAX package's, on the CPU:
each of the eleven layer classes this slice ports, SubsamplingLayer's pnorm
pooling and the eleven vertices, called directly on the same seeded input
and the same params (the port's seeded draws, fed to both), and a
SharedLayer graph in both packages.

Tolerances (docs/KERNELS.md):

- forward, fp32: 2e-5 absolute on outputs of order 1 (the same fp32
  arithmetic in other orders); the shape-only layers and vertices (padding,
  cropping, upsampling, dropout at inference, merge, subset, stack,
  unstack, reshape, pool helper, preprocessor, scale, shift) exactly;
- gradients of a fixed random projection of the output with respect to
  every param and the input: 2e-4 of the largest gradient of the tensor;
- ``output_shape`` equal to the reference's, and the conf dict equal and
  read back by each package.

Also: LossLayer with huber takes the row weights by keyword (the
reference's LossLayer passes them where huber reads its delta, ROADMAP
Queue 3, so the port is held to the reference's ``huber_loss`` called by
keyword); SharedLayer's two call sites summing into one gradient; a
SharedLayer graph's output and a 3-step Adam trajectory against the
reference's (1e-4 relative); an unknown source refused.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.nn import layers as JL  # noqa: E402
from deeplearning4j_tpu.nn import vertices as JV  # noqa: E402
from deeplearning4j_tpu.nn.computation_graph import (  # noqa: E402
    ComputationGraph as JGraph)
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC  # noqa: E402
from deeplearning4j_tpu.ops import nn as jnn  # noqa: E402
from deeplearning4j_tpu_torch import interop  # noqa: E402
from deeplearning4j_tpu_torch import tree as ttree  # noqa: E402
from deeplearning4j_tpu_torch.nn import ComputationGraph  # noqa: E402
from deeplearning4j_tpu_torch.nn import layers as TL  # noqa: E402
from deeplearning4j_tpu_torch.nn import vertices as TV  # noqa: E402
from deeplearning4j_tpu_torch.nn.computation_graph import (  # noqa: E402
    ComputationGraphConfiguration as TGConf)

FWD_ATOL, GRAD_RTOL, TRAJ_RTOL = 2e-5, 2e-4, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread while this module runs: under the suite's six
    workers on eight cores, the OpenMP regions of the port's plain conv
    path oversubscribe the cores and an Xception step takes ~100x its time
    alone (80 s against 0.35 s); on one thread it takes 0.3-0.7 s either
    way."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_IMG = (2, 7, 6, 3)
# (id, class name, fields, input shape, exact): every layer of the slice
_CASES = [
    ("sep-same", "SeparableConvolution2D", {"n_out": 5}, _IMG, False),
    ("sep-valid-s2-mult2", "SeparableConvolution2D",
     {"n_out": 4, "stride": (2, 2), "padding": "VALID",
      "depth_multiplier": 2}, _IMG, False),
    ("sep-same-s2-nobias", "SeparableConvolution2D",
     {"n_out": 6, "stride": (2, 2), "has_bias": False,
      "activation": "relu"}, _IMG, False),
    ("deconv-2x2s2-same", "Deconvolution2D", {"n_out": 4}, _IMG, False),
    ("deconv-3x3s2-valid", "Deconvolution2D",
     {"n_out": 2, "kernel_size": (3, 3), "padding": "VALID"}, _IMG, False),
    ("deconv-3x3s1-same", "Deconvolution2D",
     {"n_out": 3, "kernel_size": (3, 3), "stride": (1, 1),
      "activation": "tanh"}, _IMG, False),
    ("embedding", "EmbeddingLayer", {"n_in": 10, "n_out": 4}, (3, 5),
     False),
    ("layernorm", "LayerNormalization", {}, (2, 5, 6), False),
    ("dropout", "DropoutLayer", {"rate": 0.5}, _IMG, True),
    ("zeropad", "ZeroPaddingLayer", {"padding": ((1, 2), (0, 3))}, _IMG,
     True),
    ("upsample-2", "Upsampling2D", {}, _IMG, True),
    ("upsample-3", "Upsampling2D", {"size": 3}, _IMG, True),
    ("lrn", "LocalResponseNormalization", {}, (2, 4, 3, 7), False),
    ("lrn-n3", "LocalResponseNormalization",
     {"n": 3, "k": 1.0, "alpha": 0.5, "beta": 0.5}, (2, 4, 3, 7), False),
    ("crop", "Cropping2D", {"cropping": ((1, 0), (2, 1))}, _IMG, True),
    ("pnorm-2", "SubsamplingLayer", {"pooling_type": "pnorm"}, _IMG, False),
    ("pnorm-3-same", "SubsamplingLayer",
     {"pooling_type": "pnorm", "pnorm": 3, "kernel_size": (3, 3),
      "stride": (2, 2), "padding": "SAME"}, _IMG, False),
    ("loss-tanh", "LossLayer", {"activation": "tanh"}, (3, 4), False),
]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(kind, fields, shape, seed=3):
    """The layer in both packages, the port's seeded params (numpy) and the
    input (integer ids for the embedding)."""
    jl, tl = getattr(JL, kind)(**fields), getattr(TL, kind)(**fields)
    params, state = tl.initialize(torch.Generator().manual_seed(seed),
                                  shape[1:])
    assert not state
    params = ttree.tree_map(lambda t: t.numpy(), params)
    rng = np.random.default_rng(seed)
    if kind == "EmbeddingLayer":
        x = rng.integers(0, fields["n_in"], size=shape).astype(np.float32)
    else:
        x = rng.normal(size=shape).astype(np.float32)
    return jl, tl, params, x


@pytest.mark.parametrize("case", _CASES, ids=[c[0] for c in _CASES])
def test_layer_forward_and_gradients_match_reference(case):
    _, kind, fields, shape, exact = case
    jl, tl, params, x = _pair(kind, fields, shape)
    y_ref = np.asarray(jl.apply(jax.tree_util.tree_map(jnp.asarray, params),
                                {}, jnp.asarray(x))[0])
    tp = ttree.tree_map(torch.tensor, params)
    y, _ = tl.apply(tp, {}, torch.tensor(x))
    if exact:
        np.testing.assert_array_equal(y.numpy(), y_ref)
    else:
        np.testing.assert_allclose(y.numpy(), y_ref, atol=FWD_ATOL, rtol=0)
    assert tuple(tl.output_shape(shape[1:])) == tuple(
        jl.output_shape(shape[1:])) == y.shape[1:]

    r = np.random.default_rng(11).normal(size=y.shape).astype(np.float32)
    wrt_x = kind != "EmbeddingLayer"

    def jloss(p, xx):
        return jnp.sum(jl.apply(p, {}, xx)[0] * r)

    g_ref = jax.grad(jloss, argnums=(0, 1) if wrt_x else 0)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    if not wrt_x:
        g_ref = (g_ref, None)
    tp = ttree.tree_map(lambda v: v.requires_grad_(True), tp)
    tx = torch.tensor(x, requires_grad=wrt_x)
    y, _ = tl.apply(tp, {}, tx)
    leaves = ttree.tree_leaves(tp) + ([tx] if wrt_x else [])
    gs = torch.autograd.grad((y * torch.tensor(r)).sum(), leaves)
    refs = [np.asarray(ttree.tree_get(g_ref[0], p))
            for p, _ in ttree.tree_items(tp)]
    refs += [np.asarray(g_ref[1])] if wrt_x else []
    assert len(gs) == len(refs) >= 1
    for g, ref in zip(gs, refs):
        scale = max(float(np.abs(ref).max()), 1e-6)
        assert float(np.abs(g.numpy() - ref).max()) <= GRAD_RTOL * scale


@pytest.mark.parametrize("case", _CASES, ids=[c[0] for c in _CASES])
def test_layer_conf_dicts_match_reference(case):
    _, kind, fields, _, _ = case
    jd = json.loads(json.dumps(getattr(JL, kind)(**fields).to_dict()))
    td = json.loads(json.dumps(getattr(TL, kind)(**fields).to_dict()))
    assert td == jd
    back = TL.layer_from_dict(_detuple(jd))
    assert back == getattr(TL, kind)(**fields)
    assert JL.layer_from_dict(_detuple(td)) == getattr(JL, kind)(**fields)


def _detuple(v):
    """JSON lists back to tuples, as the confs' readers do."""
    if isinstance(v, dict):
        return {k: _detuple(x) for k, x in v.items()}
    if isinstance(v, list):
        return tuple(_detuple(x) for x in v)
    return v


def test_dropout_layer_draws_in_training_only():
    x = torch.ones((4, 50))
    lyr = TL.DropoutLayer(rate=0.5)
    gen = torch.Generator().manual_seed(1)
    assert torch.equal(lyr.apply({}, {}, x)[0], x)
    assert torch.equal(lyr.apply({}, {}, x, training=True)[0], x)
    y, _ = lyr.apply({}, {}, x, training=True, gen=gen)
    assert set(torch.unique(y).tolist()) == {0.0, 2.0}


@pytest.mark.parametrize("loss,activation", [
    ("mse", "identity"), ("huber", "identity"), ("l1", "tanh"),
    ("mcxent", "softmax"), ("xent", "sigmoid")])
def test_loss_layer_matches_reference_with_weights_by_keyword(loss,
                                                              activation):
    """The loss of the layer's input, with 0/1 row weights: the port against
    the reference's loss functions called with ``weights=`` (huber's third
    argument is its delta)."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, 3)).astype(np.float32)
    y = (np.eye(3, dtype=np.float32)[rng.integers(0, 3, 4)]
         if loss in ("mcxent", "xent") else
         rng.normal(size=(4, 3)).astype(np.float32) * 2)
    w = np.array([1.0, 1.0, 0.0, 1.0], np.float32)
    got = TL.LossLayer(loss=loss, activation=activation).compute_loss(
        {}, {}, torch.tensor(x), torch.tensor(y), weights=torch.tensor(w))
    jx, jy, jw = jnp.asarray(x), jnp.asarray(y), jnp.asarray(w)
    want = {
        "mse": lambda: jnn.mse_loss(jx, jy, weights=jw),
        "huber": lambda: jnn.huber_loss(jx, jy, weights=jw),
        "l1": lambda: jnn.mae_loss(jnp.tanh(jx), jy, weights=jw),
        "mcxent": lambda: jnn.softmax_cross_entropy(jx, jy, weights=jw),
        "xent": lambda: jnn.sigmoid_cross_entropy(jx, jy, weights=jw),
    }[loss]()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    if loss != "huber":  # where the positional weights are the weights
        ref = JL.LossLayer(loss=loss, activation=activation).compute_loss(
            {}, {}, jx, jy, weights=jw)
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_shared_layer_shape_and_standalone_apply():
    inner = TL.DenseLayer(n_in=4, n_out=3)
    s = TL.SharedLayer(source="d", layer=inner)
    assert s.output_shape((4,)) == (3,)
    assert s.initialize(torch.Generator(), (4,)) == ({}, {})
    with pytest.raises(RuntimeError, match="resolved by ComputationGraph"):
        s.apply({}, {}, torch.ones((2, 4)))


# ------------------------------------------------------------- vertices


_V_CASES = [
    # (id, class, fields, input shapes (batched), exact)
    ("merge", "MergeVertex", {}, [(2, 3, 4, 2), (2, 3, 4, 5)], True),
    ("merge-axis1", "MergeVertex", {"axis": 1},
     [(2, 3, 4), (2, 1, 4), (2, 2, 4)], True),
    ("subset", "SubsetVertex", {"from_idx": 1, "to_idx": 3},
     [(2, 3, 6)], True),
    ("subset-axis1", "SubsetVertex", {"from_idx": 0, "to_idx": 1,
                                      "axis": 1}, [(2, 5, 4)], True),
    ("scale", "ScaleVertex", {"scale": 0.17}, [(2, 3, 4)], True),
    ("shift", "ShiftVertex", {"shift": -1.5}, [(2, 3, 4)], True),
    ("l2norm", "L2NormalizeVertex", {}, [(2, 3, 4)], False),
    ("stack", "StackVertex", {}, [(2, 5), (3, 5), (1, 5)], True),
    ("unstack", "UnstackVertex", {"index": 1, "num_stacked": 3},
     [(6, 4, 2)], True),
    ("reshape", "ReshapeVertex", {"new_shape": (4, 3)}, [(2, 3, 4)], True),
    ("poolhelper", "PoolHelperVertex", {}, [(2, 5, 4, 3)], True),
    ("l2", "L2Vertex", {}, [(3, 4, 2), (3, 4, 2)], False),
    ("pre-cnn-ff", "PreprocessorVertex", {}, [(2, 3, 4, 2)], True),
    ("pre-ff-cnn", "PreprocessorVertex", {"mode": "ff_to_cnn",
                                          "shape": (2, 3, 2)},
     [(2, 12)], True),
    ("pre-rnn-ff", "PreprocessorVertex", {"mode": "rnn_to_ff"},
     [(2, 5, 3)], True),
    ("pre-ff-rnn", "PreprocessorVertex", {"mode": "ff_to_rnn",
                                          "shape": (5,)}, [(10, 3)], True),
]


@pytest.mark.parametrize("case", _V_CASES, ids=[c[0] for c in _V_CASES])
def test_vertex_matches_reference(case):
    _, kind, fields, shapes, exact = case
    rng = np.random.default_rng(9)
    xs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jv, tv = getattr(JV, kind)(**fields), getattr(TV, kind)(**fields)
    ref = np.asarray(jv.apply(*[jnp.asarray(x) for x in xs]))
    got = tv.apply(*[torch.tensor(x) for x in xs]).numpy()
    if exact:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    in_shapes = [s[1:] for s in shapes]
    assert tuple(tv.output_shape(*in_shapes)) == tuple(
        jv.output_shape(*in_shapes))
    if kind not in ("StackVertex", "UnstackVertex", "PreprocessorVertex"):
        assert tuple(tv.output_shape(*in_shapes)) == got.shape[1:]
    jd = json.loads(json.dumps(jv.to_dict()))
    assert json.loads(json.dumps(tv.to_dict())) == jd
    assert TV.vertex_from_dict(jd) == tv


def test_l2_normalize_adds_eps_after_the_root():
    x = torch.zeros((1, 3))
    x[0, 0] = 3e-8
    got = TV.L2NormalizeVertex(eps=1e-8).apply(x)
    np.testing.assert_allclose(got[0, 0].item(), 3e-8 / 4e-8, rtol=1e-6)


def test_vertex_axis_zero_is_refused():
    with pytest.raises(ValueError, match="batch axis"):
        TV.MergeVertex(axis=0).output_shape((3,), (3,))


# ----------------------------------------------------------- SharedLayer


def _shared_conf(nnc, L, V, shared=True):
    """Two inputs through one dense layer (d1 on ``a``, its SharedLayer d2
    on ``b``), merged, a dense head; with ``shared=False`` d2 is a dense
    layer of its own."""
    dense = L.DenseLayer(n_in=5, n_out=4, activation="tanh")
    d2 = L.SharedLayer(source="d1", layer=dense) if shared else dense
    return (nnc.builder().seed(4).graph_builder().add_inputs("a", "b")
            .add_layer("d1", dense, "a")
            .add_layer("d2", d2, "b")
            .add_vertex("cat", V.MergeVertex(), "d1", "d2")
            .add_layer("out", L.OutputLayer(n_in=8, n_out=3), "cat")
            .set_outputs("out").set_input_types((5,), (5,)).build())


def _shared_batch(seed=1):
    rng = np.random.default_rng(seed)
    return ([rng.normal(size=(6, 5)).astype(np.float32) for _ in range(2)],
            [np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]])


def test_shared_layer_conf_json_matches_reference():
    jd = json.loads(_shared_conf(JNNC, JL, JV).to_json())
    from deeplearning4j_tpu_torch.nn import NeuralNetConfiguration as TNNC
    assert json.loads(_shared_conf(TNNC, TL, TV).to_json()) == jd
    conf = TGConf.from_json(json.dumps(jd))
    assert isinstance(conf.nodes[1].node, TL.SharedLayer)
    assert conf.nodes[1].node.layer == TL.DenseLayer(n_in=5, n_out=4,
                                                     activation="tanh")


def test_shared_layer_sums_both_call_sites_into_the_source():
    """d1's gradient in the shared graph is d1's plus d2's in the same graph
    with two dense layers holding the same weights."""
    from deeplearning4j_tpu_torch.nn import NeuralNetConfiguration as TNNC
    shared = ComputationGraph(_shared_conf(TNNC, TL, TV)).init(device="cpu")
    assert shared.params["d2"] == {}
    twin = ComputationGraph(_shared_conf(TNNC, TL, TV, shared=False)).init(
        device="cpu")
    for k, v in shared.params["d1"].items():
        twin.params["d1"][k] = v.clone()
        twin.params["d2"][k] = v.clone()
    twin.params["out"] = ttree.tree_map(torch.clone, shared.params["out"])
    x, y = _shared_batch()
    g, loss = shared.compute_gradient_and_score(x, y)
    g2, loss2 = twin.compute_gradient_and_score(x, y)
    np.testing.assert_allclose(float(loss), float(loss2), rtol=1e-6)
    assert set(g) == {"d1", "out"}  # the SharedLayer node has no params
    for k in ("W", "b"):
        np.testing.assert_allclose(g["d1"][k].numpy(),
                                   (g2["d1"][k] + g2["d2"][k]).numpy(),
                                   rtol=1e-5, atol=1e-7)
        assert float(g2["d2"][k].abs().max()) > 0


def test_shared_layer_graph_output_and_fit_match_reference():
    """The shared graph from the reference's conf JSON with its params:
    output within 2e-5, then 3 Adam steps, losses and params within 1e-4
    relative of the reference's."""
    jconf = _shared_conf(JNNC, JL, JV)
    jnet = JGraph(jconf).init()
    params, states = _np(jnet.params), _np(jnet.states)
    net = interop.from_reference_json(jconf.to_json(), params, states,
                                      device="cpu")
    x, y = _shared_batch()
    np.testing.assert_allclose(net.output(*x).numpy(),
                               np.asarray(jnet.output(*x)), atol=FWD_ATOL)
    for _ in range(3):
        jnet.fit(x, y)
        net.fit(x, y)
        np.testing.assert_allclose(net.get_score(), float(jnet.score_value),
                                   rtol=TRAJ_RTOL)
    out = interop.to_numpy(net)
    for tree, ref in ((out["params"], jnet.params),
                      (out["opt_states"], jnet.opt_states)):
        ref = _np(ref)
        for (pa, a), (pb, b) in zip(ttree.tree_items(tree),
                                    ttree.tree_items(ref)):
            assert pa == pb
            err = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
            assert err <= TRAJ_RTOL, (pa, err)


def test_shared_layer_unknown_source_is_refused():
    from deeplearning4j_tpu_torch.nn import NeuralNetConfiguration as TNNC
    conf = _shared_conf(TNNC, TL, TV)
    conf.nodes[1].node = TL.SharedLayer(source="nope",
                                        layer=conf.nodes[0].node)
    with pytest.raises(ValueError, match="unknown source 'nope'"):
        ComputationGraph(conf)
