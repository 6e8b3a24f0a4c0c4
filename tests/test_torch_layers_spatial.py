"""nn/layers_spatial.py against the JAX package's, on the CPU: each of its
nineteen layer classes, called directly on the same seeded input with the
same params (the port's seeded draws, fed to both). The reference's own
``tests/test_layers_spatial.py`` fails at collection (it imports
``autodiff/gradcheck.py``, ROADMAP Queue 3), so these are the running
checks of those classes.

Tolerances (docs/KERNELS.md): forward 2e-5 absolute (the shape-only
layers exactly); gradients of a fixed random projection of the output with
respect to every param and the input 2e-4 of the largest gradient of the
tensor; ``output_shape`` equal; conf dicts equal and read back by each
package, nested layers (MaskZeroLayer, TimeDistributed) included.

Also the two reference faults in ``nn/layers.py`` that the port mirrors,
pinned in both packages: a bf16 EmbeddingLayer rounds float ids, and a
training-mode ``BatchNormalization(lock_gamma_beta=True)`` raises.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.nn import layers as JL  # noqa: E402
from deeplearning4j_tpu.nn import layers_spatial as JS  # noqa: E402
from deeplearning4j_tpu.nn import recurrent as JR  # noqa: E402
from deeplearning4j_tpu_torch import tree as ttree  # noqa: E402
from deeplearning4j_tpu_torch.nn import layers as TL  # noqa: E402
from deeplearning4j_tpu_torch.nn import layers_spatial as TS  # noqa: E402
from deeplearning4j_tpu_torch.nn import recurrent as TR  # noqa: E402

FWD_ATOL, GRAD_RTOL = 2e-5, 2e-4
JAX_NS = {"L": JL, "S": JS, "R": JR}
TORCH_NS = {"L": TL, "S": TS, "R": TR}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread while this module runs (the suite runs six
    workers on eight cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _s(kind, **fields):
    return lambda ns: getattr(ns["S"], kind)(**fields)


def _mask_zero(carry, rec="LSTM"):
    return lambda ns: ns["S"].MaskZeroLayer(
        underlying=getattr(ns["R"], rec)(n_in=3, n_out=4),
        carry_masked_output=carry)


_SEQ, _IMG, _VOL = (2, 9, 3), (2, 7, 6, 3), (2, 5, 6, 4, 2)
# (id, factory, input shape, exact)
_CASES = [
    ("depthwise-same", _s("DepthwiseConvolution2D"), _IMG, False),
    ("depthwise-valid-s2", _s("DepthwiseConvolution2D", stride=(2, 2),
                              padding="VALID"), _IMG, False),
    ("depthwise-mult2-nobias", _s("DepthwiseConvolution2D",
                                  depth_multiplier=2, has_bias=False,
                                  activation="relu"), _IMG, False),
    ("depthwise-5x3-s2-same", _s("DepthwiseConvolution2D",
                                 kernel_size=(5, 3), stride=(2, 1)),
     (2, 9, 8, 4), False),
    ("conv1d-same", _s("Convolution1D", n_out=4), _SEQ, False),
    ("conv1d-valid-s2-d2", _s("Convolution1D", n_out=5, stride=2,
                              padding="VALID", dilation=2,
                              activation="tanh"), _SEQ, False),
    ("conv1d-nobias", _s("Convolution1D", n_out=2, kernel_size=2,
                         has_bias=False), _SEQ, False),
    ("pool1d-max", _s("Subsampling1DLayer"), _SEQ, True),
    ("pool1d-avg-same-s1", _s("Subsampling1DLayer", kernel_size=3, stride=1,
                              padding="SAME", pooling_type="avg"),
     _SEQ, False),
    ("crop1d", _s("Cropping1D", cropping=(2, 1)), _SEQ, True),
    ("pad1d", _s("ZeroPadding1DLayer", padding=(1, 3)), _SEQ, True),
    ("up1d", _s("Upsampling1D", size=3), _SEQ, True),
    ("conv3d-same", _s("Convolution3D", n_out=3), _VOL, False),
    ("conv3d-valid-s2", _s("Convolution3D", n_out=2, kernel_size=(2, 3, 2),
                           stride=(2, 1, 2), padding="VALID",
                           activation="relu"), _VOL, False),
    ("pool3d-max", _s("Subsampling3DLayer"), _VOL, True),
    ("pool3d-avg-same", _s("Subsampling3DLayer", kernel_size=(3, 3, 3),
                           stride=(2, 2, 2), padding="SAME",
                           pooling_type="avg"), _VOL, False),
    ("crop3d", _s("Cropping3D", cropping=((1, 0), (2, 1), (0, 1))), _VOL,
     True),
    ("pad3d", _s("ZeroPadding3DLayer", padding=((1, 0), (0, 2), (1, 1))),
     _VOL, True),
    ("up3d", _s("Upsampling3D"), _VOL, True),
    ("prelu", _s("PReLULayer"), _IMG, False),
    ("repeat", _s("RepeatVector", n=4), (3, 5), True),
    ("time-distributed-dense", lambda ns: ns["S"].TimeDistributed(
        underlying=ns["L"].DenseLayer(n_in=3, n_out=4, activation="relu")),
     _SEQ, False),
    ("mask-zero-lstm", _mask_zero(False), _SEQ, False),
    ("mask-zero-lstm-carry", _mask_zero(True), _SEQ, False),
    ("mask-zero-gru-carry", _mask_zero(True, "GRU"), _SEQ, False),
    ("locally-connected-2d", _s("LocallyConnected2D", n_out=4,
                                kernel_size=(3, 2), stride=(2, 1)),
     _IMG, False),
    ("locally-connected-2d-nobias", _s("LocallyConnected2D", n_out=2,
                                       has_bias=False, activation="tanh"),
     _IMG, False),
    ("locally-connected-1d", _s("LocallyConnected1D", n_out=5, kernel_size=3,
                                stride=2), _SEQ, False),
    ("elementwise-mul", _s("ElementWiseMultiplicationLayer",
                           activation="sigmoid"), (3, 6), False),
    ("mask-layer", _s("MaskLayer"), _SEQ, True),
]


def _input(shape, seed, masked):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    if masked:  # zero steps: a padded tail and one step mid-sequence
        x[:, 6:] = 0.0
        x[1, 2] = 0.0
    return x


def _params(tl, shape, seed):
    params, state = tl.initialize(torch.Generator().manual_seed(seed),
                                  shape[1:])
    assert not state
    params = ttree.tree_map(lambda t: t.numpy(), params)
    # nonzero biases and non-unit scales, so they are tested too
    rng = np.random.default_rng(seed + 1)
    return ttree.tree_map(
        lambda a: (a + rng.normal(size=a.shape).astype(np.float32) * 0.3
                   if a.ndim <= 2 and a.shape[-1] <= 6 else a), params)


def _case(case, seed=3):
    cid, make, shape, exact = case
    jl, tl = make(JAX_NS), make(TORCH_NS)
    x = _input(shape, seed, masked=cid.startswith("mask"))
    return cid, jl, tl, _params(tl, shape, seed), x, exact


def _mask_kw(cid, x, torch_side):
    if cid != "mask-layer":
        return {}
    m = np.ones(x.shape[:2], np.float32)
    m[0, 5:] = 0.0
    return {"mask": torch.tensor(m) if torch_side else jnp.asarray(m)}


@pytest.mark.parametrize("case", _CASES, ids=[c[0] for c in _CASES])
def test_layer_forward_and_gradients_match_reference(case):
    cid, jl, tl, params, x, exact = _case(case)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    y_ref = np.asarray(jl.apply(jp, {}, jnp.asarray(x),
                                **_mask_kw(cid, x, False))[0])
    tp = ttree.tree_map(torch.tensor, params)
    y, _ = tl.apply(tp, {}, torch.tensor(x), **_mask_kw(cid, x, True))
    if exact:
        np.testing.assert_array_equal(y.numpy(), y_ref)
    else:
        np.testing.assert_allclose(y.numpy(), y_ref, atol=FWD_ATOL, rtol=0)
    if not cid.startswith("mask"):
        assert tuple(tl.output_shape(x.shape[1:])) == tuple(
            jl.output_shape(x.shape[1:])) == tuple(y.shape[1:])
    assert tl.has_params() == jl.has_params()

    r = np.random.default_rng(11).normal(size=y.shape).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jl.apply(p, {}, xx, **_mask_kw(cid, x, False))[0]
                       * r)

    g_ref = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = ttree.tree_map(lambda v: v.requires_grad_(True), tp)
    tx = torch.tensor(x, requires_grad=True)
    y, _ = tl.apply(tp, {}, tx, **_mask_kw(cid, x, True))
    leaves = ttree.tree_leaves(tp) + [tx]
    gs = torch.autograd.grad((y * torch.tensor(r)).sum(), leaves)
    refs = [np.asarray(ttree.tree_get(g_ref[0], p))
            for p, _ in ttree.tree_items(tp)] + [np.asarray(g_ref[1])]
    assert len(gs) == len(refs)
    for g, ref in zip(gs, refs):
        scale = max(float(np.abs(ref).max()), 1e-6)
        assert float(np.abs(g.numpy() - ref).max()) <= GRAD_RTOL * scale


def _detuple(v):
    """JSON lists back to tuples, as the confs' readers do."""
    if isinstance(v, dict):
        return {k: _detuple(x) for k, x in v.items()}
    if isinstance(v, list):
        return tuple(_detuple(x) for x in v)
    return v


@pytest.mark.parametrize("case", _CASES, ids=[c[0] for c in _CASES])
def test_layer_conf_dicts_match_reference(case):
    _, make, _, _ = case
    jd = json.loads(json.dumps(make(JAX_NS).to_dict()))
    td = json.loads(json.dumps(make(TORCH_NS).to_dict()))
    assert td == jd
    assert TL.layer_from_dict(_detuple(jd)) == make(TORCH_NS)
    assert JL.layer_from_dict(_detuple(td)) == make(JAX_NS)


def test_every_reference_class_is_ported():
    import dataclasses

    ref = {n for n, c in vars(JS).items() if isinstance(c, type)
           and issubclass(c, JL.Layer) and c.__module__ == JS.__name__}
    assert len(ref) == 19
    for name in ref:
        cls = getattr(TS, name)
        assert TL._LAYER_TYPES[name] is cls
        assert ([(f.name, f.default) for f in dataclasses.fields(cls)]
                == [(f.name, f.default)
                    for f in dataclasses.fields(getattr(JS, name))])
    covered = {type(c[1](TORCH_NS)).__name__ for c in _CASES}
    assert covered == ref


def test_mask_zero_layer_passes_the_mask_to_recurrent_layers_only():
    for rec in (TR.LSTM(n_in=3, n_out=4), TR.GRU(n_in=3, n_out=4),
                TR.SimpleRnn(n_in=3, n_out=4), TR.GravesLSTM(n_in=3, n_out=4),
                TR.Bidirectional(layer=TR.LSTM(n_in=3, n_out=4))):
        import inspect
        assert "mask" in inspect.signature(rec.apply).parameters


def test_elementwise_multiplication_refuses_n_out_other_than_n_in():
    with pytest.raises(ValueError, match="n_in == n_out"):
        TS.ElementWiseMultiplicationLayer(n_in=3, n_out=4).initialize(
            torch.Generator(), (3,))


# ----------------------------------------- reference faults, both packages


def _embedding_nets():
    from deeplearning4j_tpu.nn import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNNC
    from deeplearning4j_tpu_torch import interop
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork as TMLN
    from deeplearning4j_tpu_torch.nn import NeuralNetConfiguration as TNNC

    def conf(nnc, L):
        return (nnc.builder().seed(1).compute_dtype("bfloat16").list()
                .layer(L.EmbeddingLayer(n_in=1000, n_out=4))
                .layer(L.OutputLayer(n_in=4, n_out=3, loss="mse",
                                     activation="identity"))
                .set_input_type((1,)).build())

    jnet = JMLN(conf(JNNC, JL)).init()
    tnet = TMLN(conf(TNNC, TL)).init(device="cpu")
    p = jax.tree_util.tree_map(np.asarray, jnet.params)
    s = jax.tree_util.tree_map(np.asarray, jnet.states)
    interop.load_reference_mln(tnet, p, s)
    return jnet, tnet, p


def test_bf16_embedding_rounds_float_ids_in_both_packages():
    """ROADMAP Queue 3: the bf16 cast of a float input rounds ids 301, 999
    and 257 to 300, 1000 and 256 in both packages; row 1000 lies past the
    table, so its output is NaN in both."""
    jnet, tnet, p = _embedding_nets()
    x = np.array([[301.0], [999.0], [257.0]], np.float32)
    want = np.asarray(jnet.output(x), np.float32)
    got = tnet.output(x).float().numpy()
    table = p[0]["W"]
    rows = np.asarray(jnp.asarray(table).astype(jnp.bfloat16)
                      .astype(jnp.float32))
    head = (rows[[300, 256]].astype(np.float32) @ p[1]["W"]) + p[1]["b"]
    np.testing.assert_allclose(want[[0, 2]], head, rtol=2 ** -6, atol=2e-2)
    np.testing.assert_array_equal(np.isnan(want[1]), [True] * 3)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[[0, 2]], want[[0, 2]], rtol=2 ** -7,
                               atol=1e-2)


def test_batchnorm_lock_gamma_beta_raises_in_training_in_both_packages():
    """ROADMAP Queue 3: training-mode batchnorm with locked gamma/beta hands
    gamma=None to the training op, which raises AttributeError in both."""
    x = np.random.default_rng(2).normal(size=(4, 3, 3, 2)).astype(np.float32)
    jl = JL.BatchNormalization(lock_gamma_beta=True)
    tl = TL.BatchNormalization(lock_gamma_beta=True)
    jp, js = jl.initialize(jax.random.PRNGKey(0), (3, 3, 2))
    tp, ts = tl.initialize(torch.Generator(), (3, 3, 2))
    assert not jp and not tp
    with pytest.raises(AttributeError):
        jl.apply(jp, js, jnp.asarray(x), training=True)
    with pytest.raises(AttributeError):
        tl.apply(tp, ts, torch.tensor(x), training=True)
    # inference is fine in both, and equal
    np.testing.assert_allclose(
        tl.apply(tp, ts, torch.tensor(x))[0].numpy(),
        np.asarray(jl.apply(jp, js, jnp.asarray(x))[0]), atol=1e-6)
