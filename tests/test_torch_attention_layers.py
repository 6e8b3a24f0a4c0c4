"""The port's multi-head attention op and attention layers
(``ops/attention.py::multi_head_dot_product_attention``, ``nn/attention.py``)
against the JAX package's, on the CPU.

- The op: outputs and the gradients of a fixed projection of them with
  respect to the inputs and the four weights, with a (B, Tk) padding mask
  (one batch row fully masked) and a full [B, 1, Tq, Tk] mask, flash on
  (the FlashAttention Function) and off, causal and not, Tq != Tk.
- SelfAttentionLayer (projected and not), LearnedSelfAttentionLayer
  (projected and not) and RecurrentAttentionLayer: outputs and gradients
  with and without a padding mask, from the reference's params.
- Their conf JSON moves both ways, and a MultiLayerNetwork of them trains:
  four Adam steps follow the reference's within 1e-4 relative.

Tolerances: 2e-5 abs on unit-scale fp32 outputs, 2e-4 on gradients
(docs/KERNELS.md:109); trajectories 1e-4 relative with a 1e-6 floor, Adam at
epsilon 1e-3 (ROADMAP.md Queue 3).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet  # noqa: E402
from deeplearning4j_tpu.nn import attention as JAL  # noqa: E402
from deeplearning4j_tpu.nn import layers as JL  # noqa: E402
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC  # noqa: E402,E501
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JMLN)
from deeplearning4j_tpu.nn.recurrent import (  # noqa: E402
    RnnOutputLayer as JRnnOut)
from deeplearning4j_tpu.nn.updaters import Adam as JAdam  # noqa: E402
from deeplearning4j_tpu.ops import attention as JA  # noqa: E402
from deeplearning4j_tpu_torch import interop  # noqa: E402
from deeplearning4j_tpu_torch.data.dataset import DataSet  # noqa: E402
from deeplearning4j_tpu_torch.nn import attention as TAL  # noqa: E402
from deeplearning4j_tpu_torch.nn import layers as TL  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration as TConf)
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    NeuralNetConfiguration as TNNC)
from deeplearning4j_tpu_torch.nn.recurrent import (  # noqa: E402
    RnnOutputLayer as TRnnOut)
from deeplearning4j_tpu_torch.nn.updaters import Adam as TAdam  # noqa: E402
from deeplearning4j_tpu_torch.ops import attention as TA  # noqa: E402
from deeplearning4j_tpu_torch.ops import registry  # noqa: E402

ATOL, GRAD_ATOL = 2e-5, 2e-4
B, T, F = 3, 8, 8


def _rng_arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _padding_mask(b, t):
    mask = np.ones((b, t), np.float32)
    mask[1, t // 2:] = 0.0
    mask[2] = 0.0  # a fully-masked batch row
    return mask


def _full_mask(b, tq, tk):
    rng = np.random.default_rng(8)
    m = (rng.random((b, 1, tq, tk)) > 0.3).astype(np.float32)
    m[..., 0] = 1.0
    return m


def _grads_both(jfn, tfn, arrays, seed=1):
    """Outputs and the gradients of sum(out * w) of a JAX and a torch
    function of the same arrays."""
    jo = jfn(*(jnp.asarray(a) for a in arrays))
    w = np.random.default_rng(seed).normal(size=jo.shape).astype(np.float32)
    jg = jax.grad(lambda *a: jnp.sum(jfn(*a) * w),
                  argnums=tuple(range(len(arrays))))(
        *(jnp.asarray(a) for a in arrays))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    to = tfn(*ts)
    (to * torch.from_numpy(w)).sum().backward()
    return (to.detach().numpy(), np.asarray(jo),
            [t.grad.numpy() for t in ts], [np.asarray(g) for g in jg])


def _assert_both(got_o, ref_o, got_g, ref_g):
    np.testing.assert_allclose(got_o, ref_o, rtol=0, atol=ATOL)
    for i, (g, r) in enumerate(zip(got_g, ref_g)):
        np.testing.assert_allclose(g, r, rtol=0, atol=GRAD_ATOL,
                                   err_msg=f"grad {i}")


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "exact"])
@pytest.mark.parametrize("mask_kind,causal,tq", [
    (None, False, T), ("padding", False, T), ("padding", True, T),
    ("full", False, T), (None, True, 4), ("padding", False, 4)],
    ids=["nomask", "padding", "padding-causal", "full", "causal-tq4",
         "padding-tq4"])
def test_mha_matches_reference(mask_kind, causal, tq, flash):
    qs, kv, wq, wk, wv, wo = _rng_arrays(
        0, (B, tq, F), (B, T, F), (F, 8), (F, 8), (F, 8), (8, 6))
    wq, wk, wv, wo = (w * np.float32(8 ** -0.5) for w in (wq, wk, wv, wo))
    mask = {None: None, "padding": _padding_mask(B, T),
            "full": _full_mask(B, tq, T)}[mask_kind]

    def jfn(q, k, a, b, c, d):
        return JA.multi_head_dot_product_attention(
            q, k, k, a, b, c, d, n_heads=2, causal=causal, flash=flash,
            mask=None if mask is None else jnp.asarray(mask))

    def tfn(q, k, a, b, c, d):
        return TA.multi_head_dot_product_attention(
            q, k, k, a, b, c, d, n_heads=2, causal=causal, flash=flash,
            mask=None if mask is None else torch.from_numpy(mask))

    _assert_both(*_grads_both(jfn, tfn, [qs, kv, wq, wk, wv, wo]))


def test_mha_registered_by_name():
    for name in ("multi_head_dot_product_attention",
                 "multiHeadDotProductAttention", "mha"):
        assert registry.get_op(name).fn is TA.multi_head_dot_product_attention


_LAYERS = [
    ("self", lambda m: m.SelfAttentionLayer(n_in=F, n_out=F, n_heads=2)),
    ("self-causal-flash", lambda m: m.SelfAttentionLayer(
        n_in=F, n_out=F, n_heads=2, causal=True, flash=True)),
    ("self-unprojected", lambda m: m.SelfAttentionLayer(
        n_in=F, n_out=F, project_input=False)),
    ("learned", lambda m: m.LearnedSelfAttentionLayer(
        n_in=F, n_out=6, n_heads=2, n_queries=3)),
    ("learned-unprojected", lambda m: m.LearnedSelfAttentionLayer(
        n_in=F, n_out=F, n_queries=2, project_input=False)),
    ("recurrent", lambda m: m.RecurrentAttentionLayer(
        n_in=F, n_out=6, n_heads=2)),
]


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("kind,make", _LAYERS, ids=[c[0] for c in _LAYERS])
def test_attention_layer_matches_reference(kind, make, masked):
    jl, tl = make(JAL), make(TAL)
    assert tl.to_dict() == jl.to_dict()
    jparams, _ = jl.initialize(jax.random.PRNGKey(1), (T, F))
    tparams, _ = tl.initialize(torch.Generator().manual_seed(1), (T, F))
    assert {k: v.shape for k, v in tparams.items()} == {
        k: tuple(v.shape) for k, v in jparams.items()}
    keys = sorted(jparams)
    (x,) = _rng_arrays(2, (B, T, F))
    mask = _padding_mask(B, T) if masked else None

    def jfn(x, *ps):
        return jl.apply(dict(zip(keys, ps)), {}, x, mask=None if mask is None
                        else jnp.asarray(mask))[0]

    def tfn(x, *ps):
        return tl.apply(dict(zip(keys, ps)), {}, x, mask=None if mask is None
                        else torch.from_numpy(mask))[0]

    arrays = [x] + [np.array(jparams[k]) for k in keys]
    _assert_both(*_grads_both(jfn, tfn, arrays))
    assert tl.output_shape((T, F)) == tuple(jl.output_shape((T, F)))


def _stack(pkg, recurrent=True):
    """SelfAttention, then RecurrentAttention and a per-step softmax, or
    LearnedSelfAttention (2 queries) and a softmax over 4 classes."""
    if pkg == "ref":
        nnc, lm, am, rnn_out = JNNC, JL, JAL, JRnnOut
        upd = JAdam(1e-3, epsilon=1e-3)
    else:
        nnc, lm, am, rnn_out = TNNC, TL, TAL, TRnnOut
        upd = TAdam(1e-3, epsilon=1e-3)
    lb = nnc.builder().seed(5).updater(upd).list()
    lb.layer(am.SelfAttentionLayer(n_in=F, n_out=F, n_heads=2, flash=True))
    if recurrent:
        lb.layer(am.RecurrentAttentionLayer(n_in=F, n_out=F, n_heads=2))
        lb.layer(rnn_out(n_in=F, n_out=4, loss="mcxent",
                         activation="softmax"))
    else:
        lb.layer(am.LearnedSelfAttentionLayer(n_in=F, n_out=F, n_heads=2,
                                              n_queries=2))
        lb.layer(lm.OutputLayer(n_in=2 * F, n_out=4))
    return lb.set_input_type((T, F)).build()


@pytest.mark.parametrize("recurrent", [True, False],
                         ids=["self-recurrent", "self-learned"])
def test_attention_stack_trains_like_reference(recurrent):
    jnet = JMLN(_stack("ref", recurrent)).init()
    assert json.loads(_stack("port", recurrent).to_json()) == json.loads(
        jnet.conf.to_json())
    net = interop.from_reference_json(
        jnet.conf.to_json(), jax.tree_util.tree_map(np.asarray, jnet.params),
        jax.tree_util.tree_map(np.asarray, jnet.states), device="cpu")
    assert isinstance(TConf.from_json(jnet.conf.to_json()).layers[1],
                      TAL.RecurrentAttentionLayer if recurrent
                      else TAL.LearnedSelfAttentionLayer)
    rng = np.random.default_rng(3)
    for _ in range(4):
        x = rng.normal(size=(B + 1, T, F)).astype(np.float32)
        lens = rng.integers(2, T + 1, size=B + 1)
        mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
        cls = rng.integers(0, 4, size=(B + 1, T) if recurrent else B + 1)
        y = np.eye(4, dtype=np.float32)[cls]
        jnet.fit(JDataSet(x, y, features_mask=mask))
        net.fit(DataSet(x, y, features_mask=mask))
        np.testing.assert_allclose(net.get_score(), float(jnet.get_score()),
                                   rtol=1e-4)
    for i, (mine, ref) in enumerate(zip(net.params, jnet.params)):
        for k in ref:
            np.testing.assert_allclose(mine[k].numpy(), np.asarray(ref[k]),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"layer {i} {k}")
