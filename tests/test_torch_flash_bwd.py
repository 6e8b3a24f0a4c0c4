"""The port's flash-attention backward against the JAX package, on the CPU.

``ops.kernels.attention.FlashAttention`` pairs the flash forward (the K5
kernel on a card, its plain version here) with
``flash_attention_bwd_reference``, the port of the reference's
``_flash_bwd`` (``deeplearning4j_tpu/ops/attention.py:268``). Held here:

- dq, dk, dv of ``ops.attention.flash_attention`` against ``jax.vjp`` of
  the reference's ``flash_attention``, run two ways: ``use_pallas=True``
  (its jnp forward on the CPU) and ``use_pallas="interpret"`` (the Pallas
  forward in interpret mode, whose LSE feeds the same backward); cases: no
  mask, causal, Sq != Sk (causal with ``kv_offset``), a padding mask with a
  fully-masked batch row, several key blocks; fp32 and bf16;
- the same gradients against the exact attention's autograd in fp64;
- ``torch.autograd.gradcheck`` of the Function on a tiny fp64 case, with
  and without masks;
- a padded batch row gets zero gradient, and the raw launch still refuses
  inputs that require grad (on the card; here the CPU takes the plain
  version, so the Function is what trains).

Tolerances (docs/KERNELS.md:109): 2e-4 abs on the gradients of unit-scale
fp32 inputs (the same fp32 arithmetic summed in other orders); bf16: both
packages compute in fp32 from the bf16 inputs and round each gradient once
to bf16, so 2^-7 of the largest gradient (two bf16 steps); against fp64,
2e-4 of the largest gradient for fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_tpu.ops import attention as JA  # noqa: E402
from deeplearning4j_tpu_torch.ops import attention as TA  # noqa: E402
from deeplearning4j_tpu_torch.ops.kernels import attention as KA  # noqa: E402

GRAD_ATOL = 2e-4

# (id, B, H, Sq, Sk, D, causal, mask kind, block_k)
_CASES = [
    ("plain", 2, 2, 16, 16, 8, False, None, 16),
    ("causal", 2, 2, 16, 16, 8, True, None, 16),
    ("sq-lt-sk-causal", 2, 2, 8, 32, 16, True, None, 8),
    ("padding-dead-row", 3, 2, 16, 16, 8, False, "dead-row", 8),
    ("causal-padding-blocks", 2, 2, 32, 32, 8, True, "ragged", 8),
]


def _inputs(case, seed=0):
    _, b, h, sq, sk, d, _causal, kind, _bk = case
    rng = np.random.default_rng(seed)
    q, do = (rng.normal(size=(b, h, sq, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(b, h, sk, d)).astype(np.float32)
            for _ in range(2))
    mask = None
    if kind is not None:
        lens = rng.integers(sk // 4, sk, size=b)
        mask = (np.arange(sk)[None, :] < lens[:, None]).astype(np.float32)
        if kind == "dead-row":
            mask[1] = 0.0
    return q, k, v, do, mask


def _reference_grads(q, k, v, do, mask, causal, block_k, use_pallas,
                     dtype=jnp.float32):
    def f(q, k, v):
        return JA.flash_attention(
            q, k, v, causal=causal, block_q=block_k, block_k=block_k,
            use_pallas=use_pallas,
            mask=None if mask is None else jnp.asarray(mask))

    o, vjp = jax.vjp(f, *(jnp.asarray(a, dtype) for a in (q, k, v)))
    return [np.asarray(g.astype(jnp.float32))
            for g in vjp(jnp.asarray(do, dtype))]


def _port_grads(q, k, v, do, mask, causal, block_k, dtype=torch.float32):
    tq, tk, tv = (torch.from_numpy(a).to(dtype).requires_grad_()
                  for a in (q, k, v))
    o = TA.flash_attention(
        tq, tk, tv, causal=causal, block_q=block_k, block_k=block_k,
        mask=None if mask is None else torch.from_numpy(mask))
    assert o.grad_fn is not None
    o.backward(torch.from_numpy(do).to(dtype))
    return [t.grad.float().numpy() for t in (tq, tk, tv)]


@pytest.mark.parametrize("use_pallas", [True, "interpret"],
                         ids=["jnp-forward", "pallas-interpret"])
@pytest.mark.parametrize("case", _CASES, ids=[c[0] for c in _CASES])
def test_flash_grads_match_reference_vjp(case, use_pallas):
    q, k, v, do, mask = _inputs(case)
    causal, bk = case[6], case[8]
    want = _reference_grads(q, k, v, do, mask, causal, bk, use_pallas)
    got = _port_grads(q, k, v, do, mask, causal, bk)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_ATOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("case", _CASES[1:4:2], ids=[c[0] for c in _CASES[1:4:2]])
def test_flash_grads_bf16_match_reference_vjp(case):
    q, k, v, do, mask = _inputs(case, seed=3)
    causal, bk = case[6], case[8]
    want = _reference_grads(q, k, v, do, mask, causal, bk, True,
                            jnp.bfloat16)
    got = _port_grads(q, k, v, do, mask, causal, bk, torch.bfloat16)
    for name, g, w in zip("qkv", got, want):
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= 2.0 ** -7 * scale, f"d{name}"


def _exact_fp64_grads(q, k, v, do, mask, causal):
    tq, tk, tv = (torch.from_numpy(a).double().requires_grad_()
                  for a in (q, k, v))
    amask = None if mask is None else torch.from_numpy(mask)[:, None, None, :]
    o = TA.dot_product_attention(tq, tk, tv, mask=amask, causal=causal)
    o.backward(torch.from_numpy(do).double())
    return [t.grad.numpy() for t in (tq, tk, tv)]


@pytest.mark.parametrize("case", _CASES, ids=[c[0] for c in _CASES])
def test_flash_grads_match_exact_attention_in_fp64(case):
    q, k, v, do, mask = _inputs(case, seed=5)
    causal, bk = case[6], case[8]
    want = _exact_fp64_grads(q, k, v, do, mask, causal)
    got = _port_grads(q, k, v, do, mask, causal, bk)
    for name, g, w in zip("qkv", got, want):
        scale = float(np.abs(w).max())
        assert float(np.abs(g - w).max()) <= GRAD_ATOL * scale, f"d{name}"


@pytest.mark.parametrize("causal,kind", [(False, None), (True, "dead-row")],
                         ids=["plain", "causal-dead-row"])
def test_function_gradcheck_fp64(causal, kind):
    rng = np.random.default_rng(11)
    b, h, s, d = 2, 1, 6, 4
    q, k, v = (torch.from_numpy(rng.normal(size=(b, h, s, d)))
               .requires_grad_() for _ in range(3))
    mask = None
    if kind == "dead-row":
        mask = torch.tensor([[1.0] * 4 + [0.0] * 2, [0.0] * 6],
                            dtype=torch.float64)

    def f(q, k, v):
        return KA.FlashAttention.apply(q, k, v, mask, 0.5, causal, 4,
                                       False)[0]

    assert torch.autograd.gradcheck(f, (q, k, v), eps=1e-6, atol=1e-6)


def test_padded_batch_row_takes_no_gradient():
    """A fully-masked row: s == lse == -1e30, so exp(0) = 1 would leak; the
    backward zeroes p there, and the row's dq, dk, dv are exactly 0."""
    q, k, v, do, mask = _inputs(_CASES[3])
    got = _port_grads(q, k, v, do, mask, False, 8)
    for g in got:
        assert not np.any(g[1])
        assert np.any(g[0])


def test_flash_goes_through_the_function_only_for_grad():
    q = torch.randn((1, 2, 16, 8))
    o, lse = KA.flash(q, q, q, 0.25, False)
    assert o.grad_fn is None
    qg = q.clone().requires_grad_()
    o, lse = KA.flash(qg, q, q, 0.25, False)
    assert type(o.grad_fn).__name__ == "FlashAttentionBackward"
    assert lse.grad_fn is None and not lse.requires_grad
    with torch.no_grad():
        assert KA.flash(qg, q, q, 0.25, False)[0].grad_fn is None
