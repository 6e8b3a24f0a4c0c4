"""The port's attention ops against the JAX package, on the CPU.

- The flash-attention forward's plain version (the CPU side of the K5
  kernel's wrapper, ``ops/kernels/attention.py``) against the reference's
  Pallas kernel in interpret mode (``_flash_fwd_pallas(..., interpret=True)``)
  on O and the LSE, and against the reference's ``flash_attention`` and
  ``dot_product_attention`` on O: no mask, causal with Sq < Sk and Sq = Sk,
  a padding mask, a fully-masked batch row (O = 0, LSE = -1e30), bf16.
- The port's ``dot_product_attention`` against the reference's.
- ``resolve_flash`` and the reference's non-dividing fallback.
- The kernel's ``supports`` gate and dispatch (the kernel itself against
  its plain version on a card: ``tests/test_torch_cuda.py``).

Tolerances: 2e-5 abs in fp32 (docs/KERNELS.md:109; unit-scale inputs, the
same arithmetic summed in another order). bf16: both packages compute in
fp32 from the bf16 inputs and round O once to bf16, so O may differ by one
bf16 rounding step of its largest value (2^-8 relative, a tie broken the
other way); the LSE stays fp32 and keeps 2e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.ops import attention as JA  # noqa: E402
from deeplearning4j_tpu_torch.ops import attention as TA  # noqa: E402
from deeplearning4j_tpu_torch.ops import kernels as TK  # noqa: E402
from deeplearning4j_tpu_torch.ops import registry  # noqa: E402
from deeplearning4j_tpu_torch.ops.kernels import attention as KA  # noqa: E402

ATOL = 2e-5
NEG_BIG = -1e30

# (id, B, H, Sq, Sk, D, causal, mask kind, blocks)
_CASES = [
    ("plain", 2, 2, 16, 16, 8, False, None, 8),
    ("plain-d16-s32", 1, 3, 32, 32, 16, False, None, 8),
    ("causal-square", 2, 2, 32, 32, 8, True, None, 8),
    ("causal-sq-lt-sk", 2, 2, 16, 32, 16, True, None, 8),
    ("padding", 2, 2, 16, 32, 8, False, "ragged", 8),
    ("fully-masked-row", 2, 2, 16, 16, 8, False, "dead-row", 8),
    ("causal-padding", 2, 1, 32, 32, 16, True, "ragged", 8),
    ("one-block", 2, 2, 16, 16, 8, False, "ragged", 16),
]


def _ids(cases):
    return [c[0] for c in cases]


def _inputs(case, seed=0):
    _, b, h, sq, sk, d, _causal, kind, _blocks = case
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, sq, d)).astype(np.float32)
    k = rng.normal(size=(b, h, sk, d)).astype(np.float32)
    v = rng.normal(size=(b, h, sk, d)).astype(np.float32)
    mask = None
    if kind is not None:
        lens = rng.integers(sk // 4, sk, size=b)
        mask = (np.arange(sk)[None, :] < lens[:, None]).astype(np.float32)
        if kind == "dead-row":
            mask[1] = 0.0
    return q, k, v, mask


def _port(*arrays, dtype=torch.float32):
    return [None if a is None else torch.from_numpy(a).to(dtype)
            for a in arrays]


@pytest.mark.parametrize("case", _CASES, ids=_ids(_CASES))
def test_plain_flash_matches_pallas_kernel(case):
    """O and LSE against ``_flash_fwd_pallas`` in interpret mode."""
    q, k, v, mask = _inputs(case)
    causal, blocks = case[6], case[8]
    scale = 1.0 / np.sqrt(q.shape[-1])
    jo, jl = JA._flash_fwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, causal,
        blocks, blocks, True, mask=None if mask is None else jnp.asarray(mask))
    tq, tk, tv, tm = _port(q, k, v, mask)
    to, tl = KA.flash_attention_fwd(tq, tk, tv, scale, causal, tm,
                                    block_k=blocks)
    assert to.shape == tuple(jo.shape) and tl.shape == tuple(jl.shape)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)


@pytest.mark.parametrize("case", _CASES, ids=_ids(_CASES))
def test_flash_attention_matches_reference_ops(case):
    """The port's ``flash_attention`` against the reference's (its
    blockwise path on the CPU) and the reference's exact attention."""
    q, k, v, mask = _inputs(case, seed=1)
    causal, blocks = case[6], case[8]
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    jm = None if mask is None else jnp.asarray(mask)
    j_flash = JA.flash_attention(jq, jk, jv, causal=causal, block_q=blocks,
                                 block_k=blocks, mask=jm)
    j_exact = JA.dot_product_attention(
        jq, jk, jv, causal=causal,
        mask=None if jm is None else jm[:, None, None, :])
    tq, tk, tv, tm = _port(q, k, v, mask)
    t_flash = TA.flash_attention(tq, tk, tv, causal=causal, block_q=blocks,
                                 block_k=blocks, mask=tm).numpy()
    np.testing.assert_allclose(t_flash, np.asarray(j_flash), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(t_flash, np.asarray(j_exact), rtol=0,
                               atol=ATOL)


def test_fully_masked_row_gives_zero_and_neg_big():
    case = [c for c in _CASES if c[0] == "fully-masked-row"][0]
    q, k, v, mask = _inputs(case)
    tq, tk, tv, tm = _port(q, k, v, mask)
    o, lse = KA.flash_attention_fwd(tq, tk, tv, 0.5, False, tm, block_k=8)
    assert torch.equal(o[1], torch.zeros_like(o[1]))
    assert bool((lse[1] == NEG_BIG).all())
    assert bool((lse[0] > NEG_BIG / 2).all())
    exact = TA.dot_product_attention(tq, tk, tv, scale=0.5,
                                     mask=tm[:, None, None, :])
    assert torch.equal(exact[1], torch.zeros_like(exact[1]))


@pytest.mark.parametrize("case", [_CASES[3], _CASES[4]], ids=["causal",
                                                              "padding"])
def test_plain_flash_bf16_matches_pallas_kernel(case):
    """bf16 inputs: O within one bf16 rounding step of its largest value,
    LSE (fp32) within 2e-5."""
    q, k, v, mask = _inputs(case, seed=2)
    causal, blocks = case[6], case[8]
    scale = 1.0 / np.sqrt(q.shape[-1])
    jo, jl = JA._flash_fwd_pallas(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), scale, causal,
        blocks, blocks, True, mask=None if mask is None else jnp.asarray(mask))
    tq, tk, tv = _port(q, k, v, dtype=torch.bfloat16)
    tm = None if mask is None else torch.from_numpy(mask)
    to, tl = KA.flash_attention_fwd(tq, tk, tv, scale, causal, tm,
                                    block_k=blocks)
    assert to.dtype == torch.bfloat16 and tl.dtype == torch.float32
    jo32 = np.asarray(jo.astype(jnp.float32))
    np.testing.assert_allclose(to.float().numpy(), jo32, rtol=0,
                               atol=2.0 ** -8 * np.abs(jo32).max())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)


# (id, q shape, k shape, causal, mask kind)
_EXACT = [
    ("no-mask", (2, 2, 8, 8), (2, 2, 8, 8), False, None),
    ("causal-sq-lt-sk", (2, 2, 4, 8), (2, 2, 12, 8), True, None),
    ("causal-sq-gt-sk", (1, 2, 12, 8), (1, 2, 8, 8), True, None),
    ("full-mask", (2, 2, 8, 8), (2, 2, 8, 8), False, "full"),
    ("padding-dead-row", (2, 2, 8, 8), (2, 2, 8, 8), False, "dead-row"),
]


@pytest.mark.parametrize("case", _EXACT, ids=_ids(_EXACT))
def test_dot_product_attention_matches_reference(case):
    _, qs, ks, causal, kind = case
    rng = np.random.default_rng(3)
    q = rng.normal(size=qs).astype(np.float32)
    k = rng.normal(size=ks).astype(np.float32)
    v = rng.normal(size=ks).astype(np.float32)
    mask = None
    if kind == "full":
        mask = rng.random((qs[0], 1, qs[2], ks[2])) > 0.3
    elif kind == "dead-row":
        mask = np.ones((qs[0], 1, 1, ks[2]), bool)
        mask[0] = False
    j_out, j_w = JA.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=mask,
        causal=causal, with_weights=True)
    t_out, t_w = TA.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        mask=None if mask is None else torch.from_numpy(mask), causal=causal,
        with_weights=True)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(t_w.numpy(), np.asarray(j_w), rtol=0,
                               atol=ATOL)


def test_non_dividing_length_takes_exact_path():
    """Sq = 12 with blocks of 8 does not divide: both packages answer with
    exact attention (the reference's dispatch rule, :438-441)."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(size=(2, 2, 12, 8)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((2, 12), np.float32)
    mask[0, 7:] = 0.0
    TK.reset_counts()
    got = TA.flash_attention(*_port(q, k, v), block_q=8, block_k=8,
                             mask=torch.from_numpy(mask))
    exact = TA.dot_product_attention(
        *_port(q, k, v), mask=torch.from_numpy(mask)[:, None, None, :])
    assert torch.equal(got, exact)
    ref = JA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             block_q=8, block_k=8, mask=jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)
    assert TK.LAUNCHES == dict.fromkeys(TK.KERNELS, 0)


# (flash, seq, mask ndim, device, expected)
_RESOLVE = [
    (True, 16, None, "cpu", True),
    (False, 4096, None, "cuda", False),
    (True, 16, 2, "cpu", True),
    (True, 16, 4, "cpu", False),
    ("auto", 4096, None, "cpu", False),
    ("auto", 4096, None, None, False),
    ("auto", TA.FLASH_MIN_SEQ, None, "cuda", True),
    ("auto", TA.FLASH_MIN_SEQ - 1, None, "cuda", False),
    ("auto", TA.FLASH_MIN_SEQ, 2, "cuda", True),
    ("auto", TA.FLASH_MIN_SEQ, 4, "cuda", False),
]


@pytest.mark.parametrize("flash,seq,mask_ndim,device,expected", _RESOLVE)
def test_resolve_flash(flash, seq, mask_ndim, device, expected):
    mask = None if mask_ndim is None else torch.ones((1,) * (mask_ndim - 1)
                                                     + (seq,))
    assert TA.resolve_flash(flash, seq, seq, mask, device=device) is expected
    if flash != "auto":  # the reference agrees wherever it is not a TPU rule
        jm = None if mask is None else jnp.ones(mask.shape)
        assert JA.resolve_flash(flash, seq, seq, jm) is expected


@pytest.mark.parametrize("head_dim,takes", [(64, True), (100, False),
                                            (256, False)])
def test_resolve_flash_asks_the_kernel_gate(head_dim, takes):
    """"auto" picks flash on CUDA only where the kernel's ``supports`` takes
    the head dim, as the reference picks it only where its kernel runs;
    ``flash=True`` there still raises, naming the refused head dim."""
    assert TA.resolve_flash("auto", 128, 128, device="cuda",
                            head_dim=head_dim) is takes
    assert TA.resolve_flash("auto", 128, 128, device="cpu",
                            head_dim=head_dim) is False
    if takes:
        assert TA.resolve_flash(True, 128, 128, device="cuda",
                                head_dim=head_dim) is True
    else:
        with pytest.raises(ValueError, match=f"head dim {head_dim}"):
            TA.resolve_flash(True, 128, 128, device="cuda",
                             head_dim=head_dim)
    # the CPU runs the plain blockwise forward at any head dim
    assert TA.resolve_flash(True, 128, 128, device="cpu",
                            head_dim=head_dim) is True


def test_resolve_flash_rejects_other_values():
    with pytest.raises(ValueError, match="flash must be"):
        TA.resolve_flash("yes", 8, 8)


# (id, q, k, v dtype/shape edits, mask shape, supported)
_SUPPORTS = [
    ("fp32", torch.float32, 64, None, True),
    ("bf16", torch.bfloat16, 64, None, True),
    ("padding-mask", torch.float32, 64, (2, 16), True),
    ("d8", torch.float32, 8, None, True),
    ("d128", torch.float32, 128, None, True),
    ("fp16", torch.float16, 64, None, False),
    ("d12", torch.float32, 12, None, False),
    ("d136", torch.float32, 136, None, False),
    ("full-mask", torch.float32, 64, (2, 1, 16, 16), False),
    ("mask-wrong-length", torch.float32, 64, (2, 8), False),
]


@pytest.mark.parametrize("case", _SUPPORTS, ids=_ids(_SUPPORTS))
def test_supports_gate(case):
    _, dt, d, mshape, want = case
    q = torch.zeros((2, 3, 16, d), dtype=dt)
    mask = None if mshape is None else torch.ones(mshape)
    assert KA.supports(q, q, q, mask) is want


def test_supports_refuses_mixed_types():
    q = torch.zeros((2, 3, 16, 64))
    assert not KA.supports(q, q.bfloat16(), q)


def test_dispatch_on_cpu_runs_plain_and_counts_nothing():
    q = torch.randn(1, 2, 16, 8)
    TK.reset_counts()
    with TK.impl_scope("auto"):
        o = TA.flash_attention(q, q, q, block_q=8, block_k=8)
    assert o.shape == q.shape
    assert TK.LAUNCHES == dict.fromkeys(TK.KERNELS, 0)
    assert TK.PLAIN_ON_CUDA == dict.fromkeys(TK.KERNELS, 0)
    with TK.impl_scope("cuda"), pytest.raises(RuntimeError, match="CUDA"):
        TA.flash_attention(q, q, q, block_q=8, block_k=8)


def test_ops_registered_by_name():
    """flash_attention by name is the port's; dot_product_attention by name
    is the ops/nn.py form, the reference's last registration of the name,
    which agrees with ops/attention.py's on an unmasked call."""
    from deeplearning4j_tpu_torch.ops import nn as TN

    assert registry.get_op("flash_attention").fn is TA.flash_attention
    assert registry.get_op("dotProductAttention").fn is \
        TN.dot_product_attention
    q = torch.randn(1, 1, 8, 8)
    torch.testing.assert_close(
        registry.exec_op("dot_product_attention", q, q, q),
        TA.dot_product_attention(q, q, q), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------ chip_smoke helpers


def _smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("sq,sk", [(5, 7), (7, 5), (6, 6)])
@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
def test_chip_smoke_counts_attended_pairs(causal, sq, sk, masked):
    """The bound counts the (query, key) pairs these inputs attend: the
    causal window and the real keys, none for a fully-masked row."""
    rng = np.random.default_rng(sq * 10 + sk)
    mask = None
    if masked:
        mask = (rng.random((3, sk)) > 0.4).astype(np.float32)
        mask[0] = 0.0
    want = sum(
        1 for b in range(3) for q in range(sq) for k in range(sk)
        if (mask is None or mask[b, k] > 0)
        and (not causal or k <= q + sk - sq))
    assert _smoke().attention_pairs(np, 3, sq, sk, causal, mask) == want


def test_chip_smoke_bound_at_bert_base_geometry():
    """One launch at batch 32, S=512, 12 heads of 64: 25.8 GFLOP, so fp32
    is bound by operations (0.385 ms at 67 TFLOP/s); bf16 by bytes (101 MB
    at 3.35 TB/s against 0.026 ms of bf16 tensor-core time)."""
    smoke = _smoke()
    f32 = smoke.attention_bound(np, 32, 12, 512, 512, 64, False, None, 4,
                                smoke.H100_FP32_FLOPS)
    b16 = smoke.attention_bound(np, 32, 12, 512, 512, 64, False, None, 2,
                                smoke.H100_BF16_FLOPS)
    assert f32["bound_by"] == "operations"
    assert abs(f32["bound_ms"] - 0.3846) < 1e-3
    assert b16["bound_by"] == "bytes" and abs(b16["ops_ms"] - 0.0261) < 1e-3


def test_chip_smoke_profile_leaves_out_range_spans():
    """A record_function range shows on the device as the span of its
    kernels; the profile's busy time counts the kernels only."""
    from types import SimpleNamespace

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def evt(key, device_type, us, count=1):
        return SimpleNamespace(key=key, device_type=device_type, count=count,
                               self_device_time_total=us)

    prof = SimpleNamespace(key_averages=lambda: [
        evt("bert::layer_norm", cpu, 0.0, 25),
        evt("bert::layer_norm", cuda, 6000.0, 25),
        evt("aten::mm", cpu, 0.0, 60),
        evt("sgemm", cuda, 39000.0, 60),
        evt("flash_fwd_f32<64>", cuda, 12000.0, 12),
        evt("layer_norm_reduce", cuda, 5000.0, 50)])
    assert _smoke().device_kernels(torch, prof) == [
        (39.0, 60, "sgemm"), (12.0, 12, "flash_fwd_f32<64>"),
        (5.0, 50, "layer_norm_reduce")]


def test_chip_smoke_checks_each_flash_launch(monkeypatch):
    """The per-launch check holds the flash wrapper's O and LSE against the
    plain version on the call's tensors, counts it under its type, fails
    one that disagrees, and puts the wrapper back."""
    smoke = _smoke()
    q = torch.from_numpy(np.random.default_rng(13).normal(
        size=(2, 2, 16, 8)).astype(np.float32))
    mask = torch.ones((2, 16))
    mask[1] = 0.0
    original = KA.flash_attention_fwd
    checked = {}
    with smoke.check_every_launch(torch, checked):
        KA.flash_attention_fwd(q, q, q, 0.3, False, mask)
        KA.flash_attention_fwd(q.bfloat16(), q.bfloat16(), q.bfloat16(), 0.3,
                               True)
    assert {k: v["calls"] for k, v in checked.items()} == {
        ("flash_attention_fwd", "fp32"): 1, ("flash_attention_fwd", "bf16"): 1}
    assert KA.flash_attention_fwd is original

    def off_by_a_bit(*args, **kwargs):
        o, lse = original(*args, **kwargs)
        return o * 1.001, lse

    monkeypatch.setattr(KA, "flash_attention_fwd", off_by_a_bit)
    with pytest.raises(AssertionError, match="flash_attention_fwd fp32"):
        with smoke.check_every_launch(torch, {}):
            KA.flash_attention_fwd(q, q, q, 0.3, False, mask)


_OPERANDS = [
    # (id, make the operand from a contiguous (2, 3, 16, 8) fp32 tensor, copied)
    ("contiguous", lambda t: t, False),
    ("head-split-view", lambda t: t.permute(0, 2, 1, 3).contiguous()
     .permute(0, 2, 1, 3), False),
    ("expanded-batch", lambda t: t[:1].expand(2, -1, -1, -1), True),
    ("strided-last-dim", lambda t: t.transpose(2, 3), True),
]


@pytest.mark.parametrize("case", _OPERANDS, ids=_ids(_OPERANDS))
def test_kernel_operand_copies_only_what_the_kernel_cannot_read(case):
    """The kernel reads (batch, head, sequence) strides with a contiguous
    head dim, all 16-byte aligned; its bf16 TMA tensor maps also take no
    dim of more than one element at stride 0. A view that keeps to that
    goes in as it is; any other is copied, with the same values."""
    _, make, copied = case
    t = make(torch.arange(2 * 3 * 16 * 8, dtype=torch.float32)
             .reshape(2, 3, 16, 8))
    got = KA._kernel_operand(t)
    assert (got.data_ptr() != t.data_ptr()) is copied
    assert torch.equal(got, t)
    assert got.stride(-1) == 1
    assert all(s != 0 for s, n in zip(got.stride(), got.shape) if n > 1)


def test_chip_smoke_attention_cases_cover_the_kernel_geometries():
    """The smoke's attention_kernel cases: the main path's geometry first
    (batch 8, S 512, heads of 64, no mask), every mask case at S 128 and
    512, D 128, a ragged S no tile divides, and the served (1) and forward
    (32) batches."""
    cases = _smoke().ATTENTION_CASES
    assert cases[0] == (8, 512, 64, "none")
    assert len(set(cases)) == len(cases)
    for s in (128, 512):
        assert {c for b, sq, d, c in cases if (b, sq, d) == (8, s, 64)} == {
            "none", "causal", "padding"}
    assert any(d == 128 for _, _, d, _ in cases)
    assert any(s % 64 for _, s, _, _ in cases)
    assert {1, 32} <= {b for b, _, _, _ in cases}


def test_flash_ablation_variants_apply_to_the_kernel_source():
    """tools/flash_ablation.py makes its variants by editing
    csrc/flash_fwd.cu's text: every edit still finds its anchor, and every
    variant but the source as built differs from it."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / \
        "flash_ablation.py"
    spec = importlib.util.spec_from_file_location("flash_ablation", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src = pathlib.Path(tool.SOURCE).read_text()
    variants = tool.variant_sources(src)
    assert set(variants) == set(tool.VARIANTS)
    assert variants["built"] == src
    assert all(text != src for name, text in variants.items()
               if name != "built")
