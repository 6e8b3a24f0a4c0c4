"""The port's kernels on a CUDA card, against their plain versions.

Every test here is marked ``cuda`` and skips without a card. This file
imports nothing of JAX or of the JAX package, so it also runs where only
the port is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(``--noconftest``: the suite's ``conftest.py`` sets up JAX). Tolerances
are the smoke's: the flash kernel's O within 1e-5 (fp32) or 2^-7 (bf16,
P is rounded to bf16 before P @ V) of the largest plain output, its LSE
within 1e-5 relative, a fully-masked row exactly O = 0 and LSE = -1e30;
the LSTM cell kernel's h' and c', and the LSTM segment kernel's y, carries
and final state, within 1e-5 (fp32: the same fp32 sums in another order)
or 2^-7 (bf16: both round the same fp32 values to bf16, a tie may fall the
other way, two ulps of headroom) of the largest output; a
whole network within 1e-4 relative of the same network on the CPU; the
conv kernel's forward within rtol/atol 1e-4 (fp32) or rtol 8e-3 + atol
1e-4 (bf16: two bf16 ulps) of its plain version, its dgrad and the wgrad
kernel's dW within 1e-4 (fp32) or 2^-7 (bf16) of the largest plain output
(PERF.md §2); LeNet's fit against the CPU's within 1e-4, its score within
1e-5 (``-k lenet``: the conv kernels at LeNet's geometries and LeNet on
the card). The compiled step (``-k capture``, ``nn/capture.py``): a
captured run against the eager run of the same net from the same state,
equal to the bit wherever two eager runs are, the launch counters under
replay, a host sync inside a step failing its capture by name, dropout
under replay.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_tpu_torch.data import DataSet  # noqa: E402
from deeplearning4j_tpu_torch.nn import capture  # noqa: E402
from deeplearning4j_tpu_torch.nn.updaters import Adam  # noqa: E402
from deeplearning4j_tpu_torch.ops import attention as TA  # noqa: E402
from deeplearning4j_tpu_torch.ops import kernels as TK  # noqa: E402
from deeplearning4j_tpu_torch.nn.transformer import (  # noqa: E402
    TransformerEncoderBlock)
from deeplearning4j_tpu_torch.ops.kernels import attention as KA  # noqa: E402
from deeplearning4j_tpu_torch.ops.kernels import conv as KC  # noqa: E402
from deeplearning4j_tpu_torch.ops.kernels import lstm as KL  # noqa: E402
from deeplearning4j_tpu_torch.zoo import Bert, TextGenerationLSTM  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs the same checks "
                    "on the H100")
    TK.reset_counts()
    return torch.device("cuda")


# (id, B, H, Sq, Sk, D, causal, padding mask with batch row 1 fully masked)
_FLASH_CASES = [
    ("d40", 2, 3, 100, 100, 40, False, True),
    ("d64", 2, 3, 100, 100, 64, True, True),
    ("d72", 2, 3, 100, 100, 72, False, True),
    ("d128", 2, 3, 100, 100, 128, True, True),
    ("s1", 2, 3, 1, 1, 64, False, False),
    ("s63", 2, 3, 63, 63, 64, True, False),
    ("s65", 2, 3, 65, 65, 128, False, True),
    ("s512", 2, 3, 512, 512, 64, False, True),
    ("s1000", 2, 2, 1000, 1000, 64, True, True),
    ("causal-sq-lt-sk", 2, 3, 63, 200, 64, True, False),
    ("causal-sq-gt-sk", 2, 3, 200, 63, 64, True, True),
    ("causal-sq-gt-sk-d128", 2, 3, 130, 65, 128, True, False),
    ("bh384", 32, 12, 64, 64, 64, False, False),
]


@pytest.mark.parametrize("case", _FLASH_CASES, ids=[c[0] for c in _FLASH_CASES])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2.0 ** -7)],
                         ids=["fp32", "bf16"])
def test_flash_kernel_matches_plain(card, dtype, tol, case):
    """K5 on q, k, v as three distinct projections' transposed views (B, S,
    H, D) -> (B, H, S, D), across head dims, ragged lengths, a key offset
    either way under the causal mask, a padding mask with a fully-masked
    batch row, and B*H = 384: O within ``tol`` of the largest plain value,
    the LSE within 1e-5 relative, rows with no key exactly O = 0 and LSE =
    -1e30."""
    _, b, h, sq, sk, d, causal, masked = case
    rng = np.random.default_rng(sq * 1000 + sk + d)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, n, h, d), np.float32))
               .to(card, dtype).permute(0, 2, 1, 3) for n in (sq, sk, sk))
    mask = None
    if masked:
        lens = rng.integers(1, sk + 1, size=b)
        mask = torch.from_numpy((np.arange(sk)[None, :] < lens[:, None])
                                .astype(np.float32)).to(card)
        mask[1] = 0.0
    o, lse = KA.flash_attention_fwd(q, k, v, d ** -0.5, causal, mask)
    ro, rl = KA.flash_attention_fwd_reference(q, k, v, d ** -0.5, causal,
                                              mask)
    assert TK.LAUNCHES["flash_attention_fwd"] == 1
    assert o.shape == ro.shape and o.dtype == dtype
    err = (o.float() - ro.float()).abs().max() / ro.float().abs().max()
    assert float(err) <= tol
    dead = rl <= -1e29
    assert torch.equal(lse[dead], rl[dead])
    assert torch.equal(o.float()[dead], torch.zeros_like(o.float()[dead]))
    if masked:
        assert bool(dead[1].all())
    live = ~dead
    assert float((lse - rl)[live].abs().max()) <= 1e-5 * max(
        float(rl[live].abs().max()), 1.0)


def test_flash_attention_on_card_launches_the_kernel(card):
    """``flash_attention`` on a CUDA tensor launches K5 and never the plain
    version; ``exact`` takes the plain version and counts it."""
    q = torch.randn((2, 2, 64, 32), device=card)
    with TK.impl_scope("auto"):
        o = TA.flash_attention(q, q, q)
    with TK.impl_scope("exact"):
        ref = TA.flash_attention(q, q, q)
    assert TK.LAUNCHES["flash_attention_fwd"] == 1
    assert TK.PLAIN_ON_CUDA["flash_attention_fwd"] == 1
    assert float((o - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_bert_tiny_on_card_matches_cpu(card):
    """The whole slice on the card, the flash kernel forced, against the
    same net on the CPU, with a ragged padding mask."""
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, 30522, size=(4, 16))
    x = np.stack([tokens, np.zeros_like(tokens)], axis=-1).astype(np.float32)
    mask = np.ones((4, 16), np.float32)
    mask[1, 9:] = 0.0
    mask[2, 1:] = 0.0
    cpu = Bert.tiny(max_length=16, flash=True).init(device="cpu")
    gpu = Bert.tiny(max_length=16, flash=True).init(device=card)
    got = gpu.output(x, mask=mask).cpu().numpy()
    assert TK.LAUNCHES["flash_attention_fwd"] == 2  # one per encoder block
    np.testing.assert_allclose(got, cpu.output(x, mask=mask).numpy(),
                               rtol=1e-4, atol=1e-6)


def test_flash_kernel_refuses_inputs_that_need_grad(card):
    """The raw launch's output would carry no grad_fn: with grad enabled and
    an input that requires grad it raises, naming the FlashAttention
    Function; with grad off it runs. ``flash_attention`` on such inputs
    goes through the Function: its O has a grad_fn, and the kernel
    launched once more."""
    q = torch.randn((1, 2, 32, 16), device=card, requires_grad=True)
    with pytest.raises(NotImplementedError, match="FlashAttention"):
        KA.flash_attention_fwd(q, q, q, 0.25, False)
    with torch.no_grad():
        KA.flash_attention_fwd(q, q, q, 0.25, False)
    assert TK.LAUNCHES["flash_attention_fwd"] == 1
    o = TA.flash_attention(q, q, q, scale=0.25)
    assert o.grad_fn is not None
    assert TK.LAUNCHES["flash_attention_fwd"] == 2


# (id, B, H, S, D, causal, padding mask with batch row 1 fully masked)
_FLASH_BWD_CASES = [
    ("plain", 2, 3, 128, 64, False, False),
    ("causal", 2, 3, 100, 64, True, False),
    ("padding", 3, 2, 130, 64, False, True),
    ("causal-padding-d128", 2, 2, 96, 128, True, True),
]


@pytest.mark.parametrize("case", _FLASH_BWD_CASES,
                         ids=[c[0] for c in _FLASH_BWD_CASES])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2.0 ** -6)],
                         ids=["fp32", "bf16"])
def test_flash_function_grads_on_card_match_cpu(card, dtype, tol, case):
    """The FlashAttention Function on the card (K5's forward, the plain
    backward on its O and LSE) against the same Function on the CPU (the
    plain forward): dq, dk, dv within ``tol`` of the largest CPU gradient.
    fp32: the same fp32 arithmetic in another order (2e-5); bf16: K5 rounds
    P to bf16 before P @ V, so the saved O, and delta = sum(dO * O) with
    it, differ by up to a bf16 step, and each gradient rounds once to bf16:
    2^-6 (four bf16 steps)."""
    _, b, h, s, d, causal, masked = case
    rng = np.random.default_rng(s)
    arrays = [rng.normal(size=(b, s, h, d)).astype(np.float32)
              for _ in range(4)]
    mask = None
    if masked:
        lens = rng.integers(s // 4, s + 1, size=b)
        lens[1] = 0
        mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.float32)

    def grads(dev):
        q, k, v, do = (torch.from_numpy(a).to(dev).to(dtype)
                       .permute(0, 2, 1, 3) for a in arrays)
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
        m = None if mask is None else torch.from_numpy(mask).to(dev)
        o = TA.flash_attention(q, k, v, causal=causal, mask=m)
        o.backward(do)
        return [t.grad.float().cpu() for t in (q, k, v)]

    got = grads(card)
    torch.cuda.synchronize()
    assert TK.LAUNCHES["flash_attention_fwd"] == 1
    for name, g, r in zip("qkv", got, grads("cpu")):
        err = (g - r).abs().max() / r.abs().max()
        assert float(err) <= tol, f"d{name}: {float(err)}"
        if masked:
            assert not g[1].any()


def test_bert_tiny_fit_step_on_card_matches_cpu(card):
    """One Adam step of ``Bert.tiny`` (flash forced, dropout off, Adam at
    epsilon 1e-3: at 1e-8 the first step moves each entry by lr in the
    direction of its gradient, which rounding picks where a gradient is
    near 0; ROADMAP.md Queue 3) on a ragged masked batch: the card (K5 in
    both blocks, the Function's backward) against the CPU, loss and params
    within 1e-4 relative."""
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, 30522, size=(4, 32))
    x = np.stack([tokens, np.zeros_like(tokens)], axis=-1).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[[0, 1, 1, 0]]
    mask = np.ones((4, 32), np.float32)
    mask[1, 20:] = 0.0
    mask[2, 3:] = 0.0
    nets = [Bert.tiny(max_length=32, flash=True, hidden_dropout=0.0,
                      updater=Adam(1e-3, epsilon=1e-3)).init(device=dev)
            for dev in ("cpu", card)]
    for net in nets:
        net.fit(DataSet(x, y, features_mask=mask))
    torch.cuda.synchronize()
    assert TK.LAUNCHES["flash_attention_fwd"] == 2
    assert not any(TK.PLAIN_ON_CUDA.values())
    cpu, gpu = nets
    np.testing.assert_allclose(gpu.get_score(), cpu.get_score(), rtol=1e-4)
    for pc, pg in zip(cpu.params, gpu.params):
        for k in pc:
            np.testing.assert_allclose(pg[k].cpu().numpy(), pc[k].numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("order", ["ifog", "iofg"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2.0 ** -7)],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,h", [(32, 256), (4, 256), (5, 37)])
def test_lstm_cell_kernel_matches_plain(card, dtype, tol, order, b, h):
    """K4 on a strided time slice of a (B, T, 4H) projection, against its
    plain version on the same tensors."""
    ordr = KL.ORDER_IFOG if order == "ifog" else KL.ORDER_IOFG
    gen = torch.Generator(device=card).manual_seed(b * h)
    xp_seq = torch.randn((b, 3, 4 * h), device=card, generator=gen).to(dtype)
    hh = (0.5 * torch.randn((b, h), device=card, generator=gen)).to(dtype)
    c = torch.randn((b, h), device=card, generator=gen).to(dtype)
    u = (torch.randn((h, 4 * h), device=card, generator=gen)
         / h ** 0.5).to(dtype)
    xp = xp_seq[:, 1]
    assert not xp.is_contiguous()
    got = KL.lstm_cell_fwd(xp, hh, c, u, ordr)
    ref = KL.lstm_cell_reference(xp, hh, c, u, ordr)
    torch.cuda.synchronize()
    assert TK.LAUNCHES["lstm_cell_fwd"] == 1
    for g, r in zip(got, ref):
        assert g.dtype == dtype and g.shape == (b, h)
        err = (g.float() - r.float()).abs().max() / r.float().abs().max()
        assert float(err) <= tol


def test_char_rnn_on_card_matches_cpu(card):
    """A narrow TextGenerationLSTM (dropout 0, TBPTT 4 over 10 steps):
    three fit calls and a few rnn_time_step calls on the card, every LSTM
    segment one K4 launch (H 16: the step body), against the same net on
    the CPU."""
    rng = np.random.default_rng(3)
    eye = np.eye(11, dtype=np.float32)
    nets = {}
    for dev in ("cpu", card):
        net = TextGenerationLSTM(total_unique_characters=11, units=16,
                                 dropout=0.0).init(device=dev)
        net.conf.tbptt_length = 4
        nets[str(dev)] = net
    cpu, gpu = nets["cpu"], nets[str(card)]
    for _ in range(3):
        ids = rng.integers(0, 11, size=(3, 11))
        x, y = eye[ids[:, :-1]], eye[ids[:, 1:]]
        gpu.fit(x, y)
        cpu.fit(x, y)
        np.testing.assert_allclose(gpu.get_score(), cpu.get_score(),
                                   rtol=1e-4)
    # 3 fit calls x 3 segments (4, 4, 2 steps) x 2 layers
    assert TK.LAUNCHES["lstm_seq_fwd"] == 3 * 3 * 2
    assert TK.PLAIN_ON_CUDA["lstm_seq_fwd"] == 0
    assert TK.LAUNCHES["lstm_cell_fwd"] == 0
    for pg, pc in zip(gpu.params, cpu.params):
        for k in pc:
            np.testing.assert_allclose(pg[k].cpu().numpy(), pc[k].numpy(),
                                       rtol=1e-4, atol=1e-6)
    x = eye[rng.integers(0, 11, size=(2, 4))]
    for t in range(4):
        np.testing.assert_allclose(gpu.rnn_time_step(x[:, t]).cpu().numpy(),
                                   cpu.rnn_time_step(x[:, t]).numpy(),
                                   rtol=1e-4, atol=1e-6)
    assert TK.LAUNCHES["lstm_seq_fwd"] == 3 * 3 * 2 + 2 * 4


# (B, H, T): the char-RNN's training segment and sampling step, a batch
# under one n8 tile, a batch over one cluster's rows, H 512 (bf16: two m16
# tiles a column block; fp32: the step body), and H 100 (the step body)
_SEQ_CASES = [(32, 256, 50), (4, 256, 1), (3, 256, 7), (33, 256, 5),
              (32, 512, 10), (5, 100, 6), (3, 6, 4)]


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
@pytest.mark.parametrize("order", ["ifog", "iofg"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2.0 ** -7)],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,h,t", _SEQ_CASES,
                         ids=[f"b{b}-h{h}-t{t}" for b, h, t in _SEQ_CASES])
def test_lstm_seq_kernel_matches_plain(card, dtype, tol, order, b, h, t,
                                       masked):
    """K4's segment entry on the body ``seq_body`` names, xp a strided
    window of a longer projection, with a ragged mask or none: y, the h and
    c carries and the final state within ``tol`` of the plain version's
    largest output, written into blocks the allocator first handed out full
    of NaN (an element left unwritten shows), and equal to the bit over two
    launches."""
    ordr = KL.ORDER_IFOG if order == "ifog" else KL.ORDER_IOFG
    gen = torch.Generator(device=card).manual_seed(b * h + t)
    xp_all = torch.randn((b, t + 2, 4 * h), device=card, generator=gen)
    xp = xp_all.to(dtype)[:, 1:t + 1]
    h0 = (0.5 * torch.randn((b, h), device=card, generator=gen)).to(dtype)
    c0 = torch.randn((b, h), device=card, generator=gen).to(dtype)
    u = (torch.randn((h, 4 * h), device=card, generator=gen)
         / h ** 0.5).to(dtype)
    mask = None
    if masked:
        lengths = torch.randint(1, t + 1, (b,), device=card, generator=gen)
        mask = (torch.arange(t, device=card)[None]
                < lengths[:, None]).float()
    body = KL.seq_body(dtype, b, h)
    assert body == ("step" if h in (100, 6) or (h == 512 and dtype ==
                                                torch.float32)
                    else "resident")
    ref = KL.lstm_seq_reference(xp, h0, c0, u, ordr, mask)
    poison = [torch.full(r.shape, float("nan"), dtype=dtype, device=card)
              for r in ref]
    ptrs = {q.data_ptr() for q in poison}
    del poison  # the blocks go back to the cache and come out as outputs
    got = KL.lstm_seq_fwd(xp, h0, c0, u, ordr, mask)
    again = KL.lstm_seq_fwd(xp, h0, c0, u, ordr, mask)
    torch.cuda.synchronize()
    assert got[0].data_ptr() in ptrs
    assert TK.LAUNCHES["lstm_seq_fwd"] == 2
    assert TK.BODY_LAUNCHES == {f"lstm_seq_fwd/{body}": 2}
    assert (got[1] is got[0]) == (mask is None)
    for g, a, r in zip(got, again, ref):
        assert g.dtype == dtype and g.shape == r.shape
        assert bool(torch.isfinite(g.float()).all())
        assert torch.equal(g, a)
        err = (g.float() - r.float()).abs().max() / r.float().abs().max()
        assert float(err) <= tol


def test_lstm_layer_fit_step_auto_matches_exact(card):
    """One TBPTT segment's loss and gradients of a TextGenerationLSTM of 256
    units (the resident body, a ragged batch of 5 over two clusters) under
    ``auto`` against ``exact`` on the card: loss within 1e-5, each gradient
    within 1e-4 of its size (relative L2); 2 K4 launches, none plain."""
    rng = np.random.default_rng(8)
    eye = np.eye(11, dtype=np.float32)
    net = TextGenerationLSTM(total_unique_characters=11, units=256,
                             dropout=0.0).init(device=card)
    ids = rng.integers(0, 11, size=(5, 13))
    x = torch.from_numpy(eye[ids[:, :-1]]).to(card)
    y = torch.from_numpy(eye[ids[:, 1:]]).to(card)
    ones = torch.ones(5, device=card)
    l_auto, g_auto, _, _ = net._gradients(None, x, y, ones)
    assert TK.LAUNCHES["lstm_seq_fwd"] == 2
    assert TK.BODY_LAUNCHES == {"lstm_seq_fwd/resident": 2}
    with TK.impl_scope("exact"):
        l_exact, g_exact, _, _ = net._gradients(None, x, y, ones)
    assert TK.LAUNCHES["lstm_seq_fwd"] == 2
    assert TK.PLAIN_ON_CUDA["lstm_seq_fwd"] == 2
    assert abs(float(l_auto) - float(l_exact)) <= 1e-5 * abs(float(l_exact))
    assert g_auto.keys() == g_exact.keys()
    for i, layer in g_exact.items():
        for k, ge in layer.items():
            rel = (g_auto[i][k] - ge).norm() / ge.norm().clamp_min(1e-30)
            assert float(rel) <= 1e-4, (i, k)


# (id, N, H, W, Cin, k, stride, Cout, body in bf16): ResNet-50 geometries at a
# small batch: a 1x1 stride-1 with Og 64 (the wgmma body's 64-wide tile), a
# 3x3 stride-1 with Og 256 (its 128-wide tile), a 1x1 stride-2 (dgrad: three
# tapless phases of four), a 3x3 stride-2 on 7x7-odd and 14x14 edges, and
# the stem (Cin 3: the mma.sync body)
_CONV_CASES = [
    ("1x1s1-og64", 2, 56, 56, 256, 1, 1, 64, "wgmma"),
    ("3x3s1-og256", 2, 14, 14, 256, 3, 1, 256, "wgmma"),
    ("1x1s2", 2, 28, 28, 512, 1, 2, 256, "wgmma"),
    ("3x3s2-14", 2, 14, 14, 128, 3, 2, 128, "wgmma"),
    ("3x3s1-7", 4, 7, 7, 512, 3, 1, 512, "wgmma"),
    ("stem", 1, 224, 224, 3, 7, 2, 64, "mma_sync"),
]
_CONV_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (8e-3, 1e-4)}
_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}


def _conv_inputs(card, dtype, case):
    _, n, h, w, cin, k, s, cout, _ = case
    gen = torch.Generator(device=card).manual_seed(n * h * cin + k * cout)
    x = torch.randn((n, h, w, cin), device=card, generator=gen)
    wt = torch.randn((k, k, cin, cout), device=card, generator=gen) * (
        2.0 / (k * k * cin)) ** 0.5
    pads = KC.resolve_padding("SAME", (h, w), (k, k), (s, s), (1, 1))
    return x.to(dtype), wt.to(dtype), (s, s), pads


@pytest.mark.parametrize("case", _CONV_CASES, ids=[c[0] for c in _CONV_CASES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_conv_fwd_kernel_matches_plain(card, dtype, case):
    """The conv forward on the body the plan picks (fp32: FMA; bf16: wgmma
    where Cg and Og are multiples of 64, mma.sync for the stem)."""
    x, w, strides, pads = _conv_inputs(card, dtype, case)
    body = "fma" if dtype == torch.float32 else case[-1]
    assert KC.fwd_plan(x, w, strides, pads, (1, 1), 1)[2] == body
    got = KC.conv2d_fwd(x, w, strides, pads, (1, 1), 1)
    ref = KC.conv2d_fwd_reference(x, w, strides, pads, (1, 1), 1)
    torch.cuda.synchronize()
    assert TK.LAUNCHES["conv2d_fwd"] == 1
    assert TK.BODY_LAUNCHES == {f"conv2d_fwd/{body}": 1}
    assert got.dtype == dtype and got.shape == ref.shape
    rtol, atol = _CONV_TOL[dtype]
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("case", _CONV_CASES, ids=[c[0] for c in _CONV_CASES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_conv_dgrad_kernel_matches_plain(card, dtype, case):
    """dx by stride phase in one launch, against the plain dilate-and-convolve
    version, on a result block the allocator first handed out full of NaN:
    a phase that wrote nothing would leave NaN behind."""
    _, n, h, w_, cin, k, s, cout, _ = case
    _, w, strides, pads = _conv_inputs(card, dtype, case)
    oh, ow = -(-h // s), -(-w_ // s)
    gen = torch.Generator(device=card).manual_seed(7)
    dy = torch.randn((n, oh, ow, cout), device=card, generator=gen).to(dtype)
    # dgrad's GEMM reduces over Cout into Cin: the stem's Cin 3 is mma.sync's
    body = ("fma" if dtype == torch.float32 else
            "wgmma" if cin % 64 == 0 and cout % 64 == 0 else "mma_sync")
    assert KC.dgrad_plan(dy, w, (h, w_), strides, pads, (1, 1), 1)[2] == body
    ref = KC.conv2d_dgrad_reference(dy, w, (h, w_), strides, pads, (1, 1), 1)
    poison = torch.full((n, h, w_, cin), float("nan"), dtype=dtype,
                        device=card)
    del poison  # its block goes back to the cache and comes out as dx
    got = KC.conv2d_dgrad(dy, w, (h, w_), strides, pads, (1, 1), 1)
    torch.cuda.synchronize()
    assert TK.LAUNCHES["conv2d_dgrad"] == 1
    assert TK.BODY_LAUNCHES == {f"conv2d_dgrad/{body}": 1}
    assert got.shape == ref.shape and bool(torch.isfinite(got).all())
    err = (got.float() - ref.to(dtype).float()).abs().max()
    assert float(err / ref.float().abs().max()) <= _GRAD_TOL[dtype]


# (id, N, H, W, Cin, k, stride, Cout, groups, body in bf16): _CONV_CASES at
# one group, then what only wgrad's tiles meet: 7x7 at batch 1 (P = 49, less
# than one 64-position chunk), kh*kw*Cin 64 (the consumers split the tile
# over N) with Cout 256 and with Cout 64 (one consumer has no columns), a 3x3
# from 64 channels (576 filter rows: the last 128-row tile half empty), and
# two groups of 64 (the mma.sync body)
_WGRAD_CASES = [c[:8] + (1, c[8]) for c in _CONV_CASES] + [
    ("7x7-n1", 1, 7, 7, 512, 1, 1, 2048, 1, "wgmma"),
    ("r64-og256", 2, 56, 56, 64, 1, 1, 256, 1, "wgmma"),
    ("r64-og64", 1, 56, 56, 64, 1, 1, 64, 1, "wgmma"),
    ("3x3-cg64", 2, 28, 28, 64, 3, 1, 64, 1, "wgmma"),
    ("groups2", 2, 14, 14, 128, 3, 1, 128, 2, "mma_sync"),
]


@pytest.mark.parametrize("case", _WGRAD_CASES,
                         ids=[c[0] for c in _WGRAD_CASES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_conv_wgrad_kernel_matches_plain(card, dtype, case):
    """dW on the body the plan reports (fp32: FMA; bf16: wgmma for one group
    of Cin and Cout multiples of 64, else mma.sync), against the plain
    version within 1e-4 (fp32) or 2^-7 (bf16, compared in bf16 as the
    layer sees it) of the largest output, on a result block the allocator
    first handed out full of NaN (an element left unwritten shows), and
    equal to the bit over two runs (the split slices are summed in a fixed
    order)."""
    _, n, h, w_, cin, k, s, cout, groups, bf16_body = case
    gen = torch.Generator(device=card).manual_seed(n * h * cin + k * cout)
    oh, ow = -(-h // s), -(-w_ // s)
    x = torch.randn((n, h, w_, cin), device=card, generator=gen).to(dtype)
    dy = torch.randn((n, oh, ow, cout), device=card, generator=gen).to(dtype)
    pads = KC.resolve_padding("SAME", (h, w_), (k, k), (s, s), (1, 1))
    body = "fma" if dtype == torch.float32 else bf16_body
    assert KC.wgrad_body(dtype, x.shape, dy.shape, (k, k), (s, s), pads,
                         (1, 1), groups) == body
    assert KC.wgrad_plan(x, dy, k, k, (s, s), pads, (1, 1), groups)[1] == body
    ref = KC.conv2d_wgrad_reference(x, dy, k, k, (s, s), pads, (1, 1),
                                    groups)
    poison = torch.full(ref.shape, float("nan"), device=card)
    del poison  # its block goes back to the cache and comes out as dW
    got = KC.conv2d_wgrad(x, dy, k, k, (s, s), pads, (1, 1), groups)
    again = KC.conv2d_wgrad(x, dy, k, k, (s, s), pads, (1, 1), groups)
    torch.cuda.synchronize()
    assert TK.LAUNCHES["conv2d_wgrad"] == 2
    assert TK.BODY_LAUNCHES == {f"conv2d_wgrad/{body}": 2}
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, again)
    err = (got.to(dtype).float() - ref.to(dtype).float()).abs().max()
    assert float(err / ref.to(dtype).float().abs().max()) <= \
        _GRAD_TOL[dtype]


# Xception's depthwise convs (3x3, stride 1, SAME, one channel a group, as
# SeparableConvolution2D launches them): (H = W, C) of its nine geometries
# at 299x299, run at batch 8; the bf16 body is mma.sync (Cg = Og = 1)
_DEPTHWISE = [(150, 64), (150, 128), (75, 128), (75, 256), (38, 256),
              (38, 728), (19, 728), (10, 1024), (10, 1536)]


@pytest.mark.parametrize("hw,c", _DEPTHWISE,
                         ids=[f"{h}x{h}x{c}" for h, c in _DEPTHWISE])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_depthwise_kernels_match_plain(card, dtype, hw, c):
    """K1, dgrad and K3 at groups = C against their plain versions: each
    result into a block the allocator first handed out full of NaN, the
    forward within the conv tolerances, dgrad and dW within 1e-4 (fp32) or
    2^-7 (bf16) of the largest plain output, and dW equal to the bit over
    two runs."""
    n, k = 8, 3
    gen = torch.Generator(device=card).manual_seed(hw * c)
    x = torch.randn((n, hw, hw, c), device=card, generator=gen).to(dtype)
    w = (torch.randn((k, k, 1, c), device=card, generator=gen) / 3).to(dtype)
    dy = torch.randn((n, hw, hw, c), device=card, generator=gen).to(dtype)
    pads = KC.resolve_padding("SAME", (hw, hw), (k, k), (1, 1), (1, 1))
    geo = ((1, 1), pads, (1, 1), c)
    body = "fma" if dtype == torch.float32 else "mma_sync"
    assert KC.fwd_plan(x, w, *geo)[2] == body
    assert KC.dgrad_plan(dy, w, (hw, hw), *geo)[2] == body
    assert KC.wgrad_plan(x, dy, k, k, *geo)[1] == body

    def poison(shape, dt=dtype):
        # a NaN block, back in the cache for the next result of its size
        torch.full(shape, float("nan"), dtype=dt, device=card)

    poison(x.shape)
    got = KC.conv2d_fwd(x, w, *geo)
    ref = KC.conv2d_fwd_reference(x, w, *geo)
    rtol, atol = _CONV_TOL[dtype]
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol,
                               atol=atol)
    del got
    ref = KC.conv2d_dgrad_reference(dy, w, (hw, hw), *geo)
    poison(x.shape)
    got = KC.conv2d_dgrad(dy, w, (hw, hw), *geo)
    assert got.shape == ref.shape and bool(torch.isfinite(got).all())
    err = (got.float() - ref.to(dtype).float()).abs().max()
    assert float(err / ref.float().abs().max()) <= _GRAD_TOL[dtype]
    ref = KC.conv2d_wgrad_reference(x, dy, k, k, *geo)
    poison(ref.shape, torch.float32)
    got = KC.conv2d_wgrad(x, dy, k, k, *geo)
    again = KC.conv2d_wgrad(x, dy, k, k, *geo)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (k, k, 1, c)
    assert bool(torch.isfinite(got).all()) and torch.equal(got, again)
    err = (got.to(dtype).float() - ref.to(dtype).float()).abs().max()
    assert float(err / ref.to(dtype).float().abs().max()) <= \
        _GRAD_TOL[dtype]
    assert TK.LAUNCHES["conv2d_fwd"] == TK.LAUNCHES["conv2d_dgrad"] == 1
    assert TK.LAUNCHES["conv2d_wgrad"] == 2
    assert TK.BODY_LAUNCHES == {f"conv2d_fwd/{body}": 1,
                                f"conv2d_dgrad/{body}": 1,
                                f"conv2d_wgrad/{body}": 2}


# MobileNetV2's stride-2 depthwise convs (3x3, VALID after ZeroPadding2D
# ((0, 1), (0, 1)), one channel a group): (padded H = W, C) at 224x224,
# and a depth_multiplier-2 case (two outputs a group) at stride 2 and 1
_DEPTHWISE_S2 = [(113, 96, 1, 2, "VALID"), (57, 144, 1, 2, "VALID"),
                 (29, 192, 1, 2, "VALID"), (15, 576, 1, 2, "VALID"),
                 (28, 32, 2, 2, "VALID"), (14, 32, 2, 1, "SAME")]


@pytest.mark.parametrize(
    "hw,c,mult,stride,padding", _DEPTHWISE_S2,
    ids=[f"{h}x{h}x{c}-m{m}-s{s}" for h, c, m, s, _ in _DEPTHWISE_S2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_depthwise_stride2_kernels_match_plain(card, dtype, hw, c, mult,
                                               stride, padding):
    """K1, dgrad (by stride phase) and K3 at groups = C, stride 2, against
    their plain versions, as test_depthwise_kernels_match_plain holds them
    at stride 1: results into NaN blocks, dgrad and dW within 1e-4 (fp32)
    or 2^-7 (bf16) of the largest plain output, dW equal to the bit over
    two runs, one launch a call."""
    n, k = 4, 3
    gen = torch.Generator(device=card).manual_seed(hw * c + mult)
    x = torch.randn((n, hw, hw, c), device=card, generator=gen).to(dtype)
    w = (torch.randn((k, k, 1, c * mult), device=card, generator=gen)
         / 3).to(dtype)
    s = (stride, stride)
    pads = KC.resolve_padding(padding, (hw, hw), (k, k), s, (1, 1))
    oh = (hw + sum(pads[0]) - k) // stride + 1
    dy = torch.randn((n, oh, oh, c * mult), device=card,
                     generator=gen).to(dtype)
    geo = (s, pads, (1, 1), c)

    def poison(shape, dt=dtype):
        torch.full(shape, float("nan"), dtype=dt, device=card)

    poison((n, oh, oh, c * mult))
    got = KC.conv2d_fwd(x, w, *geo)
    ref = KC.conv2d_fwd_reference(x, w, *geo)
    rtol, atol = _CONV_TOL[dtype]
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol,
                               atol=atol)
    del got
    ref = KC.conv2d_dgrad_reference(dy, w, (hw, hw), *geo)
    poison(x.shape)
    got = KC.conv2d_dgrad(dy, w, (hw, hw), *geo)
    assert got.shape == ref.shape and bool(torch.isfinite(got).all())
    err = (got.float() - ref.to(dtype).float()).abs().max()
    assert float(err / ref.float().abs().max()) <= _GRAD_TOL[dtype]
    ref = KC.conv2d_wgrad_reference(x, dy, k, k, *geo)
    poison(ref.shape, torch.float32)
    got = KC.conv2d_wgrad(x, dy, k, k, *geo)
    again = KC.conv2d_wgrad(x, dy, k, k, *geo)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (k, k, 1, c * mult)
    assert bool(torch.isfinite(got).all()) and torch.equal(got, again)
    err = (got.to(dtype).float() - ref.to(dtype).float()).abs().max()
    assert float(err / ref.to(dtype).float().abs().max()) <= \
        _GRAD_TOL[dtype]
    assert TK.LAUNCHES["conv2d_fwd"] == TK.LAUNCHES["conv2d_dgrad"] == 1
    assert TK.LAUNCHES["conv2d_wgrad"] == 2
    assert not any(TK.PLAIN_ON_CUDA.values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_conv_dgrad_tapless_phases_write_zeros(card, dtype):
    """A 1x1 stride-2 dgrad: the three phases with no tap must overwrite
    the NaN the allocator's block held with zeros."""
    n, h, cin, cout = 2, 14, 128, 64
    w = torch.randn((1, 1, cin, cout), device=card).to(dtype)
    dy = torch.randn((n, 7, 7, cout), device=card).to(dtype)
    poison = torch.full((n, h, h, cin), float("nan"), dtype=dtype,
                        device=card)
    ptr = poison.data_ptr()
    del poison
    got = KC.conv2d_dgrad(dy, w, (h, h), (2, 2), ((0, 0), (0, 0)), (1, 1),
                          1)
    torch.cuda.synchronize()
    assert got.data_ptr() == ptr  # the poisoned block came back
    for r, c in ((0, 1), (1, 0), (1, 1)):
        assert bool((got[:, r::2, c::2] == 0).all())
    ref = KC.conv2d_dgrad_reference(dy, w, (h, h), (2, 2), ((0, 0), (0, 0)),
                                    (1, 1), 1)
    err = (got.float() - ref.to(dtype).float()).abs().max()
    assert float(err / ref.float().abs().max()) <= _GRAD_TOL[dtype]


def test_conv_row_tile_on_every_body(card):
    """K2's row_tile: no M tile crosses a segment of row_tile output rows,
    on the wgmma body as on the others."""
    x32 = torch.randn((2, 56, 56, 64), device=card)
    w32 = torch.randn((3, 3, 64, 64), device=card) / 24
    pads = KC.resolve_padding("SAME", (56, 56), (3, 3), (1, 1), (1, 1))
    for dtype, body in ((torch.float32, "fma"), (torch.bfloat16, "wgmma")):
        x, w = x32.to(dtype), w32.to(dtype)
        got = KC.conv2d_fwd(x, w, (1, 1), pads, (1, 1), 1, row_tile=7)
        ref = KC.conv2d_fwd_reference(x, w, (1, 1), pads, (1, 1), 1)
        rtol, atol = _CONV_TOL[dtype]
        torch.testing.assert_close(got.float(), ref.float(), rtol=rtol,
                                   atol=atol)
        assert TK.BODY_LAUNCHES.get(f"conv2d_fwd/{body}") == 1


@pytest.mark.parametrize("head_dim", [100, 256])
def test_encoder_block_auto_takes_exact_where_flash_refuses(card, head_dim):
    """flash="auto" on the card at a head dim the kernel has no body for
    gives exact attention, no flash launch and no error; flash=True
    raises, naming the head dim."""
    hidden = 4 * head_dim
    params, _ = TransformerEncoderBlock(hidden_size=hidden, n_heads=4) \
        .initialize(torch.Generator().manual_seed(0), (64, hidden))
    params = {k: v.to(card) for k, v in params.items()}
    x = torch.randn((2, 64, hidden), device=card)
    auto = TransformerEncoderBlock(hidden_size=hidden, n_heads=4)
    exact = TransformerEncoderBlock(hidden_size=hidden, n_heads=4,
                                    flash=False)
    got, _ = auto.apply(params, {}, x)
    want, _ = exact.apply(params, {}, x)
    assert TK.LAUNCHES["flash_attention_fwd"] == 0
    assert torch.equal(got, want)
    forced = TransformerEncoderBlock(hidden_size=hidden, n_heads=4,
                                     flash=True)
    with pytest.raises(ValueError, match=f"head dim {head_dim}"):
        forced.apply(params, {}, x)


# (id, N, H, Cin, Cout): LeNet-5's two convs (5x5 VALID, stride 1) at the
# training batch (64) and the ragged last batch of its epochs (32): conv1
# takes Cin 1 (25 taps in all, not a multiple of mma.sync's k16), Cout 20
# and 50 are no multiples of 8 (the unvectorised gathers); conv2's dgrad is
# a VALID conv re-padded by 4 on an 8x8 dy. Every bf16 launch is mma.sync
# (no channel count is a multiple of 64).
_LENET_CONVS = [("conv1-n64", 64, 28, 1, 20), ("conv2-n64", 64, 12, 20, 50),
                ("conv1-n32", 32, 28, 1, 20), ("conv2-n32", 32, 12, 20, 50)]


def _poisoned(shape, dtype, card):
    """Hand a NaN-filled block back to the allocator: the next result of
    this size comes out in it, so an element left unwritten shows."""
    poison = torch.full(shape, float("nan"), dtype=dtype, device=card)
    del poison


@pytest.mark.parametrize("case", _LENET_CONVS, ids=[c[0] for c in _LENET_CONVS])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_lenet_conv_kernels_match_plain(card, dtype, case):
    """K1's forward, its dgrad (conv2 only: conv1 reads the input, which
    needs no gradient) and K3 at LeNet's geometries: into NaN-filled
    blocks, within the smoke's tolerances of the plain versions, on the
    body the plan names, equal to the bit on a second launch."""
    _, n, h, cin, cout = case
    gen = torch.Generator(device=card).manual_seed(n * h + cin)
    x = torch.rand((n, h, h, cin), device=card, generator=gen).to(dtype)
    w = (torch.randn((5, 5, cin, cout), device=card, generator=gen)
         * (2.0 / (25 * cin)) ** 0.5).to(dtype)
    oh = h - 4
    dy = torch.randn((n, oh, oh, cout), device=card, generator=gen).to(dtype)
    pads, one = ((0, 0), (0, 0)), (1, 1)
    body = "fma" if dtype == torch.float32 else "mma_sync"
    assert KC.fwd_plan(x, w, one, pads, one, 1)[2] == body
    assert KC.wgrad_plan(x, dy, 5, 5, one, pads, one, 1)[1] == body

    _poisoned((n, oh, oh, cout), dtype, card)
    y = KC.conv2d_fwd(x, w, one, pads, one, 1)
    y2 = KC.conv2d_fwd(x, w, one, pads, one, 1)
    ref = KC.conv2d_fwd_reference(x, w, one, pads, one, 1)
    _poisoned((5, 5, cin, cout), torch.float32, card)
    dw = KC.conv2d_wgrad(x, dy, 5, 5, one, pads, one, 1)
    dw2 = KC.conv2d_wgrad(x, dy, 5, 5, one, pads, one, 1)
    dw_ref = KC.conv2d_wgrad_reference(x, dy, 5, 5, one, pads, one, 1)
    torch.cuda.synchronize()
    rtol, atol = _CONV_TOL[dtype]
    assert bool(torch.isfinite(y).all()) and torch.equal(y, y2)
    torch.testing.assert_close(y.float(), ref.float(), rtol=rtol, atol=atol)
    assert bool(torch.isfinite(dw).all()) and torch.equal(dw, dw2)
    err = (dw.to(dtype).float() - dw_ref.to(dtype).float()).abs().max()
    assert float(err / dw_ref.to(dtype).float().abs().max()) <= \
        _GRAD_TOL[dtype]
    launches = {"conv2d_fwd": 2, "conv2d_wgrad": 2}
    if cin > 1:
        assert KC.dgrad_plan(dy, w, (h, h), one, pads, one, 1)[2] == body
        _poisoned((n, h, h, cin), dtype, card)
        dx = KC.conv2d_dgrad(dy, w, (h, h), one, pads, one, 1)
        dx2 = KC.conv2d_dgrad(dy, w, (h, h), one, pads, one, 1)
        dx_ref = KC.conv2d_dgrad_reference(dy, w, (h, h), one, pads, one, 1)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(dx).all()) and torch.equal(dx, dx2)
        err = (dx.float() - dx_ref.to(dtype).float()).abs().max()
        assert float(err / dx_ref.float().abs().max()) <= _GRAD_TOL[dtype]
        launches["conv2d_dgrad"] = 2
    assert {k: v for k, v in TK.LAUNCHES.items() if v} == launches
    assert not any(TK.PLAIN_ON_CUDA.values())


def test_lenet_fit_and_evaluate_on_card_match_cpu(card):
    """LeNet from the zoo (the same params on both devices: init draws on
    the CPU) over 64 + 32 + 64 random digits with Adam: per-step losses and
    the params within 1e-4 of the CPU's, 2 / 1 / 2 conv launches a step
    (fwd / dgrad / wgrad), none plain; then ``score`` within 1e-5 and
    ``evaluate`` counting all 50 rows, its predictions the CPU's wherever
    the CPU's top two probabilities are more than 1e-4 apart."""
    from deeplearning4j_tpu_torch.data import ArrayDataSetIterator
    from deeplearning4j_tpu_torch.zoo import LeNet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(5)
    gpu, cpu = LeNet().init(device=card), LeNet().init(device="cpu")
    for n in (64, 32, 64):
        x = rng.random((n, 28, 28, 1), dtype=np.float32)
        y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]
        gpu.fit(x, y)
        cpu.fit(x, y)
        np.testing.assert_allclose(gpu.get_score(), cpu.get_score(),
                                   rtol=1e-4)
    assert TK.LAUNCHES["conv2d_fwd"] == 2 * 3
    assert TK.LAUNCHES["conv2d_dgrad"] == 3
    assert TK.LAUNCHES["conv2d_wgrad"] == 2 * 3
    assert not any(TK.PLAIN_ON_CUDA.values())
    for pg, pc in zip(gpu.params, cpu.params):
        for k in pc:
            np.testing.assert_allclose(pg[k].cpu().numpy(), pc[k].numpy(),
                                       rtol=1e-4, atol=1e-6)
    x = rng.random((50, 28, 28, 1), dtype=np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 50)]
    np.testing.assert_allclose(gpu.score(x=x, y=y), cpu.score(x=x, y=y),
                               rtol=1e-5)
    ev = gpu.evaluate(ArrayDataSetIterator(x, y, batch=16))
    assert ev.confusion_matrix().sum() == 50
    p_g = torch.cat([gpu.output(x[i:i + 16]) for i in range(0, 50, 16)])
    p_g, p_c = p_g.cpu().numpy(), cpu.output(x).numpy()
    top2 = np.sort(p_c, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-4
    assert clear.sum() >= 45
    np.testing.assert_array_equal(p_g.argmax(1)[clear], p_c.argmax(1)[clear])
    want = np.zeros((10, 10), np.int64)
    np.add.at(want, (y.argmax(1), p_g.argmax(1)), 1)
    np.testing.assert_array_equal(ev.confusion_matrix(), want)


def test_graph_listeners_early_stopping_and_regression_on_card(card):
    """What the LeNet slice added beyond LeNet, on CUDA tensors: a
    ComputationGraph's listeners at sync_every 3 (the same calls as on the
    CPU, scores within 1e-4), EarlyStoppingTrainer driving that graph (its
    best model on the card re-scores to its recorded score within 1e-6),
    and a MultiLayerNetwork's ``evaluate_regression`` (within 1e-5 of the
    CPU's)."""
    from deeplearning4j_tpu_torch import earlystopping as es
    from deeplearning4j_tpu_torch.data import ArrayDataSetIterator
    from deeplearning4j_tpu_torch.nn import (ComputationGraph,
                                             MultiLayerNetwork,
                                             NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf import InputType
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.listeners import CollectScoresListener

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(8)
    x = rng.normal(size=(50, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 50)]

    def graph(dev):
        gb = (NeuralNetConfiguration.builder().seed(4).sync_every(3)
              .updater({"@updater": "Sgd", "learning_rate": 0.3})
              .graph_builder().add_inputs("in"))
        gb.add_layer("d", DenseLayer(n_out=8, activation="tanh"), "in")
        gb.add_layer("out", OutputLayer(n_in=8, n_out=3), "d")
        return ComputationGraph(gb.set_outputs("out").set_input_types(
            InputType.feed_forward(5)).build()).init(device=dev)

    calls = {}
    for dev in ("cpu", card):
        g = graph(dev)
        collect = CollectScoresListener(1)
        g.set_listeners(collect)
        g.fit(ArrayDataSetIterator(x, y, batch=16, shuffle=True), epochs=2)
        calls[str(dev)] = collect.scores
    cpu, gpu = calls["cpu"], calls[str(card)]
    assert [c[0] for c in gpu] == [c[0] for c in cpu] == list(range(1, 9))
    np.testing.assert_allclose([c[1] for c in gpu], [c[1] for c in cpu],
                               rtol=1e-4)

    test = ArrayDataSetIterator(x[:20], y[:20], batch=8)
    cfg = (es.EarlyStoppingConfiguration.builder()
           .score_calculator(es.DataSetLossCalculator(test))
           .epoch_termination_conditions(
               es.MaxEpochsTerminationCondition(2)).build())
    res = es.EarlyStoppingTrainer(cfg, graph(card), ArrayDataSetIterator(
        x, y, batch=16, shuffle=True)).fit()
    best = res.best_model
    assert all(t.is_cuda for p in best.params.values() for t in p.values())
    rescored = es.DataSetLossCalculator(test).calculate_score(best)
    assert abs(rescored - res.best_model_score) <= \
        1e-6 * abs(res.best_model_score)

    evs = []
    for dev in ("cpu", card):
        conf = (NeuralNetConfiguration.builder().seed(5).list()
                .layer(DenseLayer(n_out=8, activation="tanh"))
                .layer(OutputLayer(n_in=8, n_out=3, loss="mse",
                                   activation="identity"))
                .set_input_type(InputType.feed_forward(5)).build())
        net = MultiLayerNetwork(conf).init(device=dev)
        evs.append(net.evaluate_regression(ArrayDataSetIterator(x, y,
                                                                batch=16)))
    for m in ("mean_squared_error", "mean_absolute_error", "r_squared"):
        np.testing.assert_allclose(getattr(evs[1], m)(), getattr(evs[0], m)(),
                                   rtol=1e-5)


# ---------------------------------------------------- the recurrent slice


def _recurrent_layer(kind):
    from deeplearning4j_tpu_torch.nn import layers as TL
    from deeplearning4j_tpu_torch.nn import recurrent as TR

    return {
        "graves": (TR.GravesLSTM(n_in=8, n_out=32), (4, 9, 8)),
        "gru": (TR.GRU(n_in=8, n_out=32, recurrent_bias=True), (4, 9, 8)),
        "bidir-lstm": (TR.Bidirectional(layer=TR.LSTM(n_in=8, n_out=256)),
                       (4, 9, 8)),
        "pool-max": (TL.GlobalPoolingLayer(pooling_type="max"), (4, 9, 8)),
        "convlstm": (TR.ConvLSTM2D(n_in=2, n_out=8), (2, 3, 8, 8, 2)),
    }[kind]


@pytest.mark.parametrize("kind", ["graves", "gru", "bidir-lstm", "pool-max",
                                  "convlstm"])
def test_recurrent_layers_on_card_match_cpu(card, kind):
    """A new recurrent layer on CUDA tensors against the same layer on the
    CPU (the same params, a right-padded ragged mask: Bidirectional's
    reversed mask starts with masked steps, which must keep K4's zero
    state): the output within 1e-4 and the gradients (the params', and
    the input's but ConvLSTM2D's) within 1e-3 of the largest CPU value;
    Bidirectional(LSTM) launches K4 once a direction, ConvLSTM2D (T 3)
    the conv kernel once on the B*T images and once a step, and in its
    backward a wgrad for each of those 4 convs and a dgrad for each
    recurrent conv after the first; none plain."""
    from deeplearning4j_tpu_torch import tree as ttree

    layer, shape = _recurrent_layer(kind)
    gen = torch.Generator().manual_seed(7)
    params = layer.initialize(gen, shape[1:])[0]
    x = torch.randn(shape, generator=gen)
    mask = (torch.arange(shape[1])[None]
            < torch.tensor([shape[1], 2, 5, 1][:shape[0]])[:, None]).float()
    outs = []
    for dev in ("cpu", card):
        TK.reset_counts()
        p = ttree.tree_map(lambda v: v.to(dev).requires_grad_(True), params)
        xx = x.to(dev).requires_grad_(kind != "convlstm")
        y, _ = layer.apply(p, {}, xx, mask=mask.to(dev))
        leaves = ttree.tree_leaves(p) + ([xx] if xx.requires_grad else [])
        gs = torch.autograd.grad(y.square().sum(), leaves, allow_unused=True)
        outs.append((y.detach().cpu(), [None if g is None else g.cpu()
                                        for g in gs]))
    (y_c, g_c), (y_g, g_g) = outs
    assert float((y_g - y_c).abs().max()) <= 1e-4 * float(y_c.abs().max())
    for a, b in zip(g_g, g_c):
        assert (a is None) == (b is None)
        if b is not None:
            assert float((a - b).abs().max()) <= 1e-3 * float(
                b.abs().max())
    want = {"bidir-lstm": {"lstm_seq_fwd": 2},
            "convlstm": {"conv2d_fwd": 4, "conv2d_wgrad": 4,
                         "conv2d_dgrad": 2}}.get(kind, {})
    assert {k: v for k, v in TK.LAUNCHES.items() if v} == want
    assert not any(TK.PLAIN_ON_CUDA.values())


def test_masked_graph_fit_and_tbptt_on_card_match_cpu(card):
    """A masked sequence graph (Bidirectional LSTM -> masked average ->
    OutputLayer) and a TBPTT graph (LSTM -> RnnOutputLayer, k 4 over 10
    steps) trained on the card and on the CPU from the same params: losses
    and params within 1e-4; K4 twice a masked step, once a segment."""
    from deeplearning4j_tpu_torch.nn import (ComputationGraph,
                                             NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn import layers as TL
    from deeplearning4j_tpu_torch.nn import recurrent as TR
    from deeplearning4j_tpu_torch.tree import tree_items

    def graph(kind, dev):
        gb = (NeuralNetConfiguration.builder().seed(5)
              .updater(Adam(1e-2, epsilon=1e-3)).graph_builder()
              .add_inputs("in"))
        if kind == "pool":
            gb.add_layer("bi", TR.Bidirectional(layer=TR.LSTM(n_in=6,
                                                             n_out=32)),
                         "in")
            gb.add_layer("pool", TL.GlobalPoolingLayer(), "bi")
            gb.add_layer("out", TL.OutputLayer(n_in=64, n_out=2), "pool")
        else:
            gb.add_layer("lstm", TR.LSTM(n_in=6, n_out=32), "in")
            gb.add_layer("out", TR.RnnOutputLayer(n_in=32, n_out=3), "lstm")
            gb.tbptt_length(4)
        conf = gb.set_outputs("out").set_input_types((10, 6)).build()
        return ComputationGraph(conf).init(device=dev)

    rng = np.random.default_rng(2)
    x = rng.normal(size=(5, 10, 6)).astype(np.float32)
    m = (np.arange(10)[None] < np.array([10, 3, 7, 1, 9])[:, None]).astype(
        np.float32)
    for kind, y, per_fit in (
            ("pool", np.eye(2, dtype=np.float32)[[0, 1, 1, 0, 1]], 2),
            ("tbptt", np.eye(3, dtype=np.float32)[rng.integers(0, 3, (5, 10))],
             3)):
        nets = [graph(kind, "cpu"), graph(kind, card)]
        TK.reset_counts()
        for _ in range(3):
            for net in nets:
                net.fit(DataSet(x, y, m, m if kind == "tbptt" else None))
            np.testing.assert_allclose(nets[1].get_score(),
                                       nets[0].get_score(), rtol=1e-4)
        assert TK.LAUNCHES["lstm_seq_fwd"] == 3 * per_fit
        assert not any(TK.PLAIN_ON_CUDA.values())
        for name, tree in nets[0].params.items():
            for path, v in tree_items(tree):
                got = dict(tree_items(nets[1].params[name]))[path]
                np.testing.assert_allclose(got.cpu().numpy(), v.numpy(),
                                           rtol=1e-4, atol=1e-6)


# ------------------------------------------------------ the compiled step


def _state_of(net):
    """Every param, layer state and optimizer state, copied to the host."""
    from deeplearning4j_tpu_torch.tree import tree_items

    return [t.detach().float().cpu().clone() for _, t in tree_items(
        {"p": net.params, "s": net.states, "o": net.opt_states})]


def _run(make, batches, fit, eager):
    net = make()
    losses = []
    with capture.disabled() if eager else contextlib.nullcontext():
        for b in batches:
            fit(net, b)
            losses.append(torch.as_tensor(net.score_value).float().cpu())
    torch.cuda.synchronize()
    return net, [torch.stack(losses)] + _state_of(net)


def _gate(make, batches, fit=lambda n, b: n.fit(*b)):
    """Eager twice, then captured, each from ``make()``'s state: where the
    two eager runs agree to the bit the captured run must too, elsewhere it
    may be no farther from eager than eager is from its repeat. Returns
    the captured net."""
    _, e1 = _run(make, batches, fit, True)
    _, e2 = _run(make, batches, fit, True)
    net, c = _run(make, batches, fit, False)

    def dist(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a, b))

    rep, cap = dist(e1, e2), dist(e1, c)
    assert cap <= rep, (cap, rep)
    assert net.programs() and all(p.graph is not None
                                  for p in net.programs().values())
    return net


def _dense_net(dev, dropout=0.3, dtype="float32"):
    from deeplearning4j_tpu_torch.nn import (MultiLayerNetwork,
                                             NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn import layers as TL
    from deeplearning4j_tpu_torch.nn.updaters import updater_from_dict

    step = {"@schedule": "StepSchedule", "initial_value": 1e-2,
            "decay_rate": 0.5, "step": 2}
    conf = (NeuralNetConfiguration.builder().seed(6)
            .updater(updater_from_dict({"@updater": "Adam",
                                        "learning_rate": step,
                                        "epsilon": 1e-3}))
            .compute_dtype(dtype).list()
            .layer(TL.DenseLayer(n_in=16, n_out=64, activation="tanh"))
            .layer(TL.BatchNormalization())
            .layer(TL.DenseLayer(n_in=64, n_out=32, activation="relu",
                                 dropout=dropout))
            .layer(TL.OutputLayer(n_in=32, n_out=5))
            .set_input_type((16,)).build())
    return MultiLayerNetwork(conf).init(device=dev)


def _dense_batches(n=4, b=32):
    rng = np.random.default_rng(12)
    return [(rng.normal(size=(b, 16)).astype(np.float32),
             np.eye(5, dtype=np.float32)[rng.integers(0, 5, b)])
            for _ in range(n)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_capture_mln_step_and_forward_equal_eager(card, dtype):
    """Adam under a step schedule, batchnorm, dropout 0.3: 4 captured
    steps against eager; then the captured forward (train and inference)
    against the eager forward of the same net, bf16 included (the params
    are cast inside the forward's graph, so a replay after ``fit`` sees the
    updated params)."""
    batches = _dense_batches()
    net = _gate(lambda: _dense_net(card, dtype=dtype), batches)
    assert len(net._aot_steps) == 1
    x = batches[0][0]
    for train in (False, True):
        got = net.output(x, train=train)
        with capture.disabled():
            want = net.output(x, train=train)
        assert torch.equal(got, want)
    net.fit(*batches[1])
    with capture.disabled():
        want = net.output(x)
    assert torch.equal(net.output(x), want)  # a replay after the update


def test_capture_dropout_draws_the_eager_masks(card):
    """Dropout 0.5, 6 steps: the generator registered on the graph makes
    each replay draw the eager step's masks, and leaves the generator
    where the eager run leaves it."""
    batches = _dense_batches(6)
    make = lambda: _dense_net(card, dropout=0.5)  # noqa: E731
    net = _gate(make, batches)
    eager = make()
    with capture.disabled():
        for b in batches:
            eager.fit(*b)
    assert torch.equal(net._gen.get_state(), eager._gen.get_state())
    plain = _dense_net(card, dropout=0.0)
    with capture.disabled():
        plain.fit(*batches[0])
    first = make()
    first.fit(*batches[0])
    assert plain.get_score() != first.get_score()  # dropout is on


def test_capture_graph_per_input_masks_and_tbptt_equal_eager(card):
    """A two-input graph (LSTM on K4 and GRU, each its own mask) and the
    char-RNN's TBPTT (k 4 over 10 steps: programs for 4 and for the ragged
    2, the carries through their static buffers; dropout 0.2)."""
    from deeplearning4j_tpu_torch.data import MultiDataSet
    from deeplearning4j_tpu_torch.nn import (ComputationGraph,
                                             NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn import recurrent as TR

    def graph():
        gb = (NeuralNetConfiguration.builder().seed(5)
              .updater(Adam(1e-2, epsilon=1e-3)).graph_builder()
              .add_inputs("a", "b")
              .add_layer("ra", TR.LSTM(n_in=6, n_out=32), "a")
              .add_layer("rb", TR.GRU(n_in=3, n_out=32), "b")
              .add_layer("out", TR.RnnOutputLayer(n_in=64, n_out=3),
                         "ra", "rb"))
        conf = gb.set_outputs("out").set_input_types((10, 6),
                                                     (10, 3)).build()
        return ComputationGraph(conf).init(device=card)

    rng = np.random.default_rng(3)
    batches = []
    for _ in range(4):
        ma = (np.arange(10)[None] < rng.integers(1, 11, (5, 1))).astype(
            np.float32)
        mb = (np.arange(10)[None] < rng.integers(1, 11, (5, 1))).astype(
            np.float32)
        ma[0], mb[0] = 1.0, 1.0
        batches.append(MultiDataSet(
            [rng.normal(size=(5, 10, 6)).astype(np.float32),
             rng.normal(size=(5, 10, 3)).astype(np.float32)],
            [np.eye(3, dtype=np.float32)[rng.integers(0, 3, (5, 10))]],
            [ma, mb], [ma * mb]))
    g = _gate(graph, batches, lambda n, b: n.fit(b))
    assert len(g._aot_steps) == 1

    def char_net():
        net = TextGenerationLSTM(total_unique_characters=11, units=16,
                                 dropout=0.2).init(device=card)
        net.conf.tbptt_length = 4
        return net

    eye = np.eye(11, dtype=np.float32)
    ids = [rng.integers(0, 11, size=(3, 11)) for _ in range(3)]
    net = _gate(char_net, [(eye[i[:, :-1]], eye[i[:, 1:]]) for i in ids])
    assert len(net._tbptt_steps) == 2


def test_capture_replays_count_their_launches(card):
    """The counters count the launches that ran: a program's warm-up and
    capture add nothing, each replay adds one step's launches (LeNet: 2 /
    1 / 2 conv launches a step; the char-RNN: one K4 launch a segment and
    layer), none plain."""
    from deeplearning4j_tpu_torch.zoo import LeNet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(5)
    net = LeNet().init(device=card)
    TK.reset_counts()
    x = rng.random((16, 28, 28, 1), dtype=np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 16)]
    for _ in range(3):
        net.fit(x, y)
    torch.cuda.synchronize()
    assert {k: v for k, v in TK.LAUNCHES.items() if v} == {
        "conv2d_fwd": 6, "conv2d_dgrad": 3, "conv2d_wgrad": 6}
    (prog,) = net._aot_steps.values()
    assert prog.replays == 3 and prog.counts[0] == {
        "conv2d_fwd": 2, "conv2d_dgrad": 1, "conv2d_wgrad": 2}
    net.output(x)
    net.output(x)
    assert TK.LAUNCHES["conv2d_fwd"] == 6 + 2 * 2
    TK.reset_counts()
    char = TextGenerationLSTM(total_unique_characters=11, units=16,
                              dropout=0.0).init(device=card)
    char.conf.tbptt_length = 4
    eye = np.eye(11, dtype=np.float32)
    for _ in range(3):
        ids = rng.integers(0, 11, size=(3, 11))
        char.fit(eye[ids[:, :-1]], eye[ids[:, 1:]])
    torch.cuda.synchronize()
    assert TK.LAUNCHES["lstm_seq_fwd"] == 3 * 3 * 2
    assert not any(TK.PLAIN_ON_CUDA.values())


def test_capture_fails_by_name_on_a_host_sync(card, monkeypatch):
    """A loss that reads itself on the host (``float``) inside the step:
    the warm-up runs, the capture raises CaptureError naming the function,
    the signature and the line; nothing carries on eagerly, and the net
    still trains eagerly afterwards."""
    from deeplearning4j_tpu_torch.nn import layers as TL

    orig = TL.OutputLayer.compute_loss

    def syncing(self, *a, **k):
        loss = orig(self, *a, **k)
        float(loss)  # a host sync: the capture cannot hold it
        return loss

    monkeypatch.setattr(TL.OutputLayer, "compute_loss", syncing)
    net = _dense_net(card)
    x, y = _dense_batches(1)[0]
    it = net.iteration
    with pytest.raises(capture.CaptureError) as e:
        net.fit(x, y)
    msg = str(e.value)
    assert "MultiLayerNetwork.train_step" in msg and "float(loss)" in msg
    assert "(32, 16)" in msg
    assert net.iteration == it and not net._aot_steps
    with capture.disabled():
        net.fit(x, y)
    assert net.iteration == it + 1 and np.isfinite(net.get_score())


def test_capture_collects_dead_nets_outside_the_capture(card, monkeypatch):
    """A net whose step was captured, then dropped: it sits in a reference
    cycle (net -> program -> body -> net), so only the cyclic collector
    frees it. Another net's step is then captured with a hook inside the
    captured body that drops the last reference and collects wherever the
    collector is on, as the collector may at any allocation. The capture
    keeps it off, so the dead net's graph and pinned buffers are freed after
    the capture, not inside it (inside, that invalidates the capture: CUDA
    error 901 at the next launch, as a ResNet-50 step captured after the
    smoke's capture phases once failed), and the step's loss is the eager
    step's within 1e-5."""
    import gc
    import weakref

    from deeplearning4j_tpu_torch.nn import layers as TL

    x, y = _dense_batches(1)[0]
    dead = [_dense_net(card)]
    dead[0].fit(x, y)
    assert dead[0]._aot_steps
    gone = weakref.ref(dead[0])
    orig = TL.OutputLayer.compute_loss
    seen = []

    def collecting(self, *a, **k):
        if torch.cuda.is_current_stream_capturing():
            dead.clear()
            seen.append(gc.isenabled())
            if gc.isenabled():
                gc.collect()
        return orig(self, *a, **k)

    monkeypatch.setattr(TL.OutputLayer, "compute_loss", collecting)
    net, ref = _dense_net(card), _dense_net(card)
    net.fit(x, y)
    assert seen == [False] and gc.isenabled() and net._aot_steps
    gc.collect()
    assert gone() is None
    with capture.disabled():
        ref.fit(x, y)
    assert np.isclose(net.get_score(), ref.get_score(), rtol=1e-5)


# ----------------------------------------------------------- the op table

def _op_cases():
    from deeplearning4j_tpu_torch.ops import op_cases

    return op_cases, op_cases.build(0)


_OC, _CASES = _op_cases()


def _run_case(name, case, device):
    import deeplearning4j_tpu_torch.ops as ops

    return _OC.to_numpy(_OC.run(
        ops.exec_op, name, case,
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(device),
        lambda k: torch.Generator(device=device).manual_seed(k.seed)))


@pytest.mark.parametrize("name", sorted(_CASES))
def test_op_table_on_card_matches_cpu(card, name):
    """Every op by name on CUDA tensors against the same call on the CPU,
    to its family's tolerance (op_cases.TOLERANCES); random ops by their
    moments."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    case = _CASES[name]
    _OC.compare(case, _run_case(name, case, card), _run_case(name, case,
                                                              "cpu"))
    assert not any(TK.PLAIN_ON_CUDA.values())


# (op, {kernel: launches of its case}), worked out in
# op_cases.KERNEL_LAUNCHES
_KERNEL_OPS = sorted(_OC.KERNEL_LAUNCHES.items())


@pytest.mark.parametrize("name,want", _KERNEL_OPS,
                         ids=[n for n, _ in _KERNEL_OPS])
def test_kernel_ops_by_name_launch_their_kernels(card, name, want):
    TK.reset_counts()
    _run_case(name, _CASES[name], card)
    torch.cuda.synchronize()
    assert {k: v for k, v in TK.LAUNCHES.items() if v} == want
    assert not any(TK.PLAIN_ON_CUDA.values())
    with TK.impl_scope("exact"):
        TK.reset_counts()
        _run_case(name, _CASES[name], card)
        assert not any(TK.LAUNCHES.values())


@pytest.mark.parametrize("layout", [0, 1])
@pytest.mark.parametrize("direction", ["forward", "reverse",
                                       "bidirectional"])
def test_lstm_layer_grads_on_card_match_cpu(card, direction, layout):
    """``lstm_layer`` by name on the card (K4 once a direction, inside
    ``LSTMSequenceFunction``) is differentiable: with ragged seq_lens and
    initial states, its outputs and the gradients of x, W, R, b, h0 and c0
    against the plain step loop's on the CPU, within 1e-4 of the largest
    gradient (fp32: the kernel's sums in another order)."""
    import deeplearning4j_tpu_torch.ops as ops

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(31)
    d = 2 if direction == "bidirectional" else 1
    t_, b_, i_, h_ = 9, 6, 5, 32
    lens = np.array([9, 1, 4, 7, 9, 2], np.int32)
    x = rng.standard_normal((t_, b_, i_) if layout == 0 else (b_, t_, i_))
    states = (d, b_, h_) if layout == 0 else (b_, d, h_)
    args = [x, rng.standard_normal((d, 4 * h_, i_)) * 0.3,
            rng.standard_normal((d, 4 * h_, h_)) * 0.2,
            rng.standard_normal((d, 8 * h_)) * 0.1, lens,
            rng.standard_normal(states), rng.standard_normal(states)]
    kw = dict(hidden_size=h_, direction=direction, layout=layout)

    def run(dev):
        ts = [torch.from_numpy(np.asarray(
            a, np.float32 if a.dtype != np.int32 else np.int32)).to(dev)
              for a in args]
        for i in (0, 1, 2, 3, 5, 6):
            ts[i].requires_grad_(True)
        TK.reset_counts()
        outs = ops.exec_op("lstm_layer", *ts, **kw)
        crng = np.random.default_rng(32)
        sum((o * torch.from_numpy(crng.standard_normal(o.shape).astype(
            np.float32)).to(dev)).sum() for o in outs).backward()
        launched = dict(TK.LAUNCHES)
        return ([o.detach().cpu() for o in outs],
                [ts[i].grad.cpu() for i in (0, 1, 2, 3, 5, 6)], launched)

    outs, grads, launched = run(card)
    assert launched["lstm_seq_fwd"] == d
    assert not any(TK.PLAIN_ON_CUDA.values())
    want_outs, want_grads, _ = run("cpu")
    for g, w in zip(outs + grads, want_outs + want_grads):
        assert float((g - w).abs().max()) <= 1e-4 * max(
            float(w.abs().max()), 1.0)


def test_serializer_round_trip_on_card(card, tmp_path):
    """A LeNet trained on the card, archived and restored onto the card
    (bit for bit) and onto the CPU (within 1e-5)."""
    from deeplearning4j_tpu_torch.util import ModelSerializer
    from deeplearning4j_tpu_torch.zoo import LeNet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(2)
    x = rng.random((16, 28, 28, 1), dtype=np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 16)]
    net = LeNet().init(device=card)
    net.fit(x, y)
    path = str(tmp_path / "lenet.zip")
    ModelSerializer.write_model(net, path)
    back = ModelSerializer.restore_multi_layer_network(path)
    assert back.device.type == "cuda"
    written = net.output(x)
    assert torch.equal(back.output(x), written)
    cpu = ModelSerializer.restore_multi_layer_network(path, device="cpu")
    torch.testing.assert_close(cpu.output(x).float(),
                               written.float().cpu(), rtol=1e-4, atol=1e-5)
    back.fit(x, y)
    net.fit(x, y)
    assert back.get_score() == net.get_score()


# ---------------------------------------------------- SameDiff on the card


def _sd_conv_lstm_graph(device):
    """A SameDiff graph with a conv (K1; dgrad and K3 in its gradient) and
    an ``lstm_layer`` (K4 once): x (2, 8, 8, 4) -> conv 3x3 -> 6 channels
    -> reshape to (T 8, B 2, 48) -> LSTM 16 -> sum of squares."""
    from deeplearning4j_tpu_torch.samediff import SameDiff

    rng = np.random.default_rng(4)
    sd = SameDiff(device=device)
    x = sd.placeholder("x", shape=(2, 8, 8, 4))
    w = sd.var("w", (rng.standard_normal((3, 3, 4, 6)) * 0.2)
               .astype(np.float32))
    h = sd.cnn.conv2d(x, w, padding="SAME")
    h = sd.nn.tanh(h)
    seq = sd.math.permute(sd.math.reshape(h, shape=(2, 8, 48)),
                          axes=(1, 0, 2))
    W = sd.var("W", (rng.standard_normal((1, 64, 48)) * 0.1)
               .astype(np.float32))
    R = sd.var("R", (rng.standard_normal((1, 64, 16)) * 0.1)
               .astype(np.float32))
    y, _, _ = sd.rnn.lstmLayer(seq, W, R, hidden_size=16)
    loss = sd.math.sum(y * y)
    sd.set_loss_variables(loss)
    return sd, y, rng.standard_normal((2, 8, 8, 4)).astype(np.float32)


def test_samediff_conv_lstm_on_card_match_cpu(card):
    """output and calculate_gradients of the graph on the card (captured
    programs) against the CPU within 1e-4 of the largest value, and the
    kernels each launched: K1 once a forward, K4 once; in the gradient K1,
    dgrad, K3 and K4 once each (the input needs no gradient, the LSTM's
    backward is plain)."""
    sd_gpu, y, xv = _sd_conv_lstm_graph("cuda")
    sd_cpu, _, _ = _sd_conv_lstm_graph("cpu")
    TK.reset_counts()
    out = sd_gpu.output({"x": xv}, [y.name])[y.name]
    torch.cuda.synchronize()
    fwd = dict(TK.LAUNCHES)
    ref = sd_cpu.output({"x": xv}, [y.name])[y.name]
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())
    assert fwd["conv2d_fwd"] == 1 and fwd["lstm_seq_fwd"] == 1, fwd
    TK.reset_counts()
    g = sd_gpu.calculate_gradients({"x": xv}, "w", "W", "R")
    torch.cuda.synchronize()
    launches = dict(TK.LAUNCHES)
    want = sd_cpu.calculate_gradients({"x": xv}, "w", "W", "R")
    for k in want:
        np.testing.assert_allclose(g[k], want[k], rtol=0,
                                   atol=1e-4 * np.abs(want[k]).max())
    assert launches["conv2d_fwd"] == 1 and launches["conv2d_wgrad"] == 1
    assert launches["conv2d_dgrad"] == 0 and launches["lstm_seq_fwd"] == 1
    assert not any(TK.PLAIN_ON_CUDA.values()), TK.PLAIN_ON_CUDA
    progs = sd_gpu.programs()
    assert progs and all(p.eager is None and p.graph is not None
                         for p in progs.values())


def test_samediff_instances_share_a_captured_program(card):
    """Two graphs of one structure with different weights share one
    captured output program; each gets its own answer, bit-equal to its
    eager run."""
    from deeplearning4j_tpu_torch.samediff import SameDiff

    rng = np.random.default_rng(5)

    def build(wv):
        sd = SameDiff(device="cuda")
        x = sd.placeholder("x", shape=(4, 8))
        w = sd.var("w", wv)
        sd.math.tanh(x @ w, name_out="y")
        return sd

    a = build(rng.standard_normal((8, 3)).astype(np.float32))
    b = build(rng.standard_normal((8, 3)).astype(np.float32))
    xv = rng.standard_normal((4, 8)).astype(np.float32)
    ya, yb = (s.output({"x": xv}, ["y"])["y"] for s in (a, b))
    (pa,), (pb,) = a.programs().values(), b.programs().values()
    assert pa is pb and pa.graph is not None
    with capture.disabled():
        ea, eb = (s.output({"x": xv}, ["y"])["y"] for s in (a, b))
    np.testing.assert_array_equal(ya, ea)
    np.testing.assert_array_equal(yb, eb)
    assert not np.array_equal(ya, yb)


def test_samediff_while_runs_eagerly_on_card(card):
    """A ``__cf_while__`` graph runs on the card eagerly by its stated
    rule (its program carries the reason and holds no CUDA graph)."""
    from deeplearning4j_tpu_torch.samediff import SameDiff

    cond = SameDiff(device="cpu")
    ci = cond.placeholder("i", shape=(), dtype=np.int32)
    ca = cond.placeholder("a", shape=(3,))
    cout = cond._op("less", [ci, cond.constant(np.int32(5), "lim")])
    body = SameDiff(device="cpu")
    bi = body.placeholder("i", shape=(), dtype=np.int32)
    ba = body.placeholder("a", shape=(3,))
    i2 = body._op("add", [bi, body.constant(np.int32(1), "one")])
    a2 = body._op("multiply", [ba, body.constant(np.float32(2.0), "two")])
    sd = SameDiff(device="cuda")
    x = sd.placeholder("x", shape=(3,))
    _, acc = sd.while_loop_graph(cond, [ci, ca], cout, body, [bi, ba],
                                 [i2, a2], sd.constant(np.int32(0), "i0"), x)
    xv = np.asarray([1.0, -2.0, 0.5], np.float32)
    out = sd.output({"x": xv}, [acc.name])[acc.name]
    np.testing.assert_array_equal(out, xv * 32.0)
    (prog,) = sd.programs().values()
    assert prog.eager and "__cf_while__" in prog.eager and prog.graph is None


# ------------------------------------------------------------ the conv zoo


def _xception_small(dev, dtype="float32"):
    """Xception at 32x32 with one middle repeat (13 separable convs: 26
    K1 launches, 6 plain convs), Adam(1e-3, epsilon 1e-3)."""
    from deeplearning4j_tpu_torch.zoo import Xception

    return Xception(num_classes=5, input_shape=(32, 32, 3),
                    middle_repeats=1, compute_dtype=dtype,
                    updater={"@updater": "Adam", "learning_rate": 1e-3,
                             "epsilon": 1e-3}).init(device=dev)


def _xception_batches(n=3, b=8):
    rng = np.random.default_rng(15)
    return [(rng.normal(size=(b, 32, 32, 3)).astype(np.float32),
             np.eye(5, dtype=np.float32)[rng.integers(0, 5, b)])
            for _ in range(n)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_capture_xception_step_equals_eager(card, dtype):
    """Three captured Xception steps against eager, bit for bit where two
    eager runs are (_gate); under replay each step launches 32 K1, 32 K3
    and 31 dgrad (the stem reads the input), none plain."""
    batches = _xception_batches()
    net = _gate(lambda: _xception_small(card, dtype), batches)
    TK.reset_counts()
    net.fit(*batches[0])
    torch.cuda.synchronize()
    assert {k: TK.LAUNCHES[k] for k in ("conv2d_fwd", "conv2d_wgrad",
                                        "conv2d_dgrad")} == {
        "conv2d_fwd": 32, "conv2d_wgrad": 32, "conv2d_dgrad": 31}
    assert not any(TK.PLAIN_ON_CUDA.values())


def test_capture_shared_layer_graph_equals_eager(card):
    """A graph whose SharedLayer applies a dense layer's params a second
    time: four captured steps against eager (_gate), the source's params
    trained by both call sites, the SharedLayer node owning none."""
    from deeplearning4j_tpu_torch.nn import (ComputationGraph,
                                             NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn import layers as TL

    dense = TL.DenseLayer(n_in=16, n_out=16, activation="tanh")
    conf = (NeuralNetConfiguration.builder().seed(8)
            .updater({"@updater": "Adam", "learning_rate": 1e-2,
                      "epsilon": 1e-3}).graph_builder()
            .add_inputs("in")
            .add_layer("d1", dense, "in")
            .add_layer("d2", TL.SharedLayer(source="d1", layer=dense), "d1")
            .add_layer("out", TL.OutputLayer(n_in=16, n_out=5), "d2")
            .set_outputs("out").set_input_types((16,)).build())
    net = _gate(lambda: ComputationGraph(conf).init(device=card),
                _dense_batches())
    assert net.params["d2"] == {} and len(net._aot_steps) == 1


def test_xception_archive_restores_on_card(card, tmp_path):
    """Xception trained a step on the card, archived, restored onto the
    card (outputs and the next step bit for bit) and onto the CPU (within
    1e-4 of the largest output)."""
    from deeplearning4j_tpu_torch.util import ModelSerializer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    (x, y), = _xception_batches(1)
    net = _xception_small(card)
    net.fit(x, y)
    path = str(tmp_path / "xception.zip")
    ModelSerializer.write_model(net, path)
    back = ModelSerializer.restore_computation_graph(path)
    assert back.device.type == "cuda"
    written = net.output(x)
    assert torch.equal(back.output(x), written)
    cpu = ModelSerializer.restore_computation_graph(path, device="cpu")
    err = (cpu.output(x).float() - written.float().cpu()).abs().max()
    assert float(err) <= 1e-4 * float(written.abs().max())
    back.fit(x, y)
    net.fit(x, y)
    assert back.get_score() == net.get_score()


# ------------------------------------------------------------ data pipeline

def _staging_batches(n=12, batch=64, seed=0):
    rng = np.random.default_rng(seed)
    return [DataSet(rng.normal(size=(batch, 28, 28, 1)).astype(np.float32),
                    np.eye(10, dtype=np.float32)[rng.integers(0, 10, batch)])
            for _ in range(n)]


class _Batches:
    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter(self.batches)


def test_prefetch_staged_buffers_are_never_reused_early(card):
    """The reference's donation-safety test on the card: while step k
    reads its staged batch (slow device work queued on the consumer's
    stream), the worker copies k+1 and k+2 on its own stream. Each batch's
    result, read after everything drained, is its own source's, batches
    held and batches dropped at once alike (a dropped batch's memory must
    not go to a later copy before its reader has run)."""
    from deeplearning4j_tpu_torch.data import AsyncDataSetIterator

    src = _staging_batches()
    it = AsyncDataSetIterator(_Batches(src), buffer_size=2, device=card)
    w = torch.randn(784, 784, device=card)
    held, sums = [], []
    for i, ds in enumerate(it):
        assert ds.features.device.type == "cuda" and ds.features.is_cuda
        x = ds.features.reshape(len(ds.features), -1)
        for _ in range(30):  # keep the consumer's stream busy
            x = torch.tanh(x @ w) * 0.5 + ds.features.reshape(len(x), -1)
        sums.append((x - torch.tanh(x)).sum() * 0 + ds.features.sum())
        if i % 2 == 0:
            held.append((ds, src[i]))
        del ds, x
    torch.cuda.synchronize()
    assert it.staged_batches == len(src)
    assert it.staged_bytes == sum(b.features.nbytes + b.labels.nbytes
                                  for b in src)
    for got, b in zip(sums, src):
        assert float(got) == pytest.approx(float(b.features.sum()),
                                           rel=1e-5, abs=1e-3)
    for ds, b in held:
        np.testing.assert_array_equal(ds.features.cpu().numpy(), b.features)
        np.testing.assert_array_equal(ds.labels.cpu().numpy(), b.labels)


def test_prefetch_image_ring_on_card(card, tmp_path):
    """Native-decoded image batches in the pinned ring, staged on the
    card: bit-equal to decode_image_file called file by file (one decode
    thread: file order), every ring slot reused after its copy's event
    (no fresh buffer), every batch staged once."""
    from PIL import Image

    from deeplearning4j_tpu_torch import native
    from deeplearning4j_tpu_torch.data import (AsyncDataSetIterator,
                                               AsyncImageDataSetIterator)

    if not native.image_available():
        pytest.skip("the native image decoder did not build on this host "
                    "(libjpeg/libpng headers missing): "
                    f"{(native.image_build_error() or '')[:200]}")
    rng = np.random.default_rng(1)
    for c in range(3):
        (tmp_path / f"c{c}").mkdir()
        for i in range(7):
            a = rng.integers(0, 256, (40 + i, 50, 3), dtype=np.uint8)
            Image.fromarray(a).save(tmp_path / f"c{c}" / f"{i}.png")
    src = AsyncImageDataSetIterator(root=str(tmp_path), height=32, width=32,
                                    batch=4, n_threads=1, num_classes=3)
    it = AsyncDataSetIterator(src, device=card)
    files = [p for p, _ in src.items]
    n = 0
    for k, ds in enumerate(it):
        want = np.stack([native.decode_image_file(p, 32, 32, 3)
                         for p in files[4 * k:4 * k + 4]])
        want *= np.float32(1.0 / 255.0)
        np.testing.assert_array_equal(ds.features.cpu().numpy(), want)
        n += len(want)
    assert n == 21 and src.decoded == 21
    ring = src.pipeline.ring
    assert ring is not None and ring.fresh == 0
    assert it.staged_batches == 6


def test_fork_executor_after_cuda_init(card):
    """The multiprocess executor forks from a parent whose CUDA is
    initialised: the children (and telemetry's fork hook) never touch
    torch.cuda, the records equal the serial ones, and the parent's card
    still computes afterwards."""
    from deeplearning4j_tpu_torch.datavec import (
        MultiProcessTransformExecutor, Schema, TransformProcess)
    from deeplearning4j_tpu_torch.util import telemetry as tm

    torch.cuda.init()
    before = torch.arange(8, device=card, dtype=torch.float32)
    tp = (TransformProcess.builder(
        Schema.builder().add_column_double("v").build())
        .double_math_op("v", "multiply", 2.0).build())
    recs = [[float(i)] for i in range(256)]
    tele = tm.get_telemetry()
    tele.drain_events()
    out = MultiProcessTransformExecutor(
        tp, num_workers=4, min_records_per_worker=16).execute(recs)
    assert out == tp.execute(recs)
    pids = {e["pid"] for e in tele.drain_events()
            if e["name"] == "etl.transform_chunk"}
    assert len(pids) == 4
    assert float((before * 2).sum()) == 56.0
    assert tm.device_memory_stats()  # the parent reads its own card


# ------------------------------------------------------------ decode tier

def _decoder(device, **kw):
    return Bert.tiny(causal=True, task="mlm", vocab_size=97, max_length=32,
                     hidden_dropout=0.0, **kw).init(device=device)


DECODE_BUCKETS = dict(batch_buckets=(1, 2, 4), prefill_buckets=(8, 16))
DECODE_PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8],
                  [9, 10, 11, 12, 13, 14, 15, 16, 17]]


@pytest.mark.parametrize("engine", ["contiguous", "paged", "prefix",
                                    "chunked", "speculative"])
def test_decode_engines_on_card_captured_equal_eager(card, engine):
    """Each engine's captured programs give the eager run's tokens, and
    the CPU's (the tie rule is not needed at this width), with no kernel
    launched."""
    from deeplearning4j_tpu_torch.serving import Generator

    kw = {"contiguous": dict(paged=False), "paged": {},
          "prefix": dict(prefix_cache=True), "chunked": dict(prefill_chunk=4),
          "speculative": {}}[engine]

    def make(device):
        net = _decoder(device)
        if engine == "speculative":
            kw["draft_net"] = Bert.draft(vocab_size=97, max_length=32,
                                         seed=7).init(device=device)
        return Generator(net, block_size=4, **DECODE_BUCKETS, **kw)

    gen, cpu = make("cuda"), make("cpu")
    want = cpu.generate(DECODE_PROMPTS, max_new_tokens=8)
    for _ in range(2):  # a prefix cache's second batch resumes
        got = gen.generate(DECODE_PROMPTS, max_new_tokens=8)
        with capture.disabled():
            eager = gen.generate(DECODE_PROMPTS, max_new_tokens=8)
        assert got == eager == want
    assert gen.programs() and not any(TK.LAUNCHES.values())
    if gen.pool is not None:
        assert gen.pool.conservation()[0]


def test_decode_sampling_and_int8_on_card(card):
    from deeplearning4j_tpu_torch.serving import INT8_LOGIT_TOL, Generator

    net = _decoder("cuda")
    paged = Generator(net, block_size=4, **DECODE_BUCKETS)
    contiguous = Generator(net, paged=False, **DECODE_BUCKETS)
    assert paged.generate(DECODE_PROMPTS, 6, temperature=0.8, key=3) == \
        contiguous.generate(DECODE_PROMPTS, 6, temperature=0.8, key=3)
    g8 = Generator(net, block_size=4, quantize="int8", **DECODE_BUCKETS)
    tokens, lengths, _, _ = g8._prep(DECODE_PROMPTS, 1)
    tables = torch.zeros((4, g8.pool.max_blocks_per_stream),
                         dtype=torch.int64, device="cuda")
    err = (g8._prefill_paged(tokens, lengths, tables).clone()
           - paged._prefill_paged(tokens, lengths, tables)).abs().max()
    assert float(err) <= INT8_LOGIT_TOL
    assert all(q.device.type == "cuda" for q in g8._qp.qleaves)


def test_int8_classify_on_card_launches_conv_kernel(card):
    """int8 classify serving on the card: the conv kernel runs on the
    dequantized filters inside the captured ``serving.classify_int8``
    program, equal to the eager forward."""
    from deeplearning4j_tpu_torch.serving import ServingModel
    from deeplearning4j_tpu_torch.zoo.models import LeNet

    net = LeNet().init(device="cuda")
    x = np.random.default_rng(0).random((3, 28, 28, 1), dtype=np.float32)
    q = ServingModel(net, "q", quantize="int8")
    q.warmup()
    TK.reset_counts()
    got = np.concatenate(q.execute([x])[0])
    assert TK.LAUNCHES["conv2d_fwd"] == 2 and not TK.PLAIN_ON_CUDA[
        "conv2d_fwd"]
    with capture.disabled():
        eager = np.concatenate(q.execute([x])[0])
    np.testing.assert_allclose(got, eager, rtol=1e-5, atol=1e-6)


# ------------------------------------------ serving resilience and the fleet


def test_serving_resilience_on_card(card):
    """LeNet served on the card through the scheduler: a compute error
    opens the breaker (consecutive 1) and a probe closes it; a worker crash
    fails its batch loudly and the restarted loop replays the warmed
    programs (no program built after warmup); every answer equals the
    in-process output, 2 conv launches a chunk, none plain."""
    from deeplearning4j_tpu_torch.serving import (BatchScheduler,
                                                  CircuitBreaker,
                                                  CircuitOpenError,
                                                  ServingModel,
                                                  WorkerCrashedError)
    from deeplearning4j_tpu_torch.util import faults as fl
    from deeplearning4j_tpu_torch.zoo import LeNet

    net = LeNet().init(device=card)
    x = np.random.default_rng(1).random((3, 28, 28, 1), dtype=np.float32)
    want = net.output(x).float().cpu().numpy()
    model = ServingModel(net, "lenet-card")
    model.warmup()
    clock = [0.0]
    breaker = CircuitBreaker(clock=lambda: clock[0], model_id="lenet-card",
                             consecutive_errors=1, cooldown_s=1.0)
    sched = BatchScheduler(model, max_wait_ms=0.5, breaker=breaker).start()
    inj = fl.get_injector()
    try:
        TK.reset_counts()
        np.testing.assert_allclose(sched.submit(x).result(timeout=60), want,
                                   rtol=1e-5, atol=1e-6)
        inj.inject(fl.SERVING_COMPUTE_ERROR)
        with pytest.raises(RuntimeError, match="injected serving"):
            sched.submit(x).result(timeout=60)
        with pytest.raises(CircuitOpenError):
            sched.submit(x)
        clock[0] = 2.0
        np.testing.assert_allclose(sched.submit(x).result(timeout=60), want,
                                   rtol=1e-5, atol=1e-6)
        assert breaker.state == "closed" and breaker.closes == 1
        inj.inject(fl.SERVING_WORKER_CRASH)
        with pytest.raises(WorkerCrashedError):
            sched.submit(x).result(timeout=60)
        # the crash is the breaker's one allowed error (recorded just after
        # the batch's futures fail): open again, so the next request after
        # the cooldown is its probe
        import time

        deadline = time.monotonic() + 10
        while breaker.state != "open" and time.monotonic() < deadline:
            time.sleep(0.01)
        assert breaker.state == "open"
        clock[0] = 4.0
        np.testing.assert_allclose(sched.submit(x).result(timeout=60), want,
                                   rtol=1e-5, atol=1e-6)
        assert breaker.state == "closed" and breaker.closes == 2
        stats = sched.stats()
        assert stats["worker_restarts"] == 1 and stats["worker_alive"]
        assert stats["recompiles"] == 0
        # 3 served chunks of 2 conv launches; the failed batches ran none
        assert TK.LAUNCHES["conv2d_fwd"] == 6
        assert not TK.PLAIN_ON_CUDA["conv2d_fwd"]
    finally:
        inj.clear()
        sched.shutdown()


def test_fleet_on_card(card, tmp_path):
    """Two worker processes on the card under DL4J_TORCH_KERNEL_IMPL=cuda
    serve a LeNet archive equal to the in-process output, each worker's
    own counts showing two K1 launches a chunk, none plain; a SIGKILLed
    worker fails over and respawns; stop drains both to exit code 0."""
    import http.client
    import json
    import os

    from deeplearning4j_tpu_torch.serving.fleet import FleetRouter, fleet_spec
    from deeplearning4j_tpu_torch.util import ModelSerializer
    from deeplearning4j_tpu_torch.zoo import LeNet

    net = LeNet().init(device=card)
    path = str(tmp_path / "lenet.zip")
    ModelSerializer.write_model(net, path, save_updater=False)
    x = np.random.default_rng(2).random((4, 28, 28, 1), dtype=np.float32)
    want = net.output(x).float().cpu().numpy()
    spec = fleet_spec(models=[{"id": "lenet", "path": path}],
                      env={"DL4J_TORCH_KERNEL_IMPL": "cuda"})

    def infer():
        conn = http.client.HTTPConnection("127.0.0.1", fleet.port,
                                          timeout=60)
        try:
            conn.request("POST", "/v1/models/lenet/infer",
                         body=json.dumps({"inputs": x.tolist()}).encode())
            r = conn.getresponse()
            return r.status, json.loads(r.read())
        finally:
            conn.close()

    def worker_counts():
        # per worker: (K1 launches, plain calls on CUDA, chunks), the
        # worker process's own counts from its /v1/models
        out = []
        for w in fleet.workers:
            conn = http.client.HTTPConnection("127.0.0.1", w.port,
                                              timeout=60)
            try:
                conn.request("GET", "/v1/models")
                body = json.loads(conn.getresponse().read())
            finally:
                conn.close()
            k = body["kernels"]
            out.append((k["launches"]["conv2d_fwd"],
                        k["plain_on_cuda"]["conv2d_fwd"],
                        body["models"]["lenet"]["chunks_executed"]))
        return np.asarray(out)

    fleet = FleetRouter(spec, n_workers=2, health_interval_s=0.1,
                        fleet_dir=str(tmp_path / "run")).start()
    try:
        before = worker_counts()
        for _ in range(4):
            st, body = infer()
            assert st == 200
            np.testing.assert_allclose(np.asarray(body["outputs"]), want,
                                       rtol=1e-4, atol=1e-5)
        launches, plain, chunks = (worker_counts() - before).sum(axis=0)
        # LeNet's two convs on K1 in the workers, at least a chunk a
        # request
        assert chunks >= 4 and launches == 2 * chunks and plain == 0
        victim = fleet._ring()[0]
        os.kill(victim.pid, 9)
        assert [infer()[0] for _ in range(8)] == [200] * 8
        import time

        deadline = time.monotonic() + 180
        while len(fleet._ring()) < 2 and time.monotonic() < deadline:
            time.sleep(0.2)
        assert len(fleet._ring()) == 2
        assert fleet.worker(victim.worker_id).restarts >= 1
    finally:
        fleet.stop(kill_timeout_s=30)
    assert [w.proc.returncode for w in fleet.workers] == [0, 0]


def test_observe_tune_on_card(card, tmp_path, monkeypatch):
    """Observability and tuning on the card, at a small size: LeNet's
    ``cost_report(profile=True)`` counts the same FLOPs on the card as on
    the CPU (the kernel wrappers report one formula on both), launches the
    conv kernels the same in its counted and profiled steps, and leaves the
    net's state bit-equal; a ``conv2d_tiles`` sweep admits every candidate
    and launches K2; armed, ``ops.nn.conv2d`` follows the winner (a row
    tile, then ``exact``), counted in TUNED, ROW_TILE_LAUNCHES and
    PLAIN_ON_CUDA, within 1e-4 of the plain version."""
    from deeplearning4j_tpu_torch import tuning
    from deeplearning4j_tpu_torch.ops import nn as nnops
    from deeplearning4j_tpu_torch.tree import tree_leaves
    from deeplearning4j_tpu_torch.zoo.models import LeNet

    monkeypatch.setenv("DL4J_TORCH_KERNEL_IMPL", "auto")
    monkeypatch.setenv("DL4J_TPU_PEAK_FLOPS", "bf16=9.89e14,fp32=6.7e13")
    flops = {}
    for dev in ("cpu", "cuda"):
        net = LeNet().init(device=dev)
        before = [t.clone() for t in tree_leaves(
            [net.params, net.states, net.opt_states])]
        with capture.disabled():
            rep = net.cost_report(batch_size=64, profile=True, steps=2,
                                  publish=False,
                                  trace_dir=str(tmp_path / f"trace_{dev}"))
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(
            [net.params, net.states, net.opt_states]), before))
        flops[dev] = rep.flops_per_step
        if dev == "cuda":
            want = {"conv2d_fwd": 2, "conv2d_dgrad": 1, "conv2d_wgrad": 2}
            assert rep.launches["counted"] == want
            assert rep.launches["profiled"] == want
            assert rep.mfu is not None and 0 < rep.mfu < 1
            assert rep.device_time_s > 0 and 0 < rep.trace_busy_s \
                <= rep.trace_span_s
    assert flops["cuda"] == pytest.approx(flops["cpu"], rel=1e-6)

    ctx = {"x_shape": (4, 8, 8, 16), "w_shape": (3, 3, 16, 16),
           "strides": (1, 1), "padding": "SAME", "dilation": (1, 1),
           "groups": 1, "dtype": "float32"}
    db = tuning.set_database(str(tmp_path / "tdb"))
    try:
        TK.reset_counts()
        entry = tuning.MeasurementDriver(db, min_window_s=0.005).sweep(
            tuning.get_space("conv2d_tiles"), ctx)
        assert all(r["admitted"] for r in entry["measured"])
        assert sum(TK.ROW_TILE_LAUNCHES.values()) > 0
        sp = tuning.get_space("conv2d_tiles")
        g = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn(ctx["x_shape"], device="cuda", generator=g)
        w = torch.randn(ctx["w_shape"], device="cuda", generator=g) * 0.1
        plain = KC.conv2d_fwd_reference(x, w, (1, 1), ((1, 1), (1, 1)),
                                        (1, 1), 1)
        for label, impl, params in (("cuda:rt=2", "cuda", {"row_tile": 2}),
                                    ("exact", "exact", {})):
            db.commit(sp.key(ctx), {"winner": {
                "label": label, "impl": impl, "params": params, "ms": 1.0},
                "candidates_digest": "t", "measured": []})
            TK.reset_counts()
            out = nnops.conv2d(x, w)
            assert TK.TUNED == {f"conv2d_fwd/{label}": 1}
            if impl == "exact":
                assert TK.PLAIN_ON_CUDA["conv2d_fwd"] == 1
                assert TK.LAUNCHES["conv2d_fwd"] == 0
            else:
                assert TK.ROW_TILE_LAUNCHES == {"conv2d_fwd/rt=2": 1}
            assert float((out - plain).abs().max()) <= 1e-4 * max(
                1.0, float(plain.abs().max()))
    finally:
        tuning.set_database(None)
        TK.reset_counts()


# ---------------------------------------------------------------------------
# the compile-time half of item 12 and the fused update (``-k compile_time``)
# ---------------------------------------------------------------------------
def _remat_graph(policy, dtype="float32"):
    """conv-bn-relu | conv-bn + residual add, relu | pool, output: the
    residual block of ResNet-50 at 64 channels (the bf16 wgmma bodies)."""
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn import vertices as V
    from deeplearning4j_tpu_torch.nn.computation_graph import \
        ComputationGraph
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration

    b = (NeuralNetConfiguration.builder().seed(5).compute_dtype(dtype)
         .updater({"@updater": "Sgd", "learning_rate": 0.05}))
    if policy != "none":
        b.remat_policy(policy)
    gb = b.graph_builder().add_inputs("in")
    gb.add_layer("c1", L.ConvolutionLayer(n_out=64, kernel_size=(3, 3),
                                          padding="SAME"), "in")
    gb.add_layer("bn1", L.BatchNormalization(), "c1")
    gb.add_layer("r1", L.ActivationLayer(activation="relu"), "bn1")
    gb.stage_boundary("r1")
    gb.add_layer("c2", L.ConvolutionLayer(n_out=64, kernel_size=(3, 3),
                                          padding="SAME"), "r1")
    gb.add_layer("bn2", L.BatchNormalization(), "c2")
    gb.add_vertex("add", V.ElementWiseVertex(op="add"), "r1", "bn2")
    gb.add_layer("r2", L.ActivationLayer(activation="relu"), "add")
    gb.stage_boundary("r2")
    gb.add_layer("pool", L.GlobalPoolingLayer(), "r2")
    gb.add_layer("out", L.OutputLayer(n_out=10), "pool")
    conf = gb.set_outputs("out").set_input_types((16, 16, 64)).build()
    return ComputationGraph(conf).init(device="cuda")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compile_time_remat_launches_and_values(card, dtype):
    """Each policy, eager: the step equals ``none``'s bit for bit where two
    eager ``none`` steps agree; K1 launches 2 a step, plus 2 in the
    recompute under ``full`` and none under ``save_conv``; dgrad 2 (the
    stem takes the input, which needs no gradient: 1) and K3 2."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 16, 16, 64)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 8)]
    outs, launches = {}, {}
    with capture.disabled():
        for policy in ("none", "none2", "full", "save_conv", "save_all"):
            net = _remat_graph(policy.rstrip("2"), dtype)
            TK.reset_counts()
            net.fit(x, y)
            torch.cuda.synchronize()
            launches[policy] = dict(TK.LAUNCHES)
            outs[policy] = [t.detach().float().cpu() for p in
                            net.params.values() for t in p.values()]
    same = all(torch.equal(a, b) for a, b in zip(outs["none"],
                                                 outs["none2"]))
    for policy in ("full", "save_conv", "save_all"):
        for a, b in zip(outs["none"], outs[policy]):
            if same:
                assert torch.equal(a, b), policy
            else:
                torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    want_k1 = {"none": 2, "full": 4, "save_conv": 2, "save_all": 2}
    for policy, k1 in want_k1.items():
        got = launches[policy]
        assert got["conv2d_fwd"] == k1, (policy, got)
        assert got["conv2d_dgrad"] == 1 and got["conv2d_wgrad"] == 2
        assert not any(TK.PLAIN_ON_CUDA.values())


def test_compile_time_remat_captured_equals_eager(card):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, 16, 16, 64)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 8)]
    eager, cap = _remat_graph("save_conv"), _remat_graph("save_conv")
    with capture.disabled():
        for _ in range(3):
            eager.fit(x, y)
    for _ in range(3):
        cap.fit(x, y)
    assert cap.programs()
    for a, b in zip(eager.params.values(), cap.params.values()):
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=1e-4, atol=1e-6)


def test_compile_time_fused_dynamic_skip_captured(card):
    """A bf16 layer stack, fused with dynamic scaling, captured: a step
    with a non-finite input leaves params, moments and masters bit-equal
    and halves the scale, all on the device (no host sync: the capture
    would fail by name)."""
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.tree import tree_leaves

    conf = (NeuralNetConfiguration.builder().seed(2)
            .compute_dtype("bfloat16").fused_update(True)
            .loss_scale("dynamic")
            .updater({"@updater": "Adam", "learning_rate": 1e-3})
            .list().layer(L.DenseLayer(n_out=64, activation="relu"))
            .layer(L.OutputLayer(n_out=4)).set_input_type((32,)).build())
    net = MultiLayerNetwork(conf).init(device="cuda")
    rng = np.random.default_rng(2)
    x = rng.normal(size=(16, 32)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 16)]
    net.fit(x, y)
    net.fit(x, y)
    before = [t.clone() for t in tree_leaves(
        [net.params, net.opt_states["groups"]])]
    bad = x.copy()
    bad[0, 0] = np.inf
    net.fit(bad, y)
    after = tree_leaves([net.params, net.opt_states["groups"]])
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert float(net.opt_states["scale"]["scale"]) == 2.0 ** 14
    assert int(net.opt_states["scale"]["good"]) == 0
    assert len(net.programs()) == 1


def test_compile_time_captured_rnn_time_step(card):
    net = TextGenerationLSTM(total_unique_characters=11, units=32).init(
        device="cuda")
    rng = np.random.default_rng(3)
    x = np.eye(11, dtype=np.float32)[rng.integers(0, 11, (4, 6))]
    with capture.disabled():
        eager = [net.rnn_time_step(x[:, t]).cpu() for t in range(6)]
    net.rnn_clear_previous_state()
    TK.reset_counts()
    cap = [net.rnn_time_step(x[:, t]).cpu() for t in range(6)]
    for a, b in zip(eager, cap):
        assert torch.equal(a, b)
    assert TK.LAUNCHES["lstm_seq_fwd"] == 2 * 6
    assert not any(TK.PLAIN_ON_CUDA.values())


# ---------------------------------------------------------------------------
# single-process data parallelism (``-k parallel``, parallel/)
# ---------------------------------------------------------------------------
def _parallel_graph(dev, comp=None):
    """Two convs (K1 / dgrad / K3) with batchnorm under Sgd (Adam would
    amplify to its step size the noise-level gradient of the first conv's
    bias, which the batchnorm cancels), on ``dev``: the same seeded params
    on every device."""
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn.computation_graph import \
        ComputationGraph
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration

    b = (NeuralNetConfiguration.builder().seed(9)
         .updater({"@updater": "Sgd", "learning_rate": 0.05}))
    if comp:
        b.grad_compression(comp, threshold=1e-3)
    gb = b.graph_builder().add_inputs("in")
    gb.add_layer("c1", L.ConvolutionLayer(n_out=16, kernel_size=(3, 3),
                                          padding="SAME"), "in")
    gb.add_layer("bn1", L.BatchNormalization(), "c1")
    gb.add_layer("r1", L.ActivationLayer(activation="relu"), "bn1")
    gb.add_layer("c2", L.ConvolutionLayer(n_out=16, kernel_size=(3, 3),
                                          padding="SAME"), "r1")
    gb.add_layer("pool", L.GlobalPoolingLayer(), "c2")
    gb.add_layer("out", L.OutputLayer(n_out=5), "pool")
    conf = gb.set_outputs("out").set_input_types((12, 12, 8)).build()
    return ComputationGraph(conf).init(device=dev)


def _parallel_batches(n=2, b=16):
    rng = np.random.default_rng(21)
    return [DataSet(rng.normal(size=(b, 12, 12, 8)).astype(np.float32),
                    np.eye(5, dtype=np.float32)[rng.integers(0, 5, b)])
            for _ in range(n)]


def _params_close(a, b, rtol, atol):
    from deeplearning4j_tpu_torch.tree import tree_leaves

    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        torch.testing.assert_close(x.detach().cpu(), y.detach().cpu(),
                                   rtol=rtol, atol=atol)


@pytest.mark.parametrize("mode", ["deterministic", "threshold", "shared"])
def test_parallel_lane_steps_on_card_match_cpu(card, mode):
    """The wrapper's lane step (deterministic, compressed) and the shared
    master, 4 lanes, on the card against the same steps on the CPU: losses
    within 1e-4, params within 1e-3; every conv launch a kernel, none
    plain."""
    from deeplearning4j_tpu_torch import parallel as P

    comp = "threshold" if mode == "threshold" else None
    nets = {d: _parallel_graph(d, comp) for d in ("cpu", "cuda")}
    losses = {}
    for d, net in nets.items():
        TK.reset_counts()
        if mode == "shared":
            P.SharedTrainingMaster(replicas=4).fit(net, _parallel_batches())
            losses[d] = float(net.score_value)
        else:
            pw = P.ParallelWrapper(net, deterministic=True, replicas=4,
                                   skew_every=0)
            losses[d] = [float(pw.step_batch(ds))
                         for ds in _parallel_batches()]
        if d == "cuda":
            torch.cuda.synchronize()
            assert TK.LAUNCHES["conv2d_fwd"] == 2 * 4 * 2, TK.LAUNCHES
            assert TK.LAUNCHES["conv2d_wgrad"] == 2 * 4 * 2
            assert TK.LAUNCHES["conv2d_dgrad"] == 1 * 4 * 2
            assert not any(TK.PLAIN_ON_CUDA.values())
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
    _params_close(nets["cuda"], nets["cpu"], rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("comp", [None, "threshold"])
def test_parallel_captured_lanes_equal_eager(card, comp):
    """The lane step captured against the same steps eager, from one
    state: bit for bit where two eager runs agree, else no farther from
    eager than its repeat (``_gate``'s rule)."""
    from deeplearning4j_tpu_torch import parallel as P

    def fit(net, ds):
        if not hasattr(net, "_pw"):
            net._pw = P.ParallelWrapper(net, deterministic=True, replicas=4,
                                        skew_every=0)
        net._pw.step_batch(ds)

    def dist(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a, b))

    def make():
        return _parallel_graph("cuda", comp)

    batches = _parallel_batches(3)
    _, e1 = _run(make, batches, fit, True)
    _, e2 = _run(make, batches, fit, True)
    net, cap = _run(make, batches, fit, False)
    assert dist(e1, cap) <= dist(e1, e2)
    if comp:
        assert net._grad_comp_state is net._pw._comp_state
    # the lane programs live in the wrapper's table, not the net's
    assert not net.programs() and net._pw._programs and all(
        p.graph is not None for p in net._pw._programs.values())
    assert not any(TK.PLAIN_ON_CUDA.values())


def test_parallel_inference_and_serving_on_card(card):
    from deeplearning4j_tpu_torch import parallel as P
    from deeplearning4j_tpu_torch.serving import ServingModel

    net = _parallel_graph("cuda")
    x = np.random.default_rng(4).normal(size=(11, 12, 12, 8)).astype(
        np.float32)
    with capture.disabled():
        want = net.output(x).cpu().numpy()
    pi = P.ParallelInference(net, bucketing="batch=4,8", batch_limit=8)
    TK.reset_counts()
    np.testing.assert_allclose(pi.output(x), want, rtol=1e-4, atol=1e-5)
    assert TK.LAUNCHES["conv2d_fwd"] == 2 * 2  # chunks of 8 and 3 (-> 4)
    m = ServingModel(net, "p", use_mesh=True)
    m.warmup()
    out, _ = m.execute([x[:3], x[3:]])
    np.testing.assert_allclose(np.concatenate(out), want, rtol=1e-4,
                               atol=1e-5)
    assert not any(TK.PLAIN_ON_CUDA.values())


def _pipelined_bert(dev, n_micro=2, dtype="float32"):
    """A BERT of 4 blocks at hidden 64 (4 heads of 16), S 64, 2 stages of 2
    blocks (``stage_boundary`` after the embedding and blocks 2 and 4),
    dropout 0, flash forced, on ``dev``: the same seeded params on every
    device."""
    from deeplearning4j_tpu_torch.nn import (MultiLayerNetwork,
                                             NeuralNetConfiguration)

    base = Bert(vocab_size=97, hidden_size=64, n_layers=4, n_heads=4,
                max_length=64, hidden_dropout=0.0, flash=True,
                updater=Adam(1e-3)).conf()
    lb = (NeuralNetConfiguration.builder().seed(base.seed)
          .updater(base.updater).compute_dtype(dtype).pipe_stages(2)
          .n_micro(n_micro).list())
    for i, lyr in enumerate(base.layers):
        lb.layer(lyr)
        if i in (0, 2, 4):
            lb.stage_boundary()
    return MultiLayerNetwork(lb.set_input_type(base.input_shape)
                             .build()).init(device=dev)


def _pipelined_batches(n=2, b=8, ids=False):
    rng = np.random.default_rng(31)
    out = []
    for _ in range(n):
        x = np.stack([rng.integers(1, 97, (b, 64)),
                      np.broadcast_to(np.arange(64) >= 32, (b, 64))],
                     axis=-1).astype(np.int64 if ids else np.float32)
        out.append(DataSet(x, np.eye(2, dtype=np.float32)[
            rng.integers(0, 2, b)]))
    return out


@pytest.mark.parametrize("n_micro", [2, 4])
def test_pipelined_bert_on_card_matches_cpu(card, n_micro):
    """The pipelined step on the card (K5 in every block of every stage,
    once a microbatch) against the same steps on the CPU: losses within
    1e-4, params within 1e-3; 4 blocks x n_micro K5 launches a step, none
    plain."""
    from deeplearning4j_tpu_torch import parallel as P

    losses = {}
    nets = {d: _pipelined_bert(d, n_micro) for d in ("cpu", "cuda")}
    for d, net in nets.items():
        pt = P.PipelinedTrainer(net, skew_every=0)
        TK.reset_counts()
        with capture.disabled():
            losses[d] = [float(pt.step_batch(ds))
                         for ds in _pipelined_batches()]
        pt.sync_model()
        if d == "cuda":
            torch.cuda.synchronize()
            assert TK.LAUNCHES["flash_attention_fwd"] == 4 * n_micro * 2
            assert not any(TK.PLAIN_ON_CUDA.values())
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
    _params_close(nets["cuda"], nets["cpu"], rtol=1e-3, atol=1e-5)


def test_pipelined_captured_equals_eager(card):
    """The pipelined step captured against eager from one state, under
    deterministic algorithms (the embedding backward accumulates with
    atomics otherwise): two eager runs and the captured one equal to the
    bit; the programs in the trainer's table."""
    from deeplearning4j_tpu_torch import parallel as P

    def fit(net, ds):
        if not hasattr(net, "_pt"):
            net._pt = P.PipelinedTrainer(net, skew_every=0)
        net._pt.step_batch(ds)
        net._pt.sync_model()

    def dist(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a, b))

    batches = _pipelined_batches(3)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        _, e1 = _run(lambda: _pipelined_bert("cuda"), batches, fit, True)
        _, e2 = _run(lambda: _pipelined_bert("cuda"), batches, fit, True)
        TK.reset_counts()
        net, cap = _run(lambda: _pipelined_bert("cuda"), batches, fit,
                        False)
    finally:
        torch.use_deterministic_algorithms(False)
    assert dist(e1, e2) == 0.0 and dist(e1, cap) == 0.0
    assert TK.LAUNCHES["flash_attention_fwd"] == 4 * 2 * 3
    assert net._pt._programs and all(
        p.graph is not None for p in net._pt._programs.values())


def test_elastic_pipelined_drain_resume_and_rollback_on_card(card,
                                                             tmp_path):
    """ElasticTrainer around the pipelined trainer on the card, under
    deterministic algorithms: SIGTERM at step 2, then a resume, equal to
    an uninterrupted run to the bit; inject_nan on integer ids rolled
    back, equal to the clean run to the bit."""
    import os
    import signal

    from deeplearning4j_tpu_torch import parallel as P
    from deeplearning4j_tpu_torch.tree import tree_leaves
    from deeplearning4j_tpu_torch.util import faults as fl

    class SigtermAt:
        def iteration_done(self, model, iteration, epoch):
            if iteration == 2:
                os.kill(os.getpid(), signal.SIGTERM)

        def on_epoch_end(self, model):
            pass

    def state(net):
        return [t.detach().cpu() for t in tree_leaves(
            [net.params, net.opt_states])]

    data = _pipelined_batches(4, ids=True)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        ref = _pipelined_bert("cuda")
        pt = P.PipelinedTrainer(ref, skew_every=0)
        pt.fit(data)
        pt.sync_model()
        net = _pipelined_bert("cuda")
        net.listeners.append(SigtermAt())
        t1 = P.ElasticTrainer(P.PipelinedTrainer(net, skew_every=0),
                              str(tmp_path / "a"), checkpoint_every=100,
                              log_fn=None)
        t1.fit(data, epochs=1)
        assert t1.drained and net.iteration == 2
        net2 = _pipelined_bert("cuda")
        t2 = P.ElasticTrainer(P.PipelinedTrainer(net2, skew_every=0),
                              str(tmp_path / "a"), checkpoint_every=100,
                              log_fn=None)
        t2.fit(data, epochs=1)
        assert t2.resumed_from == 2 and t2.state == "completed"
        assert all(torch.equal(a, b) for a, b in zip(state(ref),
                                                     state(net2)))
        net3 = _pipelined_bert("cuda")
        fl.get_injector().clear()
        fl.get_injector().inject(fl.INJECT_NAN, at_step=3)
        t3 = P.ElasticTrainer(P.PipelinedTrainer(net3, skew_every=0),
                              str(tmp_path / "b"), checkpoint_every=2,
                              log_fn=None)
        t3.fit(data, epochs=1)
        assert t3.rollbacks == 1 and t3.state == "completed"
        assert all(torch.equal(a, b) for a, b in zip(state(ref),
                                                     state(net3)))
    finally:
        fl.get_injector().clear()
        torch.use_deterministic_algorithms(False)


@pytest.mark.parametrize("kind", ["pipelined", "wrapper"])
def test_programs_rebuilt_after_reshard_capture_on_card(card, kind):
    """A captured step, ``reshard()`` (which drops the programs and, with
    them, their graph pool), a captured step again: the rebuilt program
    captures into a fresh pool. (Captured into the dead programs' pool,
    torch 2.11's pinned-host allocator failed an internal assert at
    ``capture_begin``.)"""
    import gc
    import math

    from deeplearning4j_tpu_torch import parallel as P

    net = _pipelined_bert("cuda")
    pt = (P.PipelinedTrainer(net, skew_every=0) if kind == "pipelined"
          else P.ParallelWrapper(net, deterministic=True, replicas=2,
                                 skew_every=0))
    batches = _pipelined_batches(2)
    pt.step_batch(batches[0])
    first = pt._pool
    pt.reshard()
    gc.collect()
    pt.step_batch(batches[1])
    torch.cuda.synchronize()
    assert first is not None and pt._pool is not None
    assert pt._pool != first
    assert pt._programs and all(p.graph is not None
                                for p in pt._programs.values())
    assert math.isfinite(float(net.score_value))
