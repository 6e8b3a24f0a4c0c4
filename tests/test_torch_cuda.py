"""The port's kernels on a CUDA card, against their plain versions.

Every test here is marked ``cuda`` and skips without a card. This file
imports nothing of JAX or of the JAX package, so it also runs where only
the port is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(``--noconftest``: the suite's ``conftest.py`` sets up JAX). Tolerances
are the smoke's: the flash kernel's O within 1e-5 (fp32) or 2^-7 (bf16,
P is rounded to bf16 before P @ V) of the largest plain output, its LSE
within 1e-5 relative, a fully-masked row exactly O = 0 and LSE = -1e30;
the LSTM cell kernel's h' and c' within 1e-5 (fp32: the same fp32 sums in
another order) or 2^-7 (bf16: both round the same fp32 values to bf16, a
tie may fall the other way, two ulps of headroom) of the largest output; a
whole network within 1e-4 relative of the same network on the CPU.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_tpu_torch.ops import attention as TA  # noqa: E402
from deeplearning4j_tpu_torch.ops import kernels as TK  # noqa: E402
from deeplearning4j_tpu_torch.ops.kernels import attention as KA  # noqa: E402
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
    """The kernel's output would carry no grad_fn: with grad enabled and an
    input that requires grad it raises, naming the flash backward; with
    grad off it runs."""
    q = torch.randn((1, 2, 32, 16), device=card, requires_grad=True)
    with pytest.raises(NotImplementedError, match="flash-attention backward"):
        KA.flash_attention_fwd(q, q, q, 0.25, False)
    with torch.no_grad():
        KA.flash_attention_fwd(q, q, q, 0.25, False)
    assert TK.LAUNCHES["flash_attention_fwd"] == 1


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
    step on K4, against the same net on the CPU."""
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
    assert TK.LAUNCHES["lstm_cell_fwd"] == 3 * 2 * 10
    assert TK.PLAIN_ON_CUDA["lstm_cell_fwd"] == 0
    for pg, pc in zip(gpu.params, cpu.params):
        for k in pc:
            np.testing.assert_allclose(pg[k].cpu().numpy(), pc[k].numpy(),
                                       rtol=1e-4, atol=1e-6)
    x = eye[rng.integers(0, 11, size=(2, 4))]
    for t in range(4):
        np.testing.assert_allclose(gpu.rnn_time_step(x[:, t]).cpu().numpy(),
                                   cpu.rnn_time_step(x[:, t]).numpy(),
                                   rtol=1e-4, atol=1e-6)
    assert TK.LAUNCHES["lstm_cell_fwd"] == 3 * 2 * 10 + 2 * 4
