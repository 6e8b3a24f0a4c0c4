"""The port's LSTM segment entry (K4 over a TBPTT segment in one launch)
against the JAX package, on the CPU.

- ``lstm_seq_reference`` (the CPU side of ``lstm_seq_fwd``) against the
  reference's ``lstm_sequence_fused`` with the Pallas kernel in interpret
  mode, both gate orders: fp32 within 2e-5 (the same fp32 arithmetic,
  summed in another order); bf16 within one bf16 ulp of the largest output
  (both round h and c to bf16 at every step). A variant that carries c in
  fp32 from step to step fails that gate.
- With a ragged mask and with a non-0/1 mask, against the reference layer's
  ``apply_seq`` (fp32), and equal to the bit to the port's own ``_scan``
  over ``LSTMCellFunction`` steps in bf16 (the mask rule with its
  roundings).
- ``LSTMSequenceFunction``'s gradients (dxp, dh0, dc0, dU) against
  ``jax.vjp`` of the reference's masked scan of ``lstm_cell_fused`` steps
  within 2e-4 (docs/KERNELS.md's LSTM gradient tolerance), and against a
  chain of ``LSTMCellFunction``s; ``torch.autograd.gradcheck`` in float64.
- ``seq_body``, the mirror of ``csrc/lstm_seq.cu``'s ``pick_body``, with the
  constants read from the source; ``tools/lstm_ablation.py``'s edits still
  find their anchors.

The kernel itself against its plain version runs on a card:
``tests/test_torch_cuda.py``.
"""

import importlib.util
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.nn.recurrent import LSTM as JLSTM  # noqa: E402
from deeplearning4j_tpu.ops import kernels as JK  # noqa: E402
from deeplearning4j_tpu.ops.kernels import lstm as JKL  # noqa: E402
from deeplearning4j_tpu_torch.nn.recurrent import LSTM as TLSTM  # noqa: E402
from deeplearning4j_tpu_torch.ops import kernels as TK  # noqa: E402
from deeplearning4j_tpu_torch.ops.kernels import lstm as KL  # noqa: E402

ATOL = 2e-5
GRAD_ATOL = 2e-4
ORDERS = {"ifog": (KL.ORDER_IFOG, JKL.ORDER_IFOG),
          "iofg": (KL.ORDER_IOFG, JKL.ORDER_IOFG)}
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _seq_inputs(b, t, h, seed):
    rng = np.random.default_rng(seed)
    xp = rng.normal(size=(b, t, 4 * h)).astype(np.float32)
    h0 = (rng.normal(size=(b, h)) * 0.5).astype(np.float32)
    c0 = rng.normal(size=(b, h)).astype(np.float32)
    u = (rng.normal(size=(h, 4 * h)) / np.sqrt(h)).astype(np.float32)
    return xp, h0, c0, u


def _ragged(b, t, seed, soft=False):
    """A (B, T) mask: random lengths (row 0 full); ``soft`` puts values of
    0.3 and 0.7 inside the lengths."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, t + 1, size=b)
    lengths[0] = t
    m = (np.arange(t)[None] < lengths[:, None]).astype(np.float32)
    if soft:
        m = m * rng.choice(np.array([0.3, 0.7, 1.0], np.float32), size=(b, t))
    return m


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
            for a in arrays]


def _bf16_ulp(max_abs):
    """One bf16 ulp (8 bits of mantissa) at ``max_abs``."""
    return 2.0 ** (np.floor(np.log2(max_abs)) - 7)


def _jax_seq(xp, h0, c0, u, order):
    """The reference's ``lstm_sequence_fused`` (Pallas in interpret mode) on
    batch-major xp: (y, h_fin, c_fin), y batch-major."""
    ys, (hf, cf) = JKL.lstm_sequence_fused(
        jnp.swapaxes(xp, 0, 1), h0, c0, u, order, "interpret")
    return jnp.swapaxes(ys, 0, 1), hf, cf


def _close_bf16(got, ref):
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    tol = _bf16_ulp(np.abs(ref).max())
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=tol)


@pytest.mark.parametrize("order", sorted(ORDERS))
@pytest.mark.parametrize("b,t,h", [(3, 6, 8), (2, 1, 16), (1, 5, 5)])
def test_seq_plain_matches_pallas_sequence_fp32(order, b, t, h):
    tord, jord = ORDERS[order]
    xp, h0, c0, u = _seq_inputs(b, t, h, seed=b * 100 + t * 10 + h)
    jy, jh, jc = _jax_seq(*map(jnp.asarray, (xp, h0, c0, u)), jord)
    y, hs, cs, hf, cf = KL.lstm_seq_fwd(*_t(xp, h0, c0, u), tord)
    assert hs is y and tuple(cs.shape) == (b, t, h)
    for got, ref in ((y, jy), (hf, jh), (cf, jc), (hs[:, -1], jh),
                     (cs[:, -1], jc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=ATOL)
    assert TK.LAUNCHES["lstm_seq_fwd"] == 0  # CPU tensors: the plain version


def _c_in_fp32(xp, h0, c0, u, order):
    """A wrong plain variant: h rounded to xp's type at every step, but c
    carried in fp32 and rounded only on output."""
    h, c, ys = h0, c0.float(), []
    for t in range(xp.shape[1]):
        h_new, c_new, _ = KL._cell_exact(xp[:, t], h, c, u, order)
        h, c = h_new.to(xp.dtype), c_new
        ys.append(h)
    return torch.stack(ys, 1), h, c.to(xp.dtype)


@pytest.mark.parametrize("order", sorted(ORDERS))
def test_seq_plain_matches_pallas_sequence_bf16(order):
    """Random inputs, then a forget gate held at 1 with increments below
    half a bf16 ulp of c: the reference rounds c back to 1 at every step,
    so a variant that keeps c in fp32 drifts three ulps off and fails the
    same gate the plain version passes."""
    tord, jord = ORDERS[order]
    xp, h0, c0, u = _seq_inputs(4, 6, 16, seed=7)
    b, t, h = 2, 8, 4
    zs = {"i": 20.0, "f": 20.0, "o": 0.0, "g": 0.003}
    drift = np.concatenate([np.full((b, t, h), zs[r], np.float32)
                            for r in tord], axis=-1)
    cases = [(xp, h0, c0, u),
             (drift, np.zeros((b, h), np.float32),
              np.ones((b, h), np.float32), np.zeros((h, 4 * h), np.float32))]
    for i, case in enumerate(cases):
        jin = [jnp.asarray(a).astype(jnp.bfloat16) for a in case]
        jy, jh, jc = _jax_seq(*jin, jord)
        tin = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            torch.bfloat16) for a in jin]
        y, _, cs, hf, cf = KL.lstm_seq_reference(*tin, tord)
        assert y.dtype == torch.bfloat16 and cs.dtype == torch.bfloat16
        for got, ref in ((y, jy), (hf, jh), (cf, jc)):
            _close_bf16(got, ref)
        if i == 1:
            assert float(cf.float().max()) == 1.0
            _, _, c_wrong = _c_in_fp32(*tin, tord)
            with pytest.raises(AssertionError):
                _close_bf16(c_wrong, jc)


@pytest.fixture(scope="module")
def layer_case():
    """LSTM(5 -> 8) over (3, 7, 5) inputs, params from the reference's
    initializer, with a ragged 0/1 mask and with a soft (0.3 / 0.7 / 1)
    one; the reference layer's outputs under its exact path."""
    jl = JLSTM(n_in=5, n_out=8)
    p, _ = jl.initialize(jax.random.PRNGKey(3), (None, 5))
    params = {k: np.asarray(v) for k, v in p.items()}
    x = np.random.default_rng(5).normal(size=(3, 7, 5)).astype(np.float32)
    masks = {"ragged": _ragged(3, 7, 6), "soft": _ragged(3, 7, 6, soft=True)}
    refs = {}
    for name, mask in masks.items():
        with JK.impl_scope("exact"):
            y, (hf, cf) = jl.apply_seq(p, jnp.asarray(x), jl.init_carry(3),
                                       mask=jnp.asarray(mask))
        refs[name] = [np.asarray(v) for v in (y, hf, cf)]
    return params, x, masks, refs


@pytest.mark.parametrize("mask_kind", ["ragged", "soft"])
def test_masked_segment_matches_reference_layer(layer_case, monkeypatch,
                                                mask_kind):
    """The segment entry with the layer's mask, through ``apply_seq``'s
    kernel branch (one LSTMSequenceFunction) and directly, against the
    reference layer: masked steps keep the carry, output m * h'."""
    params, x, masks, refs = layer_case
    mask = masks[mask_kind]
    lyr = TLSTM(n_in=5, n_out=8)
    p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    monkeypatch.setattr(TK, "dispatch", lambda *a, **k: True)
    y, (hf, cf) = lyr.apply_seq(p, torch.from_numpy(x),
                                lyr.init_carry(3, torch.float32),
                                mask=torch.from_numpy(mask))
    xp = torch.from_numpy(x) @ p["W"] + p["b"]
    zero = torch.zeros((3, 8))
    y2, _, _, hf2, cf2 = KL.lstm_seq_reference(
        xp, zero, zero, p["U"], KL.ORDER_IFOG, torch.from_numpy(mask))
    for got in ((y, hf, cf), (y2, hf2, cf2)):
        for g, r in zip(got, refs[mask_kind]):
            np.testing.assert_allclose(g.detach().numpy(), r, rtol=0,
                                       atol=ATOL)
    assert np.all(y.detach().numpy()[mask == 0] == 0.0)


@pytest.mark.parametrize("mask_kind", ["ragged", "soft"])
def test_masked_segment_bf16_is_scan_over_cells(mask_kind):
    """In bf16 the segment's plain version is, to the bit, the port's
    ``_scan`` over ``LSTMCellFunction`` steps: the same mask rule, rounded
    to bf16 after each operation."""
    xp, h0, c0, u = _t(*_seq_inputs(3, 7, 8, seed=9), dtype=torch.bfloat16)
    mask = torch.from_numpy(_ragged(3, 7, 10, soft=mask_kind == "soft"))

    def step(c, xt):
        h_new, c_new = KL.lstm_cell(xt, c[0], c[1], u)
        return (h_new, c_new), h_new

    y_ref, (h_ref, c_ref) = TLSTM._scan(step, (h0, c0), xp, mask)
    y, hs, cs, hf, cf = KL.lstm_seq_reference(xp, h0, c0, u, KL.ORDER_IFOG,
                                              mask)
    for got, ref in ((y, y_ref), (hf, h_ref), (cf, c_ref),
                     (hs[:, -1], h_ref), (cs[:, -1], c_ref)):
        assert torch.equal(got, ref)


def _jax_masked_seq(order, mask):
    """The reference's layer scan (``_scan``) of ``lstm_cell_fused`` steps in
    interpret mode, batch-major, as a function of (xp, h0, c0, U)."""
    def f(xp, h0, c0, u):
        def step(c, xt):
            h_new, c_new = JKL.lstm_cell_fused(xt, c[0], c[1], u, order,
                                               "interpret")
            return (h_new, c_new), h_new

        y, (hf, cf) = JLSTM._scan(step, (h0, c0), xp,
                                  None if mask is None else jnp.asarray(mask))
        return y, hf, cf
    return f


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
@pytest.mark.parametrize("order", sorted(ORDERS))
def test_segment_gradients_match_jax_vjp_and_cell_chain(order, masked):
    tord, jord = ORDERS[order]
    b, t, h = 3, 5, 8
    xp, h0, c0, u = _seq_inputs(b, t, h, seed=31)
    mask = _ragged(b, t, 32, soft=True) if masked else None
    rng = np.random.default_rng(33)
    dy = rng.normal(size=(b, t, h)).astype(np.float32)
    dh = rng.normal(size=(b, h)).astype(np.float32)
    dc = rng.normal(size=(b, h)).astype(np.float32)
    _, vjp = jax.vjp(_jax_masked_seq(jord, mask),
                     *map(jnp.asarray, (xp, h0, c0, u)))
    jgrads = vjp(tuple(map(jnp.asarray, (dy, dh, dc))))
    cts = _t(dy, dh, dc)
    tmask = None if mask is None else torch.from_numpy(mask)

    tin = [v.requires_grad_(True) for v in _t(xp, h0, c0, u)]
    y, (hf, cf) = KL.lstm_seq(*tin, tord, tmask)
    tgrads = torch.autograd.grad((y, hf, cf), tin, cts)

    cin = [v.requires_grad_(True) for v in _t(xp, h0, c0, u)]

    def step(c, xt):
        h_new, c_new = KL.lstm_cell(xt, c[0], c[1], cin[3], tord)
        return (h_new, c_new), h_new

    y2, (hf2, cf2) = TLSTM._scan(step, (cin[1], cin[2]), cin[0], tmask)
    cgrads = torch.autograd.grad((y2, hf2, cf2), cin, cts)
    for name, got, ref, chain in zip(("dxp", "dh0", "dc0", "dU"), tgrads,
                                     jgrads, cgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=GRAD_ATOL, err_msg=name)
        np.testing.assert_allclose(got.numpy(), chain.numpy(), rtol=0,
                                   atol=GRAD_ATOL, err_msg=name)


def test_segment_gradients_keep_the_reference_casts():
    """dxp in xp's type, dh0 and dc0 in the states', dU in U's."""
    tin = [v.requires_grad_(True) for v in _t(*_seq_inputs(2, 3, 8, seed=3),
                                                dtype=torch.bfloat16)]
    y, (hf, cf) = KL.lstm_seq(*tin)
    grads = torch.autograd.grad(y.float().sum() + cf.float().sum(), tin)
    assert [g.dtype for g in grads] == [torch.bfloat16] * 4


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
def test_segment_function_gradcheck_float64(masked):
    xp, h0, c0, u = _seq_inputs(2, 3, 3, seed=5)
    tin = tuple(v.requires_grad_(True)
                for v in _t(xp, h0, c0, u, dtype=torch.float64))
    mask = (torch.from_numpy(_ragged(2, 3, 6, soft=True)).double()
            if masked else None)
    assert torch.autograd.gradcheck(
        lambda *a: KL.LSTMSequenceFunction.apply(*a, mask, KL.ORDER_IOFG),
        tin, eps=1e-6, atol=1e-7)


# ------------------------------------------------------------------ bodies


def _cu_const(name):
    src = (ROOT / "deeplearning4j_tpu_torch" / "csrc" / "lstm_seq.cu"
           ).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_seq_body_constants_mirror_the_source():
    assert KL.SEQ_CLUSTER == _cu_const("CLUSTER")
    assert KL.SEQ_ROWS == _cu_const("ROWS")
    assert KL.SEQ_MAX_UNITS == _cu_const("MAX_UNITS")
    assert KL.SEQ_SMEM_MAX == _cu_const("SMEM_MAX")
    assert KL.SEQ_THREADS == _cu_const("SEQ_THREADS")


@pytest.mark.parametrize("dtype,b,h,body", [
    (torch.bfloat16, 32, 256, "resident"),
    (torch.float32, 32, 256, "resident"),
    (torch.bfloat16, 4, 256, "resident"),
    (torch.float32, 4, 256, "resident"),
    (torch.bfloat16, 32, 512, "resident"),
    (torch.bfloat16, 200, 512, "resident"),
    (torch.float32, 32, 512, "step"),
    (torch.float32, 32, 2048, "step"),
    (torch.bfloat16, 32, 768, "step"),
    (torch.bfloat16, 32, 100, "step"),
    (torch.float32, 32, 16, "step"),
    (torch.float64, 32, 256, "step"),
], ids=["bf16-32-256", "fp32-32-256", "bf16-4-256", "fp32-4-256",
        "bf16-32-512", "bf16-200-512", "fp32-32-512", "fp32-32-2048",
        "bf16-32-768", "bf16-32-100", "fp32-32-16", "fp64"])
def test_seq_body_gate(dtype, b, h, body):
    """Resident where H is a multiple of 16 x CLUSTER, a block owns at most
    MAX_UNITS units and U's slice, the h buffers, the z exchange and the
    slice staging fit SMEM_MAX; the step body elsewhere. More rows take
    more clusters, never the step body."""
    assert KL.seq_body(dtype, b, h) == body


def test_resident_smem_at_the_char_rnn_geometry():
    """B 32, H 256 with 8 rows a cluster: bf16 U's slice 32 KiB, fp32 64
    KiB, and the fp32 z exchange a slice per thread tile (8 slices)."""
    assert KL.seq_rows(32) == 8 and KL.seq_rows(3) == 8
    assert KL.k_slices(2, 16, 8) == 2 and KL.k_slices(4, 16, 8) == 8
    assert KL.resident_smem(2, 256, 8) == 32768 + 8192 + 2 * 8 * 68 * 4 + 256
    assert KL.resident_smem(4, 256, 8) == 65536 + 16384 + 8 * 8 * 68 * 4 + 512


def test_ablation_variants_apply_to_the_kernel_source():
    """tools/lstm_ablation.py makes its variants by editing
    csrc/lstm_seq.cu's text: every edit still finds its anchor, and every
    variant but the source as built differs from it."""
    spec = importlib.util.spec_from_file_location(
        "lstm_ablation", ROOT / "tools" / "lstm_ablation.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src = pathlib.Path(tool.SOURCE).read_text()
    variants = tool.variant_sources(src)
    assert set(variants) == set(tool.VARIANTS)
    assert variants["built"] == src
    assert all(text != src for name, text in variants.items()
               if name != "built")


# ---------------------------------------------------------------- dispatch


def test_segment_wrapper_on_cpu_and_mixed_devices():
    """CPU tensors take the plain version and count nothing; tensors on two
    devices raise; the seam knows the kernel."""
    assert "lstm_seq_fwd" in TK.KERNELS
    xp, h0, c0, u = _t(*_seq_inputs(2, 3, 4, seed=1))
    TK.reset_counts()
    KL.lstm_seq_fwd(xp, h0, c0, u)
    assert TK.LAUNCHES == dict.fromkeys(TK.KERNELS, 0)
    assert TK.BODY_LAUNCHES == {}
    with pytest.raises(ValueError, match="CUDA"):
        KL.lstm_seq_fwd(xp.to("meta"), h0, c0, u)


def test_layer_dispatches_the_segment_kernel(monkeypatch):
    """``apply_seq`` asks the seam about ``lstm_seq_fwd`` once per call and,
    where it says launch, makes one LSTMSequenceFunction call for the whole
    segment."""
    asked, calls = [], []
    monkeypatch.setattr(TK, "dispatch",
                        lambda name, *a, **k: asked.append(name) or True)
    real = KL.LSTMSequenceFunction.apply
    monkeypatch.setattr(KL.LSTMSequenceFunction, "apply",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    lyr = TLSTM(n_in=3, n_out=4)
    p, _ = lyr.initialize(torch.Generator().manual_seed(1), (None, 3))
    x = torch.randn((2, 6, 3), generator=torch.Generator().manual_seed(2))
    y, _ = lyr.apply_seq(p, x, lyr.init_carry(2))
    assert asked == ["lstm_seq_fwd"] and calls == [(2, 6, 16)]
    assert tuple(y.shape) == (2, 6, 4)
