"""The port's fused LSTM cell (K4) and LSTM layer against the JAX package,
on the CPU.

- The cell's plain version (the CPU side of ``lstm_cell_fwd``, the K4
  wrapper) against the reference's Pallas kernel in interpret mode
  (``lstm_cell_fused(..., "interpret")``), both gate orders: fp32 within
  2e-5 abs (docs/KERNELS.md: the same fp32 arithmetic, summed in another
  order); bf16 within one bf16 ulp of the largest output (both round the
  same fp32 values once; a tie can fall the other way).
- ``LSTMCellFunction``'s adjoint against ``jax.vjp`` of the same cell within
  2e-4 (docs/KERNELS.md's LSTM gradient tolerance), and
  ``torch.autograd.gradcheck`` of it in float64.
- ``lstm_sequence`` against ``lstm_sequence_fused``.
- ``nn.recurrent.LSTM.apply_seq`` with a ragged (B, T) mask against the
  reference layer under its Pallas (interpret) and exact paths, outputs,
  final carries and gradients, on the port's plain step and on its kernel
  step (``LSTMCellFunction`` per step, the kernel's plain version on CPU
  tensors).
- The kernel's ``supports`` gate and dispatch.

The kernel itself against its plain version runs on a card:
``tests/test_torch_cuda.py``.
"""

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


def _cell_inputs(b, h, seed):
    rng = np.random.default_rng(seed)
    xp = rng.normal(size=(b, 4 * h)).astype(np.float32)
    hh = (rng.normal(size=(b, h)) * 0.5).astype(np.float32)
    c = rng.normal(size=(b, h)).astype(np.float32)
    u = (rng.normal(size=(h, 4 * h)) / np.sqrt(h)).astype(np.float32)
    return xp, hh, c, u


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _bf16_ulp(max_abs):
    """One bf16 ulp (8 bits of mantissa) at ``max_abs``."""
    return 2.0 ** (np.floor(np.log2(max_abs)) - 7)


@pytest.mark.parametrize("order", sorted(ORDERS))
@pytest.mark.parametrize("b,h", [(4, 16), (3, 8), (1, 5)])
def test_cell_plain_matches_pallas_kernel_fp32(order, b, h):
    tord, jord = ORDERS[order]
    xp, hh, c, u = _cell_inputs(b, h, seed=b * 100 + h)
    jh, jc = JKL.lstm_cell_fused(*map(jnp.asarray, (xp, hh, c, u)), jord,
                                 "interpret")
    th, tc = KL.lstm_cell_fwd(*_t(xp, hh, c, u), order=tord)
    assert th.dtype == torch.float32 and tuple(th.shape) == (b, h)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=ATOL)
    assert TK.LAUNCHES["lstm_cell_fwd"] == 0  # CPU tensors: the plain version


@pytest.mark.parametrize("order", sorted(ORDERS))
def test_cell_plain_matches_pallas_kernel_bf16(order):
    tord, jord = ORDERS[order]
    xp, hh, c, u = _cell_inputs(4, 16, seed=7)
    jin = [jnp.asarray(a).astype(jnp.bfloat16) for a in (xp, hh, c, u)]
    jh, jc = JKL.lstm_cell_fused(*jin, jord, "interpret")
    tin = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16) for a in jin]
    th, tc = KL.lstm_cell_fwd(*tin, order=tord)
    assert th.dtype == torch.bfloat16 and tc.dtype == torch.bfloat16
    for got, ref in ((th, jh), (tc, jc)):
        ref = np.asarray(ref.astype(jnp.float32))
        tol = _bf16_ulp(np.abs(ref).max())
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=tol)


@pytest.mark.parametrize("order", sorted(ORDERS))
def test_cell_adjoint_matches_jax_vjp(order):
    tord, jord = ORDERS[order]
    xp, hh, c, u = _cell_inputs(4, 16, seed=11)
    rng = np.random.default_rng(12)
    dh = rng.normal(size=hh.shape).astype(np.float32)
    dc = rng.normal(size=c.shape).astype(np.float32)
    _, vjp = jax.vjp(
        lambda *a: JKL.lstm_cell_fused(*a, jord, "interpret"),
        *map(jnp.asarray, (xp, hh, c, u)))
    jgrads = vjp((jnp.asarray(dh), jnp.asarray(dc)))
    tin = [t.requires_grad_(True) for t in _t(xp, hh, c, u)]
    th, tc = KL.lstm_cell(*tin, order=tord)
    tgrads = torch.autograd.grad((th, tc), tin,
                                 (torch.from_numpy(dh), torch.from_numpy(dc)))
    for name, got, ref in zip(("dxp", "dh", "dc", "dU"), tgrads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=GRAD_ATOL, err_msg=name)


def test_cell_adjoint_keeps_the_reference_casts():
    """dxp in xp's type, dh_prev/dc_prev in the state's, dU in U's."""
    xp, hh, c, u = _cell_inputs(2, 8, seed=3)
    tin = [t.requires_grad_(True) for t in _t(xp, hh, c, u,
                                              dtype=torch.bfloat16)]
    th, tc = KL.lstm_cell(*tin)
    grads = torch.autograd.grad((th.float().sum() + tc.float().sum()), tin)
    assert [g.dtype for g in grads] == [torch.bfloat16] * 4


@pytest.mark.parametrize("order", sorted(ORDERS))
def test_cell_function_gradcheck_float64(order):
    tord, _ = ORDERS[order]
    xp, hh, c, u = _cell_inputs(2, 3, seed=5)
    tin = tuple(t.requires_grad_(True)
                for t in _t(xp, hh, c, u, dtype=torch.float64))
    assert torch.autograd.gradcheck(
        lambda *a: KL.LSTMCellFunction.apply(*a, tord), tin, eps=1e-6,
        atol=1e-7)


def test_sequence_matches_reference_sequence():
    rng = np.random.default_rng(21)
    t_len, b, h = 6, 3, 8
    xp = rng.normal(size=(t_len, b, 4 * h)).astype(np.float32)
    _, hh, c, u = _cell_inputs(b, h, seed=22)
    jys, (jh, jc) = JKL.lstm_sequence_fused(
        *map(jnp.asarray, (xp, hh, c, u)), JKL.ORDER_IFOG, "interpret")
    tys, (th, tc) = KL.lstm_sequence(*_t(xp, hh, c, u))
    for got, ref in ((tys, jys), (th, jh), (tc, jc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=ATOL)


# ------------------------------------------------------------------- layer


@pytest.fixture(scope="module")
def layer_case():
    """The reference's ``test_layer_masked_equivalence`` case: LSTM(5 -> 8)
    over (3, 6, 5) inputs with a ragged (B, T) mask, params from the
    reference's initializer."""
    jl = JLSTM(n_in=5, n_out=8)
    p, _ = jl.initialize(jax.random.PRNGKey(0), (None, 5))
    params = {k: np.asarray(v) for k, v in p.items()}
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 6, 5)).astype(np.float32)
    mask = (rng.random((3, 6)) > 0.3).astype(np.float32)
    mask[2, 3:] = 0.0  # a ragged tail
    refs = {}
    for impl in ("exact", "pallas"):
        def loss(pp, impl=impl):
            with JK.impl_scope(impl):
                y, (hf, cf) = jl.apply_seq(pp, jnp.asarray(x),
                                           jl.init_carry(3),
                                           mask=jnp.asarray(mask))
            return jnp.sum(jnp.sin(y)), (y, hf, cf)

        (_, outs), g = jax.value_and_grad(loss, has_aux=True)(p)
        refs[impl] = ([np.asarray(o) for o in outs],
                      {k: np.asarray(v) for k, v in g.items()})
    return params, x, mask, refs


def _port_layer_run(params, x, mask):
    lyr = TLSTM(n_in=5, n_out=8)
    p = {k: torch.from_numpy(v.copy()).requires_grad_(True)
         for k, v in params.items()}
    y, (hf, cf) = lyr.apply_seq(p, torch.from_numpy(x),
                                lyr.init_carry(3, torch.float32),
                                mask=torch.from_numpy(mask))
    g = torch.autograd.grad(torch.sin(y).sum(), list(p.values()))
    return [y.detach().numpy(), hf.detach().numpy(), cf.detach().numpy()], \
        dict(zip(p, (t.numpy() for t in g)))


@pytest.mark.parametrize("step", ["plain", "kernel"])
@pytest.mark.parametrize("ref_impl", ["exact", "pallas"])
def test_layer_masked_matches_reference(layer_case, monkeypatch, step,
                                        ref_impl):
    """Values (2e-5) and gradients (2e-4) of the port's layer against the
    reference layer; ``kernel`` forces the port's kernel step (one
    LSTMCellFunction per step) as the dispatch takes it on a card. Masked
    steps keep the carry and output zeros in both."""
    params, x, mask, refs = layer_case
    if step == "kernel":
        monkeypatch.setattr(TK, "dispatch", lambda *a, **k: True)
    outs, grads = _port_layer_run(params, x, mask)
    ref_outs, ref_grads = refs[ref_impl]
    for got, ref in zip(outs, ref_outs):
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    assert np.all(outs[0][mask == 0] == 0.0)
    for k in ref_grads:
        np.testing.assert_allclose(grads[k], ref_grads[k], rtol=0,
                                   atol=GRAD_ATOL, err_msg=k)


def test_layer_init_matches_reference_layout():
    """W (n_in, 4H), U (H, 4H), b (4H,) with the forget block at 1."""
    gen = torch.Generator().manual_seed(0)
    p, s = TLSTM(n_in=5, n_out=8).initialize(gen, (None, 5))
    jp, _ = JLSTM(n_in=5, n_out=8).initialize(jax.random.PRNGKey(0),
                                              (None, 5))
    assert s == {}
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        k: tuple(v.shape) for k, v in jp.items()}
    np.testing.assert_array_equal(p["b"].numpy(), np.asarray(jp["b"]))


# ---------------------------------------------------------------- dispatch


def test_supports_gate():
    xp = torch.zeros((2, 32))
    u = torch.zeros((8, 32))
    assert KL.supports(xp, u, "sigmoid", "tanh")
    assert KL.supports(xp.bfloat16(), u.bfloat16(), "Sigmoid", "TANH")
    assert not KL.supports(xp, u, "hardsigmoid", "tanh")
    assert not KL.supports(xp, u, "sigmoid", "relu")
    assert not KL.supports(xp.double(), u.double(), "sigmoid", "tanh")
    assert not KL.supports(xp, u.bfloat16(), "sigmoid", "tanh")
    assert not KL.supports(xp[:, :28], u, "sigmoid", "tanh")
    assert not KL.supports(xp, u[:, :28], "sigmoid", "tanh")


def test_layer_dispatch_on_cpu():
    """``auto`` on a CPU tensor takes the plain step and counts nothing;
    ``cuda`` needs CUDA tensors."""
    lyr = TLSTM(n_in=3, n_out=4)
    p, _ = lyr.initialize(torch.Generator().manual_seed(1), (None, 3))
    x = torch.randn((2, 5, 3), generator=torch.Generator().manual_seed(2))
    TK.reset_counts()
    with TK.impl_scope("auto"):
        lyr.apply_seq(p, x, lyr.init_carry(2))
    assert TK.LAUNCHES == dict.fromkeys(TK.KERNELS, 0)
    assert TK.PLAIN_ON_CUDA == dict.fromkeys(TK.KERNELS, 0)
    with TK.impl_scope("cuda"), pytest.raises(RuntimeError, match="CUDA"):
        lyr.apply_seq(p, x, lyr.init_carry(2))


def test_kernel_wrapper_refuses_mixed_devices():
    xp, hh, c, u = _t(*_cell_inputs(2, 4, seed=1))
    with pytest.raises(ValueError, match="CUDA"):
        KL.lstm_cell_fwd(xp.to("meta"), hh, c, u)
