"""The port's conv backward (``Conv2dFunction``: dgrad on the forward kernel,
wgrad on the K3 kernel, deeplearning4j_tpu_torch/ops/kernels/conv.py)
against the JAX package's, on the CPU.

On a CPU tensor the wrappers take their plain versions, so what is held to
the reference here is the arithmetic the CUDA kernels are held to on the
card (``chip_smoke.py``'s kernel_grad phase):

- dx and dW of ``ops.nn.conv2d`` against ``jax.grad`` of the reference's
  Pallas ``conv2d_pallas`` run in interpret mode (as tests/test_kernels.py
  runs it), and against the exact ``lax.conv_general_dilated`` over the
  reference's six-case grid (tests/test_kernels.py:89-97). Tolerance 2e-4
  abs on unit-scale inputs (docs/KERNELS.md: conv gradients).
- the plain ``conv2d_wgrad_reference`` / ``conv2d_dgrad_reference`` equal
  autograd of the plain forward; the dgrad transform (pads, flip,
  transpose) equals the reference's ``_dy_for_input_grad`` /
  ``_flip_transpose_w``;
- ``torch.autograd.gradcheck`` in fp64; dgrad skipped when x needs no
  gradient; ``cuda`` raises on a CPU tensor in the backward too.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from deeplearning4j_tpu.ops.kernels import conv as jconv  # noqa: E402
from deeplearning4j_tpu_torch.ops import kernels as TK  # noqa: E402
from deeplearning4j_tpu_torch.ops import nn as tnn  # noqa: E402
from deeplearning4j_tpu_torch.ops.kernels import conv as tconv  # noqa: E402

GRAD_ATOL = 2e-4

# the reference's grid (tests/test_kernels.py:89-97):
# (hw, k, strides, dilation, groups, cin, cout, padding)
_CONV_GRID = [
    ((9, 9), (3, 3), (1, 1), (1, 1), 1, 4, 6, "SAME"),
    ((10, 8), (3, 2), (2, 2), (1, 1), 1, 4, 6, "VALID"),
    ((11, 11), (3, 3), (2, 1), (2, 2), 2, 4, 6, (1, 2)),
    ((8, 8), (2, 2), (3, 3), (1, 1), 4, 4, 8, "SAME"),
    ((7, 7), (1, 1), (1, 1), (1, 1), 1, 3, 5, "VALID"),
    ((12, 6), (5, 3), (1, 2), (2, 1), 1, 2, 4, "SAME"),
]
# against the Pallas interpreter: the strided/dilated/grouped case above,
# a stride-2 SAME 3x3 on an even size (asymmetric (0, 1) pads), and a
# stride-2 1x1 with explicit pads of 2, whose dgrad pads lo' and hi' are
# both negative (dy is trimmed; SAME never makes them negative, its pads
# stay inside the window)
_PALLAS = [
    _CONV_GRID[2],
    ((10, 10), (3, 3), (2, 2), (1, 1), 1, 4, 6, "SAME"),
    ((8, 8), (1, 1), (2, 2), (1, 1), 1, 4, 6, (2, 2)),
]


def _ids(grid):
    return ["hw{}x{}k{}x{}s{}x{}d{}x{}g{}p{}".format(
        *c[0], *c[1], *c[2], *c[3], c[4],
        c[7] if isinstance(c[7], str) else "x".join(map(str, c[7])))
        for c in grid]


def _inputs(case, seed, n=2):
    hw, k, s, d, g, cin, cout, pad = case
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n,) + hw + (cin,)).astype(np.float32)
    w = (rng.normal(size=k + (cin // g, cout)) * 0.3).astype(np.float32)
    return x, w


def _port_grads(x, w, case):
    """dx, dW of sum(sin(conv)) through ``ops.nn.conv2d``."""
    _, _, s, d, g, _, _, pad = case
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    out = tnn.conv2d(tx, tw, strides=s, padding=pad, dilation=d,
                     feature_group_count=g)
    assert type(out.grad_fn).__name__ == "Conv2dFunctionBackward"
    return [t.numpy() for t in torch.autograd.grad(out.sin().sum(),
                                                   (tx, tw))]


def _exact_conv(x, w, s, pads, d, g):
    dn = lax.conv_dimension_numbers(x.shape, w.shape,
                                    ("NHWC", "HWIO", "NHWC"))
    return lax.conv_general_dilated(x, w, s, list(pads), rhs_dilation=d,
                                    dimension_numbers=dn,
                                    feature_group_count=g)


@pytest.mark.parametrize("case", _PALLAS, ids=_ids(_PALLAS))
def test_grads_match_pallas_interpreter(case):
    """One image: the Pallas interpreter costs seconds per image."""
    hw, k, s, d, g, _, _, pad = case
    x, w = _inputs(case, seed=_PALLAS.index(case), n=1)
    pads = jconv.resolve_padding(pad, hw, k, s, d)
    ref = jax.grad(lambda x, w: jnp.sum(jnp.sin(jconv.conv2d_pallas(
        x, w, s, pads, d, g, True))), argnums=(0, 1))(jnp.asarray(x),
                                                       jnp.asarray(w))
    for got, want in zip(_port_grads(x, w, case), ref):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=GRAD_ATOL)


@pytest.mark.parametrize("case", _CONV_GRID, ids=_ids(_CONV_GRID))
def test_grads_match_exact_conv(case):
    hw, k, s, d, g, _, _, pad = case
    x, w = _inputs(case, seed=10 + _CONV_GRID.index(case))
    pads = jconv.resolve_padding(pad, hw, k, s, d)
    ref = jax.grad(lambda x, w: jnp.sum(jnp.sin(_exact_conv(
        x, w, s, pads, d, g))), argnums=(0, 1))(jnp.asarray(x),
                                                jnp.asarray(w))
    for got, want in zip(_port_grads(x, w, case), ref):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=GRAD_ATOL)


@pytest.mark.parametrize("which", ["wgrad", "dgrad"])
@pytest.mark.parametrize("case", _CONV_GRID, ids=_ids(_CONV_GRID))
def test_plain_backward_equals_autograd_of_plain_forward(case, which):
    hw, k, s, d, g, _, _, pad = case
    x, w = (torch.from_numpy(a).requires_grad_()
            for a in _inputs(case, seed=20 + _CONV_GRID.index(case)))
    pads = tconv.resolve_padding(pad, hw, k, s, d)
    out = tconv.conv2d_fwd_reference(x, w, s, pads, d, g)
    dy = torch.from_numpy(np.random.default_rng(5).normal(
        size=tuple(out.shape)).astype(np.float32))
    want_dx, want_dw = torch.autograd.grad(out, (x, w), dy)
    if which == "wgrad":
        got = tconv.conv2d_wgrad_reference(x.detach(), dy, *k, s, pads, d, g)
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want_dw, rtol=1e-5, atol=1e-5)
        assert torch.equal(got, tconv.conv2d_wgrad(x.detach(), dy, *k, s,
                                                   pads, d, g))
    else:
        got = tconv.conv2d_dgrad_reference(dy, w.detach(), hw, s, pads, d, g)
        torch.testing.assert_close(got, want_dx, rtol=1e-5, atol=1e-5)
        assert torch.equal(got, tconv.conv2d_dgrad(dy, w.detach(), hw, s,
                                                   pads, d, g))


@pytest.mark.parametrize("case", _CONV_GRID + _PALLAS[1:],
                         ids=_ids(_CONV_GRID + _PALLAS[1:]))
def test_dgrad_transform_matches_reference(case):
    """The dilated, padded or trimmed dy and the flipped, transposed w that
    the forward kernel is launched on, against ``_dy_for_input_grad`` and
    ``_flip_transpose_w``."""
    hw, k, s, d, g, _, cout, pad = case
    x, w = _inputs(case, seed=30)
    pads = tconv.resolve_padding(pad, hw, k, s, d)
    oh = (hw[0] + sum(pads[0]) - (k[0] - 1) * d[0] - 1) // s[0] + 1
    ow = (hw[1] + sum(pads[1]) - (k[1] - 1) * d[1] - 1) // s[1] + 1
    dy = np.random.default_rng(6).normal(size=(2, oh, ow, cout)).astype(
        np.float32)
    want = np.asarray(jconv._dy_for_input_grad(jnp.asarray(dy), hw, pads, k,
                                               s, d))
    spec = tconv.dgrad_pads(hw, k, s, pads, d, (oh, ow))
    dyd = tconv.dilate_dy(torch.from_numpy(dy), s)
    (tlo, thi), (llo, lhi) = ((max(0, -lo), max(0, -hi)) for lo, hi in spec)
    got = torch.nn.functional.pad(
        dyd[:, tlo:dyd.shape[1] - thi, llo:dyd.shape[2] - lhi],
        (0, 0, max(0, spec[1][0]), max(0, spec[1][1]),
         max(0, spec[0][0]), max(0, spec[0][1])))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tconv.flip_transpose_w(torch.from_numpy(w), g).numpy(),
        np.asarray(jconv._flip_transpose_w(jnp.asarray(w), g)))


def test_gradcheck_fp64():
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(1, 5, 4, 4))).requires_grad_()
    w = torch.from_numpy(rng.normal(size=(3, 2, 2, 4))).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda x, w: tnn.conv2d(x, w, strides=(2, 1), padding="SAME",
                                dilation=(1, 2), feature_group_count=2),
        (x, w))


def test_no_dgrad_when_input_needs_no_grad(monkeypatch):
    calls = []
    real = tconv.conv2d_dgrad_reference
    monkeypatch.setattr(tconv, "conv2d_dgrad_reference",
                        lambda *a: calls.append(a) or real(*a))
    x, w = _inputs(_CONV_GRID[0], seed=8)
    tw = torch.from_numpy(w).requires_grad_()
    out = tnn.conv2d(torch.from_numpy(x), tw)
    (dw,) = torch.autograd.grad(out.sum(), (tw,))
    assert calls == [] and dw.shape == tw.shape
    tx = torch.from_numpy(x).requires_grad_()
    torch.autograd.grad(tnn.conv2d(tx, tw).sum(), (tx,))
    assert len(calls) == 1


def test_backward_dispatch_takes_plain_path_on_cpu():
    x, w = (torch.from_numpy(a).requires_grad_()
            for a in _inputs(_CONV_GRID[1], seed=9))
    TK.reset_counts()
    with TK.impl_scope("auto"):
        out = tnn.conv2d(x, w, strides=(2, 2), padding="VALID")
    torch.autograd.grad(out.sum(), (x, w))
    assert TK.LAUNCHES == dict.fromkeys(TK.KERNELS, 0)
    assert TK.PLAIN_ON_CUDA == dict.fromkeys(TK.KERNELS, 0)


def test_forced_cuda_raises_on_cpu_tensor_in_backward():
    x, w = (torch.from_numpy(a) for a in _inputs(_CONV_GRID[0], seed=1))
    pads = tconv.resolve_padding("SAME", (9, 9), (3, 3), (1, 1), (1, 1))
    dy = torch.ones((2, 9, 9, 6))
    with TK.impl_scope("cuda"):
        for need_dx, need_dw in ((True, False), (False, True)):
            with pytest.raises(RuntimeError, match="CUDA"):
                tconv.conv2d_bwd(dy, x, w, (1, 1), pads, (1, 1), 1,
                                 need_dx=need_dx, need_dw=need_dw)
        with pytest.raises(RuntimeError, match="CUDA"):
            tnn.conv2d(x.requires_grad_(), w)


def test_backward_keeps_the_forward_dispatch_mode():
    """The mode is pinned when the forward runs: a backward outside the
    scope (autograd may run it on another thread) still raises here."""
    x, w = (torch.from_numpy(a).requires_grad_()
            for a in _inputs(_CONV_GRID[0], seed=2))
    with TK.impl_scope("exact"):
        out = tnn.conv2d(x, w)
    assert type(out.grad_fn).__name__ == "Conv2dFunctionBackward"
    with TK.impl_scope("cuda"):  # backward after the forward's scope
        dx, _ = torch.autograd.grad(out.sum(), (x, w))
    assert dx.shape == x.shape
