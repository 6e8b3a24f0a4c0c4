"""The conv kernel's phase plan (deeplearning4j_tpu_torch/ops/kernels/conv.py:
``dgrad_phase_plan``, ``fwd_axis_plan`` and the ``_Spec`` struct that
``csrc/conv2d_fwd.cu`` reads) evaluated with plain torch, on the CPU.

The kernel computes dx phase by phase: the dx rows with (ih + lo) mod s = r
take only the taps with ki*d = r (mod s), each a stride-1 gather of the
undilated dy, scattered with stride s into dx. ``_evaluate`` below reads the
launch's ``_Spec`` the way the kernel does (in_step, out_step, out0, n_out,
tap0, off, wk, b_trans) and sums, per phase, the shifted dy slices times
the forward's weights read transposed (the kernel's flip and I/O transpose,
with no copy). It is held to:

- ``conv2d_dgrad_reference`` (dilate, pad or trim, plain forward: the
  reference's own construction, independent of the plan) and to the JAX
  package's ``_conv_vjp_bwd`` run through the Pallas interpreter (as
  tests/test_kernels.py runs it), on the reference's case grid plus a 3x3
  stride-2 SAME and a stride-3 case; 2e-4 abs (docs/KERNELS.md: conv
  gradients);
- every dx position written by exactly one phase, and the tapless phases of
  a 1x1 stride-2 conv writing zeros;
- the forward's one-phase plan against ``conv2d_fwd_reference``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.ops.kernels import conv as jconv  # noqa: E402
from deeplearning4j_tpu_torch.ops.kernels import conv as tconv  # noqa: E402

GRAD_ATOL = 2e-4

# (hw, k, strides, dilation, groups, cin, cout, padding): the reference's grid
# (tests/test_kernels.py:89-97, as tests/test_torch_conv_grad.py has it),
# explicit pads of 2 on a 1x1 stride 2 (dy trimmed), stride (2, 1) with
# dilation (1, 2), a 3x3 stride-2 SAME on an even size (pads (0, 1)), a
# stride-3 case, and ResNet-50's 1x1 stride-2 downsampling shape
_CASES = [
    ((9, 9), (3, 3), (1, 1), (1, 1), 1, 4, 6, "SAME"),
    ((10, 8), (3, 2), (2, 2), (1, 1), 1, 4, 6, "VALID"),
    ((11, 11), (3, 3), (2, 1), (2, 2), 2, 4, 6, (1, 2)),
    ((8, 8), (2, 2), (3, 3), (1, 1), 4, 4, 8, "SAME"),
    ((7, 7), (1, 1), (1, 1), (1, 1), 1, 3, 5, "VALID"),
    ((12, 6), (5, 3), (1, 2), (2, 1), 1, 2, 4, "SAME"),
    ((8, 8), (1, 1), (2, 2), (1, 1), 1, 4, 6, (2, 2)),
    ((9, 9), (3, 3), (2, 1), (1, 2), 2, 4, 6, "SAME"),
    ((10, 10), (3, 3), (2, 2), (1, 1), 1, 4, 6, "SAME"),
    ((11, 10), (3, 3), (3, 3), (1, 1), 1, 4, 6, "SAME"),
    ((8, 8), (1, 1), (2, 2), (1, 1), 1, 8, 4, "SAME"),
]


def _ids(grid):
    return ["hw{}x{}k{}x{}s{}x{}d{}x{}g{}p{}".format(
        *c[0], *c[1], *c[2], *c[3], c[4],
        c[7] if isinstance(c[7], str) else "x".join(map(str, c[7])))
        for c in grid]


def _dgrad_inputs(case, seed, n=2):
    hw, k, s, d, g, cin, cout, pad = case
    pads = tconv.resolve_padding(pad, hw, k, s, d)
    out_hw = [(hw[i] + sum(pads[i]) - (k[i] - 1) * d[i] - 1) // s[i] + 1
              for i in range(2)]
    rng = np.random.default_rng(seed)
    dy = rng.normal(size=(n, *out_hw, cout)).astype(np.float32)
    w = (rng.normal(size=k + (cin // g, cout)) * 0.3).astype(np.float32)
    return pads, dy, w


def _evaluate(spec, x, w):
    """The kernel's sum on ``spec`` in plain torch: x (N, in_h, in_w, Cin),
    w as the launch passes it: (kh, kw, Cin/groups, Cout), or with
    ``b_trans`` the forward's (kh, kw, Cout/groups, Cin), read transposed.
    Returns the output and how many phases wrote each output position."""
    n, g = spec.n, spec.groups
    cg, og = spec.cin // g, spec.cout // g
    ah, aw = spec.ax[0], spec.ax[1]
    out = torch.full((n, ah.out_size, aw.out_size, spec.cout), float("nan"),
                     dtype=torch.float64)
    writes = torch.zeros((ah.out_size, aw.out_size), dtype=torch.int64)
    xd, wd = x.double(), w.double()
    for ph in range(ah.phases):
        for pw in range(aw.phases):
            nh, nw = ah.n_out[ph], aw.n_out[pw]
            acc = torch.zeros((n, nh, nw, spec.cout), dtype=torch.float64)
            for ti in range(ah.tap0[ph], ah.tap0[ph + 1]):
                for tj in range(aw.tap0[pw], aw.tap0[pw + 1]):
                    rows = torch.arange(nh) * ah.in_step + ah.off[ti]
                    cols = torch.arange(nw) * aw.in_step + aw.off[tj]
                    keep = (((rows >= 0) & (rows < ah.in_size))[:, None]
                            & ((cols >= 0) & (cols < aw.in_size))[None, :])
                    patch = xd[:, rows.clamp(0, ah.in_size - 1)][
                        :, :, cols.clamp(0, aw.in_size - 1)]
                    patch = patch * keep[None, :, :, None]
                    wt = wd[ah.wk[ti], aw.wk[tj]]
                    for gi in range(g):
                        b = (wt[:, gi * cg:(gi + 1) * cg].t() if spec.b_trans
                             else wt[:, gi * og:(gi + 1) * og])
                        acc[..., gi * og:(gi + 1) * og] += (
                            patch[..., gi * cg:(gi + 1) * cg] @ b)
            ro = ah.out0[ph] + torch.arange(nh) * ah.out_step
            co = aw.out0[pw] + torch.arange(nw) * aw.out_step
            out[:, ro[:, None], co[None, :]] = acc
            writes[ro[:, None], co[None, :]] += 1
    return out, writes


def _dgrad_spec(case, n, pads):
    hw, k, s, d, g, cin, cout, _ = case
    out_hw = [(hw[i] + sum(pads[i]) - (k[i] - 1) * d[i] - 1) // s[i] + 1
              for i in range(2)]
    plans = tconv.dgrad_phase_plan(hw, k, s, pads, d, out_hw)
    return tconv._spec(n, cout, cin, g, k, tuple(out_hw), hw, plans, 0,
                       True)


def _phase_dx(case, pads, dy, w):
    """dx from the phase plan, every position written exactly once."""
    spec = _dgrad_spec(case, dy.shape[0], pads)
    out, writes = _evaluate(spec, torch.from_numpy(dy), torch.from_numpy(w))
    assert bool((writes == 1).all()), writes
    return out


@pytest.mark.parametrize("case", _CASES, ids=_ids(_CASES))
def test_phase_plan_matches_dgrad_reference(case):
    hw, k, s, d, g, *_ = case
    pads, dy, w = _dgrad_inputs(case, seed=_CASES.index(case))
    got = _phase_dx(case, pads, dy, w)
    want = tconv.conv2d_dgrad_reference(torch.from_numpy(dy),
                                        torch.from_numpy(w), hw, s, pads, d,
                                        g)
    np.testing.assert_allclose(got.numpy(), want.double().numpy(), rtol=0,
                               atol=GRAD_ATOL)


@pytest.mark.parametrize("case", _CASES, ids=_ids(_CASES))
def test_phase_plan_matches_pallas_interpreter(case):
    """dx of the reference's ``conv2d_pallas`` custom VJP (``_conv_vjp_bwd``:
    its forward kernel on the dilated dy) in interpret mode, one image."""
    hw, k, s, d, g, cin, *_ = case
    pads, dy, w = _dgrad_inputs(case, seed=40 + _CASES.index(case), n=1)
    x = jnp.zeros((1, *hw, cin), jnp.float32)
    _, vjp = jax.vjp(lambda x: jconv.conv2d_pallas(
        x, jnp.asarray(w), s, pads, d, g, True), x)
    (want,) = vjp(jnp.asarray(dy))
    got = _phase_dx(case, pads, dy, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=GRAD_ATOL)


def test_tapless_phases_of_1x1_stride_2_write_zeros():
    """ResNet-50's downsampling 1x1 stride 2 (SAME, no pads): of its four
    phases, only (0, 0) has a tap; the other three still cover their dx
    positions, with zeros."""
    case = _CASES[-1]
    hw = case[0]
    pads, dy, w = _dgrad_inputs(case, seed=50)
    plans = tconv.dgrad_phase_plan(hw, case[1], case[2], pads, case[3],
                                   dy.shape[1:3])
    for in_step, out_step, phases in plans:
        assert (in_step, out_step) == (1, 2)
        assert [(out0, n_out, taps) for out0, n_out, taps in phases] == [
            (0, 4, ((0, 0),)), (1, 4, ())]
    got = _phase_dx(case, pads, dy, w)
    assert bool((got[:, 0::2, 0::2] != 0).all())
    for r, c in ((0, 1), (1, 0), (1, 1)):
        assert torch.equal(got[:, r::2, c::2],
                           torch.zeros_like(got[:, r::2, c::2]))


def test_phase_plan_drops_phases_without_rows_and_checks_dy():
    """A stride larger than the input leaves phases with no dx row: they
    are left out, not launched; a dy of the wrong extent is refused."""
    (_, _, phases), _ = tconv.dgrad_phase_plan((2, 2), (1, 1), (3, 3),
                                               ((0, 0), (0, 0)), (1, 1),
                                               (1, 1))
    assert [p[:2] for p in phases] == [(0, 1), (1, 1)]
    with pytest.raises(ValueError, match="dy extent"):
        tconv.dgrad_phase_plan((8, 8), (3, 3), (2, 2), ((0, 1), (0, 1)),
                               (1, 1), (5, 4))


# (hw, k, strides, dilation, groups, cin, cout, padding, row_tile)
_FWD = [c + (None,) for c in _CASES] + [
    ((8, 8), (3, 3), (1, 1), (1, 1), 1, 4, 4, "SAME", 2)]


@pytest.mark.parametrize("case", _FWD, ids=_ids(_FWD))
def test_forward_plan_matches_reference(case):
    """The forward's one-phase spec (what ``conv2d_fwd`` launches) read as
    the kernel reads it, against ``conv2d_fwd_reference``."""
    hw, k, s, d, g, cin, cout, pad, row_tile = case
    pads = tconv.resolve_padding(pad, hw, k, s, d)
    rng = np.random.default_rng(60 + _FWD.index(case))
    x = torch.from_numpy(rng.normal(size=(2, *hw, cin)).astype(np.float32))
    w = torch.from_numpy(
        (rng.normal(size=k + (cin // g, cout)) * 0.3).astype(np.float32))
    want = tconv.conv2d_fwd_reference(x, w, s, pads, d, g)
    out_hw = tuple(want.shape[1:3])
    plans = tuple(tconv.fwd_axis_plan(k[i], s[i], d[i], pads[i][0],
                                      out_hw[i]) for i in range(2))
    spec = tconv._spec(2, cin, cout, g, k, hw, out_hw, plans, row_tile,
                       False)
    got, writes = _evaluate(spec, x, w)
    assert bool((writes == 1).all())
    np.testing.assert_allclose(got.numpy(), want.double().numpy(), rtol=0,
                               atol=2e-5)


def test_kernel_gates_hold_the_plan_limits():
    """The kernel's struct holds MAX_AXIS_PHASES phases and MAX_AXIS_TAPS
    taps per axis; the gates refuse what does not fit."""
    x = torch.zeros((1, 40, 40, 2))
    assert tconv.supports(x, torch.zeros((3, 3, 2, 4)), "NHWC", 1, None)
    assert not tconv.supports(x, torch.zeros((33, 1, 2, 4)), "NHWC", 1,
                              None)
    dy = torch.zeros((1, 4, 4, 4))
    w = torch.zeros((3, 3, 2, 4))
    assert tconv.supports_dgrad(dy, w, 1, (8, 8))
    assert not tconv.supports_dgrad(dy, w, 1, (9, 1))
