"""The port's conv forward (deeplearning4j_tpu_torch/ops/kernels/conv.py)
against the JAX package's, on the CPU.

The port's plain version ``conv2d_fwd_reference`` — what the CUDA kernel is
held to on the card — is compared with the reference's Pallas conv kernel
run in interpret mode (as tests/test_kernels.py runs it) and with the
reference's exact ``ops.nn.conv2d``, on one parametrised grid: 1x1/3x3/7x7,
stride 1/2, dilation 2, groups 2, SAME/VALID/explicit pads, f32 and bf16,
and the row-tiled form. Tolerances (docs/KERNELS.md): 2e-5 abs in f32 at
unit scale (tap-order reassociation); bf16 inputs compared in f32 at 1e-2
(one bf16 rounding of an fp32 sum).

The kernel itself runs only on the card (``chip_smoke.py``); the tests of
the dispatch seam below pin what the wrapper does with CPU tensors.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.ops import kernels as JK  # noqa: E402
from deeplearning4j_tpu.ops import nn as jnn  # noqa: E402
from deeplearning4j_tpu.ops.kernels import conv as jconv  # noqa: E402
from deeplearning4j_tpu_torch.ops import kernels as TK  # noqa: E402
from deeplearning4j_tpu_torch.ops import nn as tnn  # noqa: E402
from deeplearning4j_tpu_torch.ops.kernels import conv as tconv  # noqa: E402

F32, BF16 = "float32", "bfloat16"

# (hw, k, stride, dilation, groups, cin, cout, padding, dtype, row_tile,
#  also against the Pallas interpreter). Every case is held to the exact
# conv; the Pallas interpreter costs up to seconds per image on the CPU, so
# it checks the first image of one case of each kind (dilation + groups +
# explicit pads, the row-tiled program, bf16). The 7x7/s2 stem's
# asymmetric SAME pads meet the interpreter in tests/test_torch_slice.py.
_GRID = [
    ((8, 8), 1, 1, 1, 1, 4, 6, "VALID", F32, None, False),
    ((8, 8), 1, 2, 1, 1, 4, 6, "SAME", F32, None, False),
    ((9, 9), 3, 1, 1, 1, 3, 5, "SAME", F32, None, False),
    ((9, 9), 3, 2, 1, 1, 3, 5, "SAME", F32, None, False),
    ((10, 10), 3, 1, 2, 1, 4, 4, "SAME", F32, None, False),
    ((8, 8), 3, 1, 1, 2, 4, 6, "SAME", F32, None, False),
    ((11, 11), 7, 2, 1, 1, 3, 8, "SAME", F32, None, False),
    ((9, 9), 3, 1, 1, 1, 3, 5, (1, 1), F32, None, False),
    ((9, 7), 3, 2, 1, 1, 3, 5, "VALID", F32, None, False),
    ((10, 10), 3, 1, 2, 2, 4, 6, (2, 1), F32, None, True),
    ((8, 8), 3, 1, 1, 1, 4, 4, "SAME", F32, 2, True),
    ((8, 8), 1, 2, 1, 1, 4, 6, "SAME", F32, 2, False),
    ((9, 9), 3, 1, 1, 1, 4, 6, "SAME", BF16, None, False),
    ((11, 11), 7, 2, 1, 1, 3, 8, "SAME", BF16, None, False),
    ((8, 8), 3, 1, 2, 2, 4, 6, "SAME", BF16, None, True),
    ((8, 8), 1, 1, 1, 1, 4, 6, "VALID", BF16, 4, False),
]


def _case_id(c):
    hw, k, s, d, g, _, _, pad, dt, rt, _ = c
    pad = pad if isinstance(pad, str) else "x".join(map(str, pad))
    return f"hw{hw[0]}x{hw[1]}k{k}s{s}d{d}g{g}p{pad}-{dt}-rt{rt}"


def _inputs(hw, k, g, cin, cout, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2,) + hw + (cin,)).astype(np.float32)
    w = (rng.normal(size=(k, k, cin // g, cout)) * 0.3).astype(np.float32)
    return x, w


def _torch(a, dt):
    return torch.from_numpy(a).to(getattr(torch, dt))


def _np(t):
    return t.to(torch.float32).numpy()


@pytest.mark.parametrize("case", _GRID, ids=[_case_id(c) for c in _GRID])
def test_reference_matches_pallas_and_exact(case):
    hw, k, s, d, g, cin, cout, pad, dt, rt, check_pallas = case
    x, w = _inputs(hw, k, g, cin, cout, seed=_GRID.index(case))
    strides, dil = (s, s), (d, d)
    pads = tconv.resolve_padding(pad, hw, (k, k), strides, dil)
    assert pads == jconv.resolve_padding(pad, hw, (k, k), strides, dil)

    jx, jw = jnp.asarray(x, dt), jnp.asarray(w, dt)
    with JK.impl_scope("exact"):
        exact = np.asarray(jnn.conv2d(jx, jw, strides=strides, padding=pad,
                                      dilation=dil, feature_group_count=g)
                           ).astype(np.float32)

    tx, tw = _torch(x, dt), _torch(w, dt)
    ref = tconv.conv2d_fwd_reference(tx, tw, strides, pads, dil, g)
    wrapped = tconv.conv2d_fwd(tx, tw, strides, pads, dil, g, row_tile=rt)
    with TK.impl_scope("exact"):
        op = tnn.conv2d(tx, tw, strides=strides, padding=pad, dilation=dil,
                        feature_group_count=g)
    assert ref.dtype == tx.dtype and tuple(ref.shape) == exact.shape
    assert torch.equal(ref, wrapped) and torch.equal(ref, op)
    tol = dict(atol=2e-5, rtol=0) if dt == F32 else dict(atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(_np(ref), exact, **tol)
    if check_pallas:
        pallas = jconv.conv2d_pallas(jx[:1], jw, strides, pads, dil, g, True,
                                     rt)
        np.testing.assert_allclose(_np(ref[:1]),
                                   np.asarray(pallas, np.float32), **tol)


def test_bias_and_nchw_match_reference_op():
    x, w = _inputs((7, 7), 3, 1, 3, 4, seed=3)
    b = np.linspace(-1, 1, 4).astype(np.float32)
    ref = np.asarray(jnn.conv2d(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b), strides=(2, 2)))
    out = tnn.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                     torch.from_numpy(b), strides=(2, 2))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=0)
    nchw = tnn.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                      torch.from_numpy(w), torch.from_numpy(b),
                      strides=(2, 2), data_format="NCHW")
    np.testing.assert_allclose(nchw.permute(0, 2, 3, 1).numpy(), ref,
                               atol=2e-5, rtol=0)


@pytest.mark.parametrize("impl", ["auto", "exact"])
def test_dispatch_takes_plain_path_on_cpu(impl):
    x, w = (torch.from_numpy(a) for a in _inputs((6, 6), 3, 1, 2, 3, seed=1))
    TK.reset_counts()
    with TK.impl_scope(impl):
        out = tnn.conv2d(x, w)
    assert tuple(out.shape) == (2, 6, 6, 3)
    assert TK.LAUNCHES == dict.fromkeys(TK.KERNELS, 0)
    assert TK.PLAIN_ON_CUDA == dict.fromkeys(TK.KERNELS, 0)


def test_forced_cuda_raises_on_cpu_tensor():
    x, w = (torch.from_numpy(a) for a in _inputs((6, 6), 3, 1, 2, 3, seed=1))
    with TK.impl_scope("cuda"), pytest.raises(RuntimeError, match="CUDA"):
        tnn.conv2d(x, w)


def test_env_knob_resolution(monkeypatch):
    monkeypatch.setenv("DL4J_TORCH_KERNEL_IMPL", "exact")
    assert TK.resolve_impl() == "exact"
    with TK.impl_scope("cuda"):
        assert TK.resolve_impl() == "cuda"
    monkeypatch.setenv("DL4J_TORCH_KERNEL_IMPL", "pallas")
    with pytest.raises(ValueError):
        TK.resolve_impl()
    with pytest.raises(ValueError):
        TK.validate_impl("interpret")


def test_wrapper_checks_row_tile_and_supports():
    x, w = (torch.from_numpy(a) for a in _inputs((8, 8), 3, 1, 2, 3, seed=2))
    pads = tconv.resolve_padding("SAME", (8, 8), (3, 3), (1, 1), (1, 1))
    with pytest.raises(ValueError, match="row_tile"):
        tconv.conv2d_fwd(x, w, (1, 1), pads, (1, 1), 1, row_tile=3)
    assert tconv.supports(x, w, "NHWC", 1, None)
    assert not tconv.supports(x, w, "NCHW", 1, None)
    assert not tconv.supports(x.double(), w.double(), "NHWC", 1, None)
    assert not tconv.supports(x, w.to(torch.bfloat16), "NHWC", 1, None)
    assert not tconv.supports(x, w, "NHWC", 2, None)


_SUPPORTS = [  # (case, x dtype, w dtype, groups, preferred type, takes)
    ("f32", "float32", "float32", 1, None, True),
    ("bf16", "bfloat16", "bfloat16", 1, None, True),
    ("f32-prefers-f32", "float32", "float32", 1, "float32", True),
    ("bf16-prefers-f32", "bfloat16", "bfloat16", 1, "float32", True),
    ("bf16-prefers-bf16", "bfloat16", "bfloat16", 1, "bfloat16", False),
    ("f16", "float16", "float16", 1, None, False),
    ("f64", "float64", "float64", 1, None, False),
    ("mixed", "float32", "bfloat16", 1, None, False),
    ("groups-mismatch", "float32", "float32", 2, None, False),
]


@pytest.mark.parametrize("case", _SUPPORTS, ids=[c[0] for c in _SUPPORTS])
def test_supports_gate(case):
    _, xdt, wdt, groups, pref, takes = case
    x = torch.zeros((1, 5, 5, 4), dtype=getattr(torch, xdt))
    w = torch.zeros((3, 3, 4, 6), dtype=getattr(torch, wdt))
    pref = None if pref is None else getattr(torch, pref)
    assert tconv.supports(x, w, "NHWC", groups, pref) is takes


class _OnCard:
    """Stands for a CUDA tensor in the dispatch rule, which reads only
    ``is_cuda`` and ``device``."""
    is_cuda = True
    device = "cuda:0"


@pytest.mark.parametrize("impl,supported,outcome", [
    ("auto", True, "kernel"),
    ("auto", False, "raise"),
    ("cuda", True, "kernel"),
    ("cuda", False, "raise"),
    ("exact", True, "plain"),
    ("exact", False, "plain"),
])
def test_dispatch_on_cuda_launches_or_raises(impl, supported, outcome):
    TK.reset_counts()
    with TK.impl_scope(impl):
        if outcome == "raise":
            with pytest.raises(ValueError, match="no kernel for GEOM"):
                TK.dispatch("conv2d_fwd", supported, _OnCard(),
                            lambda: "GEOM")
        else:
            assert TK.dispatch("conv2d_fwd", supported, _OnCard(),
                               lambda: "GEOM") is (outcome == "kernel")
    assert TK.PLAIN_ON_CUDA == {**dict.fromkeys(TK.KERNELS, 0),
                                "conv2d_fwd": int(outcome == "plain")}


@pytest.mark.parametrize("data_format", ["NHWC", "NCHW"])
def test_conv2d_gates_on_its_nhwc_view(monkeypatch, data_format):
    seen = []

    def spy(kernel, supported, x, describe):
        seen.append((supported, tuple(x.shape), describe()))
        return False

    monkeypatch.setattr(TK, "dispatch", spy)
    x, w = (torch.from_numpy(a) for a in _inputs((6, 6), 3, 1, 2, 3, seed=1))
    xin = x if data_format == "NHWC" else x.permute(0, 3, 1, 2)
    out = tnn.conv2d(xin, w, data_format=data_format)
    assert seen[0][:2] == (True, (2, 6, 6, 2)) and data_format in seen[0][2]
    back = out if data_format == "NHWC" else out.permute(0, 2, 3, 1)
    assert torch.equal(back, tnn.conv2d(x, w))
