"""Conv2d forward: the hand-written CUDA kernel and its plain version.

Counterpart of deeplearning4j_tpu/ops/kernels/conv.py. The TPU forward
kernels ``_fwd_kernel`` / ``_fwd_kernel_tiled`` become one implicit-GEMM
CUDA kernel (``csrc/conv2d_fwd.cu``: FMA on the CUDA cores for fp32,
``mma.sync`` tensor cores for bf16); the TPU ``row_tile`` knob is that
kernel's ``row_tile`` argument (output rows per M segment), not a second
body. :func:`conv2d_fwd` launches it on a CUDA tensor and takes
:func:`conv2d_fwd_reference` only for a tensor on the CPU. A geometry with
too few output tiles to fill the card splits its K sum into an fp32
workspace: the kernel library plans the split (``dl4j_conv2d_fwd_plan``),
the wrapper allocates what it asks for.

:func:`conv2d_fwd_reference` is the TPU kernel's own arithmetic in PyTorch:
pad, then for each (ki, kj) tap one strided window reshaped to
(N*OH*OW, Cg) times the (Cg, Og) weight slice per group, summed in fp32.
It is the exact path of ``ops.nn.conv2d`` and what the kernel is held to.

The filter- and input-gradient kernels (``_wgrad_kernel``, and the forward
kernel reused for dgrad) belong to the training slice.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops import kernels as _kern
from deeplearning4j_tpu_torch.ops.kernels import _build

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def resolve_padding(padding, in_hw, k_hw, strides, dilation):
    """'SAME'/'VALID'/int/(ph, pw) -> explicit ((lo, hi), (lo, hi)) pixels
    (the ND4J symmetric convention for numeric pads; SAME computes the
    XLA-compatible asymmetric split)."""
    if padding == "VALID":
        return ((0, 0), (0, 0))
    out = []
    for i in range(2):
        k_eff = (k_hw[i] - 1) * dilation[i] + 1
        if padding == "SAME":
            o = -(-in_hw[i] // strides[i])
            pad = max((o - 1) * strides[i] + k_eff - in_hw[i], 0)
            out.append((pad // 2, pad - pad // 2))
        else:
            p = _pair(padding)[i]
            out.append((p, p))
    return tuple(out)


def _out_size(in_size, pad, k, stride, dil):
    eff = (k - 1) * dil + 1
    return (in_size + pad[0] + pad[1] - eff) // stride + 1


def valid_row_tile(oh: int, row_tile) -> bool:
    """A positive divisor of the output height, or None (whole OH)."""
    if row_tile is None:
        return True
    return isinstance(row_tile, int) and 0 < row_tile <= oh \
        and oh % row_tile == 0


def supports(x, w, data_format, feature_group_count,
             preferred_element_type) -> bool:
    """Geometry/dtype gate for the kernel (mirrors the reference's). The
    kernel sums in fp32 and writes x's type, which is what a
    ``preferred_element_type`` of None or float32 asks for; any other
    request, layout or type is refused."""
    if data_format != "NHWC" or preferred_element_type not in (
            None, torch.float32):
        return False
    if x.dim() != 4 or w.dim() != 4:
        return False
    if x.dtype not in _KERNEL_DTYPES or w.dtype != x.dtype:
        return False
    cin = x.shape[-1]
    if cin % feature_group_count or w.shape[3] % feature_group_count:
        return False
    if w.shape[2] * feature_group_count != cin:
        return False
    return True


def _geometry(x, w, strides, pads, dilation):
    n, h, wd, _ = x.shape
    kh, kw, _, cout = w.shape
    oh = _out_size(h, pads[0], kh, strides[0], dilation[0])
    ow = _out_size(wd, pads[1], kw, strides[1], dilation[1])
    return n, oh, ow, cout


@functools.lru_cache(maxsize=None)
def _splits(device_index: int, dtype_code: int, n, cin, kh, kw, cout, groups,
            oh, ow, row_tile: int) -> int:
    """K slices of one launch, as the kernel library plans them for this
    card (``dl4j_conv2d_fwd_plan``: its block tile, and one wave of
    resident blocks from the occupancy calculator); cached per geometry."""
    splits = ctypes.c_int(1)
    with torch.cuda.device(device_index):
        rc = _build.load().dl4j_conv2d_fwd_plan(
            dtype_code, n, cin, kh, kw, cout, groups, oh, ow, row_tile,
            ctypes.byref(splits))
    _build.check(rc, "conv2d_fwd plan")
    return splits.value


def conv2d_fwd_reference(x, w, strides, pads, dilation, groups):
    """Plain PyTorch version: the tap-sum of the TPU kernel, fp32 sums."""
    n, oh, ow, cout = _geometry(x, w, strides, pads, dilation)
    kh, kw, cg, _ = w.shape
    og = cout // groups
    sh, sw = strides
    dh, dw = dilation
    acc_t = torch.promote_types(x.dtype, torch.float32)
    xp = F.pad(x.to(acc_t), (0, 0, pads[1][0], pads[1][1],
                             pads[0][0], pads[0][1]))
    wf = w.to(acc_t)
    outs = []
    for g in range(groups):
        xg = xp[..., g * cg:(g + 1) * cg]
        acc = torch.zeros((n * oh * ow, og), dtype=acc_t, device=x.device)
        for ki in range(kh):
            for kj in range(kw):
                r0, c0 = ki * dh, kj * dw
                patch = xg[:, r0:r0 + (oh - 1) * sh + 1:sh,
                           c0:c0 + (ow - 1) * sw + 1:sw, :]
                acc.addmm_(patch.reshape(n * oh * ow, cg),
                           wf[ki, kj, :, g * og:(g + 1) * og])
        outs.append(acc)
    out = outs[0] if groups == 1 else torch.cat(outs, dim=1)
    return out.reshape(n, oh, ow, cout).to(x.dtype)


def conv2d_fwd(x, w, strides, pads, dilation, groups,
               row_tile: Optional[int] = None):
    """NHWC x HWIO convolution on the CUDA kernel. ``pads`` is the explicit
    ((lo, hi), (lo, hi)) form from :func:`resolve_padding`; ``row_tile``
    is the number of output rows an M segment spans (None = whole OH).
    A CPU tensor takes :func:`conv2d_fwd_reference`."""
    strides, dilation = _pair(strides), _pair(dilation)
    n, oh, ow, cout = _geometry(x, w, strides, pads, dilation)
    if not valid_row_tile(oh, row_tile):
        raise ValueError(
            f"row_tile {row_tile!r} invalid for output height {oh} "
            "(must be a positive divisor)")
    if x.device.type == "cpu" and w.device.type == "cpu":
        return conv2d_fwd_reference(x, w, strides, pads, dilation, groups)
    if not (x.is_cuda and w.is_cuda and x.device == w.device):
        raise ValueError(f"conv2d_fwd: x on {x.device}, w on {w.device}; "
                         "both must be on one CUDA device")
    if not supports(x, w, "NHWC", groups, None):
        raise ValueError(
            f"conv2d_fwd: unsupported x {tuple(x.shape)} {x.dtype}, "
            f"w {tuple(w.shape)} {w.dtype}, groups {groups}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv2d_fwd: x and w must be contiguous")
    if min(min(p) for p in pads) < 0 or min(strides + dilation) < 1:
        raise ValueError(f"conv2d_fwd: bad pads {pads} / strides {strides} "
                         f"/ dilation {dilation}")
    if oh < 1 or ow < 1:
        raise ValueError(f"conv2d_fwd: empty output {oh}x{ow}")
    out = torch.empty((n, oh, ow, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.load()
    _, h, wd, cin = x.shape
    kh, kw = w.shape[0], w.shape[1]
    splits = _splits(x.device.index, _KERNEL_DTYPES[x.dtype], n, cin, kh, kw,
                     cout, groups, oh, ow, row_tile or 0)
    ws = (torch.empty((splits, n * oh * ow, cout), dtype=torch.float32,
                      device=x.device) if splits > 1 else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.dl4j_conv2d_fwd(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), _KERNEL_DTYPES[x.dtype],
            n, h, wd, cin, kh, kw, cout, groups, oh, ow,
            strides[0], strides[1], dilation[0], dilation[1],
            pads[0][0], pads[1][0], row_tile or 0, splits,
            None if ws is None else ws.data_ptr(), stream)
    _build.check(rc, "conv2d_fwd launch")
    _kern.LAUNCHES["conv2d_fwd"] += 1
    return out
