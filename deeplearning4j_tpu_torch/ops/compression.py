"""Gradient-compression ops: threshold, one-bit and bitmap encodings, and
the weight-only int8 pair with its host-side helpers (counterpart of
deeplearning4j_tpu/ops/compression.py).

The encoded buffers are exchanged between ranks, so they equal the
reference's bit for bit: the power-of-two thresholds come from
frexp/ldexp, the ``+-t`` values from selects (no multiply for a compiler
to contract into the residual's subtract), and ``bitmap_encode`` packs 16
two-bit codes per uint32 word (1 = +t, 2 = -t, 0 = below), lowest element
in the lowest bits.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops import _compat as C
from deeplearning4j_tpu_torch.ops.registry import op


@op("pow2_floor", "compression")
def pow2_floor(t):
    """Largest power of two <= t (t > 0), exactly, by frexp/ldexp."""
    tt = C.t(t).to(torch.float32)
    _, e = torch.frexp(torch.clamp_min(tt, float(np.finfo(np.float32).tiny)))
    return torch.ldexp(torch.ones_like(tt), (e - 1).to(torch.float32))


@op("threshold_encode", "compression", aliases=("encode_threshold",))
def threshold_encode(g, threshold):
    """-> (quantized, residual): +-threshold where |g| > threshold, else
    0; residual = g - quantized."""
    t = C.t(threshold, g).to(g.dtype)
    mask = g.abs() > t
    quantized = torch.where(mask, torch.sign(g) * t, torch.zeros_like(g))
    return quantized, g - quantized


@op("threshold_encode_exact", "compression")
def threshold_encode_exact(g, threshold):
    """Threshold encode at pow2_floor(threshold), so quantized + residual
    == g bit for bit; an element at or beyond t * 2^23 stays in the
    residual; threshold <= 0 transmits everything."""
    t = C.t(threshold, g).to(torch.float32)
    t_eff = pow2_floor(t).to(g.dtype)
    live = t > 0
    a = g.abs()
    mask = (a > t_eff) & (a < t_eff * (2.0 ** 23)) & live
    signed = torch.where(g < 0, -t_eff, t_eff)
    quantized = torch.where(mask, signed,
                            torch.where(live, torch.zeros_like(g), g))
    return quantized, g - quantized


@op("onebit_encode", "compression")
def onebit_encode(g, scale=None):
    """1-bit sign quantization at s = pow2_floor(mean |g|) (or of
    ``scale``): +-s for every |g| >= s. -> (quantized, residual, s)."""
    if scale is None:
        scale = g.abs().mean()
    s = pow2_floor(scale).to(g.dtype)
    a = g.abs()
    mask = (a >= s) & (a < s * (2.0 ** 23))
    signed = torch.where(g < 0, -s, s)
    quantized = torch.where(mask, torch.broadcast_to(signed, g.shape),
                            torch.zeros_like(g))
    return quantized, g - quantized, s


@op("threshold_decode", "compression", aliases=("decode_threshold",))
def threshold_decode(quantized, target=None):
    return quantized if target is None else target + quantized


@op("bitmap_encode", "compression", aliases=("encode_bitmap",))
def bitmap_encode(g, threshold):
    """2 bits per element, 16 per uint32. Returns (packed, residual)."""
    t = C.t(threshold, g).to(g.dtype)
    flat = g.reshape(-1)
    pad = (-flat.shape[0]) % 16
    f = torch.cat([flat, flat.new_zeros(pad)]) if pad else flat
    codes = torch.where(f > t, 1, torch.where(f < -t, 2, 0)).to(torch.int64)
    shifts = torch.arange(16, device=g.device, dtype=torch.int64) * 2
    packed = (codes.reshape(-1, 16) << shifts[None, :]).sum(dim=1)
    quantized = torch.where(flat.abs() > t, torch.sign(flat) * t,
                            torch.zeros_like(flat)).reshape(g.shape)
    return packed.to(torch.uint32), g - quantized


@op("bitmap_decode", "compression", aliases=("decode_bitmap",))
def bitmap_decode(packed, threshold, shape):
    """2-bit codes back to a dense +-threshold float32 tensor."""
    p = C.t(packed).to(torch.int64)
    shifts = torch.arange(16, device=p.device, dtype=torch.int64) * 2
    codes = (p[:, None] >> shifts[None, :]) & 0x3
    n = int(np.prod(C.shape(shape)))
    flat = codes.reshape(-1)[:n]
    t = C.t(threshold, p).to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=p.device)
    return torch.where(flat == 1, t, torch.where(flat == 2, -t, zero)) \
        .reshape(C.shape(shape))


@op("quantize_per_channel", "compression")
def quantize_per_channel(x, scale):
    """Symmetric int8: round(x / scale) clipped to [-127, 127]."""
    x = C.t(x).to(torch.float32)
    s = C.t(scale, x).to(torch.float32)
    s = torch.where(s == 0, torch.ones_like(s), s)
    return torch.clamp(torch.round(x / s), -127.0, 127.0).to(torch.int8)


@op("dequantize_per_channel", "compression")
def dequantize_per_channel(q, scale):
    return C.t(q).to(torch.float32) * C.t(scale, q).to(torch.float32)


def dequantize_np(q, scale) -> np.ndarray:
    """Host-side twin of :func:`dequantize_per_channel` (reference
    ``:174``): the one dequantize expression the int8 archive's restore and
    the serving stash check share."""
    return np.asarray(q, np.float32) * np.asarray(scale, np.float32)


def channel_scale(x: np.ndarray, axis: int = -1) -> np.ndarray:
    """Host-side per-channel scale (reference ``:183``): ``amax(|x|) /
    127`` over every axis but ``axis``, keepdims; a zero channel gets
    scale 1, so it dequantizes to exact zeros."""
    x = np.asarray(x, np.float32)
    axes = tuple(i for i in range(x.ndim) if i != (axis % x.ndim))
    s = np.amax(np.abs(x), axis=axes, keepdims=True) / 127.0
    return np.where(s == 0, 1.0, s).astype(np.float32)
