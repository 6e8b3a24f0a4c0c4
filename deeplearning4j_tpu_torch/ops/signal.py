"""Signal-processing ops: FFT family, windows, STFT, the mel filterbank
(counterpart of deeplearning4j_tpu/ops/signal.py).

torch.fft in place of jnp.fft; complex results are complex64 for float32
input, as the reference's. ``mel_weight_matrix`` is a constant generator
computed on the host in numpy and returned as a numpy array, as in the
reference.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops import _compat as C
from deeplearning4j_tpu_torch.ops.registry import op


@op("fft", "signal", differentiable=False)
def fft(x, n=None, axis=-1):
    """Complex FFT of real or complex input."""
    return torch.fft.fft(C.t(x), n=n, dim=axis)


@op("ifft", "signal", differentiable=False)
def ifft(x, n=None, axis=-1):
    return torch.fft.ifft(C.t(x), n=n, dim=axis)


@op("rfft", "signal", differentiable=False)
def rfft(x, n=None, axis=-1):
    """Real-input FFT, onesided (n//2+1 bins)."""
    return torch.fft.rfft(C.t(x), n=n, dim=axis)


@op("irfft", "signal", differentiable=False)
def irfft(x, n=None, axis=-1):
    return torch.fft.irfft(C.t(x), n=n, dim=axis)


def _window(name: str, size: int, periodic: bool = True, dtype="float32"):
    n = int(size)
    if n < 1:
        raise ValueError("window size must be >= 1")
    denom = n if periodic else n - 1
    if denom == 0:
        return torch.ones(1, dtype=C.dtype(dtype))
    k = np.arange(n)
    if name == "hann":
        w = 0.5 - 0.5 * np.cos(2 * np.pi * k / denom)
    elif name == "hamming":
        # ONNX HammingWindow coefficients: 25/46, 21/46
        w = 25.0 / 46.0 - (21.0 / 46.0) * np.cos(2 * np.pi * k / denom)
    else:
        w = (0.42 - 0.5 * np.cos(2 * np.pi * k / denom)
             + 0.08 * np.cos(4 * np.pi * k / denom))
    return torch.as_tensor(w).to(C.dtype(dtype))


op("hann_window", "signal", differentiable=False)(
    lambda size, periodic=True, dtype="float32": _window(
        "hann", size, periodic, dtype))
op("hamming_window", "signal", differentiable=False)(
    lambda size, periodic=True, dtype="float32": _window(
        "hamming", size, periodic, dtype))
op("blackman_window", "signal", differentiable=False)(
    lambda size, periodic=True, dtype="float32": _window(
        "blackman", size, periodic, dtype))


@op("stft", "signal", differentiable=False)
def stft(signal, window=None, *, frame_length, frame_step, onesided=True):
    """ONNX STFT: signal (B, T) real (a trailing size-1 dim squeezed) ->
    complex (B, frames, bins)."""
    x = C.t(signal)
    if x.dim() == 3 and x.shape[-1] == 1:
        x = x[..., 0]
    if x.dim() == 1:
        x = x[None, :]
    fl, step = int(frame_length), int(frame_step)
    n_frames = 1 + (x.shape[1] - fl) // step
    if n_frames < 1:
        raise ValueError("signal shorter than one frame")
    frames = x.unfold(1, fl, step)                # (B, frames, fl)
    if window is not None:
        frames = frames * C.t(window, frames).to(frames.dtype)
    return (torch.fft.rfft(frames, dim=-1) if onesided
            else torch.fft.fft(frames.to(torch.complex64), dim=-1))


@op("mel_weight_matrix", "signal", differentiable=False)
def mel_weight_matrix(num_mel_bins, dft_length, sample_rate,
                      lower_edge_hertz, upper_edge_hertz, dtype="float32"):
    """ONNX MelWeightMatrix (opset 17): [dft_length // 2 + 1,
    num_mel_bins] triangular filters centred uniformly on the HTK mel
    scale, with the spec's integer-bin rounding; a numpy array."""
    num_mel_bins, dft_length = int(num_mel_bins), int(dft_length)
    sample_rate = int(sample_rate)
    if num_mel_bins < 1 or dft_length < 1 or sample_rate < 1:
        raise ValueError(
            "mel_weight_matrix: num_mel_bins, dft_length and sample_rate "
            "must be positive")
    num_spectrogram_bins = dft_length // 2 + 1
    points = np.arange(num_mel_bins + 2, dtype=np.float64)
    low_mel = 2595.0 * np.log10(1.0 + float(lower_edge_hertz) / 700.0)
    high_mel = 2595.0 * np.log10(1.0 + float(upper_edge_hertz) / 700.0)
    mel_step = (high_mel - low_mel) / points.shape[0]
    hz = 700.0 * (np.power(10.0, (points * mel_step + low_mel) / 2595.0)
                  - 1.0)
    bins = (((dft_length + 1) * hz) // sample_rate).astype(np.int64)
    height = max(num_spectrogram_bins, int(bins.max()) + 1)
    out = np.zeros((height, num_mel_bins), np.float64)
    for i in range(num_mel_bins):
        lo, center, hi = bins[i], bins[i + 1], bins[i + 2]
        if center == lo:
            out[center, i] = 1.0
        else:
            for j in range(lo, center + 1):
                out[j, i] = (j - lo) / float(center - lo)
        if hi > center:
            for j in range(center, hi):
                out[j, i] = (hi - j) / float(hi - center)
    name = dtype if isinstance(dtype, str) else str(dtype).replace(
        "torch.", "") if isinstance(dtype, torch.dtype) else np.dtype(
        dtype).name
    return out[:num_spectrogram_bins].astype(np.dtype(name))


@op("complex_pack", "signal", differentiable=False)
def complex_pack(x):
    """(..., 2) real/imag pairs -> complex64."""
    x = C.t(x).float()
    return torch.complex(x[..., 0], x[..., 1])


@op("complex_unpack", "signal", differentiable=False)
def complex_unpack(c):
    """complex -> (..., 2) real/imag."""
    c = C.t(c)
    return torch.stack([c.real, c.imag], dim=-1)
