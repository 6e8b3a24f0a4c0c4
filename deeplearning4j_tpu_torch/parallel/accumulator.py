"""EncodedGradientsAccumulator and the threshold algorithms (counterpart
of deeplearning4j_tpu/parallel/accumulator.py, ``:30-140``).

The reference's accumulator is the pure-function core of gradient
sharing: each worker threshold-encodes (gradient + residual), the
quantized trees are averaged across workers, and the residual stays with
its worker. Here the same functions run on torch tensors over the port's
``ops/compression.py`` (``threshold_encode``), every decision a
``torch.where`` on the device, so a step that uses them can be captured.
On the same fp32 inputs the quantized trees, residuals, thresholds and
ratios equal the reference's bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops.compression import threshold_encode
from deeplearning4j_tpu_torch.tree import tree_leaves, tree_map


def _scalar(v, device=None):
    """A 0-d fp32 tensor made by a fill on ``device`` (no host copy, so a
    body that makes one can be captured)."""
    return torch.full((), float(v), dtype=torch.float32, device=device)


def div_const(x, c):
    """``x / c`` for a constant ``c`` as the reference's compiled program
    computes it: XLA rewrites a division by a constant into a multiply by
    its fp32 reciprocal, which can differ from the division in the last
    bit. The reciprocal is exact in fp32, so the scalar multiply (in fp32)
    uses it unrounded."""
    return x * float(np.float32(1.0) / np.float32(c))


@dataclasses.dataclass(frozen=True)
class FixedThresholdAlgorithm:
    """FixedThresholdAlgorithm.java parity."""

    threshold: float = 1e-3

    def init_state(self, device=None):
        return _scalar(self.threshold, device)

    def update(self, t, sparsity_ratio):
        return t


@dataclasses.dataclass(frozen=True)
class AdaptiveThresholdAlgorithm:
    """AdaptiveThresholdAlgorithm.java parity: drift the threshold so the
    fraction of transmitted elements stays near ``target_ratio`` (x decay
    above 3x the target, / decay below a third of it)."""

    initial: float = 1e-3
    target_ratio: float = 1e-3
    decay: float = 1.2
    min_threshold: float = 1e-6
    max_threshold: float = 1.0

    def init_state(self, device=None):
        return _scalar(self.initial, device)

    def update(self, t, sparsity_ratio):
        too_dense = sparsity_ratio > self.target_ratio * 3.0
        too_sparse = sparsity_ratio < self.target_ratio / 3.0
        t = torch.where(too_dense, t * self.decay,
                        torch.where(too_sparse,
                                    div_const(t, self.decay), t))
        return torch.clamp(t, self.min_threshold, self.max_threshold)


@dataclasses.dataclass(frozen=True)
class TargetSparsityThresholdAlgorithm:
    """TargetSparsityThresholdAlgorithm.java parity: proportional control,
    the threshold moves by ``gain`` every step toward ``target_ratio``."""

    initial: float = 1e-3
    target_ratio: float = 1e-3
    gain: float = 1.05
    min_threshold: float = 1e-8
    max_threshold: float = 1.0

    def init_state(self, device=None):
        return _scalar(self.initial, device)

    def update(self, t, sparsity_ratio):
        up = sparsity_ratio > self.target_ratio
        t = torch.where(up, t * self.gain, div_const(t, self.gain))
        return torch.clamp(t, self.min_threshold, self.max_threshold)


@dataclasses.dataclass(frozen=True)
class ResidualClippingPostProcessor:
    """ResidualClippingPostProcessor.java parity: every ``frequency``
    steps, clip the residual to +-``max_multiplier`` x threshold."""

    max_multiplier: float = 5.0
    frequency: int = 5

    def apply(self, residual, threshold, iteration):
        lim = threshold * self.max_multiplier
        do = torch.as_tensor((iteration % self.frequency) == 0,
                             device=lim.device)
        return tree_map(
            lambda r: torch.where(do, torch.clamp(r, -lim, lim), r),
            residual)


@dataclasses.dataclass(frozen=True)
class EncodedGradientsAccumulator:
    """encode(grads, residual, threshold, iteration) -> (quantized,
    new_residual, new_threshold, sparsity_ratio), with error feedback; the
    caller averages ``quantized`` across workers and applies it."""

    threshold_algorithm: object = AdaptiveThresholdAlgorithm()
    residual_post_processor: object = ResidualClippingPostProcessor()

    def init_residual(self, grads_template):
        return tree_map(torch.zeros_like, grads_template)

    def encode(self, grads, residual, threshold, iteration):
        carried = tree_map(lambda g, r: g + r, grads, residual)
        enc = [threshold_encode(c, threshold) for c in tree_leaves(carried)]
        quantized = rebuild(carried, [q for q, _ in enc])
        new_residual = rebuild(carried, [r for _, r in enc])
        if self.residual_post_processor is not None:
            new_residual = self.residual_post_processor.apply(
                new_residual, threshold, iteration)
        leaves = tree_leaves(quantized)
        nz = sum((q != 0).sum().to(torch.float32) for q in leaves)
        total = sum(q.numel() for q in leaves)
        ratio = div_const(nz, total)
        new_threshold = self.threshold_algorithm.update(threshold, ratio)
        return quantized, new_residual, new_threshold, ratio


def rebuild(template, leaves: list):
    """``template``'s structure with its leaves taken from ``leaves`` in
    order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)
