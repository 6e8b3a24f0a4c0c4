"""Shape bucketing (counterpart of deeplearning4j_tpu/data/bucketing.py),
the serving half: round a batch up to one of a small fixed set of sizes,
padding with zero rows that the caller slices off again.

In the reference a bucket bounds the number of compiled XLA programs. Here
it bounds the set of shapes a model is warmed and served at, so every
served batch runs at a shape the warmup already ran. Numpy only. The
training half (padded loss weights, time-axis and TBPTT padding) comes with
the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np

BucketSpec = Union[None, str, Tuple[int, ...]]  # None | "pow2" | explicit


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1)."""
    if n <= 1:
        return 1
    return 1 << (int(n) - 1).bit_length()


def _normalize(spec: BucketSpec) -> BucketSpec:
    if spec is None:
        return None
    if isinstance(spec, str):
        if spec.lower() != "pow2":
            raise ValueError(
                f"bucket spec must be 'pow2' or an explicit size list, "
                f"got {spec!r}")
        return "pow2"
    sizes = tuple(sorted({int(s) for s in spec}))
    if not sizes or any(s < 1 for s in sizes):
        raise ValueError(f"bucket sizes must be positive ints, got {spec!r}")
    return sizes


@dataclasses.dataclass(frozen=True)
class BucketingPolicy:
    """Rounding rules for the batch and time axes: ``None`` (not bucketed),
    ``"pow2"`` (next power of two), or an explicit size list (the smallest
    bucket >= n; sizes above the largest bucket pass through unpadded)."""

    batch_buckets: BucketSpec = None
    seq_buckets: BucketSpec = None

    def __post_init__(self):
        object.__setattr__(self, "batch_buckets",
                           _normalize(self.batch_buckets))
        object.__setattr__(self, "seq_buckets", _normalize(self.seq_buckets))

    @staticmethod
    def from_conf(conf) -> Optional["BucketingPolicy"]:
        """Policy from a network conf's knobs, or None when both are off."""
        bb = getattr(conf, "batch_buckets", None)
        sb = getattr(conf, "seq_buckets", None)
        if bb is None and sb is None:
            return None
        return BucketingPolicy(batch_buckets=bb, seq_buckets=sb)

    def to_spec(self) -> str:
        parts = []
        for axis, spec in (("batch", self.batch_buckets),
                           ("seq", self.seq_buckets)):
            if spec is None:
                continue
            parts.append(
                f"{axis}={spec if spec == 'pow2' else ','.join(map(str, spec))}")
        return ";".join(parts)

    @staticmethod
    def _round(n: int, spec: BucketSpec) -> int:
        if spec is None:
            return n
        if spec == "pow2":
            return next_pow2(n)
        for b in spec:
            if b >= n:
                return b
        return n  # above the largest bucket: pass through

    def bucket_batch(self, n: int) -> int:
        return self._round(int(n), self.batch_buckets)

    def largest_batch_bucket(self) -> Optional[int]:
        """Largest explicit batch bucket, or None (pow2 / unbucketed)."""
        if isinstance(self.batch_buckets, tuple):
            return self.batch_buckets[-1]
        return None

    def plan_serving_batch(self, n: int):
        """Split a serving batch of ``n`` rows into chunks that each round
        up to an existing bucket: sizes between buckets pad up, sizes above
        the largest bucket split into largest-bucket chunks with the
        remainder rounding up to its own bucket. Returns
        ``(real_rows, padded_rows)`` pairs covering ``n`` in order. (The
        reference's ``cap`` argument serves its multi-device path, not
        ported yet.)"""
        n = int(n)
        top = self.largest_batch_bucket()
        plan = []
        while n > 0:
            take = n if top is None else min(n, top)
            plan.append((take, self.bucket_batch(take)))
            n -= take
        return plan

    @staticmethod
    def _pad_axis(a: np.ndarray, axis: int, target: int) -> np.ndarray:
        if a.shape[axis] == target:
            return a
        widths = [(0, 0)] * a.ndim
        widths[axis] = (0, target - a.shape[axis])
        return np.pad(a, widths)

    def pad_inference_batch(self, x) -> Tuple[np.ndarray, int]:
        """Pad a forward batch (rows only); returns (padded, real_n).
        Row-independent layers leave the real rows unchanged; callers
        slice ``[:real_n]``."""
        x = np.asarray(x)
        n = x.shape[0]
        np_ = self.bucket_batch(n)
        return (self._pad_axis(x, 0, np_) if np_ != n else x), n
