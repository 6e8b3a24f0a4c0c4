"""Shape bucketing (counterpart of deeplearning4j_tpu/data/bucketing.py):
round a batch up to one of a small fixed set of sizes, padding with zero
rows that the caller slices off again (serving), or that a 0/1 loss-weights
vector keeps out of the loss (training).

In the reference a bucket bounds the number of compiled XLA programs. Here
it bounds the set of shapes a model is warmed, served and trained at.
Padding works on numpy arrays and on tensors alike. A MultiLayerNetwork
batch pads on both axes (:meth:`BucketingPolicy.pad_batch`: the time axis
to its ``seq_buckets`` bucket with zero mask entries over the padding), and
each TBPTT segment onto one (B, seg_len) shape
(:meth:`BucketingPolicy.pad_segment`). A ComputationGraph batch pads its
3-D features, labels and masks (one array, or a dict by name) on the time
axis and all of them on the batch axis
(:meth:`BucketingPolicy.pad_graph_batch`); as in the reference, a graph
batch without masks gets none.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

BucketSpec = Union[None, str, Tuple[int, ...]]  # None | "pow2" | explicit


def dev_weights(cache: dict, size: int, real: int, device):
    """0/1 loss-weights vector on ``device``, memoized in ``cache`` by
    (size, real count, device): ones over the real rows, zeros over the
    padding. ``fit`` passes one on every batch (ones when nothing was
    padded), so a bucketed batch and an unbucketed one take the same
    weighted loss."""
    key = (int(size), int(real), str(device))
    w = cache.get(key)
    if w is None:
        arr = np.zeros(key[0], np.float32)
        arr[:key[1]] = 1.0
        w = torch.from_numpy(arr).to(device)
        cache[key] = w
    return w


def map_mask(m, fn):
    """``fn`` on a mask: one array, each array of a dict by name (None
    entries kept), or None."""
    if m is None:
        return None
    if isinstance(m, dict):
        return {k: None if v is None else fn(v) for k, v in m.items()}
    return fn(m)


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

    def bucket_seq(self, t: int) -> int:
        return self._round(int(t), self.seq_buckets)

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
    def _pad_axis(a, axis: int, target: int):
        """``a`` (a numpy array or a tensor) zero-padded to ``target``
        along ``axis``."""
        if a.shape[axis] == target:
            return a
        if isinstance(a, torch.Tensor):
            shape = list(a.shape)
            shape[axis] = target - a.shape[axis]
            return torch.cat([a, a.new_zeros(shape)], dim=axis)
        widths = [(0, 0)] * a.ndim
        widths[axis] = (0, target - a.shape[axis])
        return np.pad(a, widths)

    @staticmethod
    def _ones(like, shape):
        """float32 ones of ``shape``, a tensor on ``like``'s device when
        ``like`` is a tensor, else a numpy array."""
        if isinstance(like, torch.Tensor):
            return torch.ones(shape, dtype=torch.float32, device=like.device)
        return np.ones(shape, np.float32)

    def pad_batch(self, x, y, mask=None, label_mask=None):
        """Pad one MultiLayerNetwork training batch to its buckets (reference
        ``:224``); returns ``(x, y, mask, label_mask)``. The caller keeps
        the padding rows out of the loss with :func:`dev_weights` over the
        real row count. Under ``seq_buckets`` a 3-D batch gets (B, T) masks
        (ones where it had none) and its time axis padded with zero mask
        entries; 2-D (per-sequence) labels keep their shape. numpy arrays
        stay numpy, tensors stay tensors on their device."""
        n = x.shape[0]
        if self.seq_buckets is not None and x.ndim == 3:
            t = x.shape[1]
            tp = self.bucket_seq(t)
            if mask is None:
                mask = self._ones(x, (n, t))
            if label_mask is None and y.ndim == 3:
                label_mask = self._ones(x, (n, t))
            if tp != t:
                x = self._pad_axis(x, 1, tp)
                mask = self._pad_axis(mask, 1, tp)
                if y.ndim == 3:
                    y = self._pad_axis(y, 1, tp)
                if label_mask is not None:
                    label_mask = self._pad_axis(label_mask, 1, tp)
        np_ = self.bucket_batch(n)
        if np_ != n:
            x, y = self._pad_axis(x, 0, np_), self._pad_axis(y, 0, np_)
            if mask is not None:
                mask = self._pad_axis(mask, 0, np_)
            if label_mask is not None:
                label_mask = self._pad_axis(label_mask, 0, np_)
        return x, y, mask, label_mask

    def pad_segment(self, arrays, mask, label_mask, seg_len: int):
        """Put one TBPTT segment onto the (B, seg_len) shape (reference
        ``:319``): a tail shorter than ``seg_len`` pads with zero features,
        labels and mask entries, and every segment gets masks (ones where
        the batch had none), so the tail and full segments share one shape.
        ``arrays`` is the (x, y) tuple of a MultiLayerNetwork or a dict by
        name of a ComputationGraph, whose masks may be dicts by name too;
        returns (arrays, mask, label_mask) in the same forms."""
        def pad_t(a):
            if a is None or a.ndim != 3 or a.shape[1] >= seg_len:
                return a
            return self._pad_axis(a, 1, seg_len)

        leaves = list(arrays.values()) if isinstance(arrays, dict) else arrays
        ref = next((a for a in leaves if a.ndim == 3), leaves[0])
        n, t = ref.shape[0], min(ref.shape[1], seg_len)
        if mask is None:
            mask = self._ones(ref, (n, t))
        if label_mask is None:
            label_mask = self._ones(ref, (n, t))

        def pad_m(m):
            return self._pad_axis(m, 1, seg_len) if m.shape[1] < seg_len \
                else m

        if isinstance(arrays, dict):
            out = {k: pad_t(v) for k, v in arrays.items()}
        else:
            out = tuple(pad_t(a) for a in arrays)
        return out, map_mask(mask, pad_m), map_mask(label_mask, pad_m)

    def pad_graph_batch(self, features: Sequence, labels: Sequence,
                        mask=None, label_mask=None):
        """Pad one ComputationGraph training batch (lists of (B, ...) arrays
        or tensors; masks one (B, T) array, a dict by name, or None) to its
        buckets (reference ``:267-297``): under ``seq_buckets`` the 3-D
        features and labels and the masks pad their time axis to its
        bucket with zeros, then every array its rows to the batch bucket.
        Returns (features, labels, mask, label_mask); the caller keeps the
        padding rows out of the loss with :func:`dev_weights` over the real
        row count."""
        feats, labs = list(features), list(labels)
        if self.seq_buckets is not None:
            def pad_seq(a):
                return self._pad_axis(a, 1, self.bucket_seq(a.shape[1]))

            feats = [pad_seq(f) if f.ndim == 3 else f for f in feats]
            labs = [pad_seq(y) if y.ndim == 3 else y for y in labs]
            mask = map_mask(mask, pad_seq)
            label_mask = map_mask(label_mask, pad_seq)
        np_ = self.bucket_batch(feats[0].shape[0])

        def pad_rows(a):
            return self._pad_axis(a, 0, np_)

        return ([pad_rows(f) for f in feats], [pad_rows(y) for y in labs],
                map_mask(mask, pad_rows), map_mask(label_mask, pad_rows))

    def pad_inference_batch(self, x) -> Tuple[np.ndarray, int]:
        """Pad a forward batch (rows only); returns (padded, real_n).
        Row-independent layers leave the real rows unchanged; callers
        slice ``[:real_n]``."""
        x = np.asarray(x)
        n = x.shape[0]
        np_ = self.bucket_batch(n)
        return (self._pad_axis(x, 0, np_) if np_ != n else x), n
