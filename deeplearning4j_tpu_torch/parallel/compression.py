"""Encoded gradient exchange of the data-parallel step (counterpart of
deeplearning4j_tpu/parallel/compression.py, ``:70-271``).

The lane step runs

    per-worker encode(grad + residual) -> pairwise sum of the quantized
    payloads -> dense decode -> weighted-mean normalisation -> update

with the residual and the adaptive threshold as resident state on the
device. Schemes (the ``grad_compression`` knob, env
``DL4J_TPU_GRAD_COMPRESSION``):

- ``threshold``: +-t for |carried| > t, with t snapped to a power of two
  at encode time (``ops/compression.threshold_encode_exact``), so the
  error-feedback conservation ``q + r == carried`` holds bit for bit; the
  threshold adapts toward ``target_sparsity``; sparse int32 wire format
  (4 B a transmitted element);
- ``bitmap``: the same quantized values on the 2-bit bitmap wire format
  (16 codes an int32 word);
- ``onebit``: sign quantization at a power-of-two scale from each worker's
  mean |carried| per tensor;
- ``none``: off.

``threshold <= 0`` is the exact identity encode: every element transmits,
the residual stays zero, and the combine equals the uncompressed lanes'
bit for bit. Hierarchical mode (``hosts > 1``) combines each host's lanes
at full precision first and encodes only the per-host partials; with
power-of-two factors the grouped tree equals the flat one.

Everything here is ``torch.where`` on the device with no host sync, so the
step that calls it can be captured. The wire bytes are the deterministic
accounting of what the encoded transport would ship (one process has no
wire); they equal the reference's on the same inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops.compression import (onebit_encode,
                                                      threshold_encode_exact)
from deeplearning4j_tpu_torch.parallel import gspmd
from deeplearning4j_tpu_torch.parallel.accumulator import div_const, rebuild
from deeplearning4j_tpu_torch.tree import (tree_items, tree_leaves,
                                           tree_map)

SCHEMES = ("none", "threshold", "bitmap", "onebit")


def validate_scheme(scheme: Optional[str]) -> Optional[str]:
    """None passes through (defer to conf/env); anything else must be one
    of SCHEMES."""
    if scheme is None:
        return None
    if scheme not in SCHEMES:
        raise ValueError(
            f"grad_compression must be one of {SCHEMES}, got {scheme!r}")
    return scheme


def resolve_scheme(explicit: Optional[str], conf) -> str:
    """Wrapper argument > the conf's ``grad_compression`` (which folds in
    the DL4J_TPU_GRAD_COMPRESSION default) > 'none'."""
    if explicit is not None:
        return validate_scheme(explicit)
    knobs = getattr(conf, "knobs", None) or {}
    return validate_scheme(knobs.get("grad_compression") or "none")


def _f32(v, device):
    return torch.full((), float(v), dtype=torch.float32, device=device)


def sparse_wire_bytes(n_leaves: int, nnz, workers):
    """ONE participant's sparse threshold-format payload: one int32 a
    transmitted element plus a per-leaf (length, threshold) header."""
    return div_const(nnz, workers) * 4.0 + 8.0 * float(n_leaves)


def _elems(t) -> int:
    return int(np.prod(tuple(t.shape[1:]) or (1,)))


@dataclasses.dataclass(frozen=True)
class GradCompressor:
    """Encode -> combine -> decode core of the compressed exchange.
    Stateless; the residual and threshold live in the step's resident
    state (``init_state`` builds them, ``encode_combine`` threads them).
    The worker axis is the leading dimension of every array."""

    scheme: str = "threshold"
    initial_threshold: float = 1e-3
    target_sparsity: float = 1e-3
    decay: float = 1.2
    min_threshold: float = 1e-8
    max_threshold: float = 1.0
    hosts: int = 1

    def __post_init__(self):
        if self.scheme not in SCHEMES or self.scheme == "none":
            raise ValueError(f"GradCompressor needs an active scheme "
                             f"(threshold|bitmap|onebit), got {self.scheme!r}")
        if self.hosts < 1:
            raise ValueError(f"hosts must be >= 1, got {self.hosts}")

    # ------------------------------------------------------------------ state
    def exchange_axis(self, replicas: int) -> int:
        """How many participants exchange encoded payloads: the hosts in
        hierarchical mode, every worker lane otherwise."""
        if self.hosts > 1:
            if replicas % self.hosts:
                raise ValueError(
                    f"hierarchical compression needs hosts ({self.hosts}) "
                    f"to divide the lane count ({replicas})")
            return self.hosts
        return replicas

    def init_state(self, grads_template, replicas: int):
        """Zero residual stacked over the exchange axis, and the threshold.
        ``grads_template``: ONE worker's gradient tree (or the fused
        engine's list of flat group buffers)."""
        w = self.exchange_axis(replicas)
        residual = tree_map(
            lambda g: torch.zeros((w,) + tuple(g.shape), dtype=g.dtype,
                                  device=g.device), grads_template)
        device = next((t.device for t in tree_leaves(grads_template)), None)
        return {"residual": residual,
                "threshold": _f32(self.initial_threshold, device)}

    def state_matches(self, state, grads_template, replicas: int) -> bool:
        """Whether a restored state tree fits this compressor's shapes."""
        try:
            want = self.init_state(grads_template, replicas)
        except ValueError:
            return False
        if not isinstance(state, dict) or set(state) != set(want):
            return False
        wi, hi = tree_items(want), tree_items(state)
        return (len(wi) == len(hi)
                and all(pa == pb and tuple(np.shape(a)) == tuple(np.shape(b))
                        for (pa, a), (pb, b) in zip(wi, hi)))

    # ----------------------------------------------------------------- encode
    def _encode_leaf(self, carried, threshold):
        if self.scheme in ("threshold", "bitmap"):
            return threshold_encode_exact(carried, threshold)
        # onebit: a scale per (worker, tensor) from mean |carried|
        dims = tuple(range(1, carried.dim()))
        s = (div_const(carried.abs().sum(dim=dims, keepdim=True),
                       int(np.prod(tuple(carried.shape[1:]))))
             if dims else carried.abs())
        q, r, _ = onebit_encode(carried, s)
        return q, r

    def encode_combine(self, stacked_grads, state, inv):
        """One compressed exchange: per-worker error-feedback encode, the
        pairwise-tree sum of the quantized payloads, the weighted-mean
        normalisation by ``inv``. ``stacked_grads``: a tree of (R, ...)
        lane-stacked, weight-scaled gradients. Returns ``(combined,
        new_state, stats)``; ``stats`` are device scalars."""
        leaves = tree_leaves(stacked_grads)
        if not leaves:
            raise ValueError("encode_combine: empty gradient tree")
        replicas = int(leaves[0].shape[0])
        w = self.exchange_axis(replicas)
        if w != replicas:
            local = replicas // w
            # each host's lanes at full precision: the tree over the local
            # axis, host by host
            contrib = tree_map(
                lambda v: gspmd.pairwise_sum(
                    v.reshape((w, local) + tuple(v.shape[1:]))
                    .transpose(0, 1)), stacked_grads)
        else:
            contrib = stacked_grads
        carried = tree_map(lambda g, r: g + r, contrib, state["residual"])
        t = state["threshold"]
        enc = [self._encode_leaf(c, t) for c in tree_leaves(carried)]
        quant = rebuild(carried, [q for q, _ in enc])
        new_res = rebuild(carried, [r for _, r in enc])

        q_leaves = [q for q, _ in enc]
        nnz = sum((q != 0).sum().to(torch.float32) for q in q_leaves)
        elems = sum(_elems(q) for q in q_leaves)
        sparsity = div_const(nnz, w * elems)
        new_t = self._update_threshold(t, sparsity)

        combined = tree_map(
            lambda v: gspmd.pairwise_sum(v) * inv.to(v.dtype), quant)
        stats = self._wire_stats(q_leaves, nnz, w, t)
        return combined, {"residual": new_res, "threshold": new_t}, stats

    def _update_threshold(self, t, sparsity):
        if self.scheme == "onebit":
            return t  # the scale is derived each step
        too_dense = sparsity > self.target_sparsity * 3.0
        too_sparse = sparsity < self.target_sparsity / 3.0
        adapted = torch.where(too_dense, t * self.decay,
                              torch.where(too_sparse,
                                          div_const(t, self.decay), t))
        adapted = torch.clamp(adapted, self.min_threshold,
                              self.max_threshold)
        # t <= 0 is the pinned identity mode: never adapt out of it
        return torch.where(t > 0, adapted, t)

    # ------------------------------------------------------------ wire bytes
    def _wire_stats(self, q_leaves, nnz, workers, t):
        """ONE participant's encoded payload against its dense fp32
        payload (reference ``:232``)."""
        dev = nnz.device
        n_leaves = float(len(q_leaves))
        dense = float(sum(_elems(q) * q.element_size() for q in q_leaves))
        elems = float(sum(_elems(q) for q in q_leaves))
        dense_t = _f32(dense, dev)
        if self.scheme == "threshold":
            wire = sparse_wire_bytes(len(q_leaves), nnz, workers)
            wire = torch.where(t > 0, wire, dense_t)
        else:
            words = float(sum(-(-_elems(q) // 16) for q in q_leaves))
            wire = _f32(words * 4.0 + 4.0 * n_leaves, dev)
            if self.scheme == "bitmap":
                wire = torch.where(t > 0, wire, dense_t)
        wire = wire.to(torch.float32)
        return {
            "wire_bytes": wire,
            "dense_bytes": dense_t,
            "ratio": div_const(wire, dense),
            "nnz": nnz,
            "elements": _f32(elems, dev),
            "workers": _f32(workers, dev),
        }
