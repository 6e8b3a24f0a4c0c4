"""ServingModel — one loaded model behind the batching scheduler
(counterpart of deeplearning4j_tpu/serving/model.py), ``kind="classify"``.

A trained ``ComputationGraph`` or ``MultiLayerNetwork`` (the reference
binds either) is bound to the serving tier with ONE
:class:`~deeplearning4j_tpu_torch.data.bucketing.BucketingPolicy` for every
shape decision: warmup builds the net's forward program of each batch
bucket (``net.warmup``; on the card a CUDA graph each), the scheduler
coalesces up to the largest bucket, and a coalesced batch is split by
``plan_serving_batch`` into chunks padded up to a bucket, run through
``net.output`` (a replay of the bucket's program) and split back per
request. Rows are independent, so a
request's result does not depend on what it was batched with.

Rolling reload (``ModelRouter.reload``): :meth:`ServingModel.clone_with_net`
makes a shadow with this model's serving configuration,
:meth:`ServingModel.canary_check` runs a batch through it, and
:meth:`ServingModel.swap_from` adopts its net between batch cycles (under
the lock ``execute`` holds) and advances ``version``.

Not ported yet: ``kind="generate"`` (paged-KV decode, the generate
serving slice), ``quantize`` (int8 serving, ROADMAP item 11) and
``use_mesh`` (multi-device inference); each raises
``NotImplementedError`` naming its slice.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.bucketing import BucketingPolicy

_DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32)


class ServingModel:
    """One model-id's executor (see module doc)."""

    def __init__(self, net, model_id: str, *, kind: str = "classify",
                 bucketing=None, use_mesh: bool = False,
                 quantize: Optional[str] = None):
        if kind == "generate":
            raise NotImplementedError(
                "kind='generate' is not ported yet: it comes with the "
                "generate/paged-decode serving slice")
        if kind != "classify":
            raise ValueError(f"unknown serving kind {kind!r}")
        if quantize is not None:
            raise NotImplementedError(
                "quantize is not ported yet: int8 serving is a later "
                "serving slice")
        if use_mesh:
            raise NotImplementedError(
                "use_mesh is not ported yet: multi-device inference comes "
                "with the parallel slice")
        self.net = net
        self.model_id = str(model_id)
        self.kind = kind
        if bucketing is None:
            bucketing = BucketingPolicy.from_conf(getattr(net, "conf", None))
        if bucketing is None or not isinstance(bucketing.batch_buckets,
                                               tuple):
            # serving needs a finite bucket list (warmup enumerates it)
            bucketing = BucketingPolicy(batch_buckets=_DEFAULT_BUCKETS)
        self.policy = bucketing
        self.warmed = False
        #: chunks run through ``net.output`` since construction
        self.chunks_executed = 0
        #: the weights' version: 1 at registration, +1 per reload
        self.version = 1
        self.reload_time: Optional[float] = None
        self._lock = threading.Lock()

    # -------------------------------------------------------------- shapes
    def coalesce_limit(self) -> int:
        """Largest batch the scheduler should coalesce: the largest bucket."""
        top = self.policy.largest_batch_bucket()
        return int(top) if top else 64

    def payload_rows(self, payload) -> int:
        return int(np.shape(payload)[0])

    def _input_shape(self) -> tuple:
        """The conf's input shape without the batch: a graph's single input
        or a layer stack's ``input_shape`` ((T, F) for BERT)."""
        shape = tuple(getattr(self.net.conf, "input_shape", None) or ())
        if not shape or None in shape:
            raise ValueError(
                f"{self.model_id}: warmup() needs the conf's input shape "
                f"with every dimension fixed, got {shape or None}")
        return shape

    # -------------------------------------------------------------- warmup
    def warmup(self) -> int:
        """Build the net's forward program of every batch bucket before
        traffic (reference ``:175-212``: ``net.warmup(train=False,
        inference=True)``), then run each bucket once through ``output``.
        Returns the number of programs built."""
        shape = self._input_shape()
        primed = self.net.warmup(
            shapes=[(int(b),) + shape for b in self.policy.batch_buckets],
            train=False, inference=True)
        for b in self.policy.batch_buckets:
            self.net.output(np.zeros((int(b),) + shape, np.float32))
        self.warmed = True
        return primed

    # ------------------------------------------------------------- execute
    def execute(self, payloads: List[Any]
                ) -> Tuple[List[np.ndarray], Dict[str, Any]]:
        """Run one coalesced batch; returns (per-payload results, stats)
        with real/padded row counts and the number of chunks run."""
        with self._lock:
            results, real, padded, chunks = self._execute_classify(payloads)
        return results, {"real_rows": real, "padded_rows": padded,
                         "chunks": chunks}

    def _execute_classify(self, payloads):
        xs = np.concatenate([np.asarray(p, np.float32) for p in payloads],
                            axis=0)
        plan = self.policy.plan_serving_batch(xs.shape[0])
        outs, off = [], 0
        for take, _bucket in plan:
            chunk, _ = self.policy.pad_inference_batch(xs[off:off + take])
            y = self.net.output(chunk)[:take]
            outs.append(y.to(torch.float32).cpu().numpy())
            self.chunks_executed += 1
            off += take
        out = np.concatenate(outs, axis=0)
        results, off = [], 0
        for p in payloads:
            k = int(np.shape(p)[0])
            results.append(out[off:off + k])
            off += k
        return results, xs.shape[0], sum(p for _, p in plan), len(plan)

    # -------------------------------------------------------------- reload
    def clone_with_net(self, net) -> "ServingModel":
        """A shadow around ``net`` with this model's serving configuration
        (kind, bucket policy), warmed and checked without touching the
        live model."""
        return ServingModel(net, self.model_id, kind=self.kind,
                            bucketing=self.policy)

    def structure_matches(self, net) -> bool:
        """Whether ``net``'s param tree is swap-compatible with the live
        one: the same paths and leaf shapes."""
        from deeplearning4j_tpu_torch.util.model_serializer import (
            fingerprint, jax_items)

        if fingerprint(self.net.params) != fingerprint(net.params):
            return False
        return all(tuple(a.shape) == tuple(b.shape) for (_, a), (_, b) in
                   zip(jax_items(self.net.params), jax_items(net.params)))

    def canary_check(self, payload=None) -> Tuple[bool, str]:
        """One batch through this model: the forward must finish and give
        finite values. Returns (ok, detail)."""
        try:
            if payload is None:
                payload = np.zeros((1,) + self._input_shape(), np.float32)
            out, _ = self.execute([payload])
            arr = np.asarray(out[0])
            if not np.all(np.isfinite(arr)):
                bad = int(arr.size - np.isfinite(arr).sum())
                return False, (f"canary output has {bad} non-finite "
                               f"value(s) of {arr.size}")
        except Exception as e:  # noqa: BLE001 - a verdict, not a crash
            return False, f"canary raised {type(e).__name__}: {e}"
        return True, ""

    def swap_from(self, shadow) -> int:
        """Adopt the shadow's warmed, checked net between batch cycles (the
        lock ``execute`` holds); returns the new version."""
        with self._lock:
            self.net = shadow.net
            self.policy = shadow.policy
            self.warmed = shadow.warmed
            self.version += 1
            self.reload_time = time.time()
        return self.version

    def describe(self) -> dict:
        return {
            "kind": self.kind,
            "buckets": self.policy.to_spec(),
            "coalesce_limit": self.coalesce_limit(),
            "warmed": self.warmed,
            "version": self.version,
            "reload_time": self.reload_time,
            "chunks_executed": self.chunks_executed,
            "device": str(getattr(self.net, "device", None)),
            "params": int(self.net.num_params())
            if hasattr(self.net, "num_params") else None,
        }
