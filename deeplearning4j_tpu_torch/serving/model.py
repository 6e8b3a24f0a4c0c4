"""ServingModel — one loaded model behind the batching scheduler
(counterpart of deeplearning4j_tpu/serving/model.py).

A trained ``ComputationGraph`` or ``MultiLayerNetwork`` (the reference
binds either) is bound to the serving tier with ONE
:class:`~deeplearning4j_tpu_torch.data.bucketing.BucketingPolicy` for every
shape decision. Two kinds:

- ``kind="classify"``: warmup builds the net's forward program of each
  batch bucket (``net.warmup``; on the card a CUDA graph each; with
  ``export_dir`` through the on-disk AOT store, reference ``:207``), the
  scheduler coalesces up to the largest bucket, and a coalesced batch is
  split by ``plan_serving_batch`` into chunks padded up to a bucket, run
  through ``net.output`` (a replay of the bucket's program) and split back
  per request. Rows are independent, so a request's result does not
  depend on what it was batched with. With ``quantize="int8"`` the chunks
  run through a ``serving.classify_int8`` program per bucket instead: the
  net's forward over the resident int8 leaves, dequantized inside it
  (``serving/quantize.py``).
- ``kind="generate"``: paged-KV decode of a decoder-only LM
  (``serving/generate.py``: paged pool, prefix cache, chunked prefill,
  speculative decoding with ``draft_net``, ``quantize="int8"``). A request
  is one token prompt; a coalesced batch decodes as one batch, each
  request's ``max_new_tokens``/``temperature``/``eos_id`` arriving as the
  scheduler's options (requests share a batch only with equal options). A
  batch the pool cannot hold sheds :class:`PoolExhaustedError` (429).

Rolling reload (``ModelRouter.reload``): :meth:`ServingModel.clone_with_net`
makes a shadow with this model's serving configuration,
:meth:`ServingModel.canary_check` runs a batch through it (a generate
model's health probe first), and :meth:`ServingModel.swap_from` adopts its
net, generator and int8 leaves between batch cycles (under the lock
``execute`` holds) and advances ``version``. ``execute`` reports the
programs the batch built (``recompiles``: 0 in steady state).

Faults and tracing (reference ``:216-245``): the scheduler passes its
batch number as ``_step``, and only then can ``serving_slow_batch`` (a
real sleep of ``arg`` ms on the worker thread) and
``serving_compute_error`` (the batch raises) fire; a reload's canary and a
direct call pass none and never consume them. ``_trace`` (a head-sampled
batch) emits the batch's pad and device phase spans (the generator its
prefill and decode spans) through the deferred-event path.

``use_mesh=True`` (reference ``:146-151``) serves classify through
``parallel.ParallelInference`` with this model's bucket policy: a
coalesced batch is planned by ``plan_serving_batch(n,
cap=batch_limit)`` and each chunk runs the net's forward program. On one
device the mesh is the net's device. ``quantize`` with ``use_mesh`` is
refused, as in the reference.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.bucketing import BucketingPolicy
from deeplearning4j_tpu_torch.device import as_tensor
from deeplearning4j_tpu_torch.nn import capture
from deeplearning4j_tpu_torch.util import faults as fl
from deeplearning4j_tpu_torch.util import telemetry as tm
from deeplearning4j_tpu_torch.util.compile_watcher import get_watcher

_DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32)


class ServingModel:
    """One model-id's executor (see module doc)."""

    def __init__(self, net, model_id: str, *, kind: str = "classify",
                 bucketing=None, use_mesh: bool = False,
                 max_length: Optional[int] = None,
                 prefill_buckets=None,
                 paged: bool = True, block_size: int = 16,
                 pool_blocks: Optional[int] = None,
                 prefix_cache: bool = False,
                 prefill_chunk: Optional[int] = None,
                 draft_net=None, spec_tokens: int = 4,
                 quantize: Optional[str] = None,
                 export_dir: Optional[str] = None):
        if kind not in ("classify", "generate"):
            raise ValueError(f"unknown serving kind {kind!r}")
        self.net = net
        self._use_mesh = bool(use_mesh)
        self.model_id = str(model_id)
        self.kind = kind
        self.quantize = quantize
        #: the AOT store ``warmup`` passes to ``net.warmup`` (reference
        #: ``:71``; ``util/aot_store.py``)
        self.export_dir = export_dir
        # the decode engine's knobs, kept for clone_with_net
        self._gen_kw = dict(max_length=max_length, paged=paged,
                            block_size=block_size, pool_blocks=pool_blocks,
                            prefix_cache=prefix_cache,
                            prefill_chunk=prefill_chunk,
                            draft_net=draft_net, spec_tokens=spec_tokens)
        self._prefill_buckets = prefill_buckets
        if isinstance(bucketing, str):
            bucketing = BucketingPolicy.from_spec(bucketing)
        if bucketing is None:
            bucketing = BucketingPolicy.from_conf(getattr(net, "conf", None))
        if bucketing is None or not isinstance(bucketing.batch_buckets,
                                               tuple):
            # serving needs a finite bucket list (warmup enumerates it);
            # the conf's sequence buckets stay
            seq = getattr(bucketing, "seq_buckets", None)
            bucketing = BucketingPolicy(batch_buckets=_DEFAULT_BUCKETS,
                                        seq_buckets=seq)
        self.policy = bucketing
        self.generator = None
        self._qp = None
        #: the int8 classify programs by signature (in the net's pool)
        self._qprograms: Dict[tuple, capture.Program] = {}
        if kind == "generate":
            from deeplearning4j_tpu_torch.serving.generate import Generator

            self.generator = Generator(
                net, batch_buckets=self.policy.batch_buckets,
                prefill_buckets=prefill_buckets or self.policy.seq_buckets,
                quantize=quantize, model_id=self.model_id, **self._gen_kw)
            self.policy = self.generator.policy
            self._qp = self.generator._qp
        elif quantize is not None:
            if use_mesh:
                raise ValueError("quantize + use_mesh is not supported: "
                                 "the mesh path serves fp32 params")
            from deeplearning4j_tpu_torch.serving.quantize import \
                maybe_quantize

            self._qp = maybe_quantize(net, quantize, model_id=self.model_id)
        #: the mesh path (``use_mesh``): ParallelInference over this
        #: model's policy, the one bucket source for warmup and planning
        self.inference = None
        if use_mesh and kind != "generate":
            from deeplearning4j_tpu_torch.parallel.wrapper import \
                ParallelInference

            self.inference = ParallelInference(net, bucketing=self.policy)
        self.warmed = False
        #: chunks run through the forward since construction
        self.chunks_executed = 0
        #: the weights' version: 1 at registration, +1 per reload
        self.version = 1
        self.reload_time: Optional[float] = None
        # reentrant: a chunked prefill's yield hook runs queued batches
        # through execute() from the same worker thread
        self._lock = threading.RLock()

    @property
    def supports_chunked_prefill(self) -> bool:
        """Whether this model's batches can yield between prefill chunks
        (the scheduler wires its hook only into such models)."""
        return (self.generator is not None
                and self.generator.prefill_chunk is not None)

    # -------------------------------------------------------------- shapes
    def coalesce_limit(self) -> int:
        """Largest batch the scheduler should coalesce: the largest bucket."""
        top = self.policy.largest_batch_bucket()
        return int(top) if top else 64

    def payload_rows(self, payload) -> int:
        if self.kind == "generate":
            return 1  # one prompt a request
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
        """Build every program before traffic (reference ``:175-212``): the
        generator's prefill/decode programs, the int8 forward of each batch
        bucket, or the net's forward program of each bucket
        (``net.warmup(train=False, inference=True,
        export_dir=self.export_dir)``), each bucket then run once. Returns
        the number of programs built."""
        if self.kind == "generate":
            primed = self.generator.warmup()
        else:
            shape = self._input_shape()
            if self._qp is not None:
                for b in self.policy.batch_buckets:
                    self._forward_int8(np.zeros((int(b),) + shape,
                                                np.float32))
                primed = len(self.policy.batch_buckets)
            elif self.inference is not None:
                primed = self.inference.warmup(
                    batch_sizes=self.policy.batch_buckets,
                    input_shape=shape)
            else:
                primed = self.net.warmup(
                    shapes=[(int(b),) + shape
                            for b in self.policy.batch_buckets],
                    train=False, inference=True, export_dir=self.export_dir)
                for b in self.policy.batch_buckets:
                    self.net.output(np.zeros((int(b),) + shape, np.float32))
        self.warmed = True
        return primed

    # ------------------------------------------------------------- execute
    def execute(self, payloads: List[Any], _trace: bool = False,
                _step: Optional[int] = None, _yield=None, **opts
                ) -> Tuple[List[Any], Dict[str, Any]]:
        """Run one coalesced batch; returns (per-payload results, stats):
        real/padded row counts, the chunks run and the programs the batch
        built (``recompiles``, counted on this thread). Generate batches
        take the scheduler's options and add their decode stats.
        ``_step`` (the scheduler's batch number) arms the serving faults;
        ``_trace`` emits the batch's phase spans (see the module doc)."""
        if _step is not None:
            injector = fl.get_injector()
            fault = injector.fire(fl.SERVING_SLOW_BATCH, step=_step)
            if fault is not None:
                # a real stall on the worker thread: requests queued
                # behind it age toward their deadlines as behind a wedged
                # device
                time.sleep((fault.arg or 50.0) / 1e3)
            if injector.fire(fl.SERVING_COMPUTE_ERROR,
                             step=_step) is not None:
                raise RuntimeError(
                    f"{self.model_id}: injected serving compute error "
                    f"(batch {_step})")
        watcher = get_watcher()
        with self._lock:
            before = watcher.thread_traces()
            stats: Dict[str, Any] = {}
            if self.kind == "generate":
                results, real, padded = self._execute_generate(
                    payloads, stats, _yield, _trace=_trace, **opts)
                chunks = 1
            else:
                if opts:
                    raise ValueError(f"classify takes no options, got "
                                     f"{opts}")
                results, real, padded, chunks = self._execute_classify(
                    payloads, _trace=_trace)
            stats.update({"real_rows": real, "padded_rows": padded,
                          "chunks": chunks,
                          "recompiles": watcher.thread_traces() - before})
        return results, stats

    def _emit(self, name: str, t0_ns: int, **args):
        # deferred (no registry lock): this runs on the scheduler worker
        tm.get_telemetry().event_deferred(name, t0_ns, time.time_ns(),
                                          model=self.model_id, **args)

    def _execute_classify(self, payloads, _trace: bool = False):
        # the bucket-padding phase (host) apart from the device phase, so
        # a sampled trace shows where the milliseconds went
        t0 = time.time_ns() if _trace else 0
        xs = np.concatenate([np.asarray(p, np.float32) for p in payloads],
                            axis=0)
        cap = (self.inference.batch_limit if self.inference is not None
               else None)
        plan = self.policy.plan_serving_batch(xs.shape[0], cap=cap)
        padded = sum(p for _, p in plan)
        if self.inference is not None:
            if _trace:
                self._emit("serving.exec.pad", t0, rows=xs.shape[0],
                           padded=padded)
            t1 = time.time_ns() if _trace else 0
            out = self.inference.output(xs)  # plans the chunks inside
            self.chunks_executed += len(plan)
            if _trace:
                self._emit("serving.exec.device", t1, rows=xs.shape[0],
                           padded=padded, chunks=len(plan))
            results, off = [], 0
            for p in payloads:
                k = int(np.shape(p)[0])
                results.append(out[off:off + k])
                off += k
            return results, xs.shape[0], padded, len(plan)
        chunks, off = [], 0
        for take, _bucket in plan:
            chunk, _ = self.policy.pad_inference_batch(xs[off:off + take])
            chunks.append((chunk, take))
            off += take
        if _trace:
            self._emit("serving.exec.pad", t0, rows=xs.shape[0],
                       padded=padded)
        t1 = time.time_ns() if _trace else 0
        outs = []
        for chunk, take in chunks:
            if self._qp is not None:
                y = self._forward_int8(chunk)[:take]
            else:
                y = self.net.output(chunk)[:take]
            outs.append(y.to(torch.float32).cpu().numpy())
            self.chunks_executed += 1
        out = np.concatenate(outs, axis=0)
        if _trace:
            self._emit("serving.exec.device", t1, rows=xs.shape[0],
                       padded=padded, chunks=len(plan))
        results, off = [], 0
        for p in payloads:
            k = int(np.shape(p)[0])
            results.append(out[off:off + k])
            off += k
        return results, xs.shape[0], padded, len(plan)

    def _forward_int8(self, x):
        """The int8 classify forward (reference ``:126-145``): the net's
        layers over the resident int8 leaves dequantized inside it, a
        ``serving.classify_int8`` program per signature (eager inside
        ``capture.disabled()``)."""
        x = as_tensor(x, self.net.device)
        net, qp = self.net, self._qp

        def body(x):
            with net._kscope(), torch.no_grad():
                return _forward_with(net, qp.rebuild(), x)

        if not capture.enabled():
            return body(x)
        return net._program(self._qprograms, capture.dispatch_sig(x),
                            "serving.classify_int8", body, (x,),
                            train=False)(x).clone()

    def _execute_generate(self, payloads, stats, _yield=None,
                          _trace: bool = False, **opts):
        prompts = [[int(v) for v in np.asarray(p).ravel()]
                   for p in payloads]
        t0 = time.perf_counter()
        tokens = self.generator.generate(
            prompts, max_new_tokens=int(opts.get("max_new_tokens", 16)),
            temperature=float(opts.get("temperature", 0.0)),
            eos_id=opts.get("eos_id"), trace=_trace, stats=stats,
            yield_hook=_yield)
        stats["decode_seconds"] = time.perf_counter() - t0
        stats["decode_tokens"] = sum(len(t) for t in tokens)
        real = len(prompts)
        return tokens, real, self.policy.bucket_batch(real)

    # -------------------------------------------------------------- reload
    def clone_with_net(self, net) -> "ServingModel":
        """A shadow around ``net`` with this model's serving configuration
        (kind, bucket policy, export dir), warmed and checked without
        touching the live model."""
        return ServingModel(net, self.model_id, kind=self.kind,
                            bucketing=self.policy, use_mesh=self._use_mesh,
                            prefill_buckets=self._prefill_buckets,
                            quantize=self.quantize,
                            export_dir=self.export_dir, **self._gen_kw)

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
        finite values; a generate model runs its health probe (pool
        conservation, finite prefill logits) and decodes two tokens.
        Returns (ok, detail)."""
        try:
            if self.kind == "generate":
                if not self.generator.health_probe():
                    return False, "non-finite prefill logits"
                toks, _ = self.execute(
                    [np.asarray([1, 2, 3], np.int64)]
                    if payload is None else [payload], max_new_tokens=2)
                if not toks or not toks[0]:
                    return False, "canary decode produced no tokens"
                return True, ""
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
            self.generator = shadow.generator
            # the int8 leaves and their programs swap with the net
            self._qp = shadow._qp
            self._qprograms = shadow._qprograms
            self.inference = shadow.inference
            self.policy = shadow.policy
            self.warmed = shadow.warmed
            self.version += 1
            self.reload_time = time.time()
        return self.version

    def describe(self) -> dict:
        out = {
            "kind": self.kind,
            "buckets": self.policy.to_spec(),
            "coalesce_limit": self.coalesce_limit(),
            "warmed": self.warmed,
            "version": self.version,
            "reload_time": self.reload_time,
            "iteration": int(getattr(self.net, "iteration", 0) or 0),
            "mesh": self.inference is not None,
            "chunks_executed": self.chunks_executed,
            "device": str(getattr(self.net, "device", None)),
            "params": int(self.net.num_params())
            if hasattr(self.net, "num_params") else None,
        }
        if self.quantize:
            out["quantize"] = self.quantize
            if self._qp is not None:
                out["weight_bytes_resident"] = self._qp.resident_bytes()
                out["weight_bytes_fp32"] = self._qp.fp32_bytes()
        gen = self.generator
        if gen is not None:
            pool = gen.pool_stats()
            if pool is not None:
                out["kv_pool"] = pool
            hit = gen.prefix_hit_rate()
            if hit is not None:
                out["prefix_hit_rate"] = hit
            if gen.draft is not None:
                out["speculative"] = {
                    "spec_tokens": gen.spec_tokens,
                    "draft_params": int(gen.draft.net.num_params())}
        return out


def _forward_with(net, params, x):
    """The net's inference forward on ``x`` with the tree ``params`` in
    place of its own (cast to the compute type)."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.tree import tree_map

    if isinstance(net, MultiLayerNetwork):
        cparams = [tree_map(net._cast, p) for p in params]
        return net._forward_body(cparams, net.states, x, training=False)
    acts = net._forward(params, net.states, {net.conf.inputs[0]: x},
                        cached_cast=False)
    return acts[net.conf.outputs[0]]
