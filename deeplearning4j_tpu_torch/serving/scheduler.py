"""Dynamic batching scheduler with deadline-aware queues (counterpart of
deeplearning4j_tpu/serving/scheduler.py, whole).

Requests enter per-lane FIFO queues; one worker thread per model coalesces
them into device batches:

- **lanes**: ``"interactive"`` drains strictly before ``"batch"``.
- **coalescing**: the first request opens a batch; the worker keeps
  admitting requests (same options) until ``max_batch`` rows (the model's
  largest bucket) or ``max_wait_ms`` since the batch opened, then runs
  ``model.execute`` once and resolves each request's ``Future`` with its
  own rows. Per-request options (a generate request's ``max_new_tokens``,
  ``temperature``, ``eos_id``) go to ``model.execute``; only requests
  with equal options share a batch.
- **admission**: a full queue rejects at submit time with
  :class:`QueueFullError`; a request still queued past its
  ``deadline_ms`` is shed with :class:`DeadlineExceededError` (swept
  before a batch opens and while it fills). Both are 429s.
- **execute-time sheds**: a :class:`ShedError` raised by the batch itself
  (the paged KV pool's :class:`PoolExhaustedError`) sheds its requests
  with 429 and the error's ``shed_reason``, never feeding the breaker.
- **chunked prefill**: a batch of a non-priority lane on a model that
  chunks its prefill gets :meth:`BatchScheduler._drain_priority_once` as
  its yield hook, run between prompt chunks.

Resilience (``serving/resilience.py``): a per-model
:class:`CircuitBreaker` gates ``submit`` and hears one outcome per batch
(client-shaped errors, ``KeyError``/``TypeError``/``ValueError``, never
count); ``set_brownout`` sheds whole lanes; the worker is supervised: a
crash of its loop (``serving_worker_crash``) fails the batch in flight
with :class:`WorkerCrashedError` (500), and the loop restarts on the same
thread under ``WORKER_RESTART_POLICY``'s backoff, so the model's captured
programs replay and nothing is captured again; past ``max_restarts``
crashes without ``restart_reset_batches`` clean batches between them the
model is declared dead (its ``serving.worker.<id>`` health check fails and
every queued and later request gets :class:`SchedulerStoppedError`).
``drain`` finishes what is queued and stops; ``shutdown`` fails what is
queued loudly.

Observability: every request has a ``request_id`` (the HTTP layer honours
and echoes ``X-Request-Id``) and wall-clock phase stamps (queue wait,
batch fill, compute). A request head-sampled by ``DL4J_TPU_TRACE_SAMPLE``
(slow, shed and failed ones always, tracing permitting) is staged as one
tuple and turned into spans only at telemetry export
(:func:`collect_deferred_spans`); every request lands in the model's
:class:`FlightRecorder` whatever the sampling. The ``serving.*`` counters,
gauges and histograms feed ``/metrics``; ``stats()`` adds the breaker,
p50/p99 latencies, per-lane counts and the programs built since warmup
(``recompiles``: 0 in steady state).
"""

from __future__ import annotations

import bisect
import collections
import itertools
import dataclasses
import os
import random
import threading
import time
import weakref
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.serving.resilience import (BrownoutShedError,
                                                   CircuitBreaker,
                                                   CircuitOpenError,
                                                   DeadlineExceededError,
                                                   PoolExhaustedError,
                                                   QueueFullError,
                                                   SchedulerDrainingError,
                                                   SchedulerStoppedError,
                                                   ShedError,
                                                   WorkerCrashedError)
from deeplearning4j_tpu_torch.util import faults as fl
from deeplearning4j_tpu_torch.util import telemetry as tm
from deeplearning4j_tpu_torch.util.faults import RetryPolicy
from deeplearning4j_tpu_torch.util.health import record_anomaly

LANES = ("interactive", "batch")  # priority order, first drains first

#: default watchdog backoff between worker restarts (serving workers are
#: cheap to restart; the deadline bounds a crash-looping model's thrash)
WORKER_RESTART_POLICY = RetryPolicy(max_attempts=8, base_delay=0.05,
                                    max_delay=2.0, jitter=0.25)

#: head-sampling keep fraction when DL4J_TPU_TRACE_SAMPLE is unset: 2% of
#: healthy requests get full phase spans; slow/shed/error requests are
#: always kept (see trace_sample_rate); the flight recorder sees 100%.
DEFAULT_TRACE_SAMPLE = 0.02

#: a completed request slower than this is "slow" and always traced
SLOW_REQUEST_MS = 100.0

_sample_cache: Tuple[Optional[str], float] = ("\x00unset", DEFAULT_TRACE_SAMPLE)


def trace_sample_rate() -> float:
    """The head-sampling keep fraction (0..1) from ``DL4J_TPU_TRACE_SAMPLE``
    (parse memoized on the raw string — submit() calls this per request).
    ``0`` means request tracing is OFF, including the slow/shed/error
    always-keep; unset means :data:`DEFAULT_TRACE_SAMPLE`."""
    global _sample_cache
    raw = os.environ.get("DL4J_TPU_TRACE_SAMPLE")
    if raw == _sample_cache[0]:
        return _sample_cache[1]
    try:
        val = min(1.0, max(0.0, float(raw)))  # type: ignore[arg-type]
    except (TypeError, ValueError):
        val = DEFAULT_TRACE_SAMPLE
    _sample_cache = (raw, val)
    return val


_id_counter = itertools.count()
#: the process's draw for request-id prefixes (seeded from the OS)
_ID_RNG = random.Random()
_id_prefix = f"{_ID_RNG.getrandbits(24):06x}"  # per-process, import-time


def new_request_id() -> str:
    """Cheap process-unique 12-hex request id: random per-process prefix
    + monotone counter. Not uuid4: its os.urandom syscall drops the GIL,
    and getting it back behind a busy scheduler worker costs every
    submit()."""
    return f"{_id_prefix}{next(_id_counter) & 0xFFFFFF:06x}"


#: staged-trace bound per scheduler (sampled requests awaiting export)
_TRACE_STAGE_MAX = 4096

#: every live scheduler, for export-time span materialization
#: (telemetry._fold_pending -> collect_deferred_spans, sys.modules-guarded
#: exactly like the serving metrics collector)
_SCHEDULERS: "weakref.WeakSet" = weakref.WeakSet()


def collect_deferred_spans() -> List[dict]:
    """Materialize every live scheduler's staged request phase spans into
    Chrome-event dicts and clear the staging lists. Called by telemetry at
    export time (chrome_trace/drain_events/snapshot): per-request span
    emission on the worker thread would hold the GIL other models' workers
    wait for, so the hot path stages one tuple and ALL dict building
    happens here, on the cold export path."""
    out: List[dict] = []
    for s in list(_SCHEDULERS):
        try:
            out.extend(s._materialize_spans())
        except Exception:
            continue  # a dying scheduler must never break an export
    return out


class FlightRecorder:
    """Bounded ring of per-request postmortem records (one per completed,
    shed, or errored request — independent of trace sampling). Record
    schema: ``id, lane, rows, bucket, status(ok|shed|error), cause,
    queue_ms, fill_ms, compute_ms, total_ms, tokens_per_sec?, sampled,
    traced, time``."""

    def __init__(self, capacity: int = 256):
        self.capacity = int(capacity)
        self._buf: collections.deque = collections.deque(maxlen=self.capacity)
        self._lock = threading.Lock()

    def record(self, rec: dict):
        with self._lock:
            self._buf.append(rec)

    def dump(self, last: Optional[int] = None) -> List[dict]:
        with self._lock:
            out = list(self._buf)
        if last is not None and last > 0:
            out = out[-last:]
        return out

    def __len__(self):
        with self._lock:
            return len(self._buf)


# the shed-error hierarchy lives in serving/resilience.py and is
# re-exported here so every pre-existing `from ...scheduler import ShedError`
# import path keeps working
__all_errors__ = (ShedError, QueueFullError, DeadlineExceededError,
                  PoolExhaustedError, SchedulerDrainingError,
                  SchedulerStoppedError, CircuitOpenError,
                  BrownoutShedError, WorkerCrashedError)


@dataclasses.dataclass
class _Request:
    payload: Any
    rows: int
    future: Future
    lane: str
    opts_key: Tuple
    opts: Dict[str, Any]
    t_enqueue: float                 # monotonic
    deadline: Optional[float]        # absolute monotonic, or None
    request_id: str = ""
    sampled: bool = False            # head-sampling decision at submit
    # wall-clock phase stamps (ns) for span emission + the flight recorder:
    # submit -> joined a batch -> execute started -> execute done
    t_submit_ns: int = 0
    t_open_ns: int = 0
    t_exec0_ns: int = 0
    t_exec1_ns: int = 0


class _LatencyWindow:
    """Sliding window of recent request latencies for p50/p99 gauges (the
    telemetry histogram keeps the full Prometheus series; this gives exact
    quantiles over the recent past for /healthz)."""

    def __init__(self, size: int = 1024):
        self._buf = collections.deque(maxlen=size)
        self._sorted: List[float] = []
        self._lock = threading.Lock()

    def add(self, v: float):
        # the sorted view is maintained INCREMENTALLY (one C-speed insort
        # per add, one bisect-delete per eviction): the batch tail reads
        # p50/p99 on every window it touched, and a full sort there holds
        # the GIL that other models' workers wait for
        with self._lock:
            if len(self._buf) == self._buf.maxlen:
                evicted = self._buf[0]
                i = bisect.bisect_left(self._sorted, evicted)
                del self._sorted[i]
            self._buf.append(v)
            bisect.insort(self._sorted, v)

    def quantile(self, q: float) -> Optional[float]:
        return self.quantiles((q,))[0]

    def quantiles(self, qs) -> tuple:
        """Several quantiles in one locked read (no sort — see add)."""
        with self._lock:
            if not self._sorted:
                return tuple(None for _ in qs)
            n = len(self._sorted) - 1
            return tuple(
                self._sorted[min(n, max(0, int(round(q * n))))] for q in qs)


class BatchScheduler:
    """One model's request queue + coalescing worker (see module doc)."""

    def __init__(self, model, *, max_wait_ms: float = 2.0,
                 max_batch: Optional[int] = None, queue_limit: int = 64,
                 lanes=LANES, flight_capacity: int = 256,
                 breaker="default", max_restarts: int = 3,
                 restart_policy: Optional[RetryPolicy] = None,
                 restart_reset_batches: int = 100,
                 supervised: bool = True):
        self.model = model
        self.model_id = model.model_id
        self.max_wait_ms = float(max_wait_ms)
        self.max_batch = int(max_batch or model.coalesce_limit())
        self.queue_limit = int(queue_limit)
        self.lanes = tuple(lanes)
        #: per-model circuit breaker (serving/resilience.py); pass
        #: ``breaker=None`` to disable, or a configured CircuitBreaker
        self.breaker: Optional[CircuitBreaker] = (
            CircuitBreaker(model_id=self.model_id)
            if breaker == "default" else breaker)
        #: watchdog budget: worker restarts before the scheduler is declared
        #: dead (health check flips, queued futures fail loudly). The budget
        #: bounds a CRASH LOOP, not lifetime crashes: after
        #: ``restart_reset_batches`` clean batches since the last crash the
        #: spent budget resets — a rare transient (one device OOM a day)
        #: must not accumulate over weeks into a permanent 503
        self.max_restarts = int(max_restarts)
        self.restart_policy = restart_policy or WORKER_RESTART_POLICY
        self.restart_reset_batches = int(restart_reset_batches)
        self.supervised = bool(supervised)
        self._restarts = 0
        self._batches_since_crash = 0
        self._worker_dead = False
        self._batch_seq = 0            # batch-cycle counter (fault @step)
        self._current_batch: Optional[List[_Request]] = None
        self._brownout_lanes: frozenset = frozenset()
        self._queues: Dict[str, collections.deque] = {
            lane: collections.deque() for lane in self.lanes}
        self._cv = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._accepting = True
        self._inflight = 0
        self.latencies = _LatencyWindow()
        self.lane_latencies: Dict[str, _LatencyWindow] = {
            lane: _LatencyWindow() for lane in self.lanes}
        self._completed_ts = collections.deque(maxlen=4096)
        self._ts_lock = threading.Lock()  # appends race /metrics scrapes
        self.counts = collections.Counter()  # completed/shed_* totals
        self.lane_counts: Dict[str, collections.Counter] = {
            lane: collections.Counter() for lane in self.lanes}
        self.flight = FlightRecorder(capacity=flight_capacity)
        self._traced: list = []  # staged sampled requests (flat tuples)
        self._trace_dropped = 0
        #: the head-sampling dice and the restart backoff's jitter
        self.rng = random.Random()
        #: the latest generate batch's stats (accept and hit rates)
        self.last_batch_stats: Dict[str, Any] = {}
        _SCHEDULERS.add(self)

    # ------------------------------------------------------ request tracing
    def _tracing_on(self) -> bool:
        return tm.enabled() and trace_sample_rate() > 0.0

    @staticmethod
    def _phase_ms(t0_ns: int, t1_ns: int) -> Optional[float]:
        if not t0_ns or not t1_ns:
            return None
        return round(max(0, t1_ns - t0_ns) / 1e6, 3)

    def _flight_record(self, req: _Request, status: str, *,
                       cause: Optional[str] = None, end_ns: Optional[int] = None,
                       bucket: Optional[int] = None, traced: bool = False,
                       tokens_per_sec: Optional[float] = None,
                       draft_accept_rate: Optional[float] = None,
                       prefix_hit_rate: Optional[float] = None,
                       resumed_position: Optional[int] = None,
                       prefill_chunks: Optional[int] = None) -> dict:
        end_ns = end_ns or time.time_ns()
        rec = {
            "id": req.request_id,
            "lane": req.lane,
            "rows": req.rows,
            "bucket": bucket,
            "status": status,
            "cause": cause,
            "queue_ms": self._phase_ms(req.t_submit_ns,
                                       req.t_open_ns or end_ns),
            "fill_ms": self._phase_ms(req.t_open_ns, req.t_exec0_ns),
            "compute_ms": self._phase_ms(req.t_exec0_ns, req.t_exec1_ns),
            "total_ms": self._phase_ms(req.t_submit_ns, end_ns),
            "sampled": req.sampled,
            "traced": traced,
            "time": end_ns / 1e9,
        }
        if tokens_per_sec is not None:
            rec["tokens_per_sec"] = round(tokens_per_sec, 3)
        if draft_accept_rate is not None:
            # speculative decoding (serving/generate.py): the fraction of
            # draft proposals the target verified for THIS request
            rec["draft_accept_rate"] = round(draft_accept_rate, 4)
        if prefix_hit_rate is not None:
            # prefix cache: the batch's hit rate, this
            # request's resume point (0 = cold), and how many prompt
            # chunks the prefill ran as
            rec["prefix_hit_rate"] = round(prefix_hit_rate, 4)
        if resumed_position is not None:
            rec["resumed_position"] = int(resumed_position)
        if prefill_chunks is not None:
            rec["prefill_chunks"] = int(prefill_chunks)
        self.flight.record(rec)
        return rec

    def _stage_spans(self, req: _Request, outcome: str,
                     bucket: Optional[int] = None,
                     tokens_per_sec: Optional[float] = None,
                     end_ns: Optional[int] = None,
                     draft_accept_rate: Optional[float] = None,
                     prefix_hit_rate: Optional[float] = None,
                     resumed_position: Optional[int] = None,
                     prefill_chunks: Optional[int] = None):
        """Stage ONE sampled request for span export: a flat tuple append
        (no dicts, no registry lock — the hot-path finding behind
        :func:`collect_deferred_spans`). Thread identity is captured here
        so the spans land on the recording thread's trace row."""
        if len(self._traced) >= _TRACE_STAGE_MAX:
            self._trace_dropped += 1
            return
        th = threading.current_thread()
        self._traced.append(
            (req.request_id, req.lane, req.rows, req.t_submit_ns,
             req.t_open_ns, req.t_exec0_ns, req.t_exec1_ns, outcome,
             bucket, tokens_per_sec, end_ns or time.time_ns(),
             th.ident, th.name, draft_accept_rate,
             prefix_hit_rate, resumed_position, prefill_chunks))

    def _materialize_spans(self) -> List[dict]:
        """Staged tuples -> Chrome phase events (queue_wait / batch_fill /
        compute), cleared on read. Cold path: runs at telemetry export."""
        staged, self._traced = self._traced, []
        if self._trace_dropped:
            tm.counter("serving.trace_stage_dropped_total",
                       self._trace_dropped, model=self.model_id)
            self._trace_dropped = 0
        pid = os.getpid()
        out: List[dict] = []
        for (rid, lane, rows, t_submit, t_open, t_exec0, t_exec1, outcome,
             bucket, tps, end_ns, tid, tname, accept,
             hit_rate, resumed, chunks) in staged:
            base = {"request_id": rid, "model": self.model_id,
                    "lane": lane, "outcome": outcome}
            if not outcome.startswith("shed"):
                # completions/errors are recorded by the worker inside its
                # serving.batch span; sheds happen on the submit thread
                base["parent"] = "serving.batch"

            def ev(name, t0, t1, args):
                return {"name": name, "ph": "X", "pid": pid, "tid": tid,
                        "tname": tname, "ts": t0,
                        "dur": max(0, t1 - t0), "args": args}

            out.append(ev("serving.request.queue_wait", t_submit,
                          t_open or end_ns, base))
            if t_open and t_exec0:
                out.append(ev("serving.request.batch_fill", t_open,
                              t_exec0, base))
            if t_exec0 and t_exec1:
                args = dict(base, rows=rows)
                if bucket is not None:
                    args["bucket"] = bucket
                if tps is not None:
                    args["tokens_per_sec"] = round(tps, 3)
                if accept is not None:
                    # the per-request speculation ruler: how
                    # much of the draft's work the target verified
                    args["draft_accept_rate"] = round(accept, 4)
                if hit_rate is not None:
                    # prefix cache + chunked prefill: hit/miss
                    # and resume point per request, chunk count per batch
                    args["prefix_hit_rate"] = round(hit_rate, 4)
                if resumed is not None:
                    args["resumed_position"] = int(resumed)
                if chunks is not None:
                    args["prefill_chunks"] = int(chunks)
                out.append(ev("serving.request.compute", t_exec0,
                              t_exec1, args))
        return out

    # ------------------------------------------------------------ admission
    def submit(self, payload, *, lane: str = "interactive",
               deadline_ms: Optional[float] = None,
               request_id: Optional[str] = None, **opts) -> Future:
        """Enqueue one request; returns a Future of the model result.
        Raises a :class:`ShedError` subclass instead of queueing when the
        scheduler is draining or the queue is full. ``request_id`` defaults
        to a fresh id; the HTTP layer passes the inbound ``X-Request-Id``."""
        if lane not in self._queues:
            raise ValueError(f"unknown lane {lane!r} (have {self.lanes})")
        rows = self.model.payload_rows(payload)
        now = time.monotonic()
        rate = trace_sample_rate() if tm.enabled() else 0.0
        req = _Request(
            payload=payload, rows=rows, future=Future(), lane=lane,
            opts_key=tuple(sorted(opts.items())), opts=opts, t_enqueue=now,
            deadline=None if deadline_ms is None else now + deadline_ms / 1e3,
            request_id=request_id or new_request_id(),
            sampled=rate > 0.0 and (rate >= 1.0
                                    or self.rng.random() < rate),
            t_submit_ns=time.time_ns())
        with self._cv:
            if self._worker_dead:
                # fail fast: the worker crashed past its restart budget (or
                # the scheduler was shut down) — enqueueing here would park
                # the future on a queue nothing will ever drain
                self._count_shed(req, "worker_dead")
                why = (f"worker crashed {self._restarts}x "
                       f"(budget {self.max_restarts})" if self._restarts
                       else "scheduler stopped")
                raise SchedulerStoppedError(f"{self.model_id}: {why} — "
                                            "no worker will run this request")
            if not self._accepting:
                self._count_shed(req, "draining")
                raise SchedulerDrainingError(
                    f"{self.model_id}: scheduler draining")
            if lane in self._brownout_lanes:
                # SLO budget exhausted (resilience.BrownoutController):
                # bulk lanes shed so the interactive promise survives
                self._count_shed(req, "brownout")
                raise BrownoutShedError(
                    f"{self.model_id}: lane {lane!r} browned out "
                    "(SLO error budget exhausted)")
            if self.breaker is not None:
                try:
                    self.breaker.allow()
                except CircuitOpenError:
                    self._count_shed(req, "circuit_open")
                    raise
            depth = sum(len(q) for q in self._queues.values())
            if depth >= self.queue_limit:
                self._count_shed(req, "queue_full")
                raise QueueFullError(
                    f"{self.model_id}: queue at capacity ({depth})")
            self._queues[lane].append(req)
            tm.gauge("serving.queue_depth", depth + 1, model=self.model_id)
            tm.gauge("serving.queue_depth", len(self._queues[lane]),
                     model=self.model_id, lane=lane)
            self._cv.notify()
        tm.counter("serving.requests_total", model=self.model_id, lane=lane)
        return req.future

    def _count_shed(self, req: _Request, reason: str):
        """Shared shed bookkeeping: counters (total + per-lane), the flight
        recorder, and — when tracing is on — the always-kept shed span."""
        self.counts[f"shed_{reason}"] += 1
        self.lane_counts[req.lane][f"shed_{reason}"] += 1
        tm.counter("serving.shed_total", model=self.model_id,
                   reason=reason, lane=req.lane)
        traced = self._tracing_on()
        self._flight_record(req, "shed", cause=reason, traced=traced)
        if traced:
            self._stage_spans(req, f"shed:{reason}")

    # --------------------------------------------------------------- worker
    def start(self) -> "BatchScheduler":
        with self._cv:
            if self._thread is None:
                self._stop = False
                self._thread = threading.Thread(
                    target=self._supervised if self.supervised
                    else self._loop,
                    daemon=True, name=f"serving-{self.model_id}")
                self._thread.start()
        return self

    def set_brownout(self, lanes=()):
        """Shed ``lanes`` at submit time with :class:`BrownoutShedError`
        (the resilience.BrownoutController seam). Pass ``()`` to restore."""
        with self._cv:
            self._brownout_lanes = frozenset(lanes)
            self._cv.notify_all()

    def _supervised(self):
        """Watchdog wrapper around the worker loop: a crash fails the
        in-flight batch loudly (500 + flight-recorder cause), counts
        ``serving.worker_restarts_total``, and restarts the loop under the
        RetryPolicy backoff; ``max_restarts`` exhausted flips the model's
        ``serving.worker.<id>`` health check and fails everything still
        queued with :class:`SchedulerStoppedError`."""
        while True:
            try:
                self._loop()
                return  # clean stop (drain/shutdown)
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:  # noqa: BLE001 — the watchdog seam
                if not self._on_worker_crash(e):
                    return
                self.restart_policy.sleep_before_retry(self._restarts,
                                                       rng=self.rng)

    def _on_worker_crash(self, exc: BaseException) -> bool:
        """Crash bookkeeping; returns True when the loop should restart."""
        cause = f"worker_crash: {exc!r}"[:200]
        with self._cv:
            batch, self._current_batch = self._current_batch, None
        # the in-flight batch's callers get a loud 500, never a hang
        for req in batch or ():
            if req.future.done():
                # a crash AFTER _run_batch resolved this rider (e.g. in the
                # post-result bookkeeping) — re-failing a FINISHED future
                # raises, which would kill the watchdog itself and leave
                # the queue dead with _worker_dead never set
                continue
            err_ns = time.time_ns()
            req.t_exec1_ns = req.t_exec1_ns or err_ns
            if req.future.set_running_or_notify_cancel():
                req.future.set_exception(WorkerCrashedError(
                    f"{self.model_id}: scheduler worker crashed executing "
                    f"this batch: {exc!r}"))
            self.counts["errors"] += 1
            self.lane_counts[req.lane]["errors"] += 1
            tm.counter("serving.request_errors_total",
                       model=self.model_id, lane=req.lane)
            self._flight_record(req, "error", cause=cause, end_ns=err_ns,
                                traced=self._tracing_on())
        if self.breaker is not None:
            self.breaker.record_error()
        self._restarts += 1
        self._batches_since_crash = 0
        tm.counter("serving.worker_restarts_total", model=self.model_id)
        record_anomaly("worker_crash",
                       f"{self.model_id}: {exc!r}"[:200],
                       source="serving", model=self.model_id)
        if self._restarts <= self.max_restarts:
            tm.set_health(f"serving.worker.{self.model_id}", True,
                          f"restarted after crash "
                          f"({self._restarts}/{self.max_restarts}): "
                          f"{exc!r}"[:200])
            return True
        # budget exhausted: the model is declared down — health flips, and
        # everything still queued fails loudly instead of hanging forever
        tm.set_health(f"serving.worker.{self.model_id}", False,
                      f"worker dead after {self._restarts} crashes "
                      f"(budget {self.max_restarts}): {exc!r}"[:200])
        with self._cv:
            self._worker_dead = True
            self._inflight = 0
            pending = [r for l in self.lanes for r in self._queues[l]]
            for l in self.lanes:
                self._queues[l].clear()
            self._cv.notify_all()
        for req in pending:
            if req.future.set_running_or_notify_cancel():
                req.future.set_exception(SchedulerStoppedError(
                    f"{self.model_id}: worker crashed past its restart "
                    f"budget ({self.max_restarts}); request abandoned"))
            self._flight_record(req, "error", cause="worker_dead",
                                traced=self._tracing_on())
        return False

    def _shed(self, req: _Request, exc: ShedError, reason: str):
        self._count_shed(req, reason)
        if not req.future.set_running_or_notify_cancel():
            return
        req.future.set_exception(exc)

    def _sweep_expired_locked(self, now: float):
        for lane in self.lanes:
            q = self._queues[lane]
            kept = collections.deque()
            while q:
                req = q.popleft()
                if req.deadline is not None and now > req.deadline:
                    self._shed(req, DeadlineExceededError(
                        f"{self.model_id}: deadline expired after "
                        f"{(now - req.t_enqueue) * 1e3:.1f} ms in queue"),
                        "deadline")
                else:
                    kept.append(req)
            self._queues[lane] = q
            q.extend(kept)

    def _open_batch_locked(self) -> Optional[List[_Request]]:
        """Pop the head of the highest-priority non-empty lane."""
        for lane in self.lanes:
            if self._queues[lane]:
                req = self._queues[lane].popleft()
                req.t_open_ns = time.time_ns()  # queue wait ends here
                return [req]
        return None

    def _fill_batch_locked(self, batch: List[_Request]) -> int:
        """Admit compatible queued requests into the open batch (same lane
        first, then lower lanes — occupancy over strictness once the
        priority head is already in the batch). A request whose deadline
        expired while the batch was filling is shed here, not executed —
        the 429 contract holds even under a busy worker. Returns total
        rows."""
        head = batch[0]
        rows = sum(r.rows for r in batch)
        for lane in self.lanes:
            q = self._queues[lane]
            scan = len(q)
            for _ in range(scan):
                if rows >= self.max_batch:
                    return rows
                req = q[0]
                now = time.monotonic()
                if req.deadline is not None and now > req.deadline:
                    q.popleft()
                    self._shed(req, DeadlineExceededError(
                        f"{self.model_id}: deadline expired after "
                        f"{(now - req.t_enqueue) * 1e3:.1f} ms in queue"),
                        "deadline")
                    continue
                if req.opts_key != head.opts_key \
                        or rows + req.rows > self.max_batch:
                    break
                req.t_open_ns = time.time_ns()  # joins the open batch
                batch.append(q.popleft())
                rows += req.rows
        return rows

    def _loop(self):
        while True:
            with self._cv:
                while not self._stop \
                        and not any(self._queues[l] for l in self.lanes):
                    self._cv.wait(timeout=0.1)
                if self._stop \
                        and not any(self._queues[l] for l in self.lanes):
                    return
                self._sweep_expired_locked(time.monotonic())
                batch = self._open_batch_locked()
                if batch is None:
                    continue
                self._inflight = 1
                self._current_batch = batch  # the watchdog fails these
                                             # loudly if the loop dies
            # max-wait window: keep admitting until the batch is full or
            # max_wait_ms has passed since it opened (continuous batching).
            # The whole cycle (fill wait + execute) is one worker-thread
            # span, so the trace's serving-<model> row shows where the
            # worker's time goes between batches.
            t_open = time.monotonic()
            deadline = t_open + self.max_wait_ms / 1e3
            try:
                with tm.span("serving.worker.batch_cycle",
                             model=self.model_id) as cycle:
                    while True:
                        with self._cv:
                            rows = self._fill_batch_locked(batch)
                            if rows >= self.max_batch:
                                break
                            remaining = deadline - time.monotonic()
                            if remaining <= 0:
                                break
                            self._cv.wait(timeout=remaining)
                    if hasattr(cycle, "args"):  # not the disabled no-op
                        cycle.args["requests"] = len(batch)
                        cycle.args["rows"] = rows
                    self._run_batch(batch)
                    # every future resolved (result or handled error): the
                    # watchdog must not re-fail them if the loop dies later
                    self._current_batch = None
            finally:
                with self._cv:
                    self._inflight = 0
                    tm.gauge("serving.queue_depth",
                             sum(len(q) for q in self._queues.values()),
                             model=self.model_id)
                    # per-lane depths refresh on dequeue too — without this
                    # a drained lane's gauge stays at its submit-time high
                    # water forever (scrapes would show a phantom backlog)
                    for _lane, _q in self._queues.items():
                        tm.gauge("serving.queue_depth", len(_q),
                                 model=self.model_id, lane=_lane)
                    self._cv.notify_all()

    def _drain_priority_once(self):
        """Chunked-prefill yield hook (serving/generate.py): between an
        outer batch's prompt chunks, run up to two queued PRIORITY-lane
        batches so a long-prompt bulk burst cannot spike interactive
        decode p99 — the whole point of chunking. Only wired into
        non-priority batches (``_run_batch``), so the nesting depth is
        exactly one: an interactive batch never yields. The outer batch
        stays parked on ``_current_batch`` around each inner run so the
        watchdog's loud-failure contract keeps covering it."""
        ran = 0
        while ran < 2:
            with self._cv:
                self._sweep_expired_locked(time.monotonic())
                if not self._queues[self.lanes[0]]:
                    break
                inner = self._open_batch_locked()
                if inner is None:
                    break
                self._fill_batch_locked(inner)
                outer = self._current_batch
                self._current_batch = inner
            try:
                self._run_batch(inner)
            finally:
                with self._cv:
                    self._current_batch = outer
            ran += 1
        if ran:
            self.counts["prefill_yield_preemptions"] += ran
            tm.counter("serving.prefill_yield_preemptions_total", ran,
                       model=self.model_id)

    def _run_batch(self, batch: List[_Request]):
        t0 = time.monotonic()
        self.counts["batches"] += 1
        self._batch_seq += 1
        seq = self._batch_seq  # the serving_* faults' @step concept
        # the injected worker crash escapes to the watchdog (_supervised):
        # the REAL mechanism a broken scheduler exhibits — an exception in
        # the loop machinery itself, outside the per-batch model-error catch
        if fl.get_injector().fire(fl.SERVING_WORKER_CRASH,
                                  step=seq) is not None:
            raise RuntimeError(
                f"{self.model_id}: injected serving worker crash "
                f"(batch {seq})")
        tracing = self._tracing_on()
        # batch-level pad/device sub-spans ride the head-sampling decision:
        # a batch with ANY sampled request gets the detailed execute spans
        trace_batch = tracing and any(r.sampled for r in batch)
        exec0_ns = time.time_ns()
        for req in batch:
            req.t_exec0_ns = exec0_ns
        # chunked prefill interleave: a NON-priority batch on a chunking
        # model hands the device back between prompt chunks; an
        # interactive batch never yields (depth stays 1, no starvation of
        # the batch itself — at most 2 inner batches per chunk boundary)
        extra = {}
        if (batch[0].lane != self.lanes[0]
                and getattr(self.model, "supports_chunked_prefill", False)):
            extra["_yield"] = self._drain_priority_once
        with tm.span("serving.batch", model=self.model_id,
                     requests=len(batch), lane=batch[0].lane):
            try:
                results, stats = self.model.execute(
                    [r.payload for r in batch], _trace=trace_batch,
                    _step=seq, **extra, **batch[0].opts)
            except ShedError as e:
                # an EXECUTE-time shed (paged-pool exhaustion): a
                # first-class 429 with its own cause, NOT a server error —
                # the riders' futures carry the ShedError (the HTTP layer
                # answers 429 + Retry-After), the per-lane shed counters
                # and flight-recorder cause record it, and the breaker
                # never hears about it (the model is healthy; the pool is
                # full)
                err_ns = time.time_ns()
                reason = getattr(e, "shed_reason", "shed")
                for req in batch:
                    req.t_exec1_ns = err_ns
                    self._shed(req, e, reason)
                return
            except Exception as e:  # a bad request fails its batch, never
                err_ns = time.time_ns()  # the worker (ParallelInference
                for req in batch:        # contract)
                    req.t_exec1_ns = err_ns
                    if req.future.set_running_or_notify_cancel():
                        req.future.set_exception(e)
                    self.counts["errors"] += 1
                    self.lane_counts[req.lane]["errors"] += 1
                    tm.counter("serving.request_errors_total",
                               model=self.model_id, lane=req.lane)
                    # errors are always kept (tracing permitting)
                    self._flight_record(req, "error", cause=repr(e)[:200],
                                        end_ns=err_ns, traced=tracing)
                    if tracing:
                        self._stage_spans(req, "error", end_ns=err_ns)
                tm.counter("serving.batch_errors_total", model=self.model_id)
                if self.breaker is not None and not isinstance(
                        e, (KeyError, TypeError, ValueError)):
                    # one failed batch = one breaker outcome: enough of
                    # these in a row fast-fails instead of queueing more
                    # doomed work (resilience.CircuitBreaker). The
                    # client-shaped family (the server's HTTP 400 mapping)
                    # is excluded — a buggy client's malformed payloads
                    # must not open the breaker and 503 a healthy model
                    # for everyone else
                    self.breaker.record_error()
                return
            if self.breaker is not None:
                self.breaker.record_success()
            self._batches_since_crash += 1
            if self._restarts and \
                    self._batches_since_crash >= self.restart_reset_batches:
                # a sustained healthy run pays the crash budget back: the
                # watchdog bounds crash LOOPS, not lifetime crashes
                self._restarts = 0
            exec1_ns = time.time_ns()
            now = time.monotonic()
            padded = stats.get("padded_rows")
            decode_s = stats.get("decode_seconds")
            decode_toks = stats.get("decode_tokens")
            accept_rates = stats.get("draft_accept_rate")  # per rider, or None
            hit_rate = stats.get("prefix_hit_rate")        # batch-level
            resumed = stats.get("resumed_positions")       # per rider
            chunks = stats.get("prefill_chunks")
            lane_done: collections.Counter = collections.Counter()
            for ridx, (req, res) in enumerate(zip(batch, results)):
                req.t_exec1_ns = exec1_ns
                if req.future.set_running_or_notify_cancel():
                    req.future.set_result(res)
                lat = now - req.t_enqueue
                self.latencies.add(lat)
                self.lane_latencies[req.lane].add(lat)
                with self._ts_lock:
                    self._completed_ts.append(now)
                self.counts["completed"] += 1
                self.lane_counts[req.lane]["completed"] += 1
                lane_done[req.lane] += 1
                tm.observe("serving.request_latency_seconds", lat,
                           model=self.model_id, lane=req.lane)
                tps = None
                if decode_s and decode_toks:
                    # per-request decode throughput: this request's tokens
                    # over the batch's decode wall (incl. prefill)
                    try:
                        tps = len(res) / decode_s
                    except TypeError:
                        tps = None
                    if tps is not None:
                        tm.observe("serving.decode_tokens_per_sec", tps,
                                   model=self.model_id, lane=req.lane)
                rate = (accept_rates[ridx]
                        if accept_rates and ridx < len(accept_rates)
                        else None)
                rpos = (resumed[ridx]
                        if resumed and ridx < len(resumed) else None)
                keep = tracing and (req.sampled
                                    or lat * 1e3 > SLOW_REQUEST_MS)
                self._flight_record(req, "ok", end_ns=exec1_ns,
                                    bucket=padded, traced=keep,
                                    tokens_per_sec=tps,
                                    draft_accept_rate=rate,
                                    prefix_hit_rate=hit_rate,
                                    resumed_position=rpos,
                                    prefill_chunks=chunks)
                if keep:
                    self._stage_spans(
                        req, "ok" if req.sampled else "slow",
                        bucket=padded, tokens_per_sec=tps, end_ns=exec1_ns,
                        draft_accept_rate=rate, prefix_hit_rate=hit_rate,
                        resumed_position=rpos, prefill_chunks=chunks)
        # one counter bump per lane per batch, not per request — registry
        # lock acquisitions on the worker are GIL time stolen from other
        # models' workers (see _LatencyWindow.add)
        for lane, done in lane_done.items():
            tm.counter("serving.completed_total", done,
                       model=self.model_id, lane=lane)
        tm.counter("serving.batches_total", model=self.model_id)
        self.counts["recompiles"] += stats.get("recompiles", 0)
        tm.counter("serving.recompiles_total", stats.get("recompiles", 0),
                   model=self.model_id)
        kept = {k: stats[k] for k in ("draft_accept_rate", "spec_accept_rate",
                                      "prefix_hit_rate", "prefill_chunks")
                if stats.get(k) is not None}
        if kept:
            self.last_batch_stats = kept
        if stats.get("spec_accept_rate") is not None:
            # batch-mean draft acceptance — the /metrics companion of the
            # per-request flight-recorder field
            tm.gauge("serving.spec_accept_rate",
                     float(stats["spec_accept_rate"]), model=self.model_id)
        if padded:
            tm.observe("serving.batch_occupancy",
                       stats["real_rows"] / padded,
                       model=self.model_id, lane=batch[0].lane)
        tm.observe("serving.batch_exec_seconds", now - t0,
                   model=self.model_id)
        gauges = ((0.5, "serving.latency_p50_seconds"),
                  (0.99, "serving.latency_p99_seconds"))
        # one sort per touched window, and only the lanes THIS batch fed —
        # idle lanes keep their last gauge (collect_metrics refreshes all
        # lanes at scrape time anyway)
        windows = [(self.latencies, {})] + [
            (self.lane_latencies[lane], {"lane": lane})
            for lane in {r.lane for r in batch}]
        for win, extra in windows:
            for (q, g), val in zip(gauges,
                                   win.quantiles([q for q, _g in gauges])):
                if val is not None:
                    tm.gauge(g, val, model=self.model_id, **extra)

    # ----------------------------------------------------------- lifecycle
    def drain(self, timeout: float = 30.0) -> bool:
        """Graceful drain (the SIGTERM path, serving-side): stop
        accepting, FINISH everything already queued, then stop the worker.
        Returns True when the queues emptied within ``timeout``."""
        with self._cv:
            self._accepting = False
            self._cv.notify_all()
        deadline = time.monotonic() + timeout
        with self._cv:
            while (any(self._queues[l] for l in self.lanes)
                   or self._inflight) and time.monotonic() < deadline:
                self._cv.wait(timeout=0.1)
            drained = not any(self._queues[l] for l in self.lanes) \
                and not self._inflight
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        return drained

    def shutdown(self):
        """Immediate stop: fail everything still queued loudly (a pending
        future must never outlive the worker that would have run it), and
        make any LATER submit fail fast (SchedulerStoppedError) instead of
        enqueueing into the dead queue."""
        with self._cv:
            self._accepting = False
            self._stop = True
            self._worker_dead = True
            pending = [r for l in self.lanes for r in self._queues[l]]
            for l in self.lanes:
                self._queues[l].clear()
            self._cv.notify_all()
        for req in pending:
            if req.future.set_running_or_notify_cancel():
                req.future.set_exception(
                    SchedulerDrainingError(f"{self.model_id}: shut down"))
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # ---------------------------------------------------------------- stats
    def queue_depth(self) -> int:
        with self._cv:
            return sum(len(q) for q in self._queues.values())

    def lane_queue_depths(self) -> Dict[str, int]:
        with self._cv:
            return {lane: len(q) for lane, q in self._queues.items()}

    def qps(self, window_s: float = 10.0) -> float:
        now = time.monotonic()
        with self._ts_lock:
            n = sum(1 for t in self._completed_ts if now - t <= window_s)
        return n / window_s

    def stats(self) -> dict:
        p50 = self.latencies.quantile(0.5)
        p99 = self.latencies.quantile(0.99)

        def _ms(v):
            return None if v is None else round(v * 1e3, 3)

        lanes = {}
        for lane in self.lanes:
            lc = self.lane_counts[lane]
            win = self.lane_latencies[lane]
            lanes[lane] = {
                "completed": lc["completed"],
                "errors": lc["errors"],
                # per-lane shed counts BY CAUSE (deadline vs queue_full vs
                # draining)
                "shed": {k[len("shed_"):]: v for k, v in lc.items()
                         if k.startswith("shed_")},
                "latency_p50_ms": _ms(win.quantile(0.5)),
                "latency_p99_ms": _ms(win.quantile(0.99)),
            }
        return {
            "queue_depth": self.queue_depth(),
            "accepting": self._accepting,
            "worker_alive": (self._thread is not None
                             and self._thread.is_alive()
                             and not self._worker_dead),
            "worker_restarts": self._restarts,
            "breaker": (self.breaker.status()
                        if self.breaker is not None else None),
            "brownout_lanes": sorted(self._brownout_lanes),
            "completed": self.counts["completed"],
            "errors": self.counts["errors"],
            "shed": {k[len("shed_"):]: v for k, v in self.counts.items()
                     if k.startswith("shed_")},
            "lanes": lanes,
            "qps_10s": round(self.qps(), 3),
            "latency_p50_ms": _ms(p50),
            "latency_p99_ms": _ms(p99),
            "flight_recorder_depth": len(self.flight),
            "max_batch": self.max_batch,
            "max_wait_ms": self.max_wait_ms,
            "queue_limit": self.queue_limit,
            # the port's own: programs built by batches since warmup (0 in
            # steady state, across worker restarts too), every counter,
            # and the latest generate batch's rates
            "recompiles": self.counts["recompiles"],
            "counts": dict(self.counts),
            **({"last_batch": dict(self.last_batch_stats)}
               if self.last_batch_stats else {}),
        }
