"""Dynamic batching scheduler (counterpart of
deeplearning4j_tpu/serving/scheduler.py), the core of it.

Requests enter per-lane FIFO queues; one worker thread per model coalesces
them into device batches:

- **lanes**: ``"interactive"`` drains strictly before ``"batch"``.
- **coalescing**: the first request opens a batch; the worker keeps
  admitting requests until ``max_batch`` rows (the model's largest bucket)
  or ``max_wait_ms`` since the batch opened, then runs ``model.execute``
  once and resolves each request's ``Future`` with its own rows.
- **admission**: a full queue rejects at submit time with
  :class:`QueueFullError`; a request still queued past its ``deadline_ms``
  is shed with :class:`DeadlineExceededError`. Both are
  :class:`ShedError`\\ s, which the HTTP layer answers with 429.

A failing batch fails its requests, never the worker. Not ported yet: the
circuit breaker, brownout, worker watchdog, fault injection, request ids
and tracing, the flight recorder and telemetry (see ROADMAP.md).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional

LANES = ("interactive", "batch")  # priority order, first drains first


class ShedError(RuntimeError):
    """A request refused instead of run (HTTP 429 + Retry-After)."""

    http_status = 429
    retry_after_s = 1.0


class QueueFullError(ShedError):
    pass


class DeadlineExceededError(ShedError):
    pass


class SchedulerStoppedError(ShedError):
    """The scheduler was shut down (HTTP 503)."""

    http_status = 503


@dataclasses.dataclass
class _Request:
    payload: Any
    rows: int
    future: Future
    lane: str
    t_enqueue: float                 # monotonic
    deadline: Optional[float]        # absolute monotonic, or None


class BatchScheduler:
    """One model's request queues + coalescing worker (see module doc)."""

    def __init__(self, model, *, max_wait_ms: float = 2.0,
                 max_batch: Optional[int] = None, queue_limit: int = 64):
        self.model = model
        self.model_id = model.model_id
        self.max_wait_ms = float(max_wait_ms)
        self.max_batch = int(max_batch or model.coalesce_limit())
        self.queue_limit = int(queue_limit)
        self._queues: Dict[str, collections.deque] = {
            lane: collections.deque() for lane in LANES}
        self._cv = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        #: batches / completed / errors / shed_<reason> totals
        self.counts: collections.Counter = collections.Counter()

    # ------------------------------------------------------------ admission
    def submit(self, payload, *, lane: str = "interactive",
               deadline_ms: Optional[float] = None) -> Future:
        """Enqueue one request; returns a Future of the model result.
        Raises a :class:`ShedError` instead of queueing when the scheduler
        is stopped or the queue is full."""
        if lane not in self._queues:
            raise ValueError(f"unknown lane {lane!r} (have {LANES})")
        now = time.monotonic()
        req = _Request(
            payload=payload, rows=self.model.payload_rows(payload),
            future=Future(), lane=lane, t_enqueue=now,
            deadline=None if deadline_ms is None else now + deadline_ms / 1e3)
        with self._cv:
            if self._stop:
                self.counts["shed_stopped"] += 1
                raise SchedulerStoppedError(
                    f"{self.model_id}: scheduler stopped")
            depth = self._depth_locked()
            if depth >= self.queue_limit:
                self.counts["shed_queue_full"] += 1
                raise QueueFullError(
                    f"{self.model_id}: queue at capacity ({depth})")
            self._queues[lane].append(req)
            self._cv.notify()
        return req.future

    def _depth_locked(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def _take_locked(self, q: collections.deque) -> Optional[_Request]:
        """Pop ``q``'s head, shedding it instead when its deadline passed."""
        req = q.popleft()
        now = time.monotonic()
        if req.deadline is None or now <= req.deadline:
            return req
        self.counts["shed_deadline"] += 1
        if req.future.set_running_or_notify_cancel():
            req.future.set_exception(DeadlineExceededError(
                f"{self.model_id}: deadline expired after "
                f"{(now - req.t_enqueue) * 1e3:.1f} ms in queue"))
        return None

    # --------------------------------------------------------------- worker
    def start(self) -> "BatchScheduler":
        with self._cv:
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, daemon=True,
                    name=f"serving-{self.model_id}")
                self._thread.start()
        return self

    def _fill_batch_locked(self, batch: List[_Request]) -> int:
        """Admit queued requests, highest lane first, until the next one
        would pass ``max_batch`` rows; returns the batch's rows."""
        rows = sum(r.rows for r in batch)
        for lane in LANES:
            q = self._queues[lane]
            while q and rows + q[0].rows <= self.max_batch:
                req = self._take_locked(q)
                if req is not None:
                    batch.append(req)
                    rows += req.rows
        return rows

    def _loop(self):
        while True:
            batch: List[_Request] = []
            with self._cv:
                while not self._stop and not self._depth_locked():
                    self._cv.wait(timeout=0.1)
                if self._stop:
                    return
                for lane in LANES:  # open the batch with the first live head
                    while self._queues[lane] and not batch:
                        req = self._take_locked(self._queues[lane])
                        if req is not None:
                            batch.append(req)
                if not batch:
                    continue
            # max-wait window: keep admitting until the batch is full or
            # max_wait_ms has passed since it opened
            deadline = time.monotonic() + self.max_wait_ms / 1e3
            while True:
                with self._cv:
                    rows = self._fill_batch_locked(batch)
                    remaining = deadline - time.monotonic()
                    if rows >= self.max_batch or remaining <= 0:
                        break
                    self._cv.wait(timeout=remaining)
            self._run_batch(batch)

    def _run_batch(self, batch: List[_Request]):
        self.counts["batches"] += 1
        try:
            results, _stats = self.model.execute([r.payload for r in batch])
        except Exception as e:  # a bad batch fails its requests only
            for req in batch:
                self.counts["errors"] += 1
                if req.future.set_running_or_notify_cancel():
                    req.future.set_exception(e)
            return
        for req, res in zip(batch, results):
            self.counts["completed"] += 1
            if req.future.set_running_or_notify_cancel():
                req.future.set_result(res)

    # ----------------------------------------------------------- lifecycle
    def shutdown(self):
        """Stop the worker; fail everything still queued with
        :class:`SchedulerStoppedError`, and any later submit too."""
        with self._cv:
            self._stop = True
            pending = [r for q in self._queues.values() for r in q]
            for q in self._queues.values():
                q.clear()
            self._cv.notify_all()
        for req in pending:
            if req.future.set_running_or_notify_cancel():
                req.future.set_exception(SchedulerStoppedError(
                    f"{self.model_id}: scheduler stopped; request abandoned"))
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None

    def stats(self) -> dict:
        with self._cv:
            depth = self._depth_locked()
        return {"queue_depth": depth, "max_batch": self.max_batch,
                "counts": dict(self.counts)}
