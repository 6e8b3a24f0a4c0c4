"""Device-prefetch iterator — overlap host ETL + transfer with device compute
(the port's copy of deeplearning4j_tpu/data/prefetch.py).

Reference parity: org/deeplearning4j/datasets/iterator/AsyncDataSetIterator
.java (+ AsyncMultiDataSetIterator): a background thread drains the base
iterator into a bounded blocking queue so ``fit()`` never waits on ETL —
path-cite, mount empty this round.

The worker does not just *read ahead*, it stages batch k+1 onto the device
while batch k's train step runs. The reference enqueues ``jax.device_put``;
the port copies on a side CUDA stream of its own:

- each host leaf is taken from page-locked memory (an image batch decoded
  into ``native.AsyncImagePipeline``'s pinned ring is already there; any
  other leaf goes through ``Tensor.pin_memory``, whose caching host
  allocator keeps the block until the copy that reads it is done) and
  copied with ``non_blocking=True`` into a tensor allocated on the copy
  stream;
- an event is recorded on the copy stream after the batch's copies, and
  handed to the batch's ``release_after`` where it has one (a DataSet of
  ``AsyncImageDataSetIterator``: its pinned slot is reused only once that
  event has completed);
- before the batch is handed over, the consumer's current stream waits on
  the event, and every staged tensor is marked with ``record_stream`` for
  it, so the caching allocator does not hand the tensor's memory to the
  copy of a later batch while step k still reads it.

``fit()`` receives device tensors and moves nothing (``device.as_tensor``
passes a tensor already on the net's device through). ``device=None`` is
the current CUDA device, as the port's entry points resolve it, and raises
without one; ``device="cpu"`` stages CPU tensors (the CPU tests);
``device_put=False`` is plain host-side read-ahead (the reference's
behavior). ``staged_batches`` and ``staged_bytes`` count what was copied.

Worker exceptions are captured and re-raised in the consuming thread (the
original exception object keeps its worker-side traceback); a stalled
worker trips ``timeout`` instead of hanging fit() forever.
"""

from __future__ import annotations

import queue as _queue
import threading
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.data.iterators import DataSetIterator
from deeplearning4j_tpu_torch.device import as_tensor, resolve_device
from deeplearning4j_tpu_torch.util import faults as fl
from deeplearning4j_tpu_torch.util import telemetry as tm


class PrefetchStalledError(RuntimeError):
    """The prefetch worker produced nothing within ``timeout`` seconds.

    The message carries the post-mortem a stalled pipeline needs (queue
    depth, last batch that made it through, whether the producer thread is
    even alive), and ``prefetch.stalls_total`` is incremented BEFORE the
    raise — the stall is visible on /metrics even when the exception is
    swallowed upstream (docs/FAULT_TOLERANCE.md)."""


def _stage_tree(x, put):
    """``put`` on each leaf of a DataSet field (arrays, lists of them for a
    MultiDataSet, or a dict of them by name)."""
    if x is None:
        return None
    if isinstance(x, (list, tuple)):
        return [_stage_tree(v, put) for v in x]
    if isinstance(x, dict):
        return {k: _stage_tree(v, put) for k, v in x.items()}
    return put(x)


class AsyncDataSetIterator(DataSetIterator):
    """Wrap ANY DataSetIterator with background prefetch + device staging.

    ``buffer_size=2`` is the classic double buffer: one batch in compute,
    one staged on device, the worker building the next. ``device_put=False``
    degrades to plain host-side read-ahead (the reference's behavior).
    ``device``: where the staged tensors live, the net's device (``None``:
    the current CUDA device, which must exist).
    """

    #: consumer q.get waits longer than this count as a pipeline stall
    #: (telemetry: ``prefetch.stalls_total`` + an instant trace event)
    stall_threshold_s: float = 0.05

    def __init__(self, base, buffer_size: int = 2, device_put: bool = True,
                 device=None, timeout: float = 120.0):
        if buffer_size < 1:
            raise ValueError(f"buffer_size must be >= 1, got {buffer_size}")
        self.base = base
        self.buffer_size = buffer_size
        self.device_put = device_put
        self.device = resolve_device(device) if device_put else None
        self.timeout = timeout
        self.staged_batches = 0
        self.staged_bytes = 0
        self._copy_stream = None
        self._queue: Optional[_queue.Queue] = None
        self._stop: Optional[threading.Event] = None
        self._worker: Optional[threading.Thread] = None

    # ------------------------------------------------------------- plumbing
    def batch_size(self):
        # datavec's RecordReaderDataSetIterator family stores batch_size as
        # an int ATTRIBUTE shadowing the DataSetIterator method
        bs = getattr(self.base, "batch_size", None)
        return bs() if callable(bs) else bs

    def reset(self):
        if not self._shutdown():
            # the old worker is wedged INSIDE the base iterator; resetting
            # and re-iterating the same base under it would interleave two
            # threads' mutations of one iterator's state
            raise PrefetchStalledError(
                f"cannot reset: previous prefetch worker is still wedged in "
                f"{type(self.base).__name__}")
        if hasattr(self.base, "reset"):
            self.base.reset()

    def _shutdown(self) -> bool:
        """Stop + reap the worker. False when it outlived the join timeout
        (stuck in the base iterator) — the base is NOT safe to reuse."""
        if self._stop is not None:
            self._stop.set()
        if self._queue is not None:  # unblock a worker stuck in put()
            try:
                while True:
                    self._queue.get_nowait()
            except _queue.Empty:
                pass
        worker = self._worker
        if worker is not None:
            worker.join(timeout=5.0)
        self._queue = self._stop = self._worker = None
        return worker is None or not worker.is_alive()

    # -------------------------------------------------------------- staging
    def _stage(self, ds):
        """Copy a batch's leaves onto ``self.device``. → (staged batch,
        its copy event or None)."""
        if not self.device_put or not isinstance(ds, (DataSet, MultiDataSet)):
            return ds, None  # unknown batch type: pass through untouched
        dev = self.device
        if dev.type != "cuda":
            return self._rebuild(ds, lambda x: as_tensor(x, dev)), None
        stream = self._copy_stream

        def put(x):
            src = x if isinstance(x, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(x))
            if src.dtype == torch.float64:
                src = src.to(torch.float32)
            if src.device.type == "cpu" and not src.is_pinned():
                src = src.pin_memory()
            out = torch.empty(src.shape, dtype=src.dtype, device=dev)
            out.copy_(src, non_blocking=True)
            self.staged_bytes += out.nbytes
            return out

        with torch.cuda.stream(stream):
            staged = self._rebuild(ds, put)
            event = torch.cuda.Event()
            event.record(stream)
        release = getattr(ds, "release_after", None)
        if release is not None:
            release(event)
        self.staged_batches += 1
        return staged, event

    @staticmethod
    def _rebuild(ds, put):
        if isinstance(ds, MultiDataSet):
            return MultiDataSet(
                _stage_tree(ds.features, put), _stage_tree(ds.labels, put),
                _stage_tree(ds.features_masks, put),
                _stage_tree(ds.labels_masks, put))
        return DataSet(
            _stage_tree(ds.features, put), _stage_tree(ds.labels, put),
            _stage_tree(ds.features_mask, put),
            _stage_tree(ds.labels_mask, put))

    def _hand_over(self, staged, event):
        """Make the consumer's current stream wait for the batch's copies,
        and tell the allocator that stream uses the staged tensors."""
        if event is None:
            return staged
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(event)

        def mark(t):
            t.record_stream(consumer)
            return t

        return self._rebuild(staged, mark)

    # --------------------------------------------------------------- worker
    @staticmethod
    def _put(q, stop, item) -> bool:
        """Stop-aware bounded put; False when the consumer abandoned us."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except _queue.Full:
                continue
        return False

    def _produce(self, q, stop):
        # runs on the dl4j-tpu-prefetch thread: its ETL-wait and H2D-enqueue
        # spans land on a distinct tid row of the merged telemetry trace
        try:
            it = iter(self.base)
            while True:
                fault = fl.get_injector().fire(fl.STALL_PREFETCH)
                if fault is not None:
                    # wedge the REAL producer (stop-aware, so shutdown of a
                    # deliberately-stalled pipeline doesn't hang the test)
                    stop.wait(fault.arg if fault.arg else 2 * self.timeout)
                with tm.span("prefetch.etl_wait"):
                    try:
                        ds = next(it)
                    except StopIteration:
                        break
                with tm.span("prefetch.device_put"):
                    staged = self._stage(ds)
                if not self._put(q, stop, ("ok", staged)):
                    return
                tm.gauge("prefetch.queue_depth", q.qsize())
                tm.counter("prefetch.batches_total")
            self._put(q, stop, ("end", None))
        except BaseException as e:  # noqa: BLE001 — crosses the thread gap
            self._put(q, stop, ("error", e))

    # ------------------------------------------------------------- iterator
    def __iter__(self):
        if not self._shutdown():
            raise PrefetchStalledError(
                f"cannot re-iterate: previous prefetch worker is still "
                f"wedged in {type(self.base).__name__}")
        q: _queue.Queue = _queue.Queue(maxsize=self.buffer_size)
        stop = threading.Event()
        if (self.device_put and self.device.type == "cuda"
                and self._copy_stream is None):
            self._copy_stream = torch.cuda.Stream(self.device)
        worker = threading.Thread(
            target=self._produce, args=(q, stop),
            name="dl4j-tpu-prefetch", daemon=True)
        self._queue, self._stop, self._worker = q, stop, worker
        worker.start()
        import time as _time

        first = True  # the first get always absorbs worker startup + the
        last_ok = -1  # index of the last batch that made it through
        try:          # first batch's full ETL: that is warmup, not a stall
            while True:
                t0 = _time.perf_counter()
                try:
                    kind, payload = q.get(timeout=self.timeout)
                except _queue.Empty:
                    alive = worker.is_alive()
                    # counted BEFORE the raise: the stall stays visible on
                    # /metrics even if fit() swallows the exception
                    tm.counter("prefetch.stalls_total")
                    tm.counter("prefetch.stall_timeouts_total")
                    tm.instant("prefetch.stall_timeout",
                               queue_depth=q.qsize(), last_batch=last_ok,
                               producer_alive=alive)
                    raise PrefetchStalledError(
                        f"prefetch worker produced no batch for "
                        f"{self.timeout}s (base iterator "
                        f"{type(self.base).__name__} wedged?): "
                        f"queue depth {q.qsize()}/{self.buffer_size}, "
                        f"last successful batch index {last_ok}, "
                        f"producer thread "
                        f"{'alive' if alive else 'DEAD'}") from None
                waited = _time.perf_counter() - t0
                tm.gauge("prefetch.queue_depth", q.qsize())
                if (kind == "ok" and not first
                        and waited > self.stall_threshold_s):
                    # the consumer outran the pipeline: the device would
                    # have idled for `waited` seconds this batch
                    tm.counter("prefetch.stalls_total")
                    tm.observe("prefetch.stall_seconds", waited)
                    tm.instant("prefetch.stall", waited_ms=round(waited * 1e3, 2))
                first = False
                if kind == "end":
                    return
                if kind == "error":
                    # the exception object carries its worker-side traceback
                    raise payload
                last_ok += 1
                yield self._hand_over(*payload)
        finally:
            stop.set()
