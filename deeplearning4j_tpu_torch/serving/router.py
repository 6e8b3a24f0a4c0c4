"""Multi-model routing (counterpart of deeplearning4j_tpu/serving/router.py,
whole): model-id -> (ServingModel, BatchScheduler). Every model gets its
own scheduler — queue, lanes, admission limit, breaker, worker thread — so
one model's flood sheds in its own queue.

``load`` restores a ModelSerializer archive and registers it; ``reload``
swaps a registered model's weights for an archive's: restored into a
shadow, warmed, checked with a canary batch, then swapped between batch
cycles, the model's ``version`` advancing. A corrupt or truncated archive
raises :class:`ModelLoadError` and registers nothing (``load``) or leaves
the old version serving (``reload``); a topology change, a failed warmup
or a non-finite canary raises :class:`ReloadRejectedError` and leaves it
serving too. Each rejection counts ``serving.reload_rejected_total`` and
records a ``reload_rejected`` anomaly; the ``reload_corrupt_archive`` fault
makes a reload read a truncated copy of a good archive. Archives restore
onto the device given at construction (the card unless the caller names
another).

``load(quantize="int8")`` serves weight-only int8 (an int8 archive's own
quantization, bit for bit; an fp32 archive quantized at load), and
``load(draft_path=)`` restores a draft net from its own archive for a
generate model's speculative decoding.

``watch`` follows a published archive: a poller reloads the model
whenever the file's (mtime, size) changes — a publisher that commits with
``os.replace`` (``ModelSerializer.write_model``, or a
``ShardedCheckpointer.add_commit_hook`` that writes one) is never read
torn. ``set_brownout`` fans a lane brownout out to every scheduler,
``debug_requests`` dumps a model's flight recorder, and ``drain`` stops
admission everywhere and finishes what is queued.

The module keeps a registry of live routers, so ``/healthz``
(``current_status``), the telemetry collector (``collect_metrics``) and a
crash dump (``flight_snapshot``) read serving state without the probe
importing the package (``util/telemetry.py`` guards on ``sys.modules``).
"""

from __future__ import annotations

import os
import threading
import weakref
from typing import Dict, Optional, Tuple

from deeplearning4j_tpu_torch.serving.model import ServingModel
from deeplearning4j_tpu_torch.serving.resilience import (  # noqa: F401
    BREAKER_STATES, ModelLoadError, ReloadRejectedError)
from deeplearning4j_tpu_torch.serving.scheduler import BatchScheduler
from deeplearning4j_tpu_torch.util import faults as fl
from deeplearning4j_tpu_torch.util import telemetry as tm
from deeplearning4j_tpu_torch.util.health import record_anomaly

_ROUTERS: "weakref.WeakSet" = weakref.WeakSet()

#: load() keywords that configure the ServingModel, not the scheduler
_MODEL_KW = ("bucketing", "max_length", "prefill_buckets", "paged",
             "block_size", "pool_blocks", "prefix_cache", "prefill_chunk",
             "spec_tokens")


class UnknownModelError(KeyError):
    """No such model-id (HTTP 404)."""

    http_status = 404


class ModelRouter:
    """model-id -> (ServingModel, BatchScheduler) registry (see the module
    doc). ``name`` labels the router in ``/healthz`` and the flight
    snapshot; ``device`` is where restored archives go (None: the card)."""

    def __init__(self, name: str = "default", device=None):
        self.name = name
        self._lock = threading.Lock()
        self._models: Dict[str, Tuple[ServingModel, BatchScheduler]] = {}
        self.draining = False
        self._reload_locks: Dict[str, threading.Lock] = {}
        self._watchers: Dict[str, Tuple[threading.Thread,
                                        threading.Event]] = {}
        self.device = device
        _ROUTERS.add(self)

    # ------------------------------------------------------------ registry
    def register(self, model: ServingModel, *, max_wait_ms: float = 2.0,
                 max_batch: Optional[int] = None, queue_limit: int = 64,
                 start: bool = True, **sched_kw) -> BatchScheduler:
        """Attach a model under its ``model_id`` with its own scheduler;
        ``sched_kw`` passes the resilience knobs (``breaker``,
        ``max_restarts``, ``restart_policy``, ``restart_reset_batches``,
        ``supervised``, ``lanes``, ``flight_capacity``) through to
        :class:`BatchScheduler`."""
        sched = BatchScheduler(model, max_wait_ms=max_wait_ms,
                               max_batch=max_batch, queue_limit=queue_limit,
                               **sched_kw)
        with self._lock:
            if model.model_id in self._models:
                raise ValueError(
                    f"model {model.model_id!r} already registered")
            self._models[model.model_id] = (model, sched)
            self._reload_locks[model.model_id] = threading.Lock()
        tm.counter("serving.models_registered_total")
        if start:
            sched.start()
        return sched

    # ----------------------------------------------------------- archives
    def _restore_archive(self, path: str, what: str):
        """Restore an archive onto this router's device, every failure
        (missing file, truncated zip, a structure that does not match its
        own configuration) one :class:`ModelLoadError`."""
        from deeplearning4j_tpu_torch.util.model_serializer import \
            ModelSerializer

        try:
            return ModelSerializer.restore_model(path, load_updater=False,
                                                 device=self.device)
        except Exception as e:  # noqa: BLE001 - one typed error out
            raise ModelLoadError(f"{what}: archive {path!r} failed to load "
                                 f"({type(e).__name__}: {e})") from e

    def load(self, model_id: str, path: str, *, kind: str = "classify",
             quantize: Optional[str] = None,
             draft_path: Optional[str] = None, **kw) -> BatchScheduler:
        """Restore a ModelSerializer archive and register it under
        ``model_id`` (reference ``:102-127``); ``kw`` goes to
        :meth:`register` (scheduler knobs) or to :class:`ServingModel`
        (bucketing and the decode engine's knobs). ``quantize="int8"``
        serves weight-only int8; ``draft_path`` restores the draft net of
        a generate model's speculative decoding. A corrupt archive raises
        :class:`ModelLoadError` and registers nothing."""
        net = self._restore_archive(path, f"load {model_id!r}")
        model_kw = {k: kw.pop(k) for k in _MODEL_KW if k in kw}
        if draft_path is not None:
            model_kw["draft_net"] = self._restore_archive(
                draft_path, f"load {model_id!r} draft")
        model = ServingModel(net, model_id, kind=kind, quantize=quantize,
                             **model_kw)
        if quantize:
            try:
                tm.gauge("serving.archive_bytes", os.path.getsize(path),
                         model=model_id, quantize=str(quantize))
            except OSError:
                pass
        return self.register(model, **kw)

    # ------------------------------------------------------ rolling reload
    def _reject_reload(self, model_id: str, reason: str, detail: str):
        tm.counter("serving.reload_rejected_total", model=model_id,
                   reason=reason)
        record_anomaly("reload_rejected",
                       f"{model_id}: {reason}: {detail}"[:300],
                       source="serving", model=model_id)

    def reload(self, model_id: str, path: str, *, canary=None) -> int:
        """Rolling weight reload (see the module doc); returns the new
        version."""
        model, _sched = self.get(model_id)
        with self._reload_locks[model_id], \
                tm.span("serving.reload", model=model_id):
            read_path, cleanup = path, None
            fault = fl.get_injector().fire(fl.RELOAD_CORRUPT_ARCHIVE)
            if fault is not None:
                # the real mechanism: the restore reads truncated bytes,
                # failing as a torn publish or a bad disk would
                read_path = cleanup = self._truncated_copy(path, fault.arg)
            try:
                try:
                    new_net = self._restore_archive(
                        read_path, f"reload {model_id!r}")
                except ModelLoadError as e:
                    self._reject_reload(model_id, "load_error", str(e))
                    raise
            finally:
                if cleanup is not None:
                    try:
                        os.unlink(cleanup)
                    except OSError:
                        pass
            if not model.structure_matches(new_net):
                self._reject_reload(model_id, "structure_mismatch",
                                    "parameter tree differs from the live "
                                    "model — register a new model id")
                raise ReloadRejectedError(
                    f"reload {model_id!r}: archive {path!r} holds a "
                    "different topology; the live version keeps serving")
            try:
                shadow = model.clone_with_net(new_net)
                shadow.warmup()
            except Exception as e:  # noqa: BLE001 - reload must not crash
                self._reject_reload(model_id, "warmup_error", repr(e))
                raise ReloadRejectedError(
                    f"reload {model_id!r}: shadow warmup failed "
                    f"({type(e).__name__}: {e}); the live version keeps "
                    "serving") from e
            ok, detail = shadow.canary_check(canary)
            if not ok:
                self._reject_reload(model_id, "canary", detail)
                raise ReloadRejectedError(
                    f"reload {model_id!r}: canary rejected the new weights "
                    f"({detail}); the live version keeps serving")
            version = model.swap_from(shadow)
            tm.counter("serving.reloads_total", model=model_id)
            tm.instant("serving.reload_swap", model=model_id,
                       version=version, path=str(path))
            tm.set_health(f"serving.reload.{model_id}", True,
                          f"serving v{version} from {path}")
            return version

    @staticmethod
    def _truncated_copy(path: str, frac: Optional[float]) -> str:
        """The reload_corrupt_archive fault's mechanism: a copy of the
        archive truncated to ``frac`` (default 0.5) of its bytes."""
        with open(path, "rb") as f:
            data = f.read()
        cut = max(1, int(len(data) * (frac if frac else 0.5)))
        out = f"{path}.corrupt-{os.getpid()}"
        with open(out, "wb") as f:
            f.write(data[:cut])
        return out

    def watch(self, model_id: str, path: str,
              interval_s: float = 1.0) -> threading.Event:
        """Follow a published archive: a daemon poller reloads
        ``model_id`` whenever ``path``'s (mtime, size) changes. A rejected
        reload is remembered by that signature and not retried until the
        publisher commits again; an untyped failure (a transient error in
        the shadow's warmup) is counted, recorded and retried. Returns the
        stop event (also set by :meth:`unwatch`, :meth:`drain` and
        :meth:`shutdown`)."""
        self.get(model_id)  # UnknownModelError before starting a thread
        stop = threading.Event()

        def _sig():
            try:
                st = os.stat(path)
                return (st.st_mtime_ns, st.st_size)
            except OSError:
                return None

        last_sig = _sig()  # reload only new commits, not the current file

        def _poll():
            nonlocal last_sig
            while not stop.wait(interval_s):
                sig = _sig()
                if sig is None or sig == last_sig:
                    continue
                try:
                    v = self.reload(model_id, path)
                    last_sig = sig
                    tm.counter("serving.watch_reloads_total",
                               model=model_id)
                    tm.instant("serving.watch_reload", model=model_id,
                               version=v)
                except (ModelLoadError, ReloadRejectedError,
                        UnknownModelError):
                    # counted by reload(); the old version serves and this
                    # publish is not retried
                    last_sig = sig
                except Exception as e:  # noqa: BLE001 - the poller lives
                    tm.counter("serving.watch_errors_total",
                               model=model_id)
                    record_anomaly("watch_reload_error",
                                   f"{model_id}: {e!r}"[:200],
                                   source="serving", model=model_id)

        t = threading.Thread(target=_poll, daemon=True,
                             name=f"serving-watch-{model_id}")
        with self._lock:
            old = self._watchers.pop(model_id, None)
            self._watchers[model_id] = (t, stop)
        if old is not None:
            old[1].set()
        t.start()
        return stop

    def unwatch(self, model_id: str) -> bool:
        with self._lock:
            entry = self._watchers.pop(model_id, None)
        if entry is None:
            return False
        entry[1].set()
        entry[0].join(timeout=30.0)
        return True

    def set_brownout(self, lanes=()):
        """Fan a brownout (``BrownoutController``) out to every model's
        scheduler; ``()`` restores full service."""
        for model_id in self.model_ids():
            self.get(model_id)[1].set_brownout(lanes)

    def serving_device(self):
        """The device this router serves on, for ``/healthz``'s liveness
        check: the one given at construction, else the first registered
        model's (None: the card)."""
        if self.device is not None:
            return self.device
        for model_id in self.model_ids():
            dev = getattr(self.get(model_id)[0].net, "device", None)
            if dev is not None:
                return dev
        return None

    def get(self, model_id: str) -> Tuple[ServingModel, BatchScheduler]:
        with self._lock:
            entry = self._models.get(model_id)
        if entry is None:
            raise UnknownModelError(model_id)
        return entry

    def model_ids(self):
        with self._lock:
            return list(self._models)

    # ------------------------------------------------------------- serving
    def submit(self, model_id: str, payload, *, lane: str = "interactive",
               deadline_ms: Optional[float] = None,
               request_id: Optional[str] = None, **opts):
        """Route one request (and its options) to its model's scheduler;
        returns a Future. ``request_id`` (the HTTP layer's
        ``X-Request-Id``) reaches the trace spans and the flight
        recorder."""
        _model, sched = self.get(model_id)
        return sched.submit(payload, lane=lane, deadline_ms=deadline_ms,
                            request_id=request_id, **opts)

    def debug_requests(self, model_id: str,
                       last: Optional[int] = None) -> list:
        """The model's flight-recorder ring, newest last (the
        ``/v1/models/<id>/debug/requests`` body)."""
        return self.get(model_id)[1].flight.dump(last=last)

    def warmup(self) -> int:
        """Warm every registered model's buckets; returns the total run."""
        primed = 0
        for model_id in self.model_ids():
            with tm.span("serving.warmup", model=model_id):
                primed += self.get(model_id)[0].warmup()
        return primed

    # ----------------------------------------------------------- lifecycle
    def _stop_watchers(self):
        with self._lock:
            watchers, self._watchers = dict(self._watchers), {}
        for _t, stop in watchers.values():
            stop.set()
        for t, _stop in watchers.values():
            # a reload in flight (a shadow warming) finishes first
            t.join(timeout=30.0)

    def drain(self, timeout: float = 30.0) -> bool:
        """Graceful drain across every model (the SIGTERM path): stop
        admission everywhere, finish queued work, stop the workers.
        Returns whether every queue emptied in time."""
        self.draining = True
        self._stop_watchers()
        ok = True
        for model_id in self.model_ids():
            ok = self.get(model_id)[1].drain(timeout=timeout) and ok
        tm.counter("serving.drains_total")
        tm.set_health("serving.drained", True,
                      f"router {self.name} drained (clean={ok})")
        return ok

    def shutdown(self):
        self.draining = True
        self._stop_watchers()
        for model_id in self.model_ids():
            self.get(model_id)[1].shutdown()

    # ---------------------------------------------------------------- stats
    def status(self) -> dict:
        out = {"draining": self.draining, "models": {}}
        for model_id in self.model_ids():
            model, sched = self.get(model_id)
            out["models"][model_id] = {**model.describe(), **sched.stats()}
        return out


def current_status() -> dict:
    """The serving section of ``/healthz``: every live router's per-model
    queue, latency, shed and breaker state; empty without a router."""
    routers = list(_ROUTERS)
    if not routers:
        return {}
    if len(routers) == 1:
        return routers[0].status()
    return {r.name: r.status() for r in routers}


def collect_metrics() -> list:
    """Scrape-time gauges for the telemetry collectors (reference
    ``:391``): queue depth (combined and per lane), QPS, flight-recorder
    depth, breaker state, version, worker restarts and p50/p99 latency,
    fresh at every scrape."""
    rows = []
    for r in list(_ROUTERS):
        for model_id in r.model_ids():
            try:
                model, sched = r.get(model_id)
            except UnknownModelError:
                continue
            labels = {"model": model_id}
            rows.append(("serving.queue_depth", labels,
                         float(sched.queue_depth())))
            for lane, depth in sched.lane_queue_depths().items():
                rows.append(("serving.queue_depth",
                             {**labels, "lane": lane}, float(depth)))
            rows.append(("serving.qps_10s", labels, float(sched.qps())))
            rows.append(("serving.flight_recorder_depth", labels,
                         float(len(sched.flight))))
            if sched.breaker is not None:
                rows.append(("serving.breaker_state", labels,
                             float(sched.breaker.state_value())))
            rows.append(("serving.model_version", labels,
                         float(model.version)))
            rows.append(("serving.worker_restarts", labels,
                         float(sched._restarts)))
            for q, name in ((0.5, "serving.latency_p50_seconds"),
                            (0.99, "serving.latency_p99_seconds")):
                v = sched.latencies.quantile(q)
                if v is not None:
                    rows.append((name, labels, float(v)))
                for lane, win in sched.lane_latencies.items():
                    lv = win.quantile(q)
                    if lv is not None:
                        rows.append((name, {**labels, "lane": lane},
                                     float(lv)))
    return rows


def flight_snapshot(last: int = 64) -> dict:
    """The last ``last`` flight-recorder records of every live router's
    models (reference ``:434``): the serving section of a crash dump."""
    out: dict = {}
    for r in list(_ROUTERS):
        models = {}
        for model_id in r.model_ids():
            try:
                _m, sched = r.get(model_id)
            except UnknownModelError:
                continue
            records = sched.flight.dump(last=last)
            if records:
                models[model_id] = records
        if models:
            out[r.name] = models
    return out
