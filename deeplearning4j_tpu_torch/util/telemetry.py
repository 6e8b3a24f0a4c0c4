"""Unified training telemetry: one process-global registry every subsystem
feeds (the port's copy of deeplearning4j_tpu/util/telemetry.py; the
reference's docs/OBSERVABILITY.md describes it).

What differs in the port: compile counts come from the port's
``util/compile_watcher.py`` (its programs are captured CUDA graphs, and the
``xla.*`` names are kept); device memory comes from
``torch.cuda.memory_stats``, read only once the process has initialised
CUDA itself, so a scrape never initialises it and a forked child never
touches it; the compile-cache collector reports the persistent
kernel-library cache (``util/compile_cache.py``). The elastic
runtime's (``parallel/elastic.py``), the tuning
database's (``tuning/database.py``), the serving router's, the fleet's and
the SLO engine's collectors and
the serving schedulers' deferred request spans are here, each guarded by
``sys.modules`` on the port's own module name as the reference guards its
own, so a process that never served pays nothing.

The data-parallel names (``parallel/wrapper.py``, ``parallel/masters.py``;
the reference's, listed in :data:`PARALLEL_NAMES`): the
``parallel.step`` / ``parallel.tbptt_step`` spans and the
``parallel.replica_step`` events (one per shard, on a per-replica trace
row), the ``parallel.straggler_skew_seconds``, ``parallel.replicas``,
``parallel.mesh_axis_size`` (by ``axis``),
``parallel.zero_state_sharded_fraction``,
``parallel.opt_state_bytes_per_device``,
``parallel.grad_compression_hosts``, ``parallel.allreduce_wire_bytes``,
``parallel.allreduce_dense_bytes`` and
``parallel.allreduce_compression_ratio`` gauges, the
``parallel.allreduce_wire_bytes_total``,
``parallel.allreduce_exchanges_total`` and ``parallel.reshards_total``
counters.

OpProfiler, StepTimer, CompileWatcher and StatsListener each emit their own
format, and none of them observes the ETL worker processes or the prefetch
thread. This module is the shared measurement substrate:

- **Counters / gauges / histograms** with optional labels, exported as
  Prometheus text (``/metrics`` on util/ui_server.py) and as a JSON snapshot
  (the ``telemetry`` group in StatsListener records, the crash-report dump).
- **Trace spans** with PID + thread attribution, merged across processes
  into ONE Chrome/Perfetto-loadable trace: fit() dispatch spans (with
  program-build sub-spans from the CompileWatcher's counters),
  prefetch-thread ETL-wait/H2D spans (data/prefetch.py), forked ETL-worker
  chunk spans shipped back over the result pipe (datavec/executor.py), and
  per-replica spans from parallel/wrapper.py. Span timestamps use the WALL
  clock (``time.time_ns``), so events recorded in different processes land
  on one consistent timeline; export normalizes to trace-relative µs.
- **Collectors**: scrape-time callbacks (registered here for the
  CompileWatcher counters, device HBM stats, and the persistent-cache
  entry count) so ``/metrics`` always shows live values without any
  subsystem having to push.
- **Health registry**: util/health.py monitors publish named pass/fail
  checks; ``/healthz`` aggregates them.

Overhead stance: every hook is gated on :func:`enabled` (one attribute
read); a span costs two ``time.time_ns`` calls plus one locked append.
``bench.py telemetry_overhead`` tracks the on/off step-time ratio
(target ≤ 1.05x with all monitors enabled). The span buffer is a bounded
ring (``max_events``) so week-long training cannot leak host memory —
drops are themselves counted (``telemetry.events_dropped_total``).

Env knob: ``DL4J_TPU_TELEMETRY=0`` disables all recording (config.py).
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

#: the data-parallel spans, events, gauges and counters, by kind
PARALLEL_NAMES = {
    "span": ("parallel.step", "parallel.tbptt_step"),
    "event": ("parallel.replica_step",),
    "gauge": ("parallel.straggler_skew_seconds", "parallel.replicas",
              "parallel.mesh_axis_size",
              "parallel.zero_state_sharded_fraction",
              "parallel.opt_state_bytes_per_device",
              "parallel.grad_compression_hosts",
              "parallel.allreduce_wire_bytes",
              "parallel.allreduce_dense_bytes",
              "parallel.allreduce_compression_ratio"),
    "counter": ("parallel.allreduce_wire_bytes_total",
                "parallel.allreduce_exchanges_total",
                "parallel.reshards_total"),
}

# Default span-ring capacity: ~200 bytes/event -> tens of MB worst case.
_DEFAULT_MAX_EVENTS = 100_000

# Shared trace timebase: EVERY Chrome-trace exporter in the package
# (Telemetry.write_chrome_trace, OpProfiler/StepTimer in util/profiler.py)
# subtracts this one wall-clock origin, so independently written trace files
# load into one Perfetto view on one consistent timeline. Captured at import
# — telemetry is imported before any recording hook can run.
_TRACE_EPOCH_NS = time.time_ns()


def trace_epoch_ns() -> int:
    """The process's shared Chrome-trace time origin (wall ns)."""
    return _TRACE_EPOCH_NS

# Histogram bucket bounds in SECONDS (most observed values are durations);
# exponential-ish ladder from 0.5 ms to 60 s, +Inf implicit.
_DEFAULT_BOUNDS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def _labels_key(labels: dict) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Hist:
    """One histogram series: bucket counts + sum/count/min/max."""

    __slots__ = ("bounds", "buckets", "count", "sum", "min", "max")

    def __init__(self, bounds=_DEFAULT_BOUNDS):
        self.bounds = bounds
        self.buckets = [0] * (len(bounds) + 1)  # last = +Inf
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float):
        i = 0
        for b in self.bounds:
            if v <= b:
                break
            i += 1
        self.buckets[i] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def snapshot(self) -> dict:
        return {"count": self.count, "sum": round(self.sum, 6),
                "min": None if self.count == 0 else round(self.min, 6),
                "max": None if self.count == 0 else round(self.max, 6)}


class Telemetry:
    """Process-global metrics + trace-span registry (singleton via
    :func:`get_telemetry`). All methods are thread-safe; events carry the
    recording thread's id and the process PID, so one registry serves the
    main loop, the prefetch thread, and (after a merge) forked workers."""

    _instance: Optional["Telemetry"] = None
    _instance_lock = threading.Lock()

    def __init__(self, max_events: int = _DEFAULT_MAX_EVENTS):
        self.enabled = os.environ.get(
            "DL4J_TPU_TELEMETRY", "1").strip().lower() not in (
            "0", "false", "no", "off")
        self.max_events = max_events
        self.counters: Dict[Tuple[str, tuple], float] = {}
        self.gauges: Dict[Tuple[str, tuple], float] = {}
        self.histograms: Dict[Tuple[str, tuple], _Hist] = {}
        self.health: Dict[str, Tuple[bool, str]] = {}
        self._events: deque = deque()
        self._pending: list = []  # event_deferred() staging, GIL-atomic
        self._dropped = 0
        self._collectors: List[Callable[[], list]] = []
        self._lock = threading.Lock()
        self._tls = threading.local()

    @classmethod
    def get_instance(cls) -> "Telemetry":
        if cls._instance is None:
            with cls._instance_lock:
                if cls._instance is None:
                    cls._instance = cls()
        return cls._instance

    # ----------------------------------------------------------- metrics API
    def counter_inc(self, name: str, value: float = 1.0, **labels):
        if not self.enabled:
            return
        key = (name, _labels_key(labels))
        with self._lock:
            self.counters[key] = self.counters.get(key, 0.0) + value

    def gauge_set(self, name: str, value: float, **labels):
        if not self.enabled:
            return
        with self._lock:
            self.gauges[(name, _labels_key(labels))] = float(value)

    def observe(self, name: str, value: float, **labels):
        if not self.enabled:
            return
        key = (name, _labels_key(labels))
        with self._lock:
            h = self.histograms.get(key)
            if h is None:
                h = self.histograms[key] = _Hist()
            h.observe(float(value))

    # ------------------------------------------------------------ metric reads
    def counter_total(self, name: str, **label_filter) -> float:
        """Sum of every counter series named ``name`` whose labels are a
        superset of ``label_filter`` (the SLO engine's read path —
        ``counter_total("serving.shed_total", model="dense")`` sums over
        all reasons/lanes of that model)."""
        flt = {str(k): str(v) for k, v in label_filter.items()}.items()
        with self._lock:
            return sum(v for (n, labels), v in self.counters.items()
                       if n == name and flt <= set(labels))

    def gauge_values(self, name: str, **label_filter) -> List[float]:
        """Every gauge value named ``name`` whose labels superset-match
        ``label_filter`` (callers pick max/min for worst/best-case)."""
        flt = {str(k): str(v) for k, v in label_filter.items()}.items()
        with self._lock:
            return [v for (n, labels), v in self.gauges.items()
                    if n == name and flt <= set(labels)]

    # ------------------------------------------------------------- spans API
    def _span_stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _append(self, ev: dict):
        """Ring append under the lock; EVERY overflow path (spans, instants,
        merged worker events) syncs the drop counter."""
        if len(self._events) >= self.max_events:
            self._events.popleft()
            self._dropped += 1
            self.counters[("telemetry.events_dropped_total", ())] = \
                self._dropped
        self._events.append(ev)

    def event(self, name: str, t0_ns: int, t1_ns: int, *,
              tid: Optional[Any] = None, tname: Optional[str] = None,
              **args):
        """Record one completed span ('X' event): wall-clock ns endpoints,
        current PID, current thread (or an explicit synthetic ``tid`` —
        parallel/wrapper.py uses one per replica)."""
        if not self.enabled:
            return
        th = threading.current_thread()
        ev = {"name": name, "ph": "X", "pid": os.getpid(),
              "tid": th.ident if tid is None else tid,
              "tname": th.name if tname is None else tname,
              "ts": t0_ns, "dur": max(0, t1_ns - t0_ns)}
        stack = self._span_stack()
        if stack and tid is None:
            args.setdefault("parent", stack[-1])
        if args:
            ev["args"] = args
        with self._lock:
            self._append(ev)

    def event_deferred(self, name: str, t0_ns: int, t1_ns: int, **args):
        """:meth:`event` minus the registry lock: the record lands on a
        staging list with one GIL-atomic append and is folded into the
        ring at the next export (:meth:`chrome_trace` /
        :meth:`drain_events` / :meth:`snapshot`). For per-request serving
        spans — the registry lock there is GIL time stolen from OTHER
        models' decode loops (the mixed-bench finding: ~20µs/event
        contended vs ~1µs deferred). Ordering across threads is restored
        by Perfetto's ts sort; same-thread order is preserved."""
        if not self.enabled:
            return
        th = threading.current_thread()
        ev = {"name": name, "ph": "X", "pid": os.getpid(), "tid": th.ident,
              "tname": th.name, "ts": t0_ns, "dur": max(0, t1_ns - t0_ns)}
        stack = self._span_stack()
        if stack:
            args.setdefault("parent", stack[-1])
        if args:
            ev["args"] = args
        if len(self._pending) >= self.max_events:  # bound the staging list
            with self._lock:
                self._dropped += 1
                self.counters[("telemetry.events_dropped_total", ())] = \
                    self._dropped
            return
        self._pending.append(ev)

    def _fold_pending(self):
        """Move staged event_deferred() records into the ring (called
        under no lock; takes the registry lock once for the whole
        batch)."""
        pend, self._pending = self._pending, []
        pend += _staged_serving_spans()
        if not pend:
            return
        with self._lock:
            for ev in pend:
                self._append(ev)

    def instant(self, name: str, **args):
        """Record a zero-duration marker ('i' event) — stalls, anomalies."""
        if not self.enabled:
            return
        th = threading.current_thread()
        ev = {"name": name, "ph": "i", "pid": os.getpid(), "tid": th.ident,
              "tname": th.name, "ts": time.time_ns(), "s": "t"}
        if args:
            ev["args"] = args
        with self._lock:
            self._append(ev)

    def span(self, name: str, **args):
        # disabled path returns a shared no-op: zero clock reads, zero
        # allocation beyond this call — the "one attribute read" contract
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, args)

    # ------------------------------------------------------ cross-process IO
    def drain_events(self) -> List[dict]:
        """Return + clear the span buffer (forked ETL workers ship the
        result of this over the result pipe; datavec/executor.py)."""
        self._fold_pending()
        with self._lock:
            out = list(self._events)
            self._events.clear()
        return out

    def merge_events(self, events) -> int:
        """Merge events recorded in another process/thread (they already
        carry their own PIDs — the wall-clock timebase keeps them on one
        timeline). Returns the number merged."""
        if not events:
            return 0
        with self._lock:
            for ev in events:
                self._append(dict(ev))
        return len(events)

    # --------------------------------------------------------------- health
    def set_health(self, check: str, ok: bool, detail: str = ""):
        with self._lock:
            self.health[check] = (bool(ok), str(detail))

    def health_report(self) -> Tuple[bool, dict]:
        """(all_ok, {check: {"ok": ..., "detail": ...}}); a registry with no
        checks reports healthy (liveness = the process answered)."""
        with self._lock:
            checks = {k: {"ok": v[0], "detail": v[1]}
                      for k, v in self.health.items()}
        return all(c["ok"] for c in checks.values()), checks

    # ----------------------------------------------------------- collectors
    def register_collector(self, fn: Callable[[], list]):
        """``fn() -> [(name, labels_dict, value), ...]`` called at scrape /
        snapshot time; exported as gauges."""
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def _collected(self) -> List[Tuple[str, dict, float]]:
        out = []
        for fn in list(self._collectors):
            try:
                out.extend(fn())
            except Exception:
                continue  # a broken collector must never break a scrape
        return out

    # -------------------------------------------------------------- exports
    def chrome_trace(self) -> dict:
        """Merged Chrome/Perfetto trace JSON: every recorded span (main
        loop + prefetch thread + merged ETL workers + replica rows), ts/dur
        in µs relative to the earliest event, with process/thread name
        metadata rows."""
        self._fold_pending()
        with self._lock:
            events = [dict(e) for e in self._events]
        if not events:
            return {"traceEvents": [], "displayTimeUnit": "ms"}
        # shared timebase with the OpProfiler/StepTimer exporters
        # (util/profiler.py): every trace file subtracts the same origin,
        # so separate files merge onto one Perfetto timeline. Synthetic
        # events older than the epoch (tests) still export consistently.
        t0 = min(trace_epoch_ns(), min(e["ts"] for e in events))
        out: List[dict] = []
        named: set = set()
        mypid = os.getpid()
        for e in events:
            pid, tid = e["pid"], e["tid"]
            if (pid, None) not in named:
                named.add((pid, None))
                role = "main" if pid == mypid else "worker"
                out.append({"name": "process_name", "ph": "M", "pid": pid,
                            "tid": 0,
                            "args": {"name": f"{role} pid={pid}"}})
            if (pid, tid) not in named:
                named.add((pid, tid))
                out.append({"name": "thread_name", "ph": "M", "pid": pid,
                            "tid": tid,
                            "args": {"name": e.get("tname", str(tid))}})
            ev = {"name": e["name"], "ph": e["ph"], "pid": pid, "tid": tid,
                  "ts": (e["ts"] - t0) / 1e3}
            if e["ph"] == "X":
                ev["dur"] = e["dur"] / 1e3
            if e.get("s"):
                ev["s"] = e["s"]
            if e.get("args"):
                ev["args"] = e["args"]
            out.append(ev)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path

    def prometheus_text(self) -> str:
        """Prometheus exposition format (text/plain version 0.0.4): every
        counter, gauge, histogram, collector output, and health check
        (``dl4j_health_check{check=...}`` 1/0)."""
        with self._lock:
            counters = dict(self.counters)
            gauges = dict(self.gauges)
            hists = {k: (h.bounds, list(h.buckets), h.count, h.sum)
                     for k, h in self.histograms.items()}
            health = dict(self.health)
        lines: List[str] = []
        typed: set = set()
        seen_series: set = set()

        def emit(name, labels, value, mtype):
            m = _prom_name(name)
            lab = _prom_labels(labels)
            if (m, lab) in seen_series:
                return  # Prometheus parsers reject duplicate series
            seen_series.add((m, lab))
            if m not in typed:
                typed.add(m)
                lines.append(f"# TYPE {m} {mtype}")
            lines.append(f"{m}{lab} {_prom_num(value)}")

        for (name, labels), v in sorted(counters.items()):
            emit(name, dict(labels), v, "counter")
        for (name, labels), v in sorted(gauges.items()):
            emit(name, dict(labels), v, "gauge")
        # collectors last: a stored gauge with the same name+labels (e.g. a
        # health monitor pushed a device gauge) wins over the scrape-time
        # collector duplicate
        for name, labels, v in self._collected():
            emit(name, labels, v, "gauge")
        for (name, labels), (bounds, buckets, count, total) in \
                sorted(hists.items()):
            m = _prom_name(name)
            if m not in typed:
                typed.add(m)
                lines.append(f"# TYPE {m} histogram")
            cum = 0
            base = dict(labels)
            for b, c in zip(bounds, buckets[:-1]):
                cum += c
                lines.append(
                    f"{m}_bucket{_prom_labels({**base, 'le': repr(b)})} {cum}")
            lines.append(
                f"{m}_bucket{_prom_labels({**base, 'le': '+Inf'})} {count}")
            lines.append(f"{m}_sum{_prom_labels(base)} {_prom_num(total)}")
            lines.append(f"{m}_count{_prom_labels(base)} {count}")
        for check, (ok, _detail) in sorted(health.items()):
            emit("health_check", {"check": check}, 1 if ok else 0, "gauge")
        return "\n".join(lines) + "\n"

    def snapshot(self, events_tail: int = 0) -> dict:
        """JSON-able counters/gauges/histogram-summaries (+ optional last-N
        events) — the StatsListener ``telemetry`` group and the crash dump."""
        if events_tail:
            self._fold_pending()
        with self._lock:
            counters = {_flat_name(k): round(v, 6)
                        for k, v in self.counters.items()}
            gauges = {_flat_name(k): round(v, 6)
                      for k, v in self.gauges.items()}
            hists = {_flat_name(k): h.snapshot()
                     for k, h in self.histograms.items()}
            health = {k: {"ok": v[0], "detail": v[1]}
                      for k, v in self.health.items()}
            tail = [dict(e) for e in list(self._events)[-events_tail:]] \
                if events_tail else []
        for name, labels, v in self._collected():
            gauges[_flat_name((name, _labels_key(labels)))] = v
        out = {"counters": counters, "gauges": gauges,
               "histograms": hists, "health": health}
        if events_tail:
            out["recent_events"] = tail
        return out

    def reset(self):
        _staged_serving_spans()  # discard staged serving request spans
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self.histograms.clear()
            self.health.clear()
            self._events.clear()
            self._pending = []
            self._dropped = 0
            # collectors survive reset: they are wiring, not data


class _NullSpan:
    """Shared no-op context manager handed out while telemetry is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """Context manager recording one 'X' event; nesting tracked through a
    thread-local stack so child spans carry ``parent`` attribution."""

    __slots__ = ("_t", "name", "args", "t0")

    def __init__(self, tele: Telemetry, name: str, args: dict):
        self._t = tele
        self.name = name
        self.args = args

    def __enter__(self):
        self.t0 = time.time_ns()
        self._t._span_stack().append(self.name)
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        stack = self._t._span_stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        self._t.event(self.name, self.t0, t1, **self.args)
        return False


# ---------------------------------------------------------------- module API
def get_telemetry() -> Telemetry:
    return Telemetry.get_instance()


def enabled() -> bool:
    t = Telemetry._instance
    return t.enabled if t is not None else Telemetry.get_instance().enabled


def set_enabled(on: bool) -> None:
    Telemetry.get_instance().enabled = bool(on)


def counter(name: str, value: float = 1.0, **labels):
    Telemetry.get_instance().counter_inc(name, value, **labels)


def gauge(name: str, value: float, **labels):
    Telemetry.get_instance().gauge_set(name, value, **labels)


def observe(name: str, value: float, **labels):
    Telemetry.get_instance().observe(name, value, **labels)


def span(name: str, **args) -> _Span:
    return Telemetry.get_instance().span(name, **args)


def instant(name: str, **args):
    Telemetry.get_instance().instant(name, **args)


def set_health(check: str, ok: bool, detail: str = ""):
    Telemetry.get_instance().set_health(check, ok, detail)


class _StepSpan:
    """Dispatch span with program-build attribution, reusing the
    CompileWatcher's markers: if the dispatch built a program, two
    sub-spans are emitted whose durations come from the watcher (its trace
    seconds, and the seconds a CUDA graph's warm-up and capture took), so
    the merged trace shows WHERE a ragged shape paid compile inside the
    training loop. Costs two counter reads on the hot path."""

    __slots__ = ("name", "args", "_w", "_tr0", "_j0", "_c0", "t0")

    def __init__(self, name: str, args: dict):
        self.name = name
        self.args = args

    def __enter__(self):
        if not enabled():
            self._w = None
            return self
        from deeplearning4j_tpu_torch.util.compile_watcher import get_watcher

        w = self._w = get_watcher()
        self._tr0 = w.total_traces()
        self._j0 = w.jaxpr_trace_seconds
        self._c0 = w.backend_compile_seconds
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        w = self._w
        if w is None:
            return False
        t1 = time.time_ns()
        tele = Telemetry.get_instance()
        tele.event(self.name, self.t0, t1, **self.args)
        if w.total_traces() > self._tr0:
            jd = max(0.0, w.jaxpr_trace_seconds - self._j0)
            cd = max(0.0, w.backend_compile_seconds - self._c0)
            tele.counter_inc("xla.step_retraces_total")
            if jd:
                tele.event("xla.jaxpr_trace", self.t0,
                           self.t0 + int(jd * 1e9), parent=self.name)
            if cd:
                c0 = self.t0 + int(jd * 1e9)
                tele.event("xla.backend_compile", c0, c0 + int(cd * 1e9),
                           parent=self.name)
        return False


def step_span(name: str, **args) -> _StepSpan:
    return _StepSpan(name, args)


# ----------------------------------------------------------------- exporters
def _prom_name(name: str) -> str:
    return "dl4j_" + re.sub(r"[^a-zA-Z0-9_]", "_", name)


def _prom_labels(labels: dict) -> str:
    if not labels:
        return ""
    parts = []
    for k, v in sorted(labels.items()):
        key = re.sub(r"[^a-zA-Z0-9_]", "_", str(k))
        # Prometheus exposition format (text/plain 0.0.4): label values
        # escape backslash, double quote, AND line feed — a raw newline in
        # a value (e.g. a model description) would split the sample line
        # and make the whole scrape unparsable
        val = (str(v).replace("\\", "\\\\").replace('"', '\\"')
               .replace("\n", "\\n"))
        parts.append(f'{key}="{val}"')
    return "{" + ",".join(parts) + "}"


def _prom_num(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _flat_name(key: Tuple[str, tuple]) -> str:
    name, labels = key
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"


# ---------------------------------------------------------- default sources
_defaults_installed = False
_defaults_lock = threading.Lock()


def install_default_collectors() -> Telemetry:
    """Register the scrape-time sources every deployment wants (idempotent):
    CompileWatcher counters (compile observability), per-device memory
    live/peak bytes from torch's allocator, and the elastic, serving,
    fleet and SLO gauges (reference ``:655-666``)."""
    global _defaults_installed
    tele = Telemetry.get_instance()
    with _defaults_lock:
        if _defaults_installed:
            return tele
        tele.register_collector(_collect_compile)
        tele.register_collector(_collect_device_memory)
        tele.register_collector(_collect_compile_cache)
        tele.register_collector(_collect_elastic)
        tele.register_collector(_collect_serving)
        tele.register_collector(_collect_fleet)
        tele.register_collector(_collect_slo)
        tele.register_collector(_collect_tuning)
        _defaults_installed = True
    return tele


def _collect_compile() -> list:
    from deeplearning4j_tpu_torch.util.compile_watcher import CompileWatcher

    w = CompileWatcher._instance
    if w is None:  # never touched: report zeros rather than forcing hooks in
        return [("xla.traces_total", {}, 0), ("xla.backend_compiles_total", {}, 0)]
    c = w.counts()
    return [
        ("xla.traces_total", {}, c["total_traces"]),
        ("xla.backend_compiles_total", {}, c["backend_compiles"]),
        ("xla.uncached_compiles_total", {}, c["uncached_compiles"]),
        ("xla.backend_compile_seconds_total", {}, c["backend_compile_seconds"]),
        ("xla.jaxpr_trace_seconds_total", {}, c["jaxpr_trace_seconds"]),
        ("xla.persistent_cache_hits_total", {}, c["persistent_cache_hits"]),
    ]


def device_memory_stats() -> List[Tuple[str, dict, float]]:
    """Live/peak device memory gauges from ``torch.cuda.memory_stats``,
    one series per CUDA device; nothing in a process that has not
    initialised CUDA (a CPU run, a forked ETL worker), so a scrape never
    initialises it. Shared by the /metrics collector and the crash dump."""
    out: List[Tuple[str, dict, float]] = []
    import sys

    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return out
    try:
        for d in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(d)
            lab = {"device": str(d), "platform": "cuda"}
            out.append(("device.bytes_in_use", lab,
                        float(stats.get("allocated_bytes.all.current", 0))))
            out.append(("device.peak_bytes_in_use", lab,
                        float(stats.get("allocated_bytes.all.peak", 0))))
            out.append(("device.bytes_limit", lab, float(
                torch.cuda.get_device_properties(d).total_memory)))
    except RuntimeError:
        pass
    return out


def _collect_device_memory() -> list:
    return device_memory_stats()


def _collect_compile_cache() -> list:
    """Whether the persistent kernel-library cache is on, and its entries
    (reference ``:720-726``)."""
    from deeplearning4j_tpu_torch.util import compile_cache

    d = compile_cache.cache_dir()
    return [("compile_cache.enabled", {}, 1 if d else 0),
            ("compile_cache.entries", {},
             compile_cache.cache_entries() if d else 0)]


def _collect_elastic() -> list:
    """The elastic runtime's gauges (world size, live members, rollbacks,
    drained) at scrape time (reference ``:729``); nothing in a process
    that never imported it."""
    import sys

    mod = sys.modules.get("deeplearning4j_tpu_torch.parallel.elastic")
    if mod is None:
        return []
    return mod.collect_elastic_gauges()


def _collect_serving() -> list:
    """Serving-tier gauges (per-model queue depth, p50/p99 latency, QPS,
    breaker state, version, restarts) at scrape time (reference ``:741``);
    nothing in a process that never imported the router."""
    import sys

    mod = sys.modules.get("deeplearning4j_tpu_torch.serving.router")
    if mod is None:
        return []
    return mod.collect_metrics()


def _collect_fleet() -> list:
    """Fleet-tier gauges (ring size, per-worker health, membership,
    in-flight and restarts) at scrape time; nothing in a process without
    a fleet front tier."""
    import sys

    mod = sys.modules.get("deeplearning4j_tpu_torch.serving.fleet")
    if mod is None:
        return []
    return mod.collect_metrics()


def _collect_slo() -> list:
    """SLO gauges (compliance, burn rates, budget remaining) at scrape
    time; nothing in a process that never declared an objective."""
    import sys

    mod = sys.modules.get("deeplearning4j_tpu_torch.util.slo")
    if mod is None:
        return []
    return mod.collect_slo_gauges()


def _collect_tuning() -> list:
    """Tuning-database gauges (armed flag, entry count) at scrape time;
    nothing in a process that never imported the tuner (reference
    ``:766-775``)."""
    import sys

    mod = sys.modules.get("deeplearning4j_tpu_torch.tuning.database")
    if mod is None:
        return []
    return mod.collect_tuning_gauges()


def _staged_serving_spans() -> list:
    """Request phase spans staged by the serving schedulers, cleared on
    read (reference ``:468``); nothing in a process that never imported
    the scheduler."""
    import sys

    mod = sys.modules.get("deeplearning4j_tpu_torch.serving.scheduler")
    if mod is None:
        return []
    try:
        return mod.collect_deferred_spans()
    except Exception:
        return []  # a broken scheduler must never break an export


def _after_fork_child():
    """Forked children (mp-ETL workers) inherit the parent's registry by
    memory image: re-arm the lock (the parent may have held it mid-fork)
    and clear inherited spans so a worker ships only its OWN events — its
    PID attribution is then correct by construction."""
    t = Telemetry._instance
    if t is not None:
        t._lock = threading.Lock()
        t._tls = threading.local()
        t._events = deque()
        t._pending = []
        t._dropped = 0


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_after_fork_child)
