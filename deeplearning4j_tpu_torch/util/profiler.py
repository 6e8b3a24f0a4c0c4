"""Profiling and correctness guards: the op profiler, NaN panic, the device
trace and its parser, and the step timer (counterpart of
deeplearning4j_tpu/util/profiler.py).

- :class:`OpProfiler` / :class:`ProfilerConfig` (OpProfiler.java parity)
  wrap the op table's by-name dispatch, ``ops/registry.py::exec_op``, where
  the reference hooks DefaultOpExecutioner: per-op invocation counts and
  host wall time, each call closed by a device sync (the eager number, as
  the reference's ``block_until_ready``). Inside a CUDA-graph capture a
  sync is illegal: the wrapped call raises by name instead.
- :class:`NaNPanicError` and :func:`check_numerics` (nanPanic parity):
  every offending leaf named by its key path, shape and NaN/Inf counts.
- :func:`device_trace`: a ``torch.profiler`` trace of the block, written
  as Chrome-trace JSON (the reference's ``jax.profiler.trace`` XPlane).
- The trace parser (the reference's XPlane parser ``:199-400``):
  :func:`trace_device_ms`, :func:`trace_event_ms` and
  :func:`trace_mapped_ms` read the Chrome-trace JSON ``torch.profiler``
  exports. The hand kernels launch through ctypes, so a trace shows them
  by their CUDA names only (no aten op above them), and torch.profiler
  has dropped kernels from some eager traces: the launch counts live in
  the wrappers (``ops/kernels``), and a parsed busy time is a cross-check.
- :class:`StepTimer`: one Chrome-trace row per training iteration, timed by
  CUDA events on a CUDA net (device time between iterations) and by the
  host clock on the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob as _glob
import json
import os
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class ProfilerConfig:
    """ProfilerConfig.java parity."""

    profile_ops: bool = True
    check_for_nan: bool = False      # nanPanic
    check_for_inf: bool = False
    stack_trace: bool = False        # record call sites per op


def _tensors(out) -> List[torch.Tensor]:
    """The tensors of an op's result (nested tuples, lists and dicts)."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _tensors(o)]
    if isinstance(out, dict):
        return [t for o in out.values() for t in _tensors(o)]
    return []


def _sync_for(name: str, out) -> None:
    """Wait for the op's CUDA work; a CUDA-graph capture cannot wait, so
    the profiled call refuses it by name."""
    cuda = [t for t in _tensors(out) if t.is_cuda]
    if not cuda:
        return
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"OpProfiler: op {name!r} ran inside a CUDA-graph capture, "
            "where its timing would need a device sync; profile the eager "
            "path (capture.disabled()) or stop the profiler")
    torch.cuda.synchronize(cuda[0].device)


class OpProfiler:
    """Singleton per-op timing/count profiler (OpProfiler.getInstance
    parity). Wraps the registry's ``exec_op``; use ``start()``/``stop()``
    or the ``profile()`` context manager. Times are host wall time with a
    device sync (the eager number)."""

    _instance: Optional["OpProfiler"] = None

    def __init__(self, config: Optional[ProfilerConfig] = None):
        self.config = config or ProfilerConfig()
        self.reset()
        self._orig_exec = None

    @classmethod
    def get_instance(cls) -> "OpProfiler":
        if cls._instance is None:
            cls._instance = OpProfiler()
        return cls._instance

    def reset(self):
        self.invocations: Dict[str, int] = defaultdict(int)
        self.total_ns: Dict[str, int] = defaultdict(int)
        # chrome trace events; ts/dur in wall ns (time.time_ns), so this
        # trace and the telemetry trace share one timebase
        self.events: List[dict] = []

    # -- hook ---------------------------------------------------------------
    def start(self):
        """Install the exec hook (profilingHookIn/Out parity)."""
        from deeplearning4j_tpu_torch.ops import registry

        if self._orig_exec is not None:
            return self
        orig = registry.exec_op
        cfg = self.config
        prof = self

        def wrapped(name, *args, **kwargs):
            t0 = time.time_ns()
            out = orig(name, *args, **kwargs)
            _sync_for(name, out)
            t1 = time.time_ns()
            if cfg.profile_ops:
                prof.invocations[name] += 1
                prof.total_ns[name] += t1 - t0
                prof.events.append({
                    "name": name, "ph": "X", "pid": 0, "tid": 0,
                    "ts": t0, "dur": t1 - t0,  # wall ns; export converts
                })
            if cfg.check_for_nan or cfg.check_for_inf:
                _panic_check(name, out, cfg)
            return out

        registry.exec_op = wrapped
        self._orig_exec = orig
        return self

    def stop(self):
        from deeplearning4j_tpu_torch.ops import registry

        if self._orig_exec is not None:
            registry.exec_op = self._orig_exec
            self._orig_exec = None
        return self

    @contextlib.contextmanager
    def profile(self):
        self.start()
        try:
            yield self
        finally:
            self.stop()

    # -- reporting ----------------------------------------------------------
    def summary(self) -> str:
        """printOutDashboard parity: per-op totals sorted by time."""
        rows = sorted(self.total_ns.items(), key=lambda kv: -kv[1])
        lines = [f"{'op':<32}{'calls':>8}{'total ms':>12}{'mean us':>12}"]
        for name, ns in rows:
            n = self.invocations[name]
            lines.append(
                f"{name:<32}{n:>8}{ns / 1e6:>12.3f}{ns / 1e3 / max(n, 1):>12.1f}")
        return "\n".join(lines)

    def write_chrome_trace(self, path: str):
        """ProfilingListener parity: chrome://tracing JSON, timestamps
        relative to the process-shared trace epoch
        (``telemetry.trace_epoch_ns()``), so this file and a telemetry
        trace of the same run load into one view."""
        _write_wall_trace(self.events, path)


def _write_wall_trace(events: List[dict], path: str) -> None:
    from deeplearning4j_tpu_torch.util.telemetry import trace_epoch_ns

    t0 = trace_epoch_ns()
    if events:
        t0 = min(t0, min(e["ts"] for e in events))
    out = [dict(e, ts=(e["ts"] - t0) / 1e3, dur=e["dur"] / 1e3)
           for e in events]
    with open(path, "w") as f:
        json.dump({"traceEvents": out, "displayTimeUnit": "ms"}, f)


class NaNPanicError(FloatingPointError):
    pass


def _panic_check(name, out, cfg):
    for t in _tensors(out):
        if not t.is_floating_point():
            continue
        if cfg.check_for_nan and bool(torch.isnan(t).any()):
            raise NaNPanicError(f"NaN produced by op {name!r} (nanPanic)")
        if cfg.check_for_inf and bool(torch.isinf(t).any()):
            raise NaNPanicError(f"Inf produced by op {name!r} (infPanic)")


def _leaves_with_path(tree, prefix: str = ""):
    """(key path, leaf) pairs of a dict/list/tuple tree, the path in the
    reference's ``jax.tree_util.keystr`` form (``['layer1'][1]``)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_path(v, f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, f"{prefix}[{i}]")
    elif tree is not None:
        yield prefix, tree


def _as_float_array(leaf) -> Optional[np.ndarray]:
    if isinstance(leaf, torch.Tensor):
        if not leaf.is_floating_point():
            return None
        return leaf.detach().to("cpu", torch.float64).numpy()
    arr = np.asarray(leaf)
    if not np.issubdtype(arr.dtype, np.floating):
        return None
    return arr


def check_numerics(tree, where: str = ""):
    """OpExecutionerUtil.checkForAny parity on any tree of tensors (params,
    grads): raises :class:`NaNPanicError` naming the key path of every
    offending leaf with its shape and nan/inf counts."""
    bad = []
    for key, leaf in _leaves_with_path(tree):
        arr = _as_float_array(leaf)
        if arr is None:
            continue
        finite = np.isfinite(arr)
        if finite.all():
            continue
        n_nan = int(np.isnan(arr).sum())
        n_inf = int(np.isinf(arr).sum())
        bad.append(f"{where}{key} shape={tuple(arr.shape)} "
                   f"nan={n_nan} inf={n_inf}")
    if bad:
        raise NaNPanicError("non-finite values at " + "; ".join(bad))


# ---------------------------------------------------------------------------
# device trace (torch.profiler) and its Chrome-trace parser
# ---------------------------------------------------------------------------

#: Chrome-trace categories torch.profiler gives device-side work
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def device_trace(logdir: str, cuda: Optional[bool] = None):
    """Kernel-level device profile of the block through ``torch.profiler``
    (CPU activity, and CUDA activity when a card is present or ``cuda``
    says so), exported as ``<logdir>/trace.json`` (Chrome-trace JSON) when
    the block ends. The reference's ``jax.profiler.trace``; read the file
    with :func:`trace_device_ms` and friends."""
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def parse_chrome_trace(path: str) -> List[dict]:
    """The complete ("X") events of one Chrome-trace JSON file:
    ``[{"name", "cat", "pid", "tid", "ts", "dur"}]`` with ts and dur in
    microseconds, as torch.profiler writes them."""
    with open(path) as f:
        doc = json.load(f)
    events = doc.get("traceEvents", doc) if isinstance(doc, dict) else doc
    out = []
    for e in events:
        if not isinstance(e, dict) or e.get("ph") != "X":
            continue
        try:
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        except (KeyError, TypeError, ValueError):
            continue
        out.append({"name": str(e.get("name", "")),
                    "cat": str(e.get("cat", "")), "pid": e.get("pid"),
                    "tid": e.get("tid"), "ts": ts, "dur": dur,
                    "args": e.get("args") or {}})
    return out


def _trace_files(logdir: str) -> List[str]:
    if os.path.isfile(logdir):
        return [logdir]
    return sorted(_glob.glob(os.path.join(logdir, "**", "*.json"),
                             recursive=True))


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def trace_device_ms(logdir: str, by_name: bool = False,
                    exclude: Callable[[str], bool] = None):
    """Device-busy milliseconds over every trace under ``logdir`` (a file
    or a directory of ``*.json``): the union of the device events'
    intervals (kernels, copies, memsets) on each device, summed over
    devices, so streams that overlap count once. ``exclude(name)`` drops
    events (a profiler's own spacer kernels); ``by_name=True`` adds the
    per-event-name sum of durations."""
    spans: Dict[Any, list] = defaultdict(list)
    names: Dict[str, float] = defaultdict(float)
    for p in _trace_files(logdir):
        for e in parse_chrome_trace(p):
            if e["cat"] not in DEVICE_CATEGORIES:
                continue
            if exclude is not None and exclude(e["name"]):
                continue
            spans[e["pid"]].append((e["ts"], e["ts"] + e["dur"]))
            names[e["name"]] += e["dur"]
    ms = sum(_union_us(v) for v in spans.values()) / 1e3
    if by_name:
        return ms, {k: v / 1e3 for k, v in
                    sorted(names.items(), key=lambda kv: -kv[1])}
    return ms


def trace_event_ms(logdir: str, event_name: str,
                   category: Optional[str] = None) -> float:
    """Total milliseconds of every event named exactly ``event_name`` (of
    category ``category`` when given) across every thread and stream."""
    total = 0.0
    for p in _trace_files(logdir):
        for e in parse_chrome_trace(p):
            if e["name"] == event_name and (category is None
                                            or e["cat"] == category):
                total += e["dur"]
    return total / 1e3


def trace_event_counts(logdir: str, category: str = "kernel") -> Dict[str, int]:
    """How many events of ``category`` each name has: set against the
    wrappers' launch counts, it says whether the trace kept every launch."""
    counts: Dict[str, int] = defaultdict(int)
    for p in _trace_files(logdir):
        for e in parse_chrome_trace(p):
            if e["cat"] == category:
                counts[e["name"]] += 1
    return dict(counts)


def trace_mapped_ms(logdir: str, resolve) -> Dict[Any, float]:
    """Group event time by ``resolve(event) -> key`` (None = not counted)
    over every thread and stream of the traces under ``logdir``; returns
    {key: total ms}. On one row (pid, tid) only the outermost mapped event
    of an overlap chain counts, so a span and the spans nested inside it
    are never billed twice. ``resolve`` gets the parsed event dict."""
    totals: Dict[Any, float] = defaultdict(float)
    for p in _trace_files(logdir):
        rows: Dict[Any, list] = defaultdict(list)
        for e in parse_chrome_trace(p):
            key = resolve(e)
            if key is not None:
                rows[(e["pid"], e["tid"])].append((e["ts"], -e["dur"], key))
        for mapped in rows.values():
            mapped.sort()
            covered_end = float("-inf")
            for ts, neg_dur, key in mapped:
                if ts >= covered_end:
                    totals[key] += -neg_dur / 1e3
                    covered_end = ts - neg_dur
    return dict(totals)


# ---------------------------------------------------------------------------
# step timer
# ---------------------------------------------------------------------------


class StepTimer:
    """Whole-train-step Chrome-trace recorder, used as a TrainingListener:
    one 'X' event per iteration after the first. On a CUDA net each
    iteration records a CUDA event on the current stream, and a row's
    duration is the device time between two iterations' events (read,
    with one sync, when the trace is written); on the CPU, and under a
    coalesced listener window (whose calls arrive after the steps ran), it
    is the host clock between them. Rows sit on the wall-clock timebase the
    OpProfiler and telemetry traces share."""

    def __init__(self):
        self._marks: List[tuple] = []  # (iteration, wall ns, CUDA event)

    def iteration_done(self, model, iteration, epoch):
        from deeplearning4j_tpu_torch.nn.listeners import iteration_wall_ns

        coalesced = getattr(model, "last_iteration_wall_ns", None) is not None
        ev = None
        dev = getattr(model, "device", None)
        if (not coalesced and dev is not None and dev.type == "cuda"
                and not torch.cuda.is_current_stream_capturing()):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(dev))
        wall = time.time_ns() if not coalesced else \
            time.time_ns() - (time.perf_counter_ns() - iteration_wall_ns(model))
        self._marks.append((iteration, wall, ev))

    @property
    def events(self) -> List[dict]:
        out = []
        for (_, w0, e0), (it, w1, e1) in zip(self._marks, self._marks[1:]):
            if e0 is not None and e1 is not None:
                e1.synchronize()
                dur = int(e0.elapsed_time(e1) * 1e6)
            else:
                dur = w1 - w0
            out.append({"name": f"train_step[{it}]", "ph": "X", "pid": 0,
                        "tid": 0, "ts": w0, "dur": max(dur, 1)})
        return out

    def write_chrome_trace(self, path: str):
        _write_wall_trace(self.events, path)
