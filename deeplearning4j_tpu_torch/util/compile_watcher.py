"""CompileWatcher: which programs were built, per function and per shape
signature (counterpart of deeplearning4j_tpu/util/compile_watcher.py).

In the reference the unit of waste is a whole XLA program, retraced and
recompiled for every new signature (a ragged last batch, a TBPTT
remainder, an eval batch size). Here it is a captured program
(``nn/capture.py``): the first time a network sees a signature it runs the
step's warm-up and captures a CUDA graph, which later batches of that
signature replay. Each build of a signature is one trace, noted under the
reference's function names (``MultiLayerNetwork.train_step``,
``.tbptt_step``, ``.forward`` and the same three for
``ComputationGraph``), with the same per-shape attribution; on the CPU a
program is built but nothing is captured, and the traces count all the
same.

``backend_compiles`` counts CUDA graphs instantiated (none on the CPU) and
``backend_compile_seconds`` the seconds their warm-up and capture took.
``persistent_cache_hits`` stays 0: a CUDA graph holds device addresses of
one process and cannot be stored for the next; what crosses processes is
the kernel library (``util/compile_cache.py``) and each program's
signature and kernel plans (``util/aot_store.py``), which the
``aot_store.*`` and ``compile_cache.*`` telemetry counts. Read by
``nn/listeners.py::RecompileListener``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple


def _shape_of(x) -> Any:
    """Abstract signature of one argument: (shape, dtype name) of an array
    or tensor (a torch dtype by its numpy name, so a tensor and the numpy
    array it came from agree), None, or nested lists/dicts of them."""
    if x is None:
        return None
    if isinstance(x, (list, tuple)):
        return tuple(_shape_of(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _shape_of(v)) for k, v in x.items()))
    shape = getattr(x, "shape", None)
    if shape is None:
        return type(x).__name__
    return (tuple(shape),
            str(getattr(x, "dtype", "?")).replace("torch.", ""))


class CompileWatcher:
    """Counts program builds per function with per-shape attribution.

    Use the process singleton (:meth:`get_instance` / :func:`get_watcher`);
    the networks call :func:`note_trace` once per program they build.
    ``scope()`` counts deltas for tests and harnesses."""

    _instance: Optional["CompileWatcher"] = None

    def __init__(self):
        self.traces: Dict[str, int] = {}
        self.shapes: Dict[str, Dict[Any, int]] = {}
        self.events: List[Tuple[float, str, Any]] = []  # (wall_s, fn, sig)
        self.backend_compiles = 0
        self.backend_compile_seconds = 0.0
        self.jaxpr_trace_seconds = 0.0
        self.persistent_cache_hits = 0
        self._lock = threading.Lock()
        # per-thread tally: a program is built on the thread whose batch
        # first showed its signature
        self._tls = threading.local()

    @classmethod
    def get_instance(cls) -> "CompileWatcher":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    # ------------------------------------------------------------- recording
    def note_trace(self, fn_name: str, *traced_args) -> None:
        sig = tuple(_shape_of(a) for a in traced_args)
        self._tls.traces = getattr(self._tls, "traces", 0) + 1
        with self._lock:
            self.traces[fn_name] = self.traces.get(fn_name, 0) + 1
            per = self.shapes.setdefault(fn_name, {})
            per[sig] = per.get(sig, 0) + 1
            self.events.append((time.time(), fn_name, sig))

    def note_capture(self, seconds: float) -> None:
        """One CUDA graph instantiated, after ``seconds`` of warm-up and
        capture."""
        with self._lock:
            self.backend_compiles += 1
            self.backend_compile_seconds += seconds

    # --------------------------------------------------------------- queries
    def total_traces(self) -> int:
        return sum(self.traces.values())

    def thread_traces(self) -> int:
        """Traces noted on the calling thread since it first noted one."""
        return getattr(self._tls, "traces", 0)

    def counts(self) -> Dict[str, Any]:
        """Every counter, JSON-able, under the reference's keys."""
        return {
            "traces": dict(self.traces),
            "total_traces": self.total_traces(),
            "backend_compiles": self.backend_compiles,
            "uncached_compiles": max(
                0, self.backend_compiles - self.persistent_cache_hits),
            "backend_compile_seconds": round(self.backend_compile_seconds, 4),
            "jaxpr_trace_seconds": round(self.jaxpr_trace_seconds, 4),
            "persistent_cache_hits": self.persistent_cache_hits,
        }

    def summary(self) -> str:
        lines = [
            f"CompileWatcher: {self.total_traces()} traces, "
            f"{self.backend_compiles} graphs captured "
            f"({self.backend_compile_seconds:.2f}s), "
            f"{self.persistent_cache_hits} persistent-cache hits"
        ]
        for fn in sorted(self.traces):
            lines.append(f"  {fn}: {self.traces[fn]} trace(s)")
            for sig, n in self.shapes.get(fn, {}).items():
                lines.append(f"    x{n}  {sig}")
        return "\n".join(lines)

    def reset(self) -> None:
        with self._lock:
            self.traces.clear()
            self.shapes.clear()
            self.events.clear()
            self.backend_compiles = 0
            self.backend_compile_seconds = 0.0
            self.jaxpr_trace_seconds = 0.0
            self.persistent_cache_hits = 0

    def scope(self) -> "CompileScope":
        """Delta counter: ``with watcher.scope() as s: ...; s.traces``."""
        return CompileScope(self)


class CompileScope:
    """Counts traces and captures between ``__enter__`` and the read."""

    def __init__(self, watcher: CompileWatcher):
        self.watcher = watcher
        self._t0: Dict[str, int] = {}
        self._c0 = 0
        self._h0 = 0

    def __enter__(self) -> "CompileScope":
        self._t0 = dict(self.watcher.traces)
        self._c0 = self.watcher.backend_compiles
        self._h0 = self.watcher.persistent_cache_hits
        return self

    def __exit__(self, *exc):
        return False

    @property
    def traces(self) -> int:
        return sum(
            n - self._t0.get(fn, 0) for fn, n in self.watcher.traces.items())

    def traces_of(self, fn_name: str) -> int:
        return self.watcher.traces.get(fn_name, 0) - self._t0.get(fn_name, 0)

    @property
    def backend_compiles(self) -> int:
        return self.watcher.backend_compiles - self._c0

    @property
    def persistent_cache_hits(self) -> int:
        return self.watcher.persistent_cache_hits - self._h0


def get_watcher() -> CompileWatcher:
    """The process CompileWatcher."""
    return CompileWatcher.get_instance()


def note_trace(fn_name: str, *traced_args) -> None:
    """Record one build of ``fn_name`` for the signature of
    ``traced_args``."""
    CompileWatcher.get_instance().note_trace(fn_name, *traced_args)
