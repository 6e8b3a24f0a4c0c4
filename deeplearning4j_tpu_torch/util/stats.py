"""Stats pipeline: StatsListener -> StatsStorage, and crash reporting
(counterpart of deeplearning4j_tpu/util/stats.py; DL4J's StatsListener,
InMemoryStatsStorage, FileStatsStorage and CrashReportingUtil).

Records are line JSON, as the reference writes them, so either package's
files load in the other and any plotting tool (or :func:`to_csv`) renders
the curves. A record holds the score, per-layer parameter and update
summaries (mean, std, min, max, l2, optional histograms), optional
activation summaries, the program-build counters, the telemetry counters
and gauges, and the published cost reports' totals. The parameter copy to
the host happens only on logged iterations.
"""

from __future__ import annotations

import json
import os
import platform
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float64).numpy()
    return np.asarray(v, np.float64)


def _summary(arr, bins: int = 0) -> Dict[str, float]:
    a = _host(arr)
    if a.size == 0:
        # a size-0 leaf must not crash the listener: NaN-safe summary, and
        # the l2 of nothing is exactly 0
        return {"mean": float("nan"), "std": float("nan"),
                "min": float("nan"), "max": float("nan"), "l2": 0.0}
    out = {
        "mean": float(a.mean()), "std": float(a.std()),
        "min": float(a.min()), "max": float(a.max()),
        "l2": float(np.linalg.norm(a)),
    }
    if bins:
        # histograms of the finite values only (np.histogram's range
        # computation raises on non-finite data)
        flat = a.ravel()
        finite = flat[np.isfinite(flat)]
        if finite.size:
            counts, edges = np.histogram(finite, bins=bins)
            out["hist"] = [int(c) for c in counts]
            out["hist_range"] = [float(edges[0]), float(edges[-1])]
    return out


class InMemoryStatsStorage:
    """InMemoryStatsStorage parity: records kept in a list."""

    def __init__(self):
        self.records: List[dict] = []

    def put(self, record: dict):
        self.records.append(record)

    def sessions(self):
        return sorted({r["session"] for r in self.records})

    def scores(self, session=None):
        return [(r["iteration"], r["score"]) for r in self.records
                if session is None or r["session"] == session]


class FileStatsStorage(InMemoryStatsStorage):
    """FileStatsStorage parity: an append-only line-JSON file."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        if os.path.exists(path):
            with open(path) as f:
                self.records = [json.loads(ln) for ln in f if ln.strip()]

    def put(self, record: dict):
        super().put(record)
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")


def to_csv(storage, path: str):
    """Training-curve export (the UI chart's replacement)."""
    with open(path, "w") as f:
        f.write("session,iteration,epoch,score,iter_ms\n")
        for r in storage.records:
            f.write(f"{r['session']},{r['iteration']},{r.get('epoch', '')},"
                    f"{r['score']},{r.get('iter_ms', '')}\n")


def _named_layers(params):
    """(name, layer params) of a MultiLayerNetwork (a list: ``layer<i>``)
    or a ComputationGraph (a dict by node name)."""
    if isinstance(params, dict):
        return params.items()
    return ((f"layer{i}", p) for i, p in enumerate(params or []))


class StatsListener:
    """StatsListener parity: score and per-layer param/update stats into a
    StatsStorage every ``frequency`` iterations."""

    def __init__(self, storage, frequency: int = 1,
                 session_id: Optional[str] = None,
                 collect_histograms: bool = True, histogram_bins: int = 30,
                 collect_activations: bool = False):
        self.storage = storage
        self.frequency = frequency
        self.session_id = session_id or f"session_{int(time.time())}"
        self.collect_histograms = collect_histograms
        self.histogram_bins = histogram_bins
        # the model page's activation charts: an extra forward per logged
        # iteration, so opt-in
        self.collect_activations = collect_activations
        self._last_ns = None
        self._prev_params = None

    def iteration_done(self, model, iteration, epoch):
        # the step's own host clock under coalesced dispatch, where the
        # calls of a window arrive back to back at its flush
        from deeplearning4j_tpu_torch.nn.listeners import iteration_wall_ns

        now = iteration_wall_ns(model)
        iter_ms = None if self._last_ns is None else (now - self._last_ns) / 1e6
        self._last_ns = now
        if iteration % self.frequency:
            return
        rec: Dict[str, Any] = {
            "session": self.session_id,
            "iteration": iteration,
            "epoch": epoch,
            "score": float(model.score_value),
            "time": time.time(),
        }
        if iter_ms is not None:
            rec["iter_ms"] = iter_ms
        if self.collect_histograms:
            params_stats = {}
            update_stats = {}
            flat = {}
            for lname, p in _named_layers(model.params):
                if not isinstance(p, dict):
                    continue
                for k, v in p.items():
                    if isinstance(v, dict):
                        continue
                    flat[f"{lname}.{k}"] = _host(v)
            for key, v in flat.items():
                params_stats[key] = _summary(v, bins=self.histogram_bins)
                if self._prev_params is not None and key in self._prev_params:
                    update_stats[key] = _summary(
                        v - self._prev_params[key], bins=self.histogram_bins)
            rec["params"] = params_stats
            if update_stats:
                rec["updates"] = update_stats
            self._prev_params = flat
        if self.collect_activations and \
                getattr(model, "last_features", None) is not None \
                and hasattr(model, "feed_forward"):
            lf = model.last_features
            acts = model.feed_forward(*lf) if isinstance(lf, tuple) \
                else model.feed_forward(lf)
            bins = self.histogram_bins if self.collect_histograms else 0
            if isinstance(acts, dict):  # ComputationGraph: by vertex name
                named = acts.items()
            else:                       # MLN: a list, [0] the input itself
                named = ((f"layer{i}", a) for i, a in enumerate(acts[1:]))
            rec["activations"] = {
                str(k): _summary(a, bins=bins) for k, a in named}
        from deeplearning4j_tpu_torch.util.compile_watcher import get_watcher

        rec["compile"] = get_watcher().counts()
        from deeplearning4j_tpu_torch.util import telemetry as tele

        if tele.enabled():
            snap = tele.get_telemetry().snapshot()
            rec["telemetry"] = {"counters": snap["counters"],
                                "gauges": snap["gauges"]}
        from deeplearning4j_tpu_torch.util import cost_model

        cost = cost_model.cost_stats_group()
        if cost is not None:
            rec["cost"] = cost
        self.storage.put(rec)


class CrashReportingUtil:
    """CrashReportingUtil parity: a state dump for post-mortems. Call from
    an except block around ``fit`` (``FaultTolerantTrainer`` does, with its
    ``crash_dump_path``)."""

    @staticmethod
    def write_crash_dump(model, path: str, exc: Optional[BaseException] = None):
        dev = getattr(model, "device", None)
        info: Dict[str, Any] = {
            "time": time.ctime(),
            "platform": platform.platform(),
            "torch_version": torch.__version__,
            "backend": dev.type if dev is not None else None,
            "devices": ([torch.cuda.get_device_name(i)
                         for i in range(torch.cuda.device_count())]
                        if torch.cuda.is_available() else ["cpu"]),
            "exception": repr(exc) if exc else None,
            "iteration": getattr(model, "iteration", None),
            "epoch": getattr(model, "epoch", None),
            "score": float(getattr(model, "score_value", float("nan"))),
            "num_params": model.num_params() if hasattr(model, "num_params")
            else None,
        }
        sizes = {}
        for lname, p in _named_layers(getattr(model, "params", None)):
            if not isinstance(p, dict):
                continue
            for k, v in p.items():
                if isinstance(v, torch.Tensor):
                    sizes[f"{lname}.{k}"] = int(v.numel() * v.element_size())
        info["param_bytes"] = sizes
        info["device_memory_stats"] = None
        if dev is not None and dev.type == "cuda" \
                and torch.cuda.is_initialized():
            try:
                info["device_memory_stats"] = {
                    k: int(v) for k, v in torch.cuda.memory_stats(dev).items()
                    if isinstance(v, (int, float))}
            except Exception:  # noqa: BLE001 - the dump must not fail
                pass
        layers = getattr(model, "layers", None)
        if layers is not None:
            info["config"] = [type(lyr).__name__ for lyr in layers]
        conf = getattr(model, "conf", None)
        if conf is not None and hasattr(conf, "to_json"):
            try:
                info["config_json"] = json.loads(conf.to_json())
            except Exception:  # noqa: BLE001
                info["config_json"] = None
        from deeplearning4j_tpu_torch.util import telemetry as tele

        info["telemetry"] = tele.get_telemetry().snapshot(events_tail=50)
        info["hbm"] = [
            {"metric": name, **labels, "value": value}
            for name, labels, value in tele.device_memory_stats()]
        try:
            import sys as _sys

            _serving = _sys.modules.get(
                "deeplearning4j_tpu_torch.serving.router")
            snap = _serving.flight_snapshot(last=64) if _serving else {}
            if snap:
                info["serving_flight_recorder"] = snap
        except Exception:  # noqa: BLE001 - the dump must not fail
            pass
        with open(path, "w") as f:
            json.dump(info, f, indent=2, default=str)
        return path
