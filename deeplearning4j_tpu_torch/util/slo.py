"""SLO engine: declared objectives, error budgets, multi-window burn rates
(the port's copy of deeplearning4j_tpu/util/slo.py, whole; the
reference's docs/OBSERVABILITY.md#request-tracing--slos describes it).

A benchmark answers "did this change regress?"; an SLO answers "is
production meeting its promise *right now*, and how fast is it spending
the error budget?" — the SRE formulation. This module declares
objectives over the telemetry registry (util/telemetry.py) and evaluates
them on demand:

- **availability** — good / (good + bad) from the ``serving.completed_total``
  vs ``serving.shed_total`` + ``serving.request_errors_total`` counters,
  optionally filtered by ``model``/``lane`` labels. The error budget is
  ``1 - target``; the burn rate over a window is the window's bad fraction
  divided by the budget (burn 1.0 = spending exactly the budget; 10 = ten
  times too fast).
- **latency_p99** — the live ``serving.latency_p99_seconds`` gauge (worst
  matching series when the filter spans several) against a millisecond
  bound. Each evaluation is one compliance sample; the burn rate over a
  window is the fraction of non-compliant samples divided by the budget
  (the allowed non-compliant fraction, default 5%).

Burn rates are computed over EVERY window in ``objective.windows``
(default 1m/5m/1h — the multiwindow alerting pattern), from snapshots the
engine itself records at each ``evaluate()``; callers that want fresh
windows poll ``evaluate()`` (the ``/metrics`` collector and the
``/slo``/``/healthz`` routes do).

When the **longest window's budget is exhausted** (remaining < 0 — burning
strictly faster than the allowed rate; burn exactly 1.0 is compliant) the
objective flips its ``slo.<name>`` health check — ``/healthz`` answers 503
so the deploy/rollback machinery reacts without parsing burn math — emits
a ``TrainingHealthMonitor``-style anomaly (``slo.anomalies_total{type=
budget_exhausted}`` + an instant trace event, via
``util.health.record_anomaly``), and invokes any ``on_breach`` hooks.
Recovery flips the check back and counts a ``budget_recovered`` anomaly.

Surfaces: ``GET /slo`` (ModelServer + UIServer), the ``slo`` section on
``/healthz`` (sys.modules-guarded like elastic/serving/tuning — a process
that never imported this module pays nothing), and scrape-time
``slo.compliant`` / ``slo.burn_rate{window=}`` / ``slo.error_budget_
remaining`` gauges on ``/metrics``.

    from deeplearning4j_tpu_torch.util import slo
    slo.register(slo.SloObjective("dense-availability", "availability",
                                  target=0.999, model="dense"))
    slo.register(slo.SloObjective("dense-p99", "latency_p99", target=25.0,
                                  model="dense", lane="interactive"))
    slo.get_engine().evaluate()
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.util import telemetry as tm

#: multiwindow burn-rate intervals, seconds (1m / 5m / 1h)
DEFAULT_WINDOWS = (60.0, 300.0, 3600.0)

#: default allowed non-compliance fraction for latency objectives
DEFAULT_LATENCY_BUDGET = 0.05

KINDS = ("availability", "latency_p99")


@dataclasses.dataclass
class SloObjective:
    """One declared objective. ``target`` is an availability fraction
    (e.g. 0.999) for kind="availability", or a p99 bound in MILLISECONDS
    for kind="latency_p99". ``model``/``lane`` filter the telemetry
    series (None = all). ``budget`` overrides the error budget — the
    allowed bad fraction (defaults: ``1 - target`` for availability,
    :data:`DEFAULT_LATENCY_BUDGET` for latency)."""

    name: str
    kind: str
    target: float
    model: Optional[str] = None
    lane: Optional[str] = None
    windows: Tuple[float, ...] = DEFAULT_WINDOWS
    budget: Optional[float] = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown SLO kind {self.kind!r} "
                             f"(have {KINDS})")
        if self.kind == "availability" and not 0.0 < self.target <= 1.0:
            raise ValueError(f"availability target must be in (0, 1], "
                             f"got {self.target}")
        if self.kind == "latency_p99" and self.target <= 0:
            raise ValueError(f"latency_p99 target must be > 0 ms, "
                             f"got {self.target}")
        if not self.windows:
            raise ValueError("need at least one burn window")
        self.windows = tuple(sorted(float(w) for w in self.windows))

    def error_budget(self) -> float:
        if self.budget is not None:
            return max(1e-9, float(self.budget))
        if self.kind == "availability":
            return max(1e-9, 1.0 - self.target)
        return DEFAULT_LATENCY_BUDGET

    def _labels(self) -> dict:
        lab = {}
        if self.model is not None:
            lab["model"] = self.model
        if self.lane is not None:
            lab["lane"] = self.lane
        return lab


def _window_label(w: float) -> str:
    return f"{int(w)}s" if w == int(w) else f"{w}s"


class SloEngine:
    """Objective registry + evaluator (module singleton via
    :func:`get_engine`; ``clock`` is injectable for tests)."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self._lock = threading.Lock()
        self.objectives: Dict[str, SloObjective] = {}
        # name -> deque[(t, good_cum, bad_cum)] (availability)
        #         deque[(t, bad 0/1, value_ms)] (latency)
        self._samples: Dict[str, deque] = {}
        self._exhausted: Dict[str, bool] = {}
        self._hooks: List[Callable[[str, str], None]] = []
        self._recover_hooks: List[Callable[[str], None]] = []

    # -------------------------------------------------------------- registry
    def register(self, objective: SloObjective) -> SloObjective:
        with self._lock:
            if objective.name in self.objectives:
                raise ValueError(f"SLO {objective.name!r} already declared")
            self.objectives[objective.name] = objective
            self._samples[objective.name] = deque()
            self._exhausted[objective.name] = False
        tm.counter("slo.objectives_registered_total")
        tm.set_health(f"slo.{objective.name}", True, "registered")
        return objective

    def on_breach(self, hook: Callable[[str, str], None]):
        """``hook(objective_name, detail)`` invoked on budget exhaustion
        (the TrainingHealthMonitor ``on_anomaly`` convention)."""
        with self._lock:
            if hook not in self._hooks:
                self._hooks.append(hook)

    def on_recover(self, hook: Callable[[str], None]):
        """``hook(objective_name)`` invoked when an exhausted objective's
        budget recovers — the other half of the breach seam, so state
        machines hung off the SLO engine (the serving brownout controller,
        serving/resilience.py) can restore service symmetrically."""
        with self._lock:
            if hook not in self._recover_hooks:
                self._recover_hooks.append(hook)

    def off_breach(self, hook):
        """Remove a hook registered with :meth:`on_breach` (the other half
        of install/uninstall symmetry — serving/resilience.py)."""
        with self._lock:
            if hook in self._hooks:
                self._hooks.remove(hook)

    def off_recover(self, hook):
        """Remove a hook registered with :meth:`on_recover`."""
        with self._lock:
            if hook in self._recover_hooks:
                self._recover_hooks.remove(hook)

    def reset(self):
        """Drop every objective and restore its health check (tests, and
        the smoke's synthetic budget-exhausted case). Objectives that are
        exhausted at reset time fire their recover hooks first — dropping
        an objective ends its breach, and a state machine hung off the
        engine (the serving brownout controller) must see the recovery,
        not stay browned out forever with the hook list emptied under it."""
        with self._lock:
            names = list(self.objectives)
            exhausted = [n for n, bad in self._exhausted.items() if bad]
            recover_hooks = list(self._recover_hooks)
            self.objectives.clear()
            self._samples.clear()
            self._exhausted.clear()
            self._hooks.clear()
            self._recover_hooks.clear()
        for name in exhausted:
            for hook in recover_hooks:
                try:
                    hook(name)
                except Exception:
                    pass  # a broken hook must never break reset
        for name in names:
            tm.set_health(f"slo.{name}", True, "slo reset")

    # ------------------------------------------------------------ measurement
    def _observe(self, obj: SloObjective, now: float):
        """Record one sample for the objective and prune beyond the
        longest window."""
        tele = tm.get_telemetry()
        buf = self._samples[obj.name]
        lab = obj._labels()
        if obj.kind == "availability":
            good = tele.counter_total("serving.completed_total", **lab)
            bad = tele.counter_total("serving.shed_total", **lab) \
                + tele.counter_total("serving.request_errors_total", **lab)
            buf.append((now, good, bad))
        else:
            vals = tele.gauge_values("serving.latency_p99_seconds", **lab)
            val_ms = max(vals) * 1e3 if vals else None
            bad = 0 if val_ms is None or val_ms <= obj.target else 1
            buf.append((now, bad, val_ms))
        horizon = now - obj.windows[-1] - 1.0
        while len(buf) > 1 and buf[1][0] <= horizon:
            buf.popleft()

    def _window_stats(self, obj: SloObjective, now: float,
                      window: float) -> dict:
        """Bad fraction + burn rate over one window from the sample buffer."""
        buf = self._samples[obj.name]
        cutoff = now - window
        budget = obj.error_budget()
        if obj.kind == "availability":
            # baseline = the NEWEST sample at-or-before the window start
            # (the prune in _observe keeps exactly one such sample):
            # counter deltas against it cover everything that happened
            # inside the window. Using the first in-window sample instead
            # would fold traffic recorded between the window start and
            # that sample into the baseline — bad events would age out up
            # to one poll interval early and flap /healthz back to 200
            # while still inside the declared window.
            base = None
            for t, good, bad in reversed(buf):
                if t <= cutoff:
                    base = (good, bad)
                    break
            cur = (buf[-1][1], buf[-1][2]) if buf else (0.0, 0.0)
            if base is None:
                # every sample is inside the window (young process):
                # delta since the first observation
                base = (buf[0][1], buf[0][2]) if buf else cur
            d_good = max(0.0, cur[0] - base[0])
            d_bad = max(0.0, cur[1] - base[1])
            total = d_good + d_bad
            bad_frac = (d_bad / total) if total > 0 else 0.0
            out = {"good": d_good, "bad": d_bad}
        else:
            pts = [(b, v) for t, b, v in buf if t >= cutoff and v is not None]
            bad_frac = (sum(b for b, _v in pts) / len(pts)) if pts else 0.0
            out = {"samples": len(pts)}
        out["bad_fraction"] = round(bad_frac, 6)
        out["burn_rate"] = round(bad_frac / budget, 4)
        return out

    # -------------------------------------------------------------- evaluate
    def evaluate(self, now: Optional[float] = None) -> dict:
        """Evaluate every objective: record a fresh sample, compute
        current compliance + per-window burn rates + remaining budget,
        flip the ``slo.<name>`` health checks, fire breach hooks. Returns
        the JSON-able ``/slo`` document."""
        now = self.clock() if now is None else now
        with self._lock:
            objectives = list(self.objectives.values())
        results = []
        for obj in objectives:
            with self._lock:
                self._observe(obj, now)
                windows = {
                    _window_label(w): self._window_stats(obj, now, w)
                    for w in obj.windows}
                buf = self._samples[obj.name]
                if obj.kind == "availability":
                    good, bad = buf[-1][1], buf[-1][2]
                    total = good + bad
                    current = (good / total) if total > 0 else None
                    compliant = current is None or current >= obj.target
                else:
                    current = buf[-1][2]
                    compliant = current is None or current <= obj.target
            longest = windows[_window_label(obj.windows[-1])]
            remaining = round(1.0 - longest["burn_rate"], 4)
            # strictly negative: burning EXACTLY at the allowed rate
            # (burn 1.0) is a service meeting its SLO to the decimal —
            # flipping /healthz to 503 there would drain a compliant
            # service at its own declared boundary
            exhausted = remaining < 0.0
            res = {
                "name": obj.name, "kind": obj.kind, "target": obj.target,
                "model": obj.model, "lane": obj.lane,
                "budget": obj.error_budget(),
                "current": None if current is None else round(current, 6),
                "compliant": compliant,
                "windows": windows,
                "budget_remaining": remaining,
                "exhausted": exhausted,
            }
            self._transition(obj, res)
            results.append(res)
        return {"time": time.time(), "objectives": results}

    def _transition(self, obj: SloObjective, res: dict):
        """Health-check + anomaly bookkeeping on exhaustion transitions."""
        from deeplearning4j_tpu_torch.util.health import record_anomaly

        with self._lock:
            was = self._exhausted.get(obj.name, False)
            self._exhausted[obj.name] = res["exhausted"]
            hooks = list(self._hooks)
            recover_hooks = list(self._recover_hooks)
        if res["exhausted"]:
            detail = (f"error budget exhausted: burn "
                      f"{res['windows'][_window_label(obj.windows[-1])]['burn_rate']}x "
                      f"over {_window_label(obj.windows[-1])} "
                      f"(target {obj.target}, budget {res['budget']})")
            tm.set_health(f"slo.{obj.name}", False, detail)
            if not was:
                record_anomaly("budget_exhausted", f"{obj.name}: {detail}",
                               source="slo", slo=obj.name)
                for hook in hooks:
                    try:
                        hook(obj.name, detail)
                    except Exception:
                        pass  # a broken hook must never break evaluation
        else:
            tm.set_health(f"slo.{obj.name}", True,
                          f"budget remaining {res['budget_remaining']}")
            if was:
                record_anomaly("budget_recovered", obj.name, source="slo",
                               slo=obj.name)
                for hook in recover_hooks:
                    try:
                        hook(obj.name)
                    except Exception:
                        pass  # a broken hook must never break evaluation


# ------------------------------------------------------------- module API
_engine: Optional[SloEngine] = None
_engine_lock = threading.Lock()


def get_engine() -> SloEngine:
    global _engine
    if _engine is None:
        with _engine_lock:
            if _engine is None:
                _engine = SloEngine()
    return _engine


def register(objective: SloObjective) -> SloObjective:
    """Declare an objective on the process engine and make sure the
    scrape-time gauges are installed."""
    tm.install_default_collectors()
    return get_engine().register(objective)


def reset():
    if _engine is not None:
        _engine.reset()


def current_status() -> dict:
    """The ``/healthz`` slo section (and ``/slo`` body): empty dict when
    nothing is declared, so the probe stays cheap."""
    eng = _engine
    if eng is None or not eng.objectives:
        return {}
    return eng.evaluate()


def collect_slo_gauges() -> list:
    """Scrape-time gauges for the telemetry default collectors
    (sys.modules-guarded in util/telemetry.py like elastic/serving)."""
    eng = _engine
    if eng is None or not eng.objectives:
        return []
    doc = eng.evaluate()
    rows: list = [("slo.objectives", {}, float(len(doc["objectives"])))]
    for res in doc["objectives"]:
        lab = {"slo": res["name"]}
        rows.append(("slo.compliant", lab,
                     1.0 if res["compliant"] else 0.0))
        rows.append(("slo.error_budget_remaining", lab,
                     float(res["budget_remaining"])))
        if res["current"] is not None:
            rows.append(("slo.current", lab, float(res["current"])))
        for wlabel, ws in res["windows"].items():
            rows.append(("slo.burn_rate", {**lab, "window": wlabel},
                         float(ws["burn_rate"])))
    return rows
