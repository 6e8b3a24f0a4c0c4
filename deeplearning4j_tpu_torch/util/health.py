"""Training-health monitors on the telemetry registry (counterpart of
deeplearning4j_tpu/util/health.py).

Signals (the reference's, on torch tensors):

- **Loss EWMA bands**: each step's score tracked with an exponentially
  weighted mean/variance; a score outside ``mean ± band_sigma·std`` after
  warmup is a ``loss_anomaly``; a non-finite score is ``loss_non_finite``.
- **Divergence**: the loss EWMA past ``divergence_factor x`` its best is
  ``divergence``.
- **NaN/Inf sentinel and update-ratio probe**: every ``window``
  iterations one reduction over every float param leaf gives
  [all finite, ‖params‖, ‖params − params of the last window‖] as one
  fp32 vector, fetched in one copy; the update:param ratio gets its own
  EWMA band (``update_ratio_anomaly``). The last window's params are a
  device-side copy (``update_ratio=False`` skips it).
- **Device memory gauges**: the registry's scrape-time collector.

Every anomaly goes through :func:`record_anomaly` (a counter, an instant
event, the ``/healthz`` checks, ``on_anomaly``); ``panic=True`` turns a
non-finite score or param into :class:`NaNPanicError`, and
``action="rollback"`` a critical one into :class:`RollbackSignal`.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from deeplearning4j_tpu_torch.nn.listeners import TrainingListener
from deeplearning4j_tpu_torch.util import telemetry as tm
from deeplearning4j_tpu_torch.util.profiler import NaNPanicError


class RollbackSignal(RuntimeError):
    """Raised by a monitor with ``action="rollback"`` on a critical
    anomaly: the supervising loop restores the last good checkpoint and
    re-enters training instead of letting the run die. Carries the anomaly
    for the supervisor's log."""

    def __init__(self, kind: str, detail: str, iteration: int):
        super().__init__(f"{kind} at iteration {iteration}: {detail}")
        self.kind = kind
        self.detail = detail
        self.iteration = iteration


#: anomaly kinds worth restoring a checkpoint over: the run's state is
#: poisoned (NaN/Inf) or worse than its past self (divergence); band
#: breaches only warn
ROLLBACK_KINDS = ("loss_non_finite", "params_non_finite", "divergence")


def record_anomaly(kind: str, detail: str, *, source: str = "health",
                   log=None, on_anomaly=None, **args):
    """One anomaly: a counter (``<source>.anomalies_total{type=kind}``),
    an instant event on the trace timeline (``<source>.anomaly``), and an
    optional log line and callback. The serving tier (source="serving")
    and the SLO engine (source="slo") speak the same dialect on
    ``/metrics`` and the merged trace."""
    tm.counter(f"{source}.anomalies_total", type=kind)
    tm.instant(f"{source}.anomaly", type=kind, detail=detail, **args)
    if log is not None:
        log(f"{source.upper()} anomaly: {kind} ({detail})")
    if on_anomaly is not None:
        on_anomaly(kind, detail)


def _float_leaves(tree):
    from deeplearning4j_tpu_torch.tree import tree_leaves

    return [t for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor) and t.is_floating_point()]


def _finite_and_norms(params, prev):
    """The probe body: [all finite, ‖params‖, ‖params − prev‖] as one
    stacked float32 vector, three scalars for one fetch. ``prev=None``
    skips the delta term (first window)."""
    leaves = _float_leaves(params)
    if not leaves:
        return torch.tensor([1.0, 0.0, 0.0], dtype=torch.float32)
    dev = leaves[0].device
    finite = torch.ones((), dtype=torch.bool, device=dev)
    sq = torch.zeros((), dtype=torch.float32, device=dev)
    for t in leaves:
        finite = finite & torch.isfinite(t).all()
        sq = sq + t.float().square().sum()
    dq = torch.zeros((), dtype=torch.float32, device=dev)
    if prev is not None:
        for a, b in zip(leaves, _float_leaves(prev)):
            dq = dq + (a.float() - b.float()).square().sum()
    return torch.stack([finite.float(), sq.sqrt(), dq.sqrt()])


class _Ewma:
    """Exponentially weighted mean/std with sample counting."""

    __slots__ = ("alpha", "mean", "var", "n", "best")

    def __init__(self, alpha: float):
        self.alpha = alpha
        self.mean = 0.0
        self.var = 0.0
        self.n = 0
        self.best = float("inf")

    def update(self, v: float):
        if self.n == 0:
            self.mean, self.var = v, 0.0
        else:
            a = self.alpha
            d = v - self.mean
            self.mean += a * d
            self.var = (1 - a) * (self.var + a * d * d)
        self.n += 1
        if self.mean < self.best:
            self.best = self.mean

    def std(self) -> float:
        return math.sqrt(max(self.var, 0.0))

    def outside_band(self, v: float, sigma: float) -> bool:
        # the std floor is relative (1% of |mean|): the EWMA variance
        # converges slowly, so an ultra-smooth loss would otherwise flag
        # ordinary jitter as a multi-sigma breach right after warmup
        floor = max(self.std(), 0.01 * abs(self.mean), 1e-12)
        return abs(v - self.mean) > sigma * floor


class TrainingHealthMonitor(TrainingListener):
    """TrainingListener wrapping the monitors above; install with
    ``net.add_listener(TrainingHealthMonitor())`` (best with
    ``sync_every > 1``, so the scores arrive in coalesced windows).
    ``window=None`` derives the probe cadence from the conf's
    ``sync_every`` (min 10)."""

    def __init__(self, window: Optional[int] = None, alpha: float = 0.05,
                 band_sigma: float = 6.0, divergence_factor: float = 100.0,
                 warmup: int = 20, update_ratio: bool = True,
                 panic: bool = False,
                 on_anomaly: Optional[Callable[[str, str], None]] = None,
                 action: Optional[str] = None,
                 log_fn=print):
        if action not in (None, "rollback"):
            raise ValueError(
                f"action must be None or 'rollback', got {action!r}")
        self.window = window
        self.alpha = alpha
        self.band_sigma = band_sigma
        self.divergence_factor = divergence_factor
        self.warmup = warmup
        self.update_ratio = update_ratio
        self.panic = panic
        self.on_anomaly = on_anomaly
        self.action = action
        self.log = log_fn
        self.anomalies: list = []  # (iteration, type, detail)
        self._loss = _Ewma(alpha)
        self._ratio = _Ewma(alpha)
        self._prev_params = None
        self._last_probe = None  # (finite, param_norm, update_norm)

    # ------------------------------------------------------------- anomalies
    def _anomaly(self, iteration: int, kind: str, detail: str):
        self.anomalies.append((iteration, kind, detail))
        record_anomaly(
            kind, detail, source="health", iteration=iteration,
            log=(lambda _msg: self.log(
                f"HEALTH anomaly at iteration {iteration}: {kind} "
                f"({detail})")) if self.log else None,
            on_anomaly=self.on_anomaly)
        if self.action == "rollback" and kind in ROLLBACK_KINDS:
            raise RollbackSignal(kind, detail, iteration)
        if self.panic and kind in ("loss_non_finite", "params_non_finite"):
            raise NaNPanicError(
                f"training health panic at iteration {iteration}: {kind} "
                f"({detail})")

    def reset(self):
        """Re-arm after an external state change (a checkpoint rollback,
        transfer surgery): the bands and the last window's params describe
        a run that no longer exists."""
        self._loss = _Ewma(self.alpha)
        self._ratio = _Ewma(self.alpha)
        self._prev_params = None
        self._last_probe = None

    # ------------------------------------------------------------- listeners
    def iteration_done(self, model, iteration, epoch):
        score = float(model.score_value)
        if not math.isfinite(score):
            tm.set_health("training.finite", False,
                          f"non-finite loss at iteration {iteration}")
            self._anomaly(iteration, "loss_non_finite", f"score={score}")
        else:
            ew = self._loss
            if (ew.n > self.warmup
                    and ew.outside_band(score, self.band_sigma)):
                self._anomaly(
                    iteration, "loss_anomaly",
                    f"score={score:.6g} vs ewma={ew.mean:.6g}"
                    f"±{self.band_sigma}·{ew.std():.3g}")
            ew.update(score)
            tm.gauge("health.loss_ewma", ew.mean)
            if (ew.n > self.warmup and ew.best > 0
                    and ew.mean > self.divergence_factor * ew.best):
                tm.set_health(
                    "training.converging", False,
                    f"loss ewma {ew.mean:.6g} is "
                    f">{self.divergence_factor}x its best {ew.best:.6g}")
                self._anomaly(
                    iteration, "divergence",
                    f"ewma={ew.mean:.6g} best={ew.best:.6g}")
            else:
                tm.set_health("training.converging", True, "")
        if iteration % self._window_for(model) == 0:
            self._window_probe(model, iteration)

    def _window_for(self, model) -> int:
        if self.window:
            return self.window
        conf = getattr(model, "conf", None)
        knobs = getattr(conf, "knobs", None) or {}
        every = knobs.get("sync_every", getattr(conf, "sync_every", 1))
        return max(10, int(every or 1))

    # ----------------------------------------------------------------- probe
    def _window_probe(self, model, iteration: int):
        params = getattr(model, "params", None)
        if not params:
            return
        with tm.span("health.window_probe", iteration=iteration):
            prev = self._prev_params if self.update_ratio else None
            try:
                with torch.no_grad():
                    vec = _finite_and_norms(params, prev)
                finite, pnorm, unorm = (float(v) for v in vec.tolist())
            except Exception as e:
                # the params changed structure mid-run (transfer learning):
                # drop the stale copy and re-arm next window, loudly
                self._prev_params = None
                tm.counter("health.probe_errors_total")
                tm.instant("health.probe_error", iteration=iteration,
                           error=repr(e)[:200])
                if self.log:
                    self.log(f"HEALTH probe error at iteration {iteration}"
                             f" (sentinel re-arming): {e!r}")
                return
            if self.update_ratio:
                from deeplearning4j_tpu_torch.tree import tree_map

                self._prev_params = tree_map(
                    lambda t: t.detach().clone()
                    if isinstance(t, torch.Tensor) else t, params)
        self._last_probe = (bool(finite), pnorm, unorm)
        tm.gauge("health.params_finite", finite)
        tm.gauge("health.param_norm", pnorm)
        if not finite:
            tm.set_health("training.finite", False,
                          f"non-finite params at iteration {iteration}")
            self._anomaly(iteration, "params_non_finite",
                          f"param_norm={pnorm}")
        else:
            tm.set_health("training.finite", True, "")
        if prev is not None and pnorm > 0:
            ratio = unorm / pnorm
            tm.gauge("health.update_ratio", ratio)
            ew = self._ratio
            # ratio == 0 is not exempt: a window with no update at all is
            # the purest vanishing-update signature
            if ew.n > 3 and ew.outside_band(ratio, self.band_sigma):
                self._anomaly(
                    iteration, "update_ratio_anomaly",
                    f"window update:param ratio {ratio:.3g} vs "
                    f"ewma {ew.mean:.3g}±{self.band_sigma}·{ew.std():.2g}")
            ew.update(ratio)
        tm.install_default_collectors()

    # ---------------------------------------------------------------- export
    def state(self) -> dict:
        """JSON-able monitor state (tests and the crash dump)."""
        return {
            "loss_ewma": self._loss.mean, "loss_ewma_std": self._loss.std(),
            "loss_best": self._loss.best, "iterations_seen": self._loss.n,
            "update_ratio_ewma": self._ratio.mean,
            "last_probe": self._last_probe,
            "anomalies": [
                {"iteration": i, "type": k, "detail": d}
                for i, k, d in self.anomalies[-50:]],
        }
