"""The anomaly convention of the health monitors (the port's copy of the
part of deeplearning4j_tpu/util/health.py that the serving tier and the
SLO engine read: ``RollbackSignal`` ``:52``, ``ROLLBACK_KINDS`` and
``record_anomaly`` ``:71``).

``TrainingHealthMonitor`` (the loss bands, the divergence check and the
NaN sentinel of the training loop) needs the profiler's ``NaNPanicError``
and comes with ROADMAP Queue 1 item 12.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.util import telemetry as tm


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
