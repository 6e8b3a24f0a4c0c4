"""Serving resilience (counterpart of
deeplearning4j_tpu/serving/resilience.py, whole): the failure semantics of
the model server.

- **The errors.** Every :class:`ShedError` is a request refused instead of
  run: the HTTP layer answers its ``http_status`` (429, or 503 where the
  model cannot take work at all) with ``Retry-After``. A shed raised from
  inside a batch (``model.execute``), as :class:`PoolExhaustedError` is
  when the paged KV pool cannot hold a batch, carries its own
  ``shed_reason`` for the scheduler's counters.
- **:class:`CircuitBreaker`**, one per model (the scheduler owns it):
  ``consecutive_errors`` failed batches in a row, or an error fraction of
  at least ``error_rate`` over the last ``window`` batches, open it;
  submits then fail at once with :class:`CircuitOpenError` (503,
  ``Retry-After`` the cooldown left) instead of queueing doomed work.
  After ``cooldown_s`` it is half-open: ``half_open_probes`` requests pass,
  and their batch closes it (success) or opens it again (failure). The
  clock is injectable, so tests drive it without sleeping.
- **:class:`BrownoutController`**: while any objective of the SLO engine
  (``util/slo.py``) has spent its error budget, every scheduler of a
  router sheds its ``batch`` lane (:class:`BrownoutShedError`, 429) and
  ``interactive`` keeps serving; the last recovery reopens it.
- **Fleet supervision**: :data:`FLEET_RESPAWN_POLICY`, the backoff a
  fleet front tier (``serving/fleet.py``) respawns a dead worker process
  under.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Iterable

from deeplearning4j_tpu_torch.util import telemetry as tm


class ShedError(RuntimeError):
    """A request refused by load shedding (HTTP 429 + Retry-After)."""

    http_status = 429
    retry_after_s = 1.0
    #: the shed counter's cause when raised from a batch's execute
    shed_reason = "shed"


class QueueFullError(ShedError):
    """Admission control: the model's queue is at capacity."""


class DeadlineExceededError(ShedError):
    """The request's queueing deadline expired before it ran."""


class PoolExhaustedError(ShedError):
    """The model's paged KV block pool cannot hold this batch's streams
    (``serving/paged.py``): decode admission sheds with 429 + Retry-After
    before any device work, with every reserved block rolled back."""

    shed_reason = "pool_exhausted"


class SchedulerDrainingError(ShedError):
    """The scheduler is draining: no new work is accepted (HTTP 503)."""

    http_status = 503


class SchedulerStoppedError(ShedError):
    """The scheduler's worker is gone (shut down): submit fails at once
    instead of queueing where nothing will run it (HTTP 503)."""

    http_status = 503


class CircuitOpenError(ShedError):
    """The model's circuit breaker is open (HTTP 503); ``retry_after_s``
    is the breaker's remaining cooldown."""

    http_status = 503

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = max(0.1, float(retry_after_s))


class BrownoutShedError(ShedError):
    """The lane is browned out (SLO error budget spent): bulk work is shed
    so the interactive lane keeps its promise."""


class FleetUnavailableError(ShedError):
    """Every worker of a fleet is dead, unhealthy or draining (HTTP 503)."""

    http_status = 503
    retry_after_s = 2.0


class WorkerProxyError(RuntimeError):
    """Every failover attempt to proxy a request to a fleet worker failed
    at the connection (HTTP 502)."""


class WorkerCrashedError(RuntimeError):
    """The scheduler's worker loop died under an in-flight batch (HTTP
    500: a crash is a server error, not a shed)."""


class ModelLoadError(RuntimeError):
    """An archive failed to load cleanly (corrupt or truncated zip, or a
    structure that does not match its own configuration).
    ``ModelRouter.load`` raises it without registering anything;
    ``reload`` raises it with the old version still serving. ``__cause__``
    carries the underlying error."""


class ReloadRejectedError(RuntimeError):
    """A rolling reload was rejected before the swap (canary failure,
    warmup failure or a parameter-structure mismatch); the old weights
    keep serving."""



# ------------------------------------------------------- fleet supervision


def _fleet_respawn_policy():
    """The backoff a fleet respawns a dead worker process under
    (reference ``:166-173``): exponential with jitter, so workers that die
    together do not respawn in lockstep, capped so a crash-looping worker
    settles at one attempt every few seconds."""
    from deeplearning4j_tpu_torch.util.faults import RetryPolicy

    return RetryPolicy(max_attempts=8, base_delay=0.2, multiplier=2.0,
                       max_delay=5.0, jitter=0.25)


FLEET_RESPAWN_POLICY = _fleet_respawn_policy()


# --------------------------------------------------------- circuit breaker

#: breaker states, also the ``serving.breaker_state`` gauge's values
#: (0 = closed, 1 = half_open, 2 = open)
BREAKER_STATES = ("closed", "half_open", "open")


class CircuitBreaker:
    """Per-model three-state circuit breaker (see the module doc).

    Outcomes are recorded per batch (one broken batch fails every request
    in it). ``allow()`` is the submit-time gate: nothing while closed,
    :class:`CircuitOpenError` while open, and while half-open up to
    ``half_open_probes`` admissions whose batch decides the next state.
    """

    def __init__(self, *, consecutive_errors: int = 3,
                 error_rate: float = 0.5, window: int = 16,
                 min_samples: int = 8, cooldown_s: float = 5.0,
                 half_open_probes: int = 1,
                 clock: Callable[[], float] = time.monotonic,
                 model_id: str = ""):
        self.consecutive_errors = int(consecutive_errors)
        self.error_rate = float(error_rate)
        self.window = int(window)
        self.min_samples = int(min_samples)
        self.cooldown_s = float(cooldown_s)
        self.half_open_probes = int(half_open_probes)
        self.clock = clock
        self.model_id = model_id
        self._lock = threading.Lock()
        self.state = "closed"
        self._outcomes: deque = deque(maxlen=self.window)  # 1 = error
        self._consecutive = 0
        self._opened_at = 0.0
        self._probes_left = 0
        self._half_open_at = 0.0
        self.opens = 0
        self.closes = 0

    # ------------------------------------------------------------- recording
    def _trip_locked(self, now: float, why: str):
        self.state = "open"
        self._opened_at = now
        self._probes_left = 0
        self.opens += 1
        tm.counter("serving.breaker_opens_total", model=self.model_id)
        tm.instant("serving.breaker_open", model=self.model_id, reason=why)

    def record_error(self):
        now = self.clock()
        with self._lock:
            if self.state == "half_open":
                # the probe failed: open again for a fresh cooldown
                self._trip_locked(now, "half_open_probe_failed")
                return
            if self.state == "open":
                return
            self._outcomes.append(1)
            self._consecutive += 1
            if self._consecutive >= self.consecutive_errors:
                self._trip_locked(
                    now, f"{self._consecutive} consecutive errors")
                return
            if len(self._outcomes) >= self.min_samples:
                frac = sum(self._outcomes) / len(self._outcomes)
                if frac >= self.error_rate:
                    self._trip_locked(
                        now, f"error rate {frac:.2f} over "
                        f"{len(self._outcomes)} batches")

    def record_success(self):
        with self._lock:
            if self.state == "half_open":
                # the probe's batch succeeded: the model recovered
                self.state = "closed"
                self._outcomes.clear()
                self._consecutive = 0
                self._probes_left = 0
                self.closes += 1
                tm.counter("serving.breaker_closes_total",
                           model=self.model_id)
                tm.instant("serving.breaker_close", model=self.model_id)
                return
            self._outcomes.append(0)
            self._consecutive = 0

    # ------------------------------------------------------------ admission
    def allow(self):
        """Raise :class:`CircuitOpenError` unless this request may enter
        the queue (closed, or an admitted half-open probe)."""
        with self._lock:
            if self.state == "closed":
                return
            now = self.clock()
            if self.state == "open":
                remaining = self.cooldown_s - (now - self._opened_at)
                if remaining > 0:
                    raise CircuitOpenError(
                        f"{self.model_id}: circuit open "
                        f"({remaining:.1f}s cooldown left)",
                        retry_after_s=remaining)
                self.state = "half_open"
                self._probes_left = self.half_open_probes
                self._half_open_at = now
                tm.instant("serving.breaker_half_open", model=self.model_id)
            if self._probes_left <= 0:
                # a probe can be lost without a batch outcome (shed at the
                # queue, expired): after a cooldown with no verdict the
                # probes re-arm, so the breaker never wedges half-open
                if now - self._half_open_at >= self.cooldown_s:
                    self._probes_left = self.half_open_probes
                    self._half_open_at = now
                else:
                    raise CircuitOpenError(
                        f"{self.model_id}: circuit half-open, probe in "
                        "flight", retry_after_s=1.0)
            self._probes_left -= 1

    # --------------------------------------------------------------- queries
    def state_value(self) -> int:
        return BREAKER_STATES.index(self.state)

    def status(self) -> dict:
        with self._lock:
            recent = list(self._outcomes)
            return {
                "state": self.state,
                "consecutive_errors": self._consecutive,
                "recent_error_fraction": round(
                    sum(recent) / len(recent), 4) if recent else 0.0,
                "opens": self.opens,
                "closes": self.closes,
                "cooldown_s": self.cooldown_s,
            }


# --------------------------------------------------------------- brownout


class BrownoutController:
    """SLO budget exhaustion -> lane brownout (see the module doc).

    ``install()`` hooks the process SLO engine's breach and recover
    callbacks; while any objective's budget is spent, every scheduler of
    ``router`` sheds ``shed_lanes`` (never ``interactive``). Idempotent
    across repeated breaches of one objective; ``uninstall()`` detaches
    and restores the lanes.
    """

    def __init__(self, router, shed_lanes: Iterable[str] = ("batch",)):
        self.router = router
        self.shed_lanes = tuple(shed_lanes)
        if "interactive" in self.shed_lanes:
            raise ValueError(
                "brownout must not shed the interactive lane — it exists "
                "to protect it (shed_lanes order: batch before interactive)")
        self._lock = threading.Lock()
        self._exhausted: set = set()
        self.active = False
        self._installed = False

    def install(self) -> "BrownoutController":
        from deeplearning4j_tpu_torch.util import slo

        if not self._installed:
            eng = slo.get_engine()
            eng.on_breach(self._on_breach)
            eng.on_recover(self._on_recover)
            self._installed = True
        return self

    def uninstall(self) -> "BrownoutController":
        """Detach from the SLO engine (whose hooks would otherwise keep
        this controller and its router alive) and restore the lanes."""
        from deeplearning4j_tpu_torch.util import slo

        if self._installed:
            eng = slo.get_engine()
            eng.off_breach(self._on_breach)
            eng.off_recover(self._on_recover)
            self._installed = False
        with self._lock:
            self._exhausted.clear()
            if self.active:
                self._apply(False)
        return self

    def _apply(self, active: bool):
        self.active = active
        self.router.set_brownout(self.shed_lanes if active else ())
        tm.gauge("serving.brownout_active", 1.0 if active else 0.0)
        if active:
            tm.counter("serving.brownouts_total")
            tm.instant("serving.brownout_start",
                       lanes=",".join(self.shed_lanes))
        else:
            tm.instant("serving.brownout_end")

    def _on_breach(self, name: str, detail: str):
        with self._lock:
            first = not self._exhausted
            self._exhausted.add(name)
            if first:
                self._apply(True)

    def _on_recover(self, name: str):
        with self._lock:
            self._exhausted.discard(name)
            if self.active and not self._exhausted:
                self._apply(False)

    def status(self) -> dict:
        with self._lock:
            return {"active": self.active,
                    "shed_lanes": list(self.shed_lanes),
                    "exhausted_objectives": sorted(self._exhausted)}
