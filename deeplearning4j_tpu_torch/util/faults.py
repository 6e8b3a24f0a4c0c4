"""Fault injection + uniform retry/backoff policy (the port's copy of
deeplearning4j_tpu/util/faults.py; the reference's docs/FAULT_TOLERANCE.md
describes it). Of the injection sites named below, the port has the
multiprocess ETL executor (``datavec/executor.py``, KILL_ETL_WORKER) and
the prefetch pipeline (``data/prefetch.py``, STALL_PREFETCH); the others
come with their modules (ROADMAP items 10-12), and their kinds are kept so
that a ``DL4J_TPU_FAULTS`` spec parses the same in both packages.

The reference's failure story is Spark partition retry plus
CrashReportingUtil: every worker-side failure either retries bounded-many
times or surfaces loudly. This module is the TPU-native equivalent's shared
substrate, used by the elastic runtime (parallel/elastic.py), the
multiprocess ETL executor (datavec/executor.py), the prefetch pipeline
(data/prefetch.py), checkpoint I/O (util/checkpoint.py), and the DCN
bootstrap handshake (parallel/distributed.py):

- :class:`RetryPolicy` — ONE policy object (exponential backoff + jitter +
  overall deadline) everywhere a transient failure is retried, replacing
  the previous one-shot timeouts. Every retry increments
  ``elastic.retries_total{op=...}`` so post-mortems can see which seams
  flapped before a run died.
- :class:`FaultInjector` — a process-global registry of injectable faults
  (kill an ETL worker, stall the prefetch producer, drop heartbeats,
  poison a batch with NaN, SIGKILL the host, and the serving-path
  kinds: fail a batch's compute, crash a scheduler worker,
  stall a batch, corrupt a reload archive), each triggerable at a step
  number programmatically or via the ``DL4J_TPU_FAULTS`` env knob
  (``"inject_nan@5,kill_etl_worker"``). Recovery code that cannot be
  made to fire in a test does not ship — tests/test_elastic.py and the
  benchmarks/fault_smoke.py CI leg drive every kind through its recovery
  path.

Injection sites are ordinary production code paths: each site asks
``get_injector().fire(kind, step)`` (a dict lookup when no faults are
armed — zero overhead in real runs) and simulates the failure *mechanism*
(SIGKILL the real worker process, sleep the real producer thread), so the
recovery path exercised is the one a real fault would take.
"""

from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.util import telemetry as tm


class RetryExhaustedError(RuntimeError):
    """A retried operation failed on every attempt (or hit its deadline).
    ``__cause__`` carries the final underlying exception."""


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff + full jitter + overall deadline.

    ``max_attempts``: total tries (1 = no retry). ``base_delay`` doubles
    (``multiplier``) per retry, capped at ``max_delay``; each sleep is
    scaled by a uniform ``[1-jitter, 1]`` draw so N workers retrying the
    same dead coordinator do not thundering-herd in lockstep.
    ``deadline``: overall wall-clock budget in seconds across ALL attempts
    (None = unbounded); a retry that would start past the deadline raises
    instead of sleeping.
    """

    max_attempts: int = 3
    base_delay: float = 0.1
    multiplier: float = 2.0
    max_delay: float = 5.0
    jitter: float = 0.25
    deadline: Optional[float] = None

    def delays(self) -> List[float]:
        """Backoff schedule between attempts (len == max_attempts - 1)."""
        out, d = [], self.base_delay
        for _ in range(max(0, self.max_attempts - 1)):
            out.append(min(d, self.max_delay))
            d *= self.multiplier
        return out

    def with_(self, **kw) -> "RetryPolicy":
        return replace(self, **kw)

    def sleep_before_retry(self, attempt: int,
                           rng: Optional[random.Random] = None) -> float:
        """Jittered backoff before retry number ``attempt`` (1-based) —
        for callers that drive their own retry loop (the mp-ETL chunk
        supervisor, the serving scheduler's watchdog) but must keep this
        policy's backoff semantics; ``rng`` is the caller's own draw (the
        module's otherwise). Returns the seconds slept."""
        delays = self.delays()
        if not delays:
            return 0.0
        d = delays[min(attempt - 1, len(delays) - 1)]
        d *= 1.0 - self.jitter * (rng or random).random()
        time.sleep(d)
        return d

    def run(self, fn: Callable, *, name: str = "op",
            retry_on: tuple = (Exception,),
            on_retry: Optional[Callable[[int, BaseException], None]] = None):
        """Call ``fn()`` under this policy. Transient failures (``retry_on``)
        back off and retry; exhaustion raises :class:`RetryExhaustedError`
        from the last failure. Never swallows KeyboardInterrupt/SystemExit."""
        t0 = time.monotonic()
        delays = self.delays()
        last: Optional[BaseException] = None
        for attempt in range(self.max_attempts):
            try:
                return fn()
            except retry_on as e:  # noqa: PERF203 — retry loop by design
                last = e
                if attempt >= self.max_attempts - 1:
                    break
                delay = delays[attempt] * (1.0 - self.jitter * random.random())
                if (self.deadline is not None
                        and time.monotonic() - t0 + delay > self.deadline):
                    raise RetryExhaustedError(
                        f"{name}: deadline {self.deadline}s exhausted after "
                        f"{attempt + 1} attempt(s): {type(e).__name__}: {e}"
                    ) from e
                tm.counter("elastic.retries_total", op=name)
                tm.instant("elastic.retry", op=name, attempt=attempt + 1,
                           error=f"{type(e).__name__}: {e}"[:200])
                if on_retry is not None:
                    on_retry(attempt + 1, e)
                time.sleep(delay)
        raise RetryExhaustedError(
            f"{name}: failed after {self.max_attempts} attempt(s): "
            f"{type(last).__name__}: {last}") from last


# --------------------------------------------------------------------- faults
#: fault kinds and the site that consumes each one
KILL_ETL_WORKER = "kill_etl_worker"    # datavec/executor.py: SIGKILL a child
STALL_PREFETCH = "stall_prefetch"      # data/prefetch.py: producer sleeps
DROP_HEARTBEAT = "drop_heartbeat"      # parallel/elastic.py: skip heartbeats
INJECT_NAN = "inject_nan"              # parallel/elastic.py: poison a batch
SIGKILL_HOST = "sigkill_host"          # parallel/elastic.py: kill this process
# serving-path kinds (docs/SERVING.md#resilience): the r13 tier's failure
# modes, each firing on the REAL mechanism so the recovery exercised is the
# production one (benchmarks/resilience_smoke.py drives all four in CI)
SERVING_COMPUTE_ERROR = "serving_compute_error"  # serving/model.py: execute raises
SERVING_WORKER_CRASH = "serving_worker_crash"    # serving/scheduler.py: worker loop dies
SERVING_SLOW_BATCH = "serving_slow_batch"        # serving/model.py: execute stalls arg ms
RELOAD_CORRUPT_ARCHIVE = "reload_corrupt_archive"  # serving/router.py: reload reads a truncated zip

FAULT_KINDS = (KILL_ETL_WORKER, STALL_PREFETCH, DROP_HEARTBEAT, INJECT_NAN,
               SIGKILL_HOST, SERVING_COMPUTE_ERROR, SERVING_WORKER_CRASH,
               SERVING_SLOW_BATCH, RELOAD_CORRUPT_ARCHIVE)

#: kinds whose injection site has a step concept — the elastic training
#: loop's iteration for inject_nan/sigkill_host, the serving scheduler's
#: batch-cycle sequence number for the serving_* kinds (``@nth`` = fire at
#: the nth batch the worker runs). The other sites — the ETL dispatcher,
#: the prefetch producer, the heartbeat thread, the reload path — fire with
#: step=None, where a step-gated fault stays armed forever, so @step is
#: rejected for them at parse/inject time ("a typo'd chaos knob must not
#: silently test nothing")
STEP_GATED_KINDS = (INJECT_NAN, SIGKILL_HOST, SERVING_COMPUTE_ERROR,
                    SERVING_WORKER_CRASH, SERVING_SLOW_BATCH)


@dataclass
class Fault:
    """One armed fault. ``at_step=None`` fires at the first opportunity;
    ``count`` is how many times it fires before disarming (-1 = forever).
    ``arg`` is kind-specific (stall seconds, heartbeats to drop)."""

    kind: str
    at_step: Optional[int] = None
    count: int = 1
    arg: Optional[float] = None
    fired: int = field(default=0, compare=False)

    def should_fire(self, step: Optional[int]) -> bool:
        if self.count >= 0 and self.fired >= self.count:
            return False
        if self.at_step is None:
            return True
        # sites without a step concept (prefetch producer, heartbeat
        # thread) pass step=None: a step-gated fault stays armed for them
        return step is not None and step >= self.at_step


class FaultInjector:
    """Process-global fault registry (singleton via :func:`get_injector`).

    Arm programmatically::

        get_injector().inject(INJECT_NAN, at_step=5)

    or from the environment (read once at first access)::

        DL4J_TPU_FAULTS="kill_etl_worker,inject_nan@5,stall_prefetch:3.0"

    where ``kind[@step][:arg]``. Sites call :meth:`fire`, which consumes
    one firing and records ``faults.injected_total{kind=...}``.
    """

    _instance: Optional["FaultInjector"] = None
    _instance_lock = threading.Lock()

    def __init__(self):
        self._lock = threading.Lock()
        self._faults: Dict[str, List[Fault]] = {}
        self.log: List[Tuple[str, Optional[int]]] = []  # (kind, step) fired
        for f in parse_fault_spec(os.environ.get("DL4J_TPU_FAULTS", "")):
            self._faults.setdefault(f.kind, []).append(f)
        #: lock-free fast path for fire() — the serving tier calls fire()
        #: on every batch cycle (util/faults is process-global), and an
        #: un-chaos'd process must not pay a global lock acquisition per
        #: call. Conservative: set on inject, cleared only by clear()
        #: (a process with exhausted faults is a chaos test already).
        self._armed_fast = bool(self._faults)

    @classmethod
    def get_instance(cls) -> "FaultInjector":
        if cls._instance is None:
            with cls._instance_lock:
                if cls._instance is None:
                    cls._instance = cls()
        return cls._instance

    def inject(self, kind: str, at_step: Optional[int] = None,
               count: int = 1, arg: Optional[float] = None) -> Fault:
        if kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {kind!r}; "
                             f"one of {FAULT_KINDS}")
        if at_step is not None and kind not in STEP_GATED_KINDS:
            raise ValueError(
                f"fault kind {kind!r} fires at a site with no step concept;"
                f" @step would arm a fault that can never fire (step-gated "
                f"kinds: {STEP_GATED_KINDS})")
        f = Fault(kind, at_step=at_step, count=count, arg=arg)
        with self._lock:
            self._faults.setdefault(kind, []).append(f)
            self._armed_fast = True
        return f

    def armed(self, kind: Optional[str] = None) -> bool:
        with self._lock:
            kinds = [kind] if kind else list(self._faults)
            return any(f.count < 0 or f.fired < f.count
                       for k in kinds for f in self._faults.get(k, ()))

    def fire(self, kind: str, step: Optional[int] = None) -> Optional[Fault]:
        """Consume one firing of ``kind`` at ``step`` (None when the site has
        no step concept). Returns the Fault (for ``arg``) or None."""
        if not self._armed_fast:  # plain attribute read: no lock on the
            return None           # hot path of an un-chaos'd process
        with self._lock:
            for f in self._faults.get(kind, ()):
                if f.should_fire(step):
                    f.fired += 1
                    self.log.append((kind, step))
                    break
            else:
                return None
        tm.counter("faults.injected_total", kind=kind)
        tm.instant("faults.injected", kind=kind,
                   step=-1 if step is None else step)
        return f

    def clear(self):
        with self._lock:
            self._faults.clear()
            self.log.clear()
            self._armed_fast = False


def parse_fault_spec(spec: str) -> List[Fault]:
    """``"kill_etl_worker,inject_nan@5,stall_prefetch:3.0"`` ->
    [Fault, ...]. Unknown kinds raise, and ``@step`` on a kind whose
    site has no step concept raises (a typo'd chaos knob must not
    silently test nothing)."""
    out: List[Fault] = []
    for part in (p.strip() for p in spec.split(",") if p.strip()):
        arg: Optional[float] = None
        if ":" in part:
            part, args = part.split(":", 1)
            arg = float(args)
        if "@" in part:
            kind, steps = part.split("@", 1)
            at_step: Optional[int] = int(steps)
        else:
            kind, at_step = part, None
        kind = kind.strip().lower()
        if kind not in FAULT_KINDS:
            raise ValueError(
                f"DL4J_TPU_FAULTS: unknown fault kind {kind!r}; "
                f"one of {FAULT_KINDS}")
        if at_step is not None and kind not in STEP_GATED_KINDS:
            raise ValueError(
                f"DL4J_TPU_FAULTS: {kind!r} fires at a site with no step "
                f"concept — drop the @{at_step} (step-gated kinds: "
                f"{STEP_GATED_KINDS})")
        out.append(Fault(kind, at_step=at_step, arg=arg))
    return out


def get_injector() -> FaultInjector:
    return FaultInjector.get_instance()
