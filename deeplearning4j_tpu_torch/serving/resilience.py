"""The serving tier's errors (counterpart of the error classes of
deeplearning4j_tpu/serving/resilience.py, ``:62-160``).

Every :class:`ShedError` is a request refused instead of run: the HTTP
layer answers its ``http_status`` (429, or 503 where the model cannot take
work at all) with ``Retry-After``. A shed raised from inside a batch
(``model.execute``), as :class:`PoolExhaustedError` is when the paged KV
pool cannot hold a batch, carries its own ``shed_reason`` for the
scheduler's counters.

The reference module's CircuitBreaker, BrownoutController and fleet
supervision are ROADMAP Queue 1 item 11b; the errors they raise are
defined here already, as the reference defines them in one place.
"""


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
