"""Serving tier of the port (counterpart of deeplearning4j_tpu/serving):
ModelServer -> ModelRouter -> BatchScheduler -> ServingModel, classify
(fp32 or int8) and generate (the paged-KV decode tier of
``serving/generate.py``), with the resilience layer (circuit breaker,
brownout, supervised worker, drain, request ids, flight recorder; the
``/metrics``, ``/healthz``, ``/slo`` and ``/admin`` routes) and the fleet
(``FleetRouter`` over worker processes, ``serving/fleet_worker.py``).

    from deeplearning4j_tpu_torch.serving import (ModelRouter, ModelServer,
                                                  ServingModel)

    router = ModelRouter()
    router.register(ServingModel(net, "lenet"))
    router.load("lm", "/models/lm.zip", kind="generate")
    server = ModelServer(router, port=8080).start()  # warms the programs

Multi-device inference (``use_mesh``) is ROADMAP Queue 1 item 10.
"""

from deeplearning4j_tpu_torch.serving.fleet import (FleetRouter, FleetWorker,
                                                    affinity_key, fleet_spec,
                                                    rendezvous_pick)
from deeplearning4j_tpu_torch.serving.generate import Generator
from deeplearning4j_tpu_torch.serving.model import ServingModel
from deeplearning4j_tpu_torch.serving.paged import (BlockPool,
                                                    PoolExhaustedError,
                                                    PrefixCache)
from deeplearning4j_tpu_torch.serving.quantize import (INT8_LOGIT_TOL,
                                                       QuantizedParams)
from deeplearning4j_tpu_torch.serving.resilience import (
    BrownoutController, BrownoutShedError, CircuitBreaker, CircuitOpenError,
    FleetUnavailableError, ModelLoadError, ReloadRejectedError,
    SchedulerStoppedError, WorkerCrashedError, WorkerProxyError)
from deeplearning4j_tpu_torch.serving.router import (ModelRouter,
                                                     UnknownModelError,
                                                     current_status)
from deeplearning4j_tpu_torch.serving.scheduler import (
    BatchScheduler, DeadlineExceededError, FlightRecorder, QueueFullError,
    SchedulerDrainingError, ShedError, new_request_id, trace_sample_rate)
from deeplearning4j_tpu_torch.serving.server import ModelServer

__all__ = [
    "BatchScheduler",
    "BlockPool",
    "BrownoutController",
    "BrownoutShedError",
    "CircuitBreaker",
    "CircuitOpenError",
    "DeadlineExceededError",
    "FleetRouter",
    "FleetUnavailableError",
    "FleetWorker",
    "FlightRecorder",
    "Generator",
    "INT8_LOGIT_TOL",
    "ModelLoadError",
    "ModelRouter",
    "ModelServer",
    "PoolExhaustedError",
    "PrefixCache",
    "QuantizedParams",
    "QueueFullError",
    "ReloadRejectedError",
    "SchedulerDrainingError",
    "SchedulerStoppedError",
    "ServingModel",
    "ShedError",
    "UnknownModelError",
    "WorkerCrashedError",
    "WorkerProxyError",
    "affinity_key",
    "current_status",
    "fleet_spec",
    "new_request_id",
    "rendezvous_pick",
    "trace_sample_rate",
]
