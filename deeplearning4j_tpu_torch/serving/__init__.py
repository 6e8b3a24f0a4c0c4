"""Serving tier of the port (counterpart of deeplearning4j_tpu/serving):
ModelServer -> ModelRouter -> BatchScheduler -> ServingModel, classify
(fp32 or int8) and generate (the paged-KV decode tier of
``serving/generate.py``).

    from deeplearning4j_tpu_torch.serving import (ModelRouter, ModelServer,
                                                  ServingModel)

    router = ModelRouter()
    router.register(ServingModel(net, "lenet"))
    router.load("lm", "/models/lm.zip", kind="generate")
    server = ModelServer(router, port=8080).start()  # warms the programs

Resilience beyond the errors and the fleet are ROADMAP Queue 1 item 11b.
"""

from deeplearning4j_tpu_torch.serving.generate import Generator
from deeplearning4j_tpu_torch.serving.model import ServingModel
from deeplearning4j_tpu_torch.serving.paged import (BlockPool,
                                                    PoolExhaustedError,
                                                    PrefixCache)
from deeplearning4j_tpu_torch.serving.quantize import (INT8_LOGIT_TOL,
                                                       QuantizedParams)
from deeplearning4j_tpu_torch.serving.resilience import (
    BrownoutShedError, CircuitOpenError, FleetUnavailableError,
    ModelLoadError, ReloadRejectedError, SchedulerDrainingError,
    SchedulerStoppedError, WorkerCrashedError, WorkerProxyError)
from deeplearning4j_tpu_torch.serving.router import (ModelRouter,
                                                     UnknownModelError)
from deeplearning4j_tpu_torch.serving.scheduler import (BatchScheduler,
                                                        DeadlineExceededError,
                                                        QueueFullError,
                                                        ShedError)
from deeplearning4j_tpu_torch.serving.server import ModelServer

__all__ = [
    "BatchScheduler",
    "BlockPool",
    "BrownoutShedError",
    "CircuitOpenError",
    "DeadlineExceededError",
    "FleetUnavailableError",
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
]
