"""Serving tier of the port (counterpart of deeplearning4j_tpu/serving):
ModelServer -> ModelRouter -> BatchScheduler -> ServingModel (classify)."""

from deeplearning4j_tpu_torch.serving.model import ServingModel
from deeplearning4j_tpu_torch.serving.resilience import (ModelLoadError,
                                                         ReloadRejectedError)
from deeplearning4j_tpu_torch.serving.router import (ModelRouter,
                                                     UnknownModelError)
from deeplearning4j_tpu_torch.serving.scheduler import (BatchScheduler,
                                                        DeadlineExceededError,
                                                        QueueFullError,
                                                        SchedulerStoppedError,
                                                        ShedError)
from deeplearning4j_tpu_torch.serving.server import ModelServer

__all__ = ["BatchScheduler", "DeadlineExceededError", "ModelLoadError",
           "ModelRouter", "ModelServer", "QueueFullError",
           "ReloadRejectedError", "SchedulerStoppedError",
           "ServingModel", "ShedError", "UnknownModelError"]
