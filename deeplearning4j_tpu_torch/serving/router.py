"""Multi-model routing (counterpart of deeplearning4j_tpu/serving/router.py):
model-id -> (ServingModel, BatchScheduler). Every model gets its own
scheduler — queue, lanes, admission limit, worker thread — so one model's
flood sheds in its own queue.

Not ported yet: archive loading (the serialization slice), rolling reload
and archive watching (the serving resilience slice), drain and brownout.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

from deeplearning4j_tpu_torch.serving.model import ServingModel
from deeplearning4j_tpu_torch.serving.scheduler import BatchScheduler


class UnknownModelError(KeyError):
    """No such model-id (HTTP 404)."""

    http_status = 404


class ModelRouter:
    """model-id -> (ServingModel, BatchScheduler) registry."""

    def __init__(self):
        self._lock = threading.Lock()
        self._models: Dict[str, Tuple[ServingModel, BatchScheduler]] = {}

    def register(self, model: ServingModel, *, max_wait_ms: float = 2.0,
                 max_batch: Optional[int] = None, queue_limit: int = 64,
                 start: bool = True) -> BatchScheduler:
        """Attach a model under its ``model_id`` with its own scheduler."""
        sched = BatchScheduler(model, max_wait_ms=max_wait_ms,
                               max_batch=max_batch, queue_limit=queue_limit)
        with self._lock:
            if model.model_id in self._models:
                raise ValueError(
                    f"model {model.model_id!r} already registered")
            self._models[model.model_id] = (model, sched)
        if start:
            sched.start()
        return sched

    def get(self, model_id: str) -> Tuple[ServingModel, BatchScheduler]:
        with self._lock:
            entry = self._models.get(model_id)
        if entry is None:
            raise UnknownModelError(model_id)
        return entry

    def model_ids(self):
        with self._lock:
            return list(self._models)

    def submit(self, model_id: str, payload, *, lane: str = "interactive",
               deadline_ms: Optional[float] = None):
        """Route one request to its model's scheduler; returns a Future."""
        _model, sched = self.get(model_id)
        return sched.submit(payload, lane=lane, deadline_ms=deadline_ms)

    def warmup(self) -> int:
        """Warm every registered model's buckets; returns the total run."""
        return sum(self.get(m)[0].warmup() for m in self.model_ids())

    def shutdown(self):
        for model_id in self.model_ids():
            self.get(model_id)[1].shutdown()

    def status(self) -> dict:
        out = {"models": {}}
        for model_id in self.model_ids():
            model, sched = self.get(model_id)
            out["models"][model_id] = {**model.describe(), **sched.stats()}
        return out
