"""Multi-model routing (counterpart of deeplearning4j_tpu/serving/router.py):
model-id -> (ServingModel, BatchScheduler). Every model gets its own
scheduler — queue, lanes, admission limit, worker thread — so one model's
flood sheds in its own queue.

``load`` restores a ModelSerializer archive and registers it; ``reload``
swaps a registered model's weights for an archive's: restored into a
shadow, warmed, checked with a canary batch, then swapped between batch
cycles, the model's ``version`` advancing. A corrupt or truncated archive
raises :class:`ModelLoadError` and registers nothing (``load``) or leaves
the old version serving (``reload``); a topology change, a failed warmup
or a non-finite canary raises :class:`ReloadRejectedError` and leaves it
serving too. Archives restore onto the device given at construction (the
card unless the caller names another).

``load(quantize="int8")`` serves weight-only int8 (an int8 archive's own
quantization, bit for bit; an fp32 archive quantized at load), and
``load(draft_path=)`` restores a draft net from its own archive for a
generate model's speculative decoding.

Not ported yet (ROADMAP Queue 1 item 11b): archive watching (``watch``),
drain, brownout, metrics collection and the flight snapshot.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

from deeplearning4j_tpu_torch.serving.model import ServingModel
from deeplearning4j_tpu_torch.serving.resilience import (ModelLoadError,
                                                         ReloadRejectedError)
from deeplearning4j_tpu_torch.serving.scheduler import BatchScheduler

_ITEM_11B = "ROADMAP.md Queue 1 item 11b (resilience and fleet)"


#: load() keywords that configure the ServingModel, not the scheduler
_MODEL_KW = ("bucketing", "max_length", "prefill_buckets", "paged",
             "block_size", "pool_blocks", "prefix_cache", "prefill_chunk",
             "spec_tokens")


class UnknownModelError(KeyError):
    """No such model-id (HTTP 404)."""

    http_status = 404


class ModelRouter:
    """model-id -> (ServingModel, BatchScheduler) registry."""

    def __init__(self, device=None):
        self._lock = threading.Lock()
        self._models: Dict[str, Tuple[ServingModel, BatchScheduler]] = {}
        self._reload_locks: Dict[str, threading.Lock] = {}
        #: where restored archives go (None: the card)
        self.device = device

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
            self._reload_locks[model.model_id] = threading.Lock()
        if start:
            sched.start()
        return sched

    # ----------------------------------------------------------- archives
    def _restore_archive(self, path: str, what: str):
        from deeplearning4j_tpu_torch.util.model_serializer import \
            ModelSerializer

        try:
            return ModelSerializer.restore_model(path, load_updater=False,
                                                 device=self.device)
        except Exception as e:  # noqa: BLE001 - one typed error out
            raise ModelLoadError(f"{what}: archive {path!r} failed to load "
                                 f"({type(e).__name__}: {e})") from e

    def load(self, model_id: str, path: str, *, kind: str = "classify",
             quantize: Optional[str] = None,
             draft_path: Optional[str] = None, **kw) -> BatchScheduler:
        """Restore a ModelSerializer archive and register it under
        ``model_id`` (reference ``:102-127``); ``kw`` goes to
        :meth:`register` (scheduler knobs) or to :class:`ServingModel`
        (bucketing and the decode engine's knobs). ``quantize="int8"``
        serves weight-only int8; ``draft_path`` restores the draft net of
        a generate model's speculative decoding. A corrupt archive raises
        :class:`ModelLoadError` and registers nothing."""
        net = self._restore_archive(path, f"load {model_id!r}")
        model_kw = {k: kw.pop(k) for k in _MODEL_KW if k in kw}
        if draft_path is not None:
            model_kw["draft_net"] = self._restore_archive(
                draft_path, f"load {model_id!r} draft")
        return self.register(ServingModel(net, model_id, kind=kind,
                                          quantize=quantize, **model_kw),
                             **kw)

    def reload(self, model_id: str, path: str, *, canary=None) -> int:
        """Rolling weight reload (see the module doc); returns the new
        version."""
        model, _ = self.get(model_id)
        with self._reload_locks[model_id]:
            new_net = self._restore_archive(path, f"reload {model_id!r}")
            if not model.structure_matches(new_net):
                raise ReloadRejectedError(
                    f"reload {model_id!r}: archive {path!r} holds a "
                    "different topology; the live version keeps serving")
            try:
                shadow = model.clone_with_net(new_net)
                shadow.warmup()
            except Exception as e:  # noqa: BLE001 - reload must not crash
                raise ReloadRejectedError(
                    f"reload {model_id!r}: shadow warmup failed "
                    f"({type(e).__name__}: {e}); the live version keeps "
                    "serving") from e
            ok, detail = shadow.canary_check(canary)
            if not ok:
                raise ReloadRejectedError(
                    f"reload {model_id!r}: canary rejected the new weights "
                    f"({detail}); the live version keeps serving")
            return model.swap_from(shadow)

    def watch(self, model_id: str, path: str, interval_s: float = 1.0):
        raise NotImplementedError(
            f"watch (archive following) is not ported: {_ITEM_11B}")

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
               deadline_ms: Optional[float] = None, **opts):
        """Route one request (and its options) to its model's scheduler;
        returns a Future."""
        _model, sched = self.get(model_id)
        return sched.submit(payload, lane=lane, deadline_ms=deadline_ms,
                            **opts)

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
