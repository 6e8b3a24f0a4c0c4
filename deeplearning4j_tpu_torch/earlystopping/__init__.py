"""Early stopping (counterpart of deeplearning4j_tpu/earlystopping;
org/deeplearning4j/earlystopping/**): the epoch and iteration termination
conditions, ``DataSetLossCalculator``, ``InMemoryModelSaver``, the
``EarlyStoppingConfiguration`` builder, and ``EarlyStoppingTrainer``, which
drives ``net.fit`` one epoch at a time, scores between epochs and returns
an ``EarlyStoppingResult`` with its ``TerminationReason``. It drives a
``MultiLayerNetwork`` or a ``ComputationGraph``.

Scores are the only values that come to the host. ``InMemoryModelSaver``
keeps its snapshots as CPU tensors (params, states and optimizer states
cloned, so the training that goes on in place leaves them as they were);
``get_best_model`` returns a network on the trained net's own device,
with no listeners. ``LocalFileModelSaver`` writes ``bestModel.zip`` and
``latestModel.zip`` ModelSerializer archives (``util/model_serializer.py``)
into a directory and restores the best one onto the trained net's device.
"""

from __future__ import annotations

import copy
import math
import os
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, List, Optional

import torch

from deeplearning4j_tpu_torch.nn.listeners import CoalescingListenerDispatcher


# ----------------------------------------------------------------- conditions
class EpochTerminationCondition:
    requires_score = False  # skip on epochs with no validation score

    def initialize(self): ...
    def terminate(self, epoch: int, score: float) -> bool: ...


class IterationTerminationCondition:
    def initialize(self): ...
    def terminate(self, score: float) -> bool: ...


class MaxEpochsTerminationCondition(EpochTerminationCondition):
    def __init__(self, max_epochs: int):
        self.max_epochs = max_epochs

    def terminate(self, epoch, score):
        return epoch >= self.max_epochs


class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    """Stop after ``max_epochs_without_improvement`` epochs with < min_improvement."""

    requires_score = True

    def __init__(self, max_epochs_without_improvement: int,
                 min_improvement: float = 0.0):
        self.patience = max_epochs_without_improvement
        self.min_improvement = min_improvement

    def initialize(self):
        self.best = math.inf
        self.since = 0

    def terminate(self, epoch, score):
        if self.best - score >= self.min_improvement:
            self.best = score
            self.since = 0
        else:
            self.since += 1
        return self.since > self.patience


class MaxTimeIterationTerminationCondition(IterationTerminationCondition):
    def __init__(self, max_seconds: float):
        self.max_seconds = max_seconds

    def initialize(self):
        self.start = time.monotonic()

    def terminate(self, score):
        return time.monotonic() - self.start > self.max_seconds


class MaxScoreIterationTerminationCondition(IterationTerminationCondition):
    def __init__(self, max_score: float):
        self.max_score = max_score

    def terminate(self, score):
        return score > self.max_score


class InvalidScoreIterationTerminationCondition(IterationTerminationCondition):
    def terminate(self, score):
        return math.isnan(score) or math.isinf(score)


# ------------------------------------------------------------------- scoring
class ScoreCalculator:
    def calculate_score(self, model) -> float: ...


class DataSetLossCalculator(ScoreCalculator):
    """Mean loss over a held-out iterator (DataSetLossCalculator parity)."""

    def __init__(self, iterator, average: bool = True):
        self.iterator = iterator
        self.average = average

    def calculate_score(self, model):
        if hasattr(self.iterator, "reset"):
            self.iterator.reset()
        total, n = 0.0, 0
        for ds in self.iterator:
            b = ds.features.shape[0] if hasattr(ds.features, "shape") else len(ds.features)
            total += model.score(ds) * b
            n += b
        return total / n if self.average and n else total


# -------------------------------------------------------------------- savers
def _map_tensors(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _with_state(model, fn):
    """A shallow copy of ``model`` whose params, states and optimizer
    states are ``fn`` of its own, with no listeners, an empty dispatch
    window, cast caches and program tables, and a dropout generator of its
    own at the same state."""
    snap = copy.copy(model)
    snap.params = _map_tensors(model.params, fn)
    snap.states = _map_tensors(model.states, fn)
    snap.opt_states = _map_tensors(model.opt_states, fn)
    snap.listeners = []
    snap._dispatcher = CoalescingListenerDispatcher(
        snap, model._dispatcher.sync_every)
    snap._cast_cache = {}
    snap._w_cache = {}
    snap._drop_programs()  # the model's read the model's own tensors
    if hasattr(model, "_rnn_carries"):
        snap._rnn_carries = None
    if model._gen is not None:
        snap._gen = torch.Generator(device=model.device)
        snap._gen.set_state(model._gen.get_state())
    return snap


def _host_snapshot(model):
    """The model with its tensors cloned to the CPU (reference ``:122``,
    which pulls them to host numpy): the updaters step the params in
    place, so a snapshot that shared them would follow the training."""
    return _with_state(model, lambda t: t.detach().to("cpu", copy=True))


class InMemoryModelSaver:
    def __init__(self):
        self.best = None
        self.latest = None

    def save_best_model(self, model, score):
        self.best = _host_snapshot(model)

    def save_latest_model(self, model, score):
        self.latest = _host_snapshot(model)

    def get_best_model(self):
        """The best snapshot as a network on its own device (a fresh copy
        each call), or None when none was saved."""
        if self.best is None:
            return None
        dev = self.best.device
        return _with_state(self.best, lambda t: t.to(dev, copy=True))


class LocalFileModelSaver:
    """The best and latest models as ModelSerializer archives in
    ``directory``; ``get_best_model`` restores the best onto the device of
    the net that was saved (None when none was saved)."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._device = None

    def _path(self, name):
        return os.path.join(self.directory, name)

    def _write(self, model, name):
        from deeplearning4j_tpu_torch.util.model_serializer import \
            ModelSerializer

        self._device = model.device
        ModelSerializer.write_model(model, self._path(name))

    def save_best_model(self, model, score):
        self._write(model, "bestModel.zip")

    def save_latest_model(self, model, score):
        self._write(model, "latestModel.zip")

    def get_best_model(self):
        from deeplearning4j_tpu_torch.util.model_serializer import \
            ModelSerializer

        path = self._path("bestModel.zip")
        if not os.path.exists(path):
            return None
        return ModelSerializer.restore_model(path, device=self._device)


# --------------------------------------------------------------------- config
@dataclass
class EarlyStoppingConfiguration:
    score_calculator: ScoreCalculator
    model_saver: Any = field(default_factory=InMemoryModelSaver)
    epoch_termination_conditions: List[EpochTerminationCondition] = field(
        default_factory=list
    )
    iteration_termination_conditions: List[IterationTerminationCondition] = field(
        default_factory=list
    )
    evaluate_every_n_epochs: int = 1
    save_last_model: bool = False

    class Builder:
        def __init__(self):
            self._score_calc = None
            self._saver = None
            self._epoch_conds = []
            self._iter_conds = []
            self._every_n = 1
            self._save_last = False

        def score_calculator(self, sc):
            self._score_calc = sc
            return self

        def model_saver(self, s):
            self._saver = s
            return self

        def epoch_termination_conditions(self, *conds):
            self._epoch_conds.extend(conds)
            return self

        def iteration_termination_conditions(self, *conds):
            self._iter_conds.extend(conds)
            return self

        def evaluate_every_n_epochs(self, n):
            self._every_n = n
            return self

        def save_last_model(self, b=True):
            self._save_last = b
            return self

        def build(self):
            return EarlyStoppingConfiguration(
                score_calculator=self._score_calc,
                model_saver=self._saver or InMemoryModelSaver(),
                epoch_termination_conditions=self._epoch_conds,
                iteration_termination_conditions=self._iter_conds,
                evaluate_every_n_epochs=self._every_n,
                save_last_model=self._save_last,
            )

    @staticmethod
    def builder():
        return EarlyStoppingConfiguration.Builder()


class TerminationReason(Enum):
    Error = "Error"
    IterationTerminationCondition = "IterationTerminationCondition"
    EpochTerminationCondition = "EpochTerminationCondition"


@dataclass
class EarlyStoppingResult:
    termination_reason: TerminationReason
    termination_details: str
    total_epochs: int
    best_model_epoch: int
    best_model_score: float
    score_vs_epoch: dict
    best_model: Any


# -------------------------------------------------------------------- trainer
class EarlyStoppingTrainer:
    """EarlyStoppingTrainer / EarlyStoppingGraphTrainer parity — drives
    net.fit one epoch at a time, scoring and checking conditions between."""

    def __init__(self, config: EarlyStoppingConfiguration, network, train_iterator):
        self.config = config
        self.net = network
        self.iterator = train_iterator

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        for c in cfg.epoch_termination_conditions:
            c.initialize()
        for c in cfg.iteration_termination_conditions:
            c.initialize()

        best_score, best_epoch = math.inf, -1
        scores: dict = {}
        epoch = 0
        reason, details = TerminationReason.EpochTerminationCondition, "max loop"

        class _IterGuard:
            """Listener checking iteration conditions during the epoch."""

            def __init__(self):
                self.tripped: Optional[str] = None

            def iteration_done(self, model, iteration, ep):
                if self.tripped:
                    return
                score = model.get_score()
                for c in cfg.iteration_termination_conditions:
                    if c.terminate(score):
                        self.tripped = type(c).__name__
                        raise _IterStop(self.tripped)

            def on_epoch_end(self, model):
                pass

        class _IterStop(Exception):
            pass

        saved_listeners = list(getattr(self.net, "listeners", []))
        if cfg.iteration_termination_conditions:
            # only install the guard when needed — get_score() forces a
            # device→host sync per iteration
            self.net.set_listeners(*saved_listeners, _IterGuard())
        try:
            while True:
                try:
                    if hasattr(self.iterator, "reset"):
                        self.iterator.reset()
                    self.net.fit(self.iterator, epochs=1)
                except _IterStop as e:
                    reason = TerminationReason.IterationTerminationCondition
                    details = str(e)
                    break
                epoch += 1
                if epoch % cfg.evaluate_every_n_epochs == 0:
                    score = cfg.score_calculator.calculate_score(self.net)
                    scores[epoch] = score
                    if score < best_score:
                        best_score, best_epoch = score, epoch
                        cfg.model_saver.save_best_model(self.net, score)
                if cfg.save_last_model:  # every epoch, eval or not
                    cfg.model_saver.save_latest_model(self.net, scores.get(epoch))
                stop = False
                for c in cfg.epoch_termination_conditions:
                    if c.requires_score and epoch not in scores:
                        continue  # no validation ran this epoch
                    if c.terminate(epoch, scores.get(epoch, math.inf)):
                        reason = TerminationReason.EpochTerminationCondition
                        details = type(c).__name__
                        stop = True
                        break
                if stop:
                    break
        finally:
            self.net.set_listeners(*saved_listeners)

        return EarlyStoppingResult(
            termination_reason=reason,
            termination_details=details,
            total_epochs=epoch,
            best_model_epoch=best_epoch,
            best_model_score=best_score,
            score_vs_epoch=scores,
            best_model=cfg.model_saver.get_best_model(),
        )


EarlyStoppingGraphTrainer = EarlyStoppingTrainer
