"""Learning-rate schedules (counterpart of deeplearning4j_tpu/nn/schedules.py,
ND4J's ``ISchedule`` implementations).

A schedule is a function of the host's iteration counter (and epoch) that
returns the learning rate as a Python float; the port's train step is eager,
so the value is computed once per step on the host. The dataclasses and
their JSON dicts (``{"@schedule": "StepSchedule", ...}``) are the
reference's, field for field, so an updater whose ``learning_rate`` is a
schedule dict moves between the two packages unchanged.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict


class Schedule:
    """ISchedule parity: value(iteration, epoch) -> lr."""

    def __call__(self, iteration, epoch=0):
        raise NotImplementedError

    def to_dict(self):
        d = dataclasses.asdict(self)
        d["@schedule"] = type(self).__name__
        return d


_SCHEDULES: Dict[str, type] = {}


def _register(cls):
    _SCHEDULES[cls.__name__] = cls
    return cls


def schedule_from_dict(d):
    d = dict(d)
    name = d.pop("@schedule")
    cls = _SCHEDULES[name]
    if name == "MapSchedule":
        d["values"] = {int(k): v for k, v in d["values"].items()}
    return cls(**d)


@_register
@dataclasses.dataclass(frozen=True)
class FixedSchedule(Schedule):
    value: float

    def __call__(self, iteration, epoch=0):
        return self.value


@_register
@dataclasses.dataclass(frozen=True)
class StepSchedule(Schedule):
    """lr = initial * decay_rate ^ floor(iter / step)."""

    initial_value: float
    decay_rate: float
    step: int

    def __call__(self, iteration, epoch=0):
        return self.initial_value * self.decay_rate ** math.floor(
            iteration / self.step)


@_register
@dataclasses.dataclass(frozen=True)
class ExponentialSchedule(Schedule):
    """lr = initial * gamma ^ iter."""

    initial_value: float
    gamma: float

    def __call__(self, iteration, epoch=0):
        return self.initial_value * self.gamma ** iteration


@_register
@dataclasses.dataclass(frozen=True)
class InverseSchedule(Schedule):
    """lr = initial / (1 + gamma * iter) ^ power."""

    initial_value: float
    gamma: float
    power: float

    def __call__(self, iteration, epoch=0):
        return self.initial_value / (1.0 + self.gamma * iteration) ** self.power


@_register
@dataclasses.dataclass(frozen=True)
class PolySchedule(Schedule):
    """lr = initial * (1 - iter/max_iter) ^ power."""

    initial_value: float
    power: float
    max_iter: int

    def __call__(self, iteration, epoch=0):
        frac = min(max(iteration / self.max_iter, 0.0), 1.0)
        return self.initial_value * (1.0 - frac) ** self.power


@_register
@dataclasses.dataclass(frozen=True)
class SigmoidSchedule(Schedule):
    """lr = initial / (1 + exp(-gamma * (iter - step_size)))."""

    initial_value: float
    gamma: float
    step_size: int

    def __call__(self, iteration, epoch=0):
        return self.initial_value / (
            1.0 + math.exp(-self.gamma * (iteration - self.step_size)))


@_register
@dataclasses.dataclass(frozen=True)
class WarmupCosineSchedule(Schedule):
    """Linear warmup then cosine decay (the reference's addition for its
    transformer configs)."""

    peak_value: float
    warmup_steps: int
    total_steps: int
    end_value: float = 0.0

    def __call__(self, iteration, epoch=0):
        it = float(iteration)
        if it < self.warmup_steps:
            return self.peak_value * it / max(self.warmup_steps, 1)
        frac = min(max((it - self.warmup_steps)
                       / max(self.total_steps - self.warmup_steps, 1), 0.0),
                   1.0)
        return self.end_value + 0.5 * (self.peak_value - self.end_value) * (
            1 + math.cos(math.pi * frac))


@_register
@dataclasses.dataclass(frozen=True)
class MapSchedule(Schedule):
    """Piecewise-constant from {iteration: lr}; holds the last value."""

    values: dict  # {int: float}

    def __call__(self, iteration, epoch=0):
        keys = sorted(self.values)
        lr = self.values[keys[0]]
        for k in keys[1:]:
            if iteration >= k:
                lr = self.values[k]
        return lr

    def to_dict(self):
        return {"@schedule": "MapSchedule",
                "values": {str(k): v for k, v in self.values.items()}}


def resolve(lr_or_schedule) -> Schedule:
    if isinstance(lr_or_schedule, Schedule):
        return lr_or_schedule
    return FixedSchedule(float(lr_or_schedule))
