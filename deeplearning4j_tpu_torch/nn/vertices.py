"""Graph vertices (counterpart of deeplearning4j_tpu/nn/vertices.py): the
parameter-free DAG combinators of ComputationGraph: the element-wise
combine of ResNet-50's residual adds, and the two recurrent vertices.
Shapes exclude the batch dim; CNN format NHWC.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

_VERTEX_TYPES: Dict[str, type] = {}


def register_vertex(cls):
    _VERTEX_TYPES[cls.__name__] = cls
    return cls


def vertex_from_dict(d: dict) -> "GraphVertex":
    d = dict(d)
    kind = d.pop("@vertex")
    cls = _VERTEX_TYPES.get(kind)
    if cls is None:
        raise KeyError(f"vertex type {kind!r} is not ported yet; ported: "
                       f"{sorted(_VERTEX_TYPES)}")
    for k, v in list(d.items()):
        if isinstance(v, list):
            d[k] = tuple(tuple(x) if isinstance(x, list) else x for x in v)
    return cls(**d)


@dataclasses.dataclass(frozen=True)
class GraphVertex:
    """Parameter-free DAG node taking >= 1 input activations."""

    def apply(self, *inputs):
        raise NotImplementedError

    def output_shape(self, *input_shapes) -> Tuple[int, ...]:
        raise NotImplementedError

    def to_dict(self) -> dict:
        d = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        d["@vertex"] = type(self).__name__
        return d


@register_vertex
@dataclasses.dataclass(frozen=True)
class ElementWiseVertex(GraphVertex):
    """Pointwise combine (conf/graph/ElementWiseVertex.java).
    op: add | subtract | product | average | max | min."""

    op: str = "add"

    def apply(self, *inputs):
        o = self.op.lower()
        out = inputs[0]
        if o == "add":
            for x in inputs[1:]:
                out = out + x
            return out
        if o == "subtract":
            if len(inputs) != 2:
                raise ValueError("subtract requires exactly 2 inputs")
            return inputs[0] - inputs[1]
        if o == "product":
            for x in inputs[1:]:
                out = out * x
            return out
        if o in ("average", "avg"):
            for x in inputs[1:]:
                out = out + x
            return out / len(inputs)
        if o == "max":
            for x in inputs[1:]:
                out = torch.maximum(out, x)
            return out
        if o == "min":
            for x in inputs[1:]:
                out = torch.minimum(out, x)
            return out
        raise ValueError(f"unknown ElementWiseVertex op {self.op}")

    def output_shape(self, *input_shapes):
        return tuple(input_shapes[0])


@register_vertex
@dataclasses.dataclass(frozen=True)
class LastTimeStepVertex(GraphVertex):
    """(B, T, C) -> (B, C), the last step (conf/graph/rnn/
    LastTimeStepVertex.java; reference ``nn/vertices.py:279``). It sees no
    mask: the masked form is the LastTimeStep layer."""

    def apply(self, *inputs):
        (x,) = inputs
        return x[:, -1]

    def output_shape(self, *input_shapes):
        _, c = input_shapes[0]
        return (c,)


@register_vertex
@dataclasses.dataclass(frozen=True)
class DuplicateToTimeSeriesVertex(GraphVertex):
    """(B, C) repeated along a sequence's time axis -> (B, T, C)
    (conf/graph/rnn/DuplicateToTimeSeriesVertex.java; reference ``:295``).
    Inputs (static, sequence): T is the second input's."""

    def apply(self, *inputs):
        x, seq = inputs
        return x[:, None, :].expand(x.shape[0], seq.shape[1], x.shape[1])

    def output_shape(self, *input_shapes):
        (c,), (t, _) = input_shapes[0], input_shapes[1]
        return (t, c)
