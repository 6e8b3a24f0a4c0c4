"""Graph vertices (counterpart of deeplearning4j_tpu/nn/vertices.py): the
parameter-free DAG combinators of ComputationGraph, all of the reference's
but FrozenVertex (ROADMAP Queue 1 item 13). Shapes exclude the batch dim;
CNN format NHWC. ``axis`` fields index the batched tensor (axis 0 is the
batch); ``output_shape`` converts them (:func:`_shape_axis`), so axis -1
is NHWC's channel axis.
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


def _shape_axis(axis: int) -> int:
    """A batched-tensor axis as the axis of a batch-excluded shape tuple
    (reference ``:61``)."""
    if axis == 0:
        raise ValueError("vertex axis 0 is the batch axis")
    return axis - 1 if axis > 0 else axis


@register_vertex
@dataclasses.dataclass(frozen=True)
class MergeVertex(GraphVertex):
    """Concatenation along ``axis`` (conf/graph/MergeVertex.java, reference
    ``:70``); -1 is NHWC's channel axis, as the reference's NCHW dim 1."""

    axis: int = -1

    def apply(self, *inputs):
        return torch.cat(inputs, dim=self.axis)

    def output_shape(self, *input_shapes):
        base = list(input_shapes[0])
        ax = _shape_axis(self.axis)
        base[ax] = sum(s[ax] for s in input_shapes)
        return tuple(base)


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


@register_vertex
@dataclasses.dataclass(frozen=True)
class SubsetVertex(GraphVertex):
    """The slice [from_idx, to_idx], both included, along ``axis``
    (conf/graph/SubsetVertex.java, reference ``:134``)."""

    from_idx: int = 0
    to_idx: int = 0
    axis: int = -1

    def apply(self, *inputs):
        (x,) = inputs
        return x.narrow(self.axis % x.dim(), self.from_idx,
                        self.to_idx - self.from_idx + 1)

    def output_shape(self, *input_shapes):
        base = list(input_shapes[0])
        base[_shape_axis(self.axis)] = self.to_idx - self.from_idx + 1
        return tuple(base)


@register_vertex
@dataclasses.dataclass(frozen=True)
class ScaleVertex(GraphVertex):
    """x * scale (conf/graph/ScaleVertex.java, reference ``:156``)."""

    scale: float = 1.0

    def apply(self, *inputs):
        return inputs[0] * self.scale

    def output_shape(self, *input_shapes):
        return tuple(input_shapes[0])


@register_vertex
@dataclasses.dataclass(frozen=True)
class ShiftVertex(GraphVertex):
    """x + shift (conf/graph/ShiftVertex.java, reference ``:170``)."""

    shift: float = 0.0

    def apply(self, *inputs):
        return inputs[0] + self.shift

    def output_shape(self, *input_shapes):
        return tuple(input_shapes[0])


@register_vertex
@dataclasses.dataclass(frozen=True)
class L2NormalizeVertex(GraphVertex):
    """x / (||x||_2 + eps), the norm over every non-batch axis
    (conf/graph/L2NormalizeVertex.java, reference ``:184``; eps is added
    after the square root)."""

    eps: float = 1e-8

    def apply(self, *inputs):
        (x,) = inputs
        dims = tuple(range(1, x.dim()))
        norm = torch.sqrt((x * x).sum(dim=dims, keepdim=True))
        return x / (norm + self.eps)

    def output_shape(self, *input_shapes):
        return tuple(input_shapes[0])


@register_vertex
@dataclasses.dataclass(frozen=True)
class StackVertex(GraphVertex):
    """Concatenation along the batch axis (conf/graph/StackVertex.java,
    reference ``:201``): one subnet over several inputs."""

    def apply(self, *inputs):
        return torch.cat(inputs, dim=0)

    def output_shape(self, *input_shapes):
        return tuple(input_shapes[0])


@register_vertex
@dataclasses.dataclass(frozen=True)
class UnstackVertex(GraphVertex):
    """Chunk ``index`` of ``num_stacked`` equal batch chunks
    (conf/graph/UnstackVertex.java, reference ``:214``), StackVertex's
    inverse."""

    index: int = 0
    num_stacked: int = 1

    def apply(self, *inputs):
        (x,) = inputs
        step = x.shape[0] // self.num_stacked
        return x[self.index * step:(self.index + 1) * step]

    def output_shape(self, *input_shapes):
        return tuple(input_shapes[0])


@register_vertex
@dataclasses.dataclass(frozen=True)
class ReshapeVertex(GraphVertex):
    """Reshape of the non-batch axes to ``new_shape`` (conf/graph/
    ReshapeVertex.java, reference ``:232``)."""

    new_shape: tuple = ()

    def apply(self, *inputs):
        (x,) = inputs
        return x.reshape((x.shape[0],) + tuple(self.new_shape))

    def output_shape(self, *input_shapes):
        return tuple(self.new_shape)


@register_vertex
@dataclasses.dataclass(frozen=True)
class PoolHelperVertex(GraphVertex):
    """Drop the first row and column (conf/graph/PoolHelperVertex.java,
    reference ``:247``; GoogLeNet import)."""

    def apply(self, *inputs):
        (x,) = inputs
        return x[:, 1:, 1:, :]

    def output_shape(self, *input_shapes):
        h, w, c = input_shapes[0]
        return (h - 1, w - 1, c)


@register_vertex
@dataclasses.dataclass(frozen=True)
class L2Vertex(GraphVertex):
    """The L2 distance of two activations, (B, 1): sqrt(sum (a - b)^2 +
    eps) (conf/graph/L2Vertex.java, reference ``:262``)."""

    eps: float = 1e-8

    def apply(self, *inputs):
        a, b = inputs
        d = (a - b).reshape(a.shape[0], -1)
        return torch.sqrt((d * d).sum(dim=-1, keepdim=True) + self.eps)

    def output_shape(self, *input_shapes):
        return (1,)


@register_vertex
@dataclasses.dataclass(frozen=True)
class PreprocessorVertex(GraphVertex):
    """An InputPreProcessor as a vertex (conf/graph/PreprocessorVertex.java,
    reference ``:312``). ``mode``: "cnn_to_ff" (flatten), "ff_to_cnn"
    (reshape to ``shape`` (h, w, c)), "rnn_to_ff" (time into the batch),
    "ff_to_rnn" (back out, ``shape`` (t,))."""

    mode: str = "cnn_to_ff"
    shape: tuple = ()

    def apply(self, *inputs):
        (x,) = inputs
        if self.mode == "cnn_to_ff":
            return x.reshape(x.shape[0], -1)
        if self.mode == "ff_to_cnn":
            return x.reshape((x.shape[0],) + tuple(self.shape))
        if self.mode == "rnn_to_ff":
            return x.reshape(-1, x.shape[-1])
        if self.mode == "ff_to_rnn":
            (t,) = self.shape
            return x.reshape(-1, t, x.shape[-1])
        raise ValueError(f"unknown preprocessor mode {self.mode!r}")

    def output_shape(self, *input_shapes):
        s = input_shapes[0]
        if self.mode == "cnn_to_ff":
            n = 1
            for d in s:
                n *= d
            return (n,)
        if self.mode == "ff_to_cnn":
            return tuple(self.shape)
        if self.mode == "rnn_to_ff":
            return (s[-1],)
        if self.mode == "ff_to_rnn":
            return (self.shape[0], s[-1])
        raise ValueError(f"unknown preprocessor mode {self.mode!r}")
