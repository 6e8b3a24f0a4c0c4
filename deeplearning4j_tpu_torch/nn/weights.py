"""Weight initialization by DL4J ``WeightInit`` name (counterpart of
deeplearning4j_tpu/nn/weights.py), the schemes ResNet-50's layers use:
``relu`` (He normal, the ConvolutionLayer default) and ``xavier`` (Glorot
normal, the Dense/Output default), with the reference's fan conventions
(for a conv, fan_in = kH*kW*Cin and fan_out = kH*kW*Cout), and ``normal``
(unit normal over sqrt(fan_in): GravesLSTM's peepholes). The other
schemes come with the slices whose layers use them.

Draws come from a ``torch.Generator`` on the CPU, so a seed gives the same
weights whatever device they are moved to. They are not the reference's
numbers (``jax.random`` and torch generators never agree); parity tests
copy the reference's initialized params across (``interop.py``).
"""

from __future__ import annotations

import math

import torch


def _fans(shape):
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[:-2])
    return receptive * shape[-2], receptive * shape[-1]


def init(gen: torch.Generator, name: str, shape,
         dtype=torch.float32) -> torch.Tensor:
    """A CPU tensor initialized per the named scheme (case-insensitive)."""
    name = name.lower()
    shape = tuple(int(s) for s in shape)
    fan_in, fan_out = _fans(shape)
    if name in ("relu", "he", "he_normal"):
        std = math.sqrt(2.0 / fan_in)
    elif name in ("xavier", "glorot_normal"):
        std = math.sqrt(2.0 / (fan_in + fan_out))
    elif name in ("normal", "distribution"):
        std = 1.0 / math.sqrt(fan_in)
    else:
        raise ValueError(f"weight init {name!r} is not ported yet "
                         "(ported: relu, xavier, normal)")
    return torch.randn(shape, generator=gen, dtype=dtype) * std
