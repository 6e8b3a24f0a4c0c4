"""Activation functions by DL4J name (counterpart of
deeplearning4j_tpu/nn/activations.py; the name table is the reference's).

Each name maps to a registered op. Names whose op the port has not
registered yet raise ``OpNotFoundError`` when resolved.
"""

from __future__ import annotations

from typing import Callable, Union

from deeplearning4j_tpu_torch.ops import registry

# name -> op-table name (DL4J enum value -> op)
_ACTIVATIONS = {
    "identity": "identity",
    "relu": "relu",
    "relu6": "relu6",
    "leakyrelu": "leakyrelu",
    "tanh": "tanh",
    "sigmoid": "sigmoid",
    "softmax": "softmax",
    "logsoftmax": "log_softmax",
    "elu": "elu",
    "selu": "selu",
    "gelu": "gelu",
    "swish": "swish",
    "mish": "mish",
    "softplus": "softplus",
    "softsign": "softsign",
    "hardsigmoid": "hard_sigmoid",
    "hardtanh": "hard_tanh",
    "cube": "cube",
    "rationaltanh": "rationaltanh",
    "rectifiedtanh": "rectifiedtanh",
    "thresholdedrelu": "thresholdrelu",
}


def resolve(activation: Union[str, Callable, None]) -> Callable:
    """Accept a DL4J-style name ('relu'), an op name, or a callable."""
    if activation is None:
        return lambda x: x
    if callable(activation):
        return activation
    key = activation.lower()
    return registry.get_op(_ACTIVATIONS.get(key, key)).fn


def available() -> list:
    return sorted(_ACTIVATIONS)
