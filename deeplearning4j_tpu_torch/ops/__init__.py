"""Ops of the port: the registry and the ``ops/nn.py`` ops on the ported
paths (counterpart of deeplearning4j_tpu/ops)."""

from deeplearning4j_tpu_torch.ops import nn  # noqa: F401  (registers the ops)
from deeplearning4j_tpu_torch.ops.registry import (exec_op, get_op, has_op,
                                                   list_ops)

__all__ = ["exec_op", "get_op", "has_op", "list_ops", "nn"]
