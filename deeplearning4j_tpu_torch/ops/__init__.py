"""Ops of the port: the registry, the ``ops/nn.py``, ``ops/attention.py``
and ``ops/random.py`` ops on the ported paths (counterpart of
deeplearning4j_tpu/ops)."""

from deeplearning4j_tpu_torch.ops import (  # noqa: F401  (registers the ops)
    attention, nn, random)
from deeplearning4j_tpu_torch.ops.registry import (exec_op, get_op, has_op,
                                                   list_ops)

__all__ = ["attention", "exec_op", "get_op", "has_op", "list_ops", "nn",
           "random"]
