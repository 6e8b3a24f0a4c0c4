"""SameDiff, the define-by-graph API (counterpart of
deeplearning4j_tpu/samediff/__init__.py; SameDiff.java, SDVariable.java and
the namespaced op factories).

A recorded graph runs through the port's op table, one captured program
per (outputs, feed shapes) signature for ``output``, ``calculate_gradients``
and the ``fit`` step (``core.py`` says when a graph runs eagerly instead);
reverse-mode autodiff is autograd over the recorded nodes.
"""

from deeplearning4j_tpu_torch.samediff.core import (
    SameDiff,
    SDVariable,
    TrainingConfig,
    VariableType,
)

__all__ = ["SameDiff", "SDVariable", "TrainingConfig", "VariableType"]
