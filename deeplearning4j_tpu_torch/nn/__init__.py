"""Networks of the port (counterpart of deeplearning4j_tpu/nn)."""

from deeplearning4j_tpu_torch.nn.computation_graph import (
    ComputationGraph, ComputationGraphConfiguration, GraphBuilder)
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration

__all__ = ["ComputationGraph", "ComputationGraphConfiguration",
           "GraphBuilder", "InputType", "NeuralNetConfiguration"]
