"""Networks of the port (counterpart of deeplearning4j_tpu/nn)."""

from deeplearning4j_tpu_torch.nn import transformer  # noqa: F401  (registers its layers)
from deeplearning4j_tpu_torch.nn.computation_graph import (
    ComputationGraph, ComputationGraphConfiguration, GraphBuilder)
from deeplearning4j_tpu_torch.nn.conf import (InputType, ListBuilder,
                                              MultiLayerConfiguration,
                                              NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

__all__ = ["ComputationGraph", "ComputationGraphConfiguration",
           "GraphBuilder", "InputType", "ListBuilder",
           "MultiLayerConfiguration", "MultiLayerNetwork",
           "NeuralNetConfiguration"]
