"""Networks of the port (counterpart of deeplearning4j_tpu/nn)."""

from deeplearning4j_tpu_torch.nn import (  # noqa: F401  (register their layers)
    attention, recurrent, transfer, transformer)
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
