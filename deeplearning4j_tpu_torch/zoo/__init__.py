"""Zoo models of the port (counterpart of deeplearning4j_tpu/zoo)."""

from deeplearning4j_tpu_torch.zoo.bert import Bert
from deeplearning4j_tpu_torch.zoo.models import (LeNet, ResNet50,
                                                 TextGenerationLSTM, ZooModel)

__all__ = ["Bert", "LeNet", "ResNet50", "TextGenerationLSTM", "ZooModel"]
