"""Zoo models of the port (counterpart of deeplearning4j_tpu/zoo)."""

from deeplearning4j_tpu_torch.zoo.bert import Bert
from deeplearning4j_tpu_torch.zoo.models import (AlexNet, Darknet19,
                                                 FaceNetNN4Small2,
                                                 InceptionResNetV1, LeNet,
                                                 ResNet50, SimpleCNN,
                                                 SqueezeNet,
                                                 TextGenerationLSTM, VGG16,
                                                 VGG19, Xception, ZooModel)

__all__ = ["AlexNet", "Bert", "Darknet19", "FaceNetNN4Small2",
           "InceptionResNetV1", "LeNet", "ResNet50", "SimpleCNN",
           "SqueezeNet", "TextGenerationLSTM", "VGG16", "VGG19", "Xception",
           "ZooModel"]
