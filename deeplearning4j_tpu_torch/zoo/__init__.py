"""Zoo models of the port (counterpart of deeplearning4j_tpu/zoo)."""

from deeplearning4j_tpu_torch.zoo.models import ResNet50, ZooModel

__all__ = ["ResNet50", "ZooModel"]
