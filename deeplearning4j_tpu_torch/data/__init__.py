"""Data utilities of the port (counterpart of deeplearning4j_tpu/data)."""

from deeplearning4j_tpu_torch.data.bucketing import BucketingPolicy

__all__ = ["BucketingPolicy"]
