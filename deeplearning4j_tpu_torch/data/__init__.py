"""Data utilities of the port (counterpart of deeplearning4j_tpu/data)."""

from deeplearning4j_tpu_torch.data.bucketing import BucketingPolicy
from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet

__all__ = ["BucketingPolicy", "DataSet", "MultiDataSet"]
