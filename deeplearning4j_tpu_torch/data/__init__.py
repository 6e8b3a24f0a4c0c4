"""Data utilities of the port (counterpart of deeplearning4j_tpu/data): the
DataSet, bucketing, the iterators and the normalizers."""

from deeplearning4j_tpu_torch.data.bucketing import BucketingPolicy
from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.data.iterators import (ArrayDataSetIterator,
                                                     DataSetIterator,
                                                     MnistDataSetIterator)
from deeplearning4j_tpu_torch.data.normalizers import (
    DataNormalization, ImagePreProcessingScaler, NormalizerMinMaxScaler,
    NormalizerStandardize, normalizer_from_dict)

__all__ = ["ArrayDataSetIterator", "BucketingPolicy", "DataNormalization",
           "DataSet", "DataSetIterator", "ImagePreProcessingScaler",
           "MnistDataSetIterator", "MultiDataSet", "NormalizerMinMaxScaler",
           "NormalizerStandardize", "normalizer_from_dict"]
