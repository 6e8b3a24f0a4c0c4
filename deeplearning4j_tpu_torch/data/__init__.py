"""Data utilities of the port (counterpart of deeplearning4j_tpu/data): the
DataSet, bucketing, the iterators, the normalizers, the prefetching
iterator that stages batches on the card (``prefetch.py``) and the native
image iterator (``image_iterator.py``)."""

from deeplearning4j_tpu_torch.data.bucketing import BucketingPolicy
from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.data.image_iterator import \
    AsyncImageDataSetIterator
from deeplearning4j_tpu_torch.data.iterators import (ArrayDataSetIterator,
                                                     DataSetIterator,
                                                     MnistDataSetIterator)
from deeplearning4j_tpu_torch.data.normalizers import (
    DataNormalization, ImagePreProcessingScaler, NormalizerMinMaxScaler,
    NormalizerStandardize, normalizer_from_dict)
from deeplearning4j_tpu_torch.data.prefetch import (AsyncDataSetIterator,
                                                    PrefetchStalledError)

__all__ = ["ArrayDataSetIterator", "AsyncDataSetIterator",
           "AsyncImageDataSetIterator", "BucketingPolicy", "DataNormalization",
           "DataSet", "DataSetIterator", "ImagePreProcessingScaler",
           "MnistDataSetIterator", "MultiDataSet", "NormalizerMinMaxScaler",
           "NormalizerStandardize", "PrefetchStalledError",
           "normalizer_from_dict"]
