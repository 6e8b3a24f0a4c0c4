"""Data normalizers (counterpart of deeplearning4j_tpu/data/normalizers.py;
DL4J's DataNormalization): ``fit`` over a DataSet or an iterator collects
the statistics, ``transform`` (and ``revert``) normalise a DataSet's
features in place, and ``to_dict``/:func:`normalizer_from_dict` keep the
reference's dict form, so a normalizer fitted in one package serves in
the other.

The statistics are small host numpy arrays and the transform stays in
numpy on the host side of the input pipeline, as in the reference: the
network moves the normalised batch to its device.
"""

from __future__ import annotations

import numpy as np


def _out_dtype(x):
    """Normalized output dtype: keep float inputs' dtype, but promote integer
    features (e.g. raw uint8 pixels) to float32 — casting standardized values
    back to uint8 would wrap negatives and truncate fractions."""
    return x.dtype if np.issubdtype(x.dtype, np.floating) else np.float32


class DataNormalization:
    """fit/transform/revert protocol (DataNormalization.java parity)."""

    def fit(self, data) -> "DataNormalization":
        """Accepts a DataSet or a DataSetIterator. Each call computes fresh
        statistics (re-fitting replaces, never accumulates — reference
        semantics)."""
        self._reset()
        if hasattr(data, "__iter__") and not hasattr(data, "features"):
            if hasattr(data, "reset"):
                data.reset()
            for ds in data:
                self._fit_partial(np.asarray(ds.features))
            self._finalize()
        else:
            self._fit_partial(np.asarray(data.features))
            self._finalize()
        return self

    def transform(self, ds):
        ds.features = self.normalize(np.asarray(ds.features))
        return ds

    def revert(self, ds):
        ds.features = self.denormalize(np.asarray(ds.features))
        return ds

    def pre_process(self, ds):  # DataSetPreProcessor parity
        return self.transform(ds)

    # subclass API
    def _reset(self): ...
    def _fit_partial(self, x: np.ndarray): ...
    def _finalize(self): ...
    def normalize(self, x: np.ndarray) -> np.ndarray: ...
    def denormalize(self, x: np.ndarray) -> np.ndarray: ...
    def to_dict(self) -> dict: ...


class NormalizerStandardize(DataNormalization):
    """Zero-mean unit-variance per feature column (NormalizerStandardize)."""

    def __init__(self):
        self._reset()

    def _reset(self):
        self.mean = None
        self.std = None
        self._n = 0
        self._sum = None
        self._sumsq = None

    def _fit_partial(self, x):
        x = x.reshape(x.shape[0], -1).astype(np.float64)
        if self._sum is None:
            self._sum = x.sum(0)
            self._sumsq = (x * x).sum(0)
        else:
            self._sum += x.sum(0)
            self._sumsq += (x * x).sum(0)
        self._n += x.shape[0]

    def _finalize(self):
        mean = self._sum / self._n
        var = self._sumsq / self._n - mean * mean
        self.mean = mean.astype(np.float32)
        self.std = np.sqrt(np.maximum(var, 1e-12)).astype(np.float32)

    def normalize(self, x):
        shape = x.shape
        flat = x.reshape(shape[0], -1)
        return ((flat - self.mean) / self.std).reshape(shape).astype(_out_dtype(x))

    def denormalize(self, x):
        shape = x.shape
        flat = x.reshape(shape[0], -1)
        return (flat * self.std + self.mean).reshape(shape).astype(_out_dtype(x))

    def to_dict(self):
        return {
            "@normalizer": "standardize",
            "mean": self.mean.tolist(),
            "std": self.std.tolist(),
        }

    @staticmethod
    def from_dict(d):
        n = NormalizerStandardize()
        n.mean = np.array(d["mean"], dtype=np.float32)
        n.std = np.array(d["std"], dtype=np.float32)
        return n


class NormalizerMinMaxScaler(DataNormalization):
    """Scale each feature column into [min_range, max_range]."""

    def __init__(self, min_range: float = 0.0, max_range: float = 1.0):
        self.min_range = float(min_range)
        self.max_range = float(max_range)
        self._reset()

    def _reset(self):
        self.data_min = None
        self.data_max = None

    def _fit_partial(self, x):
        flat = x.reshape(x.shape[0], -1).astype(np.float64)
        mn, mx = flat.min(0), flat.max(0)
        self.data_min = mn if self.data_min is None else np.minimum(self.data_min, mn)
        self.data_max = mx if self.data_max is None else np.maximum(self.data_max, mx)

    def _finalize(self):
        self.data_min = self.data_min.astype(np.float32)
        self.data_max = self.data_max.astype(np.float32)

    def _scale(self):
        return np.maximum(self.data_max - self.data_min, 1e-12)

    def normalize(self, x):
        shape = x.shape
        flat = x.reshape(shape[0], -1)
        unit = (flat - self.data_min) / self._scale()
        out = unit * (self.max_range - self.min_range) + self.min_range
        return out.reshape(shape).astype(_out_dtype(x))

    def denormalize(self, x):
        shape = x.shape
        flat = x.reshape(shape[0], -1)
        unit = (flat - self.min_range) / (self.max_range - self.min_range)
        out = unit * self._scale() + self.data_min
        return out.reshape(shape).astype(_out_dtype(x))

    def to_dict(self):
        return {
            "@normalizer": "minmax",
            "min_range": self.min_range,
            "max_range": self.max_range,
            "data_min": self.data_min.tolist(),
            "data_max": self.data_max.tolist(),
        }

    @staticmethod
    def from_dict(d):
        n = NormalizerMinMaxScaler(d["min_range"], d["max_range"])
        n.data_min = np.array(d["data_min"], dtype=np.float32)
        n.data_max = np.array(d["data_max"], dtype=np.float32)
        return n


class ImagePreProcessingScaler(DataNormalization):
    """Pixel [0, 255] → [a, b] (ImagePreProcessingScaler parity); stateless
    fit (the range is fixed by max_pixel, not data)."""

    def __init__(self, min_range: float = 0.0, max_range: float = 1.0,
                 max_pixel: float = 255.0):
        self.min_range = float(min_range)
        self.max_range = float(max_range)
        self.max_pixel = float(max_pixel)

    def _fit_partial(self, x): ...
    def _finalize(self): ...

    def normalize(self, x):
        unit = x.astype(np.float32) / self.max_pixel
        return unit * (self.max_range - self.min_range) + self.min_range

    def denormalize(self, x):
        unit = (x - self.min_range) / (self.max_range - self.min_range)
        return (unit * self.max_pixel).astype(np.float32)

    def to_dict(self):
        return {
            "@normalizer": "image_scaler",
            "min_range": self.min_range,
            "max_range": self.max_range,
            "max_pixel": self.max_pixel,
        }

    @staticmethod
    def from_dict(d):
        return ImagePreProcessingScaler(d["min_range"], d["max_range"], d["max_pixel"])


_REGISTRY = {
    "standardize": NormalizerStandardize,
    "minmax": NormalizerMinMaxScaler,
    "image_scaler": ImagePreProcessingScaler,
}


def normalizer_from_dict(d: dict) -> DataNormalization:
    return _REGISTRY[d["@normalizer"]].from_dict(d)
