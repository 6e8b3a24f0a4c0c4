"""NativeCSVDataSetIterator: the native pipeline as a DataSetIterator.

Reference parity: RecordReaderDataSetIterator wrapped in
AsyncDataSetIterator (SURVEY.md §3.1: "async-prefetch wrapper ... separate
thread") — here the prefetch thread pool, file IO, and float parsing are all
native (csrc/dl4jtpu_native.cpp); Python only slices batches and one-hots
labels. The port's copy of deeplearning4j_tpu/native/dataset.py, with one
addition: ``preprocessor`` (a DataSetPreProcessor, as
RecordReaderDataSetIterator takes) is applied to each batch.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch import native
from deeplearning4j_tpu_torch.data.dataset import DataSet


class NativeCSVDataSetIterator:
    """Iterate DataSet minibatches over many CSV shards.

    ``label_index`` column becomes the label (one-hot with ``num_classes``,
    raw for regression); remaining columns are features."""

    def __init__(self, paths: List[str], batch_size: int, n_columns: int,
                 label_index: int = -1, num_classes: Optional[int] = None,
                 regression: bool = False, delimiter: str = ",",
                 n_threads: int = 2, prefetch: int = 4, preprocessor=None):
        if not native.is_available():
            raise RuntimeError(f"native build unavailable: {native.build_error()}")
        self.paths = list(paths)
        self.batch_size = batch_size
        self.n_columns = n_columns
        self.label_index = label_index % n_columns
        self.num_classes = num_classes
        self.regression = regression
        self.delimiter = delimiter
        self.n_threads = n_threads
        self.prefetch = prefetch
        self.preprocessor = preprocessor

    def reset(self):
        pass  # a fresh pipeline is created per epoch in __iter__

    def _emit(self, rows: np.ndarray) -> DataSet:
        li = self.label_index
        labels = rows[:, li]
        feats = np.delete(rows, li, axis=1)
        if self.regression:
            y = labels[:, None].astype(np.float32)
        else:
            y = np.eye(self.num_classes, dtype=np.float32)[
                labels.astype(np.int64)]
        ds = DataSet(feats, y)
        if self.preprocessor is not None:
            self.preprocessor.pre_process(ds)
        return ds

    def __iter__(self):
        pipe = native.AsyncCSVPipeline(
            self.paths, cols=self.n_columns, delimiter=self.delimiter,
            n_threads=self.n_threads, prefetch=self.prefetch)
        try:
            pending: Optional[np.ndarray] = None
            for _, arr in pipe:
                buf = arr if pending is None else np.concatenate([pending, arr])
                n_full = len(buf) // self.batch_size * self.batch_size
                for s in range(0, n_full, self.batch_size):
                    yield self._emit(buf[s:s + self.batch_size])
                pending = buf[n_full:] if n_full < len(buf) else None
            if pending is not None and len(pending):
                yield self._emit(pending)
        finally:
            pipe.close()
