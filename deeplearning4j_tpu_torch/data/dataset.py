"""DataSet — (features, labels) pair with optional masks (counterpart of
deeplearning4j_tpu/data/dataset.py; org/nd4j/linalg/dataset/DataSet.java and
MultiDataSet). Numpy arrays, or tensors; ``fit`` takes one, a list of
them, or any iterable of them (the iterators of ``data/iterators.py``),
``evaluate`` an iterable and ``score`` one. Both networks apply the (B, T)
feature and label masks; a ComputationGraph shares a DataSet's masks among
its inputs and outputs, and keys a MultiDataSet's mask lists by input and
output name. The async prefetching iterator and the image iterator are not
ported yet (item 9).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class DataSet:
    features: np.ndarray
    labels: np.ndarray
    features_mask: Optional[np.ndarray] = None
    labels_mask: Optional[np.ndarray] = None

    def num_examples(self) -> int:
        return len(self.features)

    def split_test_and_train(self, n_train: int):
        return (
            DataSet(self.features[:n_train], self.labels[:n_train]),
            DataSet(self.features[n_train:], self.labels[n_train:]),
        )

    def shuffle(self, seed: int = 0):
        rng = np.random.default_rng(seed)
        idx = rng.permutation(len(self.features))
        self.features = self.features[idx]
        self.labels = self.labels[idx]
        if self.features_mask is not None:
            self.features_mask = self.features_mask[idx]
        if self.labels_mask is not None:
            self.labels_mask = self.labels_mask[idx]
        return self


@dataclasses.dataclass
class MultiDataSet:
    """Multiple inputs/outputs (ComputationGraph training)."""

    features: list
    labels: list
    features_masks: Optional[list] = None
    labels_masks: Optional[list] = None

    def num_examples(self) -> int:
        return len(self.features[0])
