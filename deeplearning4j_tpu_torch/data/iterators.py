"""DataSet iterators (counterpart of deeplearning4j_tpu/data/iterators.py):
DL4J's DataSetIterator interface, minibatches over in-memory arrays, and
MnistDataSetIterator.

Batches are host numpy arrays; ``fit``, ``score`` and ``evaluate`` move
each to the network's device. With ``shuffle`` the order of an epoch is
``default_rng(seed + epoch)``'s permutation, the reference's, so both
packages see the same batches epoch by epoch.

MNIST: the idx files are read from ``data_dir`` when it holds them
(``train-images-idx3-ubyte[.gz]`` and the labels beside it); otherwise
the reference's deterministic synthetic digits are generated
(:func:`_synthetic_mnist`, the same arrays bit for bit; ``.synthetic`` is
True). The reference looks in ``~/.deeplearning4j_tpu/mnist`` when no
``data_dir`` is given; the port reads nothing outside what the caller
names, so without ``data_dir`` it generates the synthetic set.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Iterator

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet


class DataSetIterator:
    """Iterator protocol (org/nd4j/linalg/dataset/api/iterator/
    DataSetIterator.java): iterable over DataSet minibatches with reset()."""

    def __iter__(self) -> Iterator[DataSet]:
        raise NotImplementedError

    def reset(self) -> None:
        pass

    def batch_size(self) -> int:
        raise NotImplementedError


class ArrayDataSetIterator(DataSetIterator):
    """Minibatches over in-memory arrays (ExistingDataSetIterator /
    ListDataSetIterator parity). Each pass over it is one epoch: with
    ``shuffle`` the rows are permuted by ``default_rng(seed + epoch)``;
    ``drop_last`` leaves out a ragged last batch."""

    def __init__(self, features, labels, batch=32, shuffle=False, seed=123,
                 drop_last=False):
        self.features = np.asarray(features)
        self.labels = np.asarray(labels)
        self.batch = batch
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0

    def __iter__(self):
        n = len(self.features)
        idx = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        self._epoch += 1
        stop = n - (n % self.batch) if self.drop_last else n
        for i in range(0, stop, self.batch):
            j = idx[i:i + self.batch]
            yield DataSet(self.features[j], self.labels[j])

    def batch_size(self):
        return self.batch

    def total_examples(self):
        return len(self.features)


def _read_idx(path: str) -> np.ndarray:
    """An idx file (MNIST's format: a big-endian magic whose low byte is the
    rank, the extents, then uint8 data), optionally gzipped."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


# stroke endpoints per class on a 0..1 canvas (crude 7-segment-ish digits),
# as the reference draws them
_STROKES = {
    0: [(0.2, 0.2, 0.8, 0.2), (0.8, 0.2, 0.8, 0.8), (0.8, 0.8, 0.2, 0.8),
        (0.2, 0.8, 0.2, 0.2)],
    1: [(0.5, 0.15, 0.5, 0.85)],
    2: [(0.2, 0.2, 0.8, 0.2), (0.8, 0.2, 0.8, 0.5), (0.8, 0.5, 0.2, 0.5),
        (0.2, 0.5, 0.2, 0.8), (0.2, 0.8, 0.8, 0.8)],
    3: [(0.2, 0.2, 0.8, 0.2), (0.8, 0.2, 0.8, 0.8), (0.2, 0.5, 0.8, 0.5),
        (0.2, 0.8, 0.8, 0.8)],
    4: [(0.2, 0.2, 0.2, 0.5), (0.2, 0.5, 0.8, 0.5), (0.8, 0.2, 0.8, 0.8)],
    5: [(0.8, 0.2, 0.2, 0.2), (0.2, 0.2, 0.2, 0.5), (0.2, 0.5, 0.8, 0.5),
        (0.8, 0.5, 0.8, 0.8), (0.8, 0.8, 0.2, 0.8)],
    6: [(0.7, 0.15, 0.3, 0.4), (0.3, 0.4, 0.2, 0.8), (0.2, 0.8, 0.8, 0.8),
        (0.8, 0.8, 0.8, 0.5), (0.8, 0.5, 0.2, 0.5)],
    7: [(0.2, 0.2, 0.8, 0.2), (0.8, 0.2, 0.4, 0.85)],
    8: [(0.2, 0.2, 0.8, 0.2), (0.8, 0.2, 0.8, 0.8), (0.8, 0.8, 0.2, 0.8),
        (0.2, 0.8, 0.2, 0.2), (0.2, 0.5, 0.8, 0.5)],
    9: [(0.8, 0.5, 0.2, 0.5), (0.2, 0.5, 0.2, 0.2), (0.2, 0.2, 0.8, 0.2),
        (0.8, 0.2, 0.8, 0.8)],
}


def _synthetic_mnist(n: int, seed: int, image_hw: int = 28):
    """The reference's deterministic digit-like set: each class a glyph of
    line segments, drawn with a random rotation, scale and shift, one pixel
    of thickening below the stroke and Gaussian noise. (features (n, hw,
    hw, 1) float32 in [0, 1], one-hot labels (n, 10)); the same draws in
    the same order as the reference, so the arrays are equal bit for
    bit."""
    rng = np.random.default_rng(seed)
    xs = np.zeros((n, image_hw, image_hw), dtype=np.float32)
    ys = rng.integers(0, 10, size=n)
    t = np.linspace(0, 1, 24)
    top = image_hw - 1
    for i in range(n):
        ang = rng.normal(0, 0.12)
        scale = 1.0 + rng.normal(0, 0.08)
        dx, dy = rng.normal(0, 0.04, 2)
        ca, sa = np.cos(ang), np.sin(ang)
        img = xs[i]
        for (x0, y0, x1, y1) in _STROKES[ys[i]]:
            cx = x0 + (x1 - x0) * t - 0.5
            cy = y0 + (y1 - y0) * t - 0.5
            rx = (ca * cx - sa * cy) * scale + 0.5 + dx
            ry = (sa * cx + ca * cy) * scale + 0.5 + dy
            ix = np.clip((rx * top).astype(int), 0, top)
            iy = np.clip((ry * top).astype(int), 0, top)
            img[iy, ix] = 1.0
            below = np.clip(iy + 1, 0, top)
            img[below, ix] = np.maximum(img[below, ix], 0.7)
        xs[i] += rng.normal(0, 0.05, (image_hw, image_hw)).astype(np.float32)
    xs = np.clip(xs, 0.0, 1.0)
    return xs[..., None], np.eye(10, dtype=np.float32)[ys]


class MnistDataSetIterator(ArrayDataSetIterator):
    """MNIST batches, NHWC (b, 28, 28, 1) in [0, 1], one-hot labels; the
    training set shuffles each epoch. Real idx files from ``data_dir``
    when it holds them, else the synthetic set (``n_examples`` of it, by
    default 4096 for training and 1024 for test, test drawn from
    ``seed + 1``)."""

    def __init__(self, batch=64, train=True, seed=123, n_examples=None,
                 data_dir=None, flatten=False):
        prefix = "train" if train else "t10k"
        img_path = lbl_path = None
        for ext in ("", ".gz") if data_dir is not None else ():
            ip = os.path.join(data_dir, f"{prefix}-images-idx3-ubyte{ext}")
            lp = os.path.join(data_dir, f"{prefix}-labels-idx1-ubyte{ext}")
            if os.path.exists(ip) and os.path.exists(lp):
                img_path, lbl_path = ip, lp
                break
        if img_path:
            images = _read_idx(img_path).astype(np.float32) / 255.0
            labels = np.eye(10, dtype=np.float32)[_read_idx(lbl_path)]
            features = images[..., None]
            self.synthetic = False
        else:
            n = n_examples or (4096 if train else 1024)
            features, labels = _synthetic_mnist(
                n, seed=seed if train else seed + 1)
            self.synthetic = True
        if n_examples:
            features, labels = features[:n_examples], labels[:n_examples]
        if flatten:
            features = features.reshape(len(features), -1)
        super().__init__(features, labels, batch=batch, shuffle=train,
                         seed=seed)
