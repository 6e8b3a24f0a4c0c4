"""The port's data pipeline against the JAX package's, on the CPU: the
synthetic MNIST set and the iterators bit for bit, the idx reader on files
the test writes, and each normalizer's fit, transform, revert and dict
form (statistics and transforms equal to the bit: both are numpy)."""

import gzip
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_tpu.data import dataset as jds  # noqa: E402
from deeplearning4j_tpu.data import iterators as jit_  # noqa: E402
from deeplearning4j_tpu.data import normalizers as jnorm  # noqa: E402
from deeplearning4j_tpu_torch.data import (ArrayDataSetIterator,  # noqa: E402
                                           DataSet, ImagePreProcessingScaler,
                                           MnistDataSetIterator,
                                           NormalizerMinMaxScaler,
                                           NormalizerStandardize,
                                           normalizer_from_dict)
from deeplearning4j_tpu_torch.data import iterators as tit  # noqa: E402


def _batches(it):
    return [(ds.features, ds.labels) for ds in it]


def _assert_same_batches(mine, ref):
    assert len(mine) == len(ref)
    for (x, y), (jx, jy) in zip(mine, ref):
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)


@pytest.mark.parametrize("n,seed", [(1, 0), (97, 123), (50, 124)])
def test_synthetic_mnist_is_bit_equal(n, seed):
    x, y = tit._synthetic_mnist(n, seed)
    jx, jy = jit_._synthetic_mnist(n, seed)
    assert x.shape == (n, 28, 28, 1) and x.dtype == np.float32
    assert y.shape == (n, 10) and y.dtype == np.float32
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)


@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, False),
                                               (True, True)],
                         ids=["ordered", "shuffled", "shuffled-drop-last"])
def test_array_iterator_order_matches_reference_across_epochs(shuffle,
                                                              drop_last):
    """37 rows in batches of 8 (a ragged 5, or none with drop_last): three
    epochs give the reference's batches, each epoch its own permutation."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(37, 3)).astype(np.float32)
    y = np.arange(37)
    mine = ArrayDataSetIterator(x, y, batch=8, shuffle=shuffle, seed=5,
                                drop_last=drop_last)
    ref = jit_.ArrayDataSetIterator(x, y, batch=8, shuffle=shuffle, seed=5,
                                    drop_last=drop_last)
    epochs = []
    for _ in range(3):
        got = _batches(mine)
        _assert_same_batches(got, _batches(ref))
        assert sum(len(b[1]) for b in got) == (32 if drop_last else 37)
        epochs.append(np.concatenate([b[1] for b in got]))
    assert (not np.array_equal(epochs[0], epochs[1])) == shuffle
    assert mine.batch_size() == 8 and mine.total_examples() == 37


@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
def test_mnist_iterator_matches_reference(train, tmp_path):
    """Without idx files both generate the synthetic set (the reference
    pointed at an empty directory): the same batches, two epochs."""
    mine = MnistDataSetIterator(batch=16, train=train, n_examples=40)
    ref = jit_.MnistDataSetIterator(batch=16, train=train, n_examples=40,
                                    data_dir=str(tmp_path))
    assert mine.synthetic and ref.synthetic
    for _ in range(2):
        _assert_same_batches(_batches(mine), _batches(ref))


def _write_idx(path, arr):
    header = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(header + arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("ext", ["", ".gz"], ids=["raw", "gzip"])
def test_read_idx_and_mnist_from_idx_files(tmp_path, ext):
    """An idx file the test writes reads back equal; an MNIST directory of
    them (20 test images) iterates as the reference's does."""
    rng = np.random.default_rng(2)
    images = rng.integers(0, 256, size=(20, 28, 28)).astype(np.uint8)
    labels = rng.integers(0, 10, size=20).astype(np.uint8)
    _write_idx(str(tmp_path / f"t10k-images-idx3-ubyte{ext}"), images)
    _write_idx(str(tmp_path / f"t10k-labels-idx1-ubyte{ext}"), labels)
    got = tit._read_idx(str(tmp_path / f"t10k-images-idx3-ubyte{ext}"))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, images)
    mine = MnistDataSetIterator(batch=8, train=False, data_dir=str(tmp_path))
    ref = jit_.MnistDataSetIterator(batch=8, train=False,
                                    data_dir=str(tmp_path))
    assert not mine.synthetic
    _assert_same_batches(_batches(mine), _batches(ref))
    np.testing.assert_array_equal(mine.features[..., 0],
                                  images.astype(np.float32) / 255.0)


_NORMS = {
    "standardize": (NormalizerStandardize, jnorm.NormalizerStandardize, ()),
    "minmax": (NormalizerMinMaxScaler, jnorm.NormalizerMinMaxScaler,
               (-1.0, 2.0)),
    "image_scaler": (ImagePreProcessingScaler, jnorm.ImagePreProcessingScaler,
                     (0.0, 1.0, 255.0)),
}


@pytest.mark.parametrize("source", ["dataset", "iterator"])
@pytest.mark.parametrize("kind", sorted(_NORMS))
def test_normalizer_matches_reference(kind, source):
    """fit on a DataSet or over an iterator (batches of 7), then transform,
    revert and the dict form both ways."""
    cls, jcls, args = _NORMS[kind]
    rng = np.random.default_rng(3)
    x = (rng.random((30, 4, 3)) * 255).astype(np.float32)
    y = np.zeros((30, 2), np.float32)
    mine, ref = cls(*args), jcls(*args)
    if source == "dataset":
        mine.fit(DataSet(x.copy(), y))
        ref.fit(jds.DataSet(x.copy(), y))
    else:
        mine.fit(ArrayDataSetIterator(x, y, batch=7))
        ref.fit(jit_.ArrayDataSetIterator(x, y, batch=7))
    d = mine.to_dict()
    assert d == ref.to_dict()
    ds, jds_ = DataSet(x.copy(), y), jds.DataSet(x.copy(), y)
    mine.transform(ds)
    ref.transform(jds_)
    np.testing.assert_array_equal(ds.features, jds_.features)
    mine.revert(ds)
    ref.revert(jds_)
    np.testing.assert_array_equal(ds.features, jds_.features)
    np.testing.assert_allclose(ds.features, x, rtol=1e-5, atol=1e-3)
    # the dict form crosses in both directions
    back = normalizer_from_dict(ref.to_dict())
    assert type(back) is cls and back.to_dict() == d
    assert jnorm.normalizer_from_dict(d).to_dict() == d
