"""The port's HDF5 decoder and encoder (``imports/h5mini.py``) against
h5py, on the CPU: every group, attribute and dataset of files that tf.keras
and h5py wrote (a Sequential MLP, a functional CNN, MobileNetV2's 157-group
``model_weights``, a ``.keras`` zip's ``model.weights.h5``, a
``libver='latest'`` file with compact groups, a compact dataset) decodes
to the same names in the same order, the same types, shapes and values;
files the encoder wrote read back in h5py equal, and import in the
reference's Keras importer; chunked and filtered data, and what is not
HDF5, are refused by name."""

import io
import zipfile

import numpy as np
import pytest

pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

from deeplearning4j_tpu_torch.imports import h5mini  # noqa: E402
from deeplearning4j_tpu_torch.imports import keras_cases  # noqa: E402


def _same_value(a, b, where):
    if isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a, b)
        assert (a == b).all(), where
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def assert_same_tree(mine, ref, where=""):
    """Every attribute, member and dataset of the h5py object ``ref`` in
    the h5mini object ``mine``: the same names in the same order, equal
    values of the same types."""
    assert list(mine.attrs) == list(ref.attrs.keys()), where
    for k in ref.attrs:
        _same_value(mine.attrs[k], ref.attrs[k], f"{where}@{k}")
    if isinstance(ref, h5py.Group):
        assert isinstance(mine, h5mini.Group), where
        assert list(mine) == list(ref), where
        for k in ref:
            assert_same_tree(mine[k], ref[k], f"{where}/{k}")
    else:
        assert isinstance(mine, h5mini.Dataset), where
        assert mine.shape == ref.shape and mine.dtype == ref.dtype, where
        _same_value(mine[()], ref[()], where)


def _count(g):
    n = 0

    def visit(_name, _obj):
        nonlocal n
        n += 1
    g.visititems(visit)
    return n


@pytest.fixture(scope="module")
def tf():
    return pytest.importorskip("tensorflow")


def test_tf_keras_files_decode_as_h5py_reads_them(tf, tmp_path):
    tf.keras.utils.set_random_seed(3)
    mlp = tf.keras.Sequential([
        tf.keras.layers.Input((6,)),
        tf.keras.layers.Dense(16, activation="relu"),
        tf.keras.layers.Dense(4, activation="softmax")])
    inp = tf.keras.Input((8, 8, 3), name="img")
    h = tf.keras.layers.Conv2D(4, 3, padding="same", name="c1")(inp)
    h = tf.keras.layers.BatchNormalization(name="bn")(h)
    s = tf.keras.layers.Add(name="res")([h, tf.keras.layers.Conv2D(
        4, 3, padding="same", name="c2")(h)])
    out = tf.keras.layers.Dense(2, name="head")(
        tf.keras.layers.GlobalAveragePooling2D(name="gap")(s))
    cnn = tf.keras.Model(inp, out)
    mnv2 = tf.keras.applications.MobileNetV2(
        weights=None, input_shape=(32, 32, 3), alpha=0.35, classes=7)
    for name, model in (("mlp", mlp), ("cnn", cnn), ("mnv2", mnv2)):
        path = str(tmp_path / f"{name}.h5")
        model.save(path)
        with h5py.File(path, "r") as ref:
            mine = h5mini.File(path)
            assert_same_tree(mine, ref)
            assert _count(mine) == _count(ref)
    # 157 groups: more than one SNOD, under a B-tree node
    assert len(h5mini.File(str(tmp_path / "mnv2.h5"))["model_weights"]) == 157
    path = str(tmp_path / "mlp.keras")
    mlp.save(path)
    data = zipfile.ZipFile(path).read("model.weights.h5")
    with h5py.File(io.BytesIO(data), "r") as ref:
        assert_same_tree(h5mini.File(data), ref)


def test_h5py_files_decode_latest_compact_and_f16(tmp_path):
    path = str(tmp_path / "latest.h5")
    with h5py.File(path, "w", libver="latest") as f:
        g = f.create_group("a")
        g.attrs["s"] = "héllo"
        g.attrs["strs"] = ["x", "yy", ""]
        g.attrs["i"] = np.int64(-3)
        g.create_dataset("d", data=np.arange(6.0).reshape(2, 3))
        for i in range(5):
            f.create_group(f"g{i}").attrs["n"] = np.arange(i, dtype=np.uint16)
    with h5py.File(path, "r") as ref:
        assert_same_tree(h5mini.File(path), ref)
    path = str(tmp_path / "earliest.h5")
    with h5py.File(path, "w") as f:
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        sid = h5py.h5s.create_simple((5,))
        h5py.h5d.create(f.id, b"compact", h5py.h5t.NATIVE_INT32, sid,
                        dcpl=dcpl).write(h5py.h5s.ALL, h5py.h5s.ALL,
                                         np.arange(5, dtype=np.int32))
        f.create_dataset("half", data=np.linspace(-2, 2, 7).astype(
            np.float16))
        f.create_dataset("fixed", data=np.array([b"ab", b"cde"]))
        f.create_dataset("scalar", data=np.float64(2.5))
        f.create_dataset("empty", shape=(0, 3), dtype=np.float32)
        f.attrs["fixed_attr"] = np.bytes_(b"fixed")
    with h5py.File(path, "r") as ref:
        assert_same_tree(h5mini.File(path), ref)


def test_chunked_filtered_and_foreign_data_refused(tmp_path):
    path = str(tmp_path / "chunked.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("c", data=np.arange(8.0), chunks=(4,))
        f.create_dataset("z", data=np.arange(8.0), compression="gzip")
    f = h5mini.File(path)
    with pytest.raises(h5mini.H5Unsupported, match="chunked dataset"):
        np.asarray(f["c"])
    with pytest.raises(h5mini.H5Unsupported, match="filtered dataset"):
        np.asarray(f["z"])
    with pytest.raises(h5mini.H5Error, match="not an HDF5 file"):
        h5mini.File(b"PK\x03\x04 not hdf5")
    with pytest.raises(KeyError):
        h5mini.File(path)["missing"]


def test_written_files_read_back_in_h5py(tmp_path):
    rng = np.random.default_rng(0)
    w = h5mini.Writer()
    w.attrs["model_config"] = "{" + "x" * 151625 + "}"
    w.attrs["ints"] = np.arange(4, dtype=np.int16)
    w.attrs["fixed"] = np.array([b"ab", b"c"])
    w.attrs["empty"] = np.zeros((0,))
    g = w.create_group("model_weights")
    names = [f"layer_{i}" for i in range(300)]  # a two-level B-tree
    g.attrs["layer_names"] = names
    arrays = {}
    for i, n in enumerate(names[:40] + names[-3:]):
        sub = g.create_group(n)
        sub.attrs["weight_names"] = [f"{n}/kernel", f"{n}/bias"]
        a = rng.normal(size=(3, i % 4 + 1)).astype(
            [np.float32, np.float64, np.float16][i % 3])
        arrays[n] = a
        sub.create_dataset(f"{n}/kernel", a)
        sub.create_dataset(f"{n}/bias", np.arange(i % 4 + 1, dtype=np.int64))
    for n in names[40:-3]:
        g.create_group(n)
    w.create_group("empty_group")
    path = str(tmp_path / "w.h5")
    w.save(path)
    with h5py.File(path, "r") as ref:
        assert len(ref["model_weights"]) == 300
        assert list(ref["model_weights"].attrs["layer_names"]) == names
        assert len(ref.attrs["model_config"]) == 151627
        for n, a in arrays.items():
            np.testing.assert_array_equal(
                ref[f"model_weights/{n}/{n}/kernel"][()], a)
        assert list(ref["empty_group"]) == []
        assert_same_tree(h5mini.File(path), ref)


def test_written_mobilenet_v2_imports_in_the_reference(tmp_path):
    """keras_cases' file, written by the encoder, through the reference's
    h5py importer and the port's: the same outputs."""
    from deeplearning4j_tpu.imports import KerasModelImport as JK
    from deeplearning4j_tpu_torch.imports import KerasModelImport as TK

    path = keras_cases.mobilenet_v2_h5(
        str(tmp_path / "m.h5"), input_shape=(32, 32, 3), alpha=0.35,
        classes=5, seed=1)
    x = np.random.default_rng(2).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(JK.import_keras_model_and_weights(path).output(x))
    got = TK.import_keras_model_and_weights(path, device="cpu").output(x)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-5)


def test_no_port_source_imports_h5py_or_tensorflow():
    """The card's machine has neither: no module of the port, nor the
    smoke, imports them."""
    import ast
    import pathlib

    repo = pathlib.Path(__file__).resolve().parents[1]
    files = sorted((repo / "deeplearning4j_tpu_torch").rglob("*.py")) + [
        repo / "chip_smoke.py"]
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] not in ("h5py", "tensorflow", "keras"), (
                    f"{f.relative_to(repo)} imports {n}")
