"""The port's native loaders (``deeplearning4j_tpu_torch/native``) against
the reference's.

The reference's own cases of ``tests/test_native.py`` and
``tests/test_native_image.py`` run here on the port (``_torch_port_cases``).
The tests below hold the two libraries bit for bit: ``parse_csv`` (blank
lines, CRLF, non-numeric cells, malformed rows), the CSV pipeline's files
in order, ``decode_image_file`` and ``AsyncImagePipeline`` by index on
seeded JPEG and PNG files (grayscale too), and the two CSV iterators' batches
against the plain Python path. The repaired CSV pipeline runs 200 times in
a subprocess under its own time limit; the pinned batch ring is exercised
with stand-in buffers and events (pinning needs a card).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from _torch_port_cases import expose, port_copy  # noqa: E402

import deeplearning4j_tpu.native as ref_native  # noqa: E402
import deeplearning4j_tpu.native.dataset as ref_dataset  # noqa: E402
import deeplearning4j_tpu_torch.native as port_native  # noqa: E402
import deeplearning4j_tpu_torch.native.dataset as port_dataset  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_native_cases = port_copy("test_native")
expose(_native_cases, ["TestArena", "TestCSVParse", "TestAsyncPipeline",
                       "TestNativeDataSetIterator"], globals())
_image_cases = port_copy("test_native_image")
expose(_image_cases, ["TestDecode", "TestIteratorIntegration"], globals())
# the reference's image pipeline class, under a name of its own here
TestImagePipelineCases = _image_cases.TestAsyncPipeline

BOTH = (ref_native, port_native)


def test_library_builds_under_build_dir_by_hash():
    info = port_native.build_info()
    assert info["error"] is None and info["image"], info
    lib = info["library"]
    assert os.path.dirname(lib) == os.path.join(REPO, "build", "native")
    assert os.path.basename(lib) == os.path.basename(
        str(port_native.library_path(image=True)))
    pkg = os.path.join(REPO, "deeplearning4j_tpu_torch", "native")
    assert not [f for f in os.listdir(pkg) if f.endswith((".so", ".tmp"))]


@pytest.mark.parametrize("text", [
    b"1,2,3\n4,5,6\n", b"1,2,3\r\n\r\n4,5,6\r\n", b"\n\n1.5,-2e3,7\n\n",
    b"1,abc,3\n\"x\",5,6\n", b"1, 2 ,3\n4,5,6", b"", b"nan,inf,-inf\n",
    b"3.4028235e39,1e-46,0x1p3\n"], ids=lambda t: repr(t)[:24])
def test_parse_csv_bit_equal(text):
    a = ref_native.parse_csv(text, 3)
    b = port_native.parse_csv(text, 3)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def test_parse_csv_seeded_bit_equal():
    rng = np.random.default_rng(11)
    rows = rng.normal(size=(300, 9)) * 10.0 ** rng.integers(-8, 8, (300, 9))
    text = "\n".join(",".join(repr(float(v)) for v in r) for r in rows)
    a = ref_native.parse_csv(text.encode(), 9)
    b = port_native.parse_csv(text.encode(), 9)
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("text", [b"1,2\n3,4,5\n", b"1,2,3,4\n",
                                  b"1\n2,3,4\n"])
def test_parse_csv_malformed_raises_in_both(text):
    for nat in BOTH:
        with pytest.raises(ValueError, match="malformed"):
            nat.parse_csv(text, 3)


def _csv_files(tmp_path, n=6, seed=5):
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        rows = rng.normal(size=(int(rng.integers(1, 40)), 4))
        p = tmp_path / f"f{i}.csv"
        p.write_text("\n".join(",".join(f"{v:.7g}" for v in r) for r in rows)
                     + ("\r\n" if i % 2 else "\n"))
        paths.append(str(p))
    return paths


def test_csv_pipeline_files_in_order_equal(tmp_path):
    """The port's pipeline delivers every file in order, each equal to the
    reference's parse of that file. (The reference's own pipeline is not
    run here: it can hang, see the stress test below.)"""
    paths = _csv_files(tmp_path)
    pipe = port_native.AsyncCSVPipeline(paths, cols=4, n_threads=3,
                                        prefetch=1)
    got = list(pipe)
    pipe.close()
    assert [i for i, _ in got] == list(range(len(paths)))
    for i, arr in got:
        with open(paths[i], "rb") as f:
            want = ref_native.parse_csv(f.read(), 4)
        np.testing.assert_array_equal(arr, want)


@pytest.mark.parametrize("bad", ["missing", "malformed"])
def test_csv_pipeline_markers(tmp_path, bad):
    """A missing file raises IOError and a malformed one ValueError when
    its turn comes, after the files before it, as in the reference."""
    paths = _csv_files(tmp_path, n=3)
    p = tmp_path / "bad.csv"
    if bad == "malformed":
        p.write_text("1,2,3,4\n5,6\n")
    paths.insert(2, str(p))
    err = IOError if bad == "missing" else ValueError
    pipe = port_native.AsyncCSVPipeline(paths, cols=4, n_threads=2,
                                        prefetch=2)
    got = [next(pipe)[0], next(pipe)[0]]
    with pytest.raises(err, match="bad.csv"):
        next(pipe)
    pipe.close()
    assert got == [0, 1]


STRESS = r'''
import sys, time
import numpy as np
sys.path.insert(0, {repo!r})
from deeplearning4j_tpu_torch import native
paths = {paths!r}
want = [native.parse_csv(open(p, "rb").read(), 4) for p in paths]
t0 = time.perf_counter()
for k in range({runs}):
    pipe = native.AsyncCSVPipeline(paths, cols=4, n_threads=4, prefetch=1)
    got = list(pipe)
    pipe.close()
    assert [i for i, _ in got] == list(range(len(paths))), (k, got)
    for (i, a) in got:
        assert np.array_equal(a, want[i]), (k, i)
print("ok", {runs}, time.perf_counter() - t0)
'''


def test_repaired_csv_pipeline_never_hangs(tmp_path):
    """200 pipelines of 4 files on 4 threads with a ring of 1, each
    delivering every file, in order, equal to the single-threaded parse.
    The reference's pipeline hangs in this loop (a parked worker missed its
    wake-up and ``pipe_next`` waited forever; 12 of 30 runs of its own
    4-file case hung), which is why it runs in a subprocess with a time
    limit: a hang fails the test instead of the suite. The files end
    without a newline: the reference's pipeline parsed such a last cell
    past the end of its buffer (a heap byte after "2.002393" read as a
    digit), which the port's NUL-terminated buffer repairs."""
    rng = np.random.default_rng(0)
    paths = []
    for i in range(4):
        p = tmp_path / f"r{i}.csv"
        p.write_text("\n".join(",".join(f"{v:.6f}" for v in r)
                               for r in rng.normal(size=(20, 4))))
        paths.append(str(p))
    code = STRESS.format(repo=REPO, paths=paths, runs=200)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.startswith("ok 200"), proc.stdout


def _images(tmp_path, seed=3):
    from PIL import Image

    rng = np.random.default_rng(seed)
    items = []
    for i in range(9):
        h, w = int(rng.integers(20, 70)), int(rng.integers(20, 70))
        a = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        fmt, ext, mode = [("JPEG", "jpg", "RGB"), ("PNG", "png", "RGB"),
                          ("JPEG", "jpg", "L"), ("PNG", "png", "L")][i % 4]
        img = Image.fromarray(a)
        if mode == "L":
            img = img.convert("L")
        p = str(tmp_path / f"im{i}.{ext}")
        img.save(p, fmt, quality=90)
        items.append((p, i % 3))
    return items


@pytest.mark.parametrize("hwc", [(32, 32, 3), (17, 45, 3), (64, 24, 1)])
def test_decode_image_file_bit_equal(tmp_path, hwc):
    for p, _ in _images(tmp_path):
        a = ref_native.decode_image_file(p, *hwc)
        b = port_native.decode_image_file(p, *hwc)
        np.testing.assert_array_equal(a, b)


def test_image_pipeline_bit_equal_by_index(tmp_path):
    items = _images(tmp_path)
    paths, labels = [p for p, _ in items], [l for _, l in items]
    by_index = []
    for nat in BOTH:
        pipe = nat.AsyncImagePipeline(paths, labels, height=28, width=30,
                                      channels=3, batch=4, n_threads=3,
                                      prefetch=2)
        got = {}
        for x, lab, idx in pipe:
            for j, i in enumerate(idx.tolist()):
                got[i] = (x[j].copy(), int(lab[j]))
        pipe.close()
        by_index.append(got)
    assert sorted(by_index[1]) == list(range(len(items)))
    for i in range(len(items)):
        np.testing.assert_array_equal(by_index[0][i][0], by_index[1][i][0])
        assert by_index[0][i][1] == by_index[1][i][1] == labels[i]
        np.testing.assert_array_equal(
            by_index[1][i][0], port_native.decode_image_file(
                paths[i], 28, 30, 3))


def test_image_iterator_one_thread_equals_reference(tmp_path):
    """One decode thread delivers in file order: the port's
    AsyncImageDataSetIterator equals the reference's batch for batch."""
    from deeplearning4j_tpu.data.image_iterator import \
        AsyncImageDataSetIterator as Ref
    from deeplearning4j_tpu_torch.data.image_iterator import \
        AsyncImageDataSetIterator as Port

    items = _images(tmp_path)
    out = []
    for cls in (Ref, Port):
        it = cls(items, height=24, width=24, channels=3, batch=4,
                 n_threads=1)
        out.append([(ds.features.copy(), ds.labels) for ds in it])
        it.close()
    assert len(out[1]) == 3
    for (xa, ya), (xb, yb) in zip(*out):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


def _mnist_shards(tmp_path, n=200, shards=3, seed=0):
    """MNIST-format CSV shards (label, then 784 pixels 0-255)."""
    rng = np.random.default_rng(seed)
    pix = rng.integers(0, 256, (n, 784))
    lab = rng.integers(0, 10, n)
    rows = np.concatenate([lab[:, None], pix], 1)
    paths = []
    for k, part in enumerate(np.array_split(rows, shards)):
        p = tmp_path / f"mnist_{k}.csv"
        p.write_text("\n".join(",".join(map(str, r)) for r in part) + "\n")
        paths.append(str(p))
    return paths


def test_csv_iterators_equal_the_plain_python_path(tmp_path):
    """NativeCSVDataSetIterator (both packages) and the port's
    CSVRecordReader over a list of shards give the same batches, batches
    crossing shard boundaries and a ragged last one included."""
    from deeplearning4j_tpu_torch.datavec import (CSVRecordReader,
                                                  RecordReaderDataSetIterator)

    paths = _mnist_shards(tmp_path)
    plain = list(RecordReaderDataSetIterator(CSVRecordReader(paths), 32,
                                             label_index=0, num_classes=10))
    for mod in (ref_dataset, port_dataset):
        it = mod.NativeCSVDataSetIterator(paths, 32, 785, label_index=0,
                                          num_classes=10, n_threads=3,
                                          prefetch=1)
        got = list(it)
        assert [len(b.features) for b in got] == [32] * 6 + [8]
        for a, b in zip(plain, got):
            np.testing.assert_array_equal(a.features, b.features)
            np.testing.assert_array_equal(a.labels, b.labels)


def test_native_iterator_preprocessor(tmp_path):
    from deeplearning4j_tpu_torch.data import ImagePreProcessingScaler

    paths = _mnist_shards(tmp_path, n=40, shards=2)
    it = port_dataset.NativeCSVDataSetIterator(
        paths, 16, 785, label_index=0, num_classes=10,
        preprocessor=ImagePreProcessingScaler())
    raw = port_dataset.NativeCSVDataSetIterator(paths, 16, 785,
                                                label_index=0,
                                                num_classes=10)
    for a, b in zip(it, raw):
        np.testing.assert_array_equal(a.features, b.features / 255.0)


class _FakeEvent:
    def __init__(self, done=True):
        self.done = done
        self.synced = False

    def query(self):
        return self.done

    def synchronize(self):
        self.synced = True


@pytest.fixture
def cpu_ring(monkeypatch):
    """A pinned ring whose buffers are ordinary CPU tensors (pinning
    needs CUDA), so its reuse rule is checked here."""
    monkeypatch.setattr(
        port_native._PinnedRing, "_alloc",
        lambda self: torch.empty(self.shape, dtype=torch.float32))
    return port_native._PinnedRing((2, 3, 3, 1), 2)


def test_pinned_ring_reuses_a_slot_only_after_its_copy(cpu_ring):
    a = cpu_ring.acquire()
    b = cpu_ring.acquire()
    bufs = [a.buf, b.buf]
    ev = _FakeEvent(done=False)
    a.release_after(ev)
    a2 = cpu_ring.acquire()  # slot a: waits for its event, same buffer
    assert a2 is a and a2.buf is bufs[0] and ev.synced
    assert cpu_ring.waits == 1 and cpu_ring.fresh == 0
    b2 = cpu_ring.acquire()  # slot b: no copy reported, a fresh buffer
    assert b2 is b and b2.buf is not bufs[1] and cpu_ring.fresh == 1


def test_image_batches_carry_their_slot_release(tmp_path, cpu_ring):
    """With a pinned ring, each DataSet of AsyncImageDataSetIterator
    carries its slot's ``release_after`` (what data/prefetch.py hands the
    copy's event to); its features are a view of that slot's buffer.
    Without a ring a batch carries none."""
    from deeplearning4j_tpu_torch.data import AsyncImageDataSetIterator

    items = _images(tmp_path)
    src = AsyncImageDataSetIterator(items, height=8, width=8, batch=4,
                                    n_threads=1, pin_memory=True)
    ring = None
    for ds in src:
        slot = ds.release_after.__self__
        ring = src.pipeline.ring
        assert slot in ring.slots
        assert np.shares_memory(ds.features, slot.buf.numpy())
        ds.release_after(_FakeEvent())
    assert ring is not None and ring.fresh == 0
    plain = AsyncImageDataSetIterator(items, height=8, width=8, batch=4,
                                      n_threads=1, pin_memory=False)
    assert not any(hasattr(ds, "release_after") for ds in plain)


def test_image_pipeline_without_card_allocates_per_batch(tmp_path):
    items = _images(tmp_path)
    pipe = port_native.AsyncImagePipeline([p for p, _ in items],
                                          height=8, width=8, batch=4)
    assert pipe.ring is None  # no CUDA here: the reference's np.empty
    xs = [x for x, _, _ in pipe]
    assert pipe.decoded == len(items)
    assert len({x.__array_interface__["data"][0] for x in xs}) == len(xs)
