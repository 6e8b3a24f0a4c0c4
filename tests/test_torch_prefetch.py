"""The port's AsyncDataSetIterator (``data/prefetch.py``) on the CPU, and a
LeNet trained from CSV shards through it against the reference.

The reference's own cases of ``tests/test_host_pipeline.py`` for the
multiprocess executor and the prefetch iterator run here on the port
(``_torch_port_cases``; the port stages onto ``device="cpu"``). The tests
below check the port's order, staging, error, stall and reset behaviour
with ``device_put=False`` and with ``device="cpu"``, its telemetry names
and its fault seam, and train a narrow LeNet three steps through
``fit(AsyncDataSetIterator(NativeCSVDataSetIterator(...)))`` against the
reference's same pipeline: losses and params within 1e-4 relative, 1e-6
absolute (the docs/KERNELS.md trajectory tolerance).
"""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from _torch_port_cases import expose, port_copy  # noqa: E402

import jax  # noqa: E402

from deeplearning4j_tpu.data.prefetch import \
    AsyncDataSetIterator as RefAsync  # noqa: E402
from deeplearning4j_tpu.native.dataset import \
    NativeCSVDataSetIterator as RefNativeCSV  # noqa: E402
from deeplearning4j_tpu.nn.conf import \
    MultiLayerConfiguration as JConf  # noqa: E402
from deeplearning4j_tpu.nn.multilayer import \
    MultiLayerNetwork as JMLN  # noqa: E402
from deeplearning4j_tpu.nn.updaters import Sgd as JSgd  # noqa: E402
from deeplearning4j_tpu.zoo.models import LeNet as JLeNet  # noqa: E402
from deeplearning4j_tpu_torch import interop  # noqa: E402
from deeplearning4j_tpu_torch.data import (AsyncDataSetIterator,  # noqa: E402
                                           DataSet, MultiDataSet,
                                           PrefetchStalledError)
from deeplearning4j_tpu_torch.native.dataset import \
    NativeCSVDataSetIterator  # noqa: E402
from deeplearning4j_tpu_torch.nn import MultiLayerNetwork  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import \
    MultiLayerConfiguration as TConf  # noqa: E402
from deeplearning4j_tpu_torch.util import faults as fl  # noqa: E402
from deeplearning4j_tpu_torch.util import telemetry as tm  # noqa: E402

_cases = port_copy("test_host_pipeline")
expose(_cases, [
    "test_mp_executor_bit_identical_to_serial",
    "test_mp_executor_small_input_serial_path",
    "test_mp_executor_worker_exception_propagates",
    "test_mp_executor_timeout_no_hang",
    "test_parallel_record_reader_bridges_to_iterator",
    "test_prefetch_batch_size_over_attribute_style_base",
    "test_prefetch_yields_all_batches_in_order",
    "test_prefetch_donation_safety",
    "test_prefetch_worker_exception_reraises",
    "test_prefetch_worker_exception_propagates_to_fit",
    "test_prefetch_stalled_worker_times_out"], globals())


def _batches(n=6, batch=4, seed=0, masks=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.normal(size=(batch, 5, 3)).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (batch, 5))]
        m = (rng.random((batch, 5)) > 0.3).astype(np.float32) \
            if masks else None
        out.append(DataSet(x, y, m, m))
    return out


class _List:
    def __init__(self, batches):
        self.batches = batches
        self.resets = 0

    def __iter__(self):
        return iter(self.batches)

    def reset(self):
        self.resets += 1


class _Wedged(_List):
    def __init__(self, batches, release):
        super().__init__(batches)
        self.release = release

    def __iter__(self):
        yield self.batches[0]
        self.release.wait(30.0)
        yield from self.batches[1:]


@pytest.fixture
def registry():
    tele = tm.get_telemetry()
    was = tele.enabled
    tele.reset()
    tele.enabled = True
    yield tele
    tele.enabled = was
    tele.reset()


def test_without_a_card_the_default_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AsyncDataSetIterator(_List(_batches(1)))
    # plain read-ahead needs no device
    AsyncDataSetIterator(_List(_batches(1)), device_put=False)


@pytest.mark.parametrize("masks", [False, True])
def test_read_ahead_and_cpu_staging_keep_order_and_values(masks):
    src = _batches(7, masks=masks)
    plain = list(AsyncDataSetIterator(_List(src), device_put=False))
    assert all(a is b for a, b in zip(plain, src))
    staged_it = AsyncDataSetIterator(_List(src), buffer_size=3, device="cpu")
    staged = list(staged_it)
    assert len(staged) == 7 and staged_it.staged_batches == 0
    for a, b in zip(src, staged):
        assert isinstance(b.features, torch.Tensor)
        np.testing.assert_array_equal(b.features.numpy(), a.features)
        np.testing.assert_array_equal(b.labels.numpy(), a.labels)
        if masks:
            np.testing.assert_array_equal(b.features_mask.numpy(),
                                          a.features_mask)
        else:
            assert b.features_mask is None


def test_multidataset_staged_leaf_by_leaf():
    rng = np.random.default_rng(1)
    mds = MultiDataSet([rng.normal(size=(2, 3)).astype(np.float32),
                        rng.normal(size=(2, 4)).astype(np.float64)],
                       [np.eye(2, dtype=np.float32)], None,
                       [np.ones((2, 1), np.float32)])
    (out,) = list(AsyncDataSetIterator(_List([mds]), device="cpu"))
    assert isinstance(out, MultiDataSet)
    assert [t.dtype for t in out.features] == [torch.float32, torch.float32]
    np.testing.assert_array_equal(out.features[1].numpy(),
                                  mds.features[1].astype(np.float32))
    assert out.features_masks is None
    np.testing.assert_array_equal(out.labels_masks[0].numpy(), 1.0)


def test_error_reraises_after_the_good_batches():
    class Boom(_List):
        def __iter__(self):
            yield self.batches[0]
            yield self.batches[1]
            raise KeyError("record 2 is corrupt")

    got = []
    with pytest.raises(KeyError, match="record 2 is corrupt"):
        for ds in AsyncDataSetIterator(Boom(_batches(3)), device="cpu"):
            got.append(ds)
    assert len(got) == 2


def test_stall_raises_with_post_mortem_and_refuses_reset(registry):
    release = threading.Event()
    base = _Wedged(_batches(3), release)
    it = AsyncDataSetIterator(base, buffer_size=2, device="cpu",
                              timeout=0.3)
    got = []
    with pytest.raises(PrefetchStalledError) as e:
        for ds in it:
            got.append(ds)
    msg = str(e.value)
    assert "no batch for 0.3s" in msg and "_Wedged" in msg
    assert "last successful batch index 0" in msg
    assert "producer thread alive" in msg
    assert len(got) == 1
    snap = registry.snapshot()["counters"]
    assert snap["prefetch.stalls_total"] >= 1
    assert snap["prefetch.stall_timeouts_total"] == 1
    # the worker is still inside the base iterator: no reset, no re-iterate
    it._worker.join(0.1)
    with pytest.raises(PrefetchStalledError, match="cannot reset"):
        it.reset()
    release.set()
    it._worker.join(10.0) if it._worker else None
    it.reset()  # the worker has left the base: reset goes through
    assert base.resets == 1
    assert len(list(it)) == 3


def test_injected_stall_trips_the_timeout():
    inj = fl.get_injector()
    inj.inject(fl.STALL_PREFETCH, arg=5.0)
    try:
        it = AsyncDataSetIterator(_List(_batches(2)), device="cpu",
                                  timeout=0.3)
        with pytest.raises(PrefetchStalledError, match="0.3s"):
            list(it)
    finally:
        inj.clear()
        it._shutdown()


def test_telemetry_names_and_thread(registry):
    n = len(list(AsyncDataSetIterator(_List(_batches(4)), device="cpu")))
    assert n == 4
    snap = registry.snapshot()
    assert snap["counters"]["prefetch.batches_total"] == 4
    assert "prefetch.queue_depth" in snap["gauges"]
    events = registry.drain_events()
    names = {e["name"] for e in events}
    assert {"prefetch.etl_wait", "prefetch.device_put"} <= names
    assert all(e["tname"] == "dl4j-tpu-prefetch" for e in events
               if e["name"].startswith("prefetch.") and e["ph"] == "X")


def test_batch_size_reads_attribute_and_method():
    class Attr(_List):
        batch_size = 16

    class Method(_List):
        def batch_size(self):
            return 8

    assert AsyncDataSetIterator(Attr([]), device="cpu").batch_size() == 16
    assert AsyncDataSetIterator(Method([]), device="cpu").batch_size() == 8


# ------------------------------------------------------------ LeNet from CSV

class _MnistCsv:
    """DataSetPreProcessor: MNIST-format CSV features (0-255, flat) to
    NHWC in [0, 1]."""

    def pre_process(self, ds):
        ds.features = (ds.features / np.float32(255.0)).reshape(-1, 28, 28, 1)


def _shards(tmp_path, n=24, shards=2, seed=4):
    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.integers(0, 10, (n, 1)),
                           rng.integers(0, 256, (n, 784))], 1)
    paths = []
    for k, part in enumerate(np.array_split(rows, shards)):
        p = tmp_path / f"s{k}.csv"
        p.write_text("\n".join(",".join(map(str, r)) for r in part) + "\n")
        paths.append(str(p))
    return paths


def test_lenet_trains_from_csv_shards_as_the_reference(tmp_path):
    """Three Sgd steps of LeNet-5 (batch 8, 24 rows in 2 shards) through
    the native CSV iterator and the prefetching iterator, in both
    packages, from the same params."""
    paths = _shards(tmp_path)
    jconf = JLeNet(updater=JSgd(0.05)).conf()
    jnet = JMLN(jconf).init()
    net = MultiLayerNetwork(TConf.from_json(jconf.to_json())).init(
        device="cpu")
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    interop.load_reference_mln(net, tree(jnet.params), tree(jnet.states),
                               tree(jnet.opt_states), jnet.iteration)
    pre = _MnistCsv()

    def ref_batches():
        for ds in RefNativeCSV(paths, 8, 785, label_index=0, num_classes=10,
                               n_threads=2):
            pre.pre_process(ds)
            yield ds

    class RefBase:
        def __iter__(self):
            return ref_batches()

    jscores, scores = [], []
    for ds in RefAsync(RefBase(), buffer_size=2):
        jnet.fit(ds)
        jscores.append(float(jnet.score_value))
    it = AsyncDataSetIterator(NativeCSVDataSetIterator(
        paths, 8, 785, label_index=0, num_classes=10, n_threads=2,
        preprocessor=pre), buffer_size=2, device="cpu")

    class Scores:
        def iteration_done(self, model, iteration, epoch):
            scores.append(float(model.get_score()))

    net.set_listeners(Scores())
    net.fit(it)
    assert len(scores) == len(jscores) == 3
    np.testing.assert_allclose(scores, jscores, rtol=1e-4, atol=1e-6)
    for i, layer in enumerate(jnet.params):
        for k, v in layer.items():
            np.testing.assert_allclose(net.params[i][k].numpy(),
                                       np.asarray(v), rtol=1e-4, atol=1e-6)
