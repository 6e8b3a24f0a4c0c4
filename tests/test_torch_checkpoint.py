"""Checkpoints on the CPU: the sharded checkpointer's contract (atomic
commit, keep-N, a corrupt step skipped, async saves, commit hooks), a
FaultTolerantTrainer run stopped by a fault and resumed against an
uninterrupted run (bit for bit, the dropout generator included), the
CheckpointListener's keep-N archives, early stopping with a
LocalFileModelSaver, and ModelRouter.load/reload on the CPU."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_tpu.nn import layers as JL  # noqa: E402
from deeplearning4j_tpu.nn import updaters as jupd  # noqa: E402
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC  # noqa: E402
from deeplearning4j_tpu_torch import earlystopping as es  # noqa: E402
from deeplearning4j_tpu_torch.data import ArrayDataSetIterator  # noqa: E402
from deeplearning4j_tpu_torch.nn import MultiLayerNetwork  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration as TConf)
from deeplearning4j_tpu_torch.nn.listeners import (  # noqa: E402
    CheckpointListener, TrainingListener)
from deeplearning4j_tpu_torch.serving import (ModelLoadError,  # noqa: E402
                                              ModelRouter,
                                              ReloadRejectedError)
from deeplearning4j_tpu_torch.util import (FaultTolerantTrainer,  # noqa: E402
                                           ModelSerializer,
                                           ShardedCheckpointer)
from deeplearning4j_tpu_torch.util import checkpoint as ck  # noqa: E402
from deeplearning4j_tpu_torch.util.model_serializer import (  # noqa: E402
    jax_items)


def _conf(dropout=0.3, seed=4, n_out=3):
    jconf = (JNNC.builder().seed(seed).updater(
        jupd.Adam(learning_rate=1e-2, epsilon=1e-3)).list()
        .layer(JL.DenseLayer(n_in=8, n_out=16, activation="relu",
                             dropout=dropout))
        .layer(JL.OutputLayer(n_in=16, n_out=n_out))
        .set_input_type((8,)).build())
    return TConf.from_json(jconf.to_json())


def _net(**kw):
    return MultiLayerNetwork(_conf(**kw)).init(device="cpu")


def _data(n=48, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 8)).astype(np.float32),
            np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)])


def _iterator():
    """Six batches an epoch, in the same order every epoch: an iterator's
    own shuffling epoch is not part of a checkpoint (the reference keeps
    that cursor in its elastic runtime)."""
    return ArrayDataSetIterator(*_data(), batch=8)


def _params(net):
    return [v.clone() for _, v in jax_items(net.params)]


def _assert_equal_nets(a, b):
    for (_, x), (_, y) in zip(jax_items(a.params), jax_items(b.params)):
        assert torch.equal(x, y)
    for (_, x), (_, y) in zip(jax_items(a.opt_states),
                              jax_items(b.opt_states)):
        assert torch.equal(x, y)


# ------------------------------------------------------ sharded checkpointer


def test_save_restore_keep_n_and_hooks(tmp_path):
    net = _net()
    ckpt = ShardedCheckpointer(str(tmp_path), keep=3, log_fn=None)
    seen = []
    ckpt.add_commit_hook(seen.append)
    ckpt.add_commit_hook(lambda s: 1 / 0)
    x, y = _data()
    for step in range(1, 6):
        net.fit(x[:8], y[:8])
        ckpt.save(step, net, extra_meta={"cursor": step * 8})
    assert ckpt.all_steps() == [3, 4, 5] and ckpt.latest_step() == 5
    assert seen == [1, 2, 3, 4, 5]
    assert ckpt.commit_hook_errors_total == 5
    assert ckpt.checkpoints_total == 5
    assert ckpt.load_meta(5) == {"step": 5, "epoch": 5, "cursor": 40}
    fresh = _net()
    ckpt.restore(fresh)
    assert (fresh.iteration, fresh.epoch) == (5, 5)
    _assert_equal_nets(fresh, net)
    assert torch.equal(fresh._gen.get_state(), net._gen.get_state())


def test_crash_mid_save_leaves_only_tmp(tmp_path, monkeypatch):
    net = _net()
    ckpt = ShardedCheckpointer(str(tmp_path), keep=3, retry=None,
                               log_fn=None)
    ckpt.save(1, net)

    def crash(path, tree):
        open(path, "wb").write(b"partial")
        raise OSError("crash mid-save")

    monkeypatch.setattr(ck, "save_tree_npz", crash)
    with pytest.raises(OSError, match="mid-save"):
        ckpt.save(2, net)
    names = sorted(os.listdir(tmp_path))
    assert len(names) == 2 and "1" in names
    assert [n for n in names if n != "1"][0].startswith(".tmp-2-")
    assert ckpt.all_steps() == [1]
    monkeypatch.undo()
    ckpt.save(3, net)           # the next commit sweeps this pid's tmp
    assert sorted(os.listdir(tmp_path)) == ["1", "3"]


def test_corrupt_newest_step_is_skipped(tmp_path):
    net = _net()
    ckpt = ShardedCheckpointer(str(tmp_path), keep=3, log_fn=None)
    x, y = _data()
    saved = {}
    for step in (1, 2, 3):
        net.fit(x[:8], y[:8])
        ckpt.save(step, net, block=False)
        ckpt.wait_until_finished()
        saved[step] = _params(net)
    path = tmp_path / "3" / "state.npz"
    path.write_bytes(path.read_bytes()[:200])
    fresh = _net()
    assert ckpt.restore_latest_good(fresh) == 2
    assert ckpt.corrupt_skipped_total == 1
    assert ckpt.all_steps() == [1, 2]
    assert any(n.startswith(".unloadable-3-") for n in os.listdir(tmp_path))
    for got, want in zip(_params(fresh), saved[2]):
        assert torch.equal(got, want)


def test_tree_npz_round_trip(tmp_path):
    tree = {"a": [np.arange(3), (np.ones((2, 2)), None)], "b": {}}
    ck.save_tree_npz(str(tmp_path / "t.npz"), tree)
    back = ck.load_tree_npz(str(tmp_path / "t.npz"))
    assert isinstance(back["a"][1], tuple) and back["a"][1][1] is None
    np.testing.assert_array_equal(back["a"][0], np.arange(3))
    assert back["b"] == {}


class _FaultAt(TrainingListener):
    """Raises once, at ``iteration`` (after that step's update)."""

    def __init__(self, iteration):
        self.iteration, self.fired = iteration, False

    def iteration_done(self, model, iteration, epoch):
        if iteration == self.iteration and not self.fired:
            self.fired = True
            raise RuntimeError("injected fault")


def test_fault_tolerant_trainer_resumes_bit_for_bit(tmp_path):
    """A fault at the first step of epoch 2 rolls back to the last step of
    epoch 1 (saved async every step, its sidecar's epoch refreshed at the
    epoch's end) and fits on: params, optimizer state and the dropout
    generator equal an uninterrupted run's."""
    steady = _net()
    steady.fit(_iterator(), epochs=3)
    net = _net()
    fault = _FaultAt(7)
    net.listeners.append(fault)
    trainer = FaultTolerantTrainer(net, str(tmp_path), checkpoint_every=1,
                                   keep=3, crash_dump_path=str(
                                       tmp_path / "crash.json"))
    trainer.listener.block = False
    trainer.fit(_iterator(), epochs=3)
    assert fault.fired and trainer.restarts == 1
    assert json.loads((tmp_path / "crash.json").read_text())["iteration"] \
        == 7
    assert (net.iteration, net.epoch) == (steady.iteration, steady.epoch)
    _assert_equal_nets(net, steady)
    assert torch.equal(net._gen.get_state(), steady._gen.get_state())
    assert trainer.listener not in net.listeners


# -------------------------------------------- listener and early stopping


def test_checkpoint_listener_keeps_the_last_n(tmp_path):
    net = _net()
    lst = CheckpointListener(str(tmp_path), save_every_n_iterations=2,
                             save_every_n_epochs=1, keep_last=2)
    net.listeners.append(lst)
    net.fit(_iterator(), epochs=2)
    names = sorted(os.listdir(tmp_path))
    assert len(names) == 2 and names == sorted(
        os.path.basename(p) for p in lst.saved)
    assert lst.last_checkpoint().endswith("checkpoint_iter12_epoch2.zip")
    back = ModelSerializer.restore_multi_layer_network(
        lst.last_checkpoint(), device="cpu")
    _assert_equal_nets(back, net)


def test_early_stopping_with_local_file_saver(tmp_path):
    x, y = _data(seed=1)
    val = ArrayDataSetIterator(x, y, batch=16)
    saver = es.LocalFileModelSaver(str(tmp_path))
    conf = (es.EarlyStoppingConfiguration.builder()
            .score_calculator(es.DataSetLossCalculator(val))
            .model_saver(saver).save_last_model(True)
            .epoch_termination_conditions(es.MaxEpochsTerminationCondition(3))
            .build())
    result = es.EarlyStoppingTrainer(conf, _net(dropout=0.0),
                                     _iterator()).fit()
    assert sorted(os.listdir(tmp_path)) == ["bestModel.zip",
                                            "latestModel.zip"]
    best = result.best_model
    assert isinstance(best, MultiLayerNetwork)
    score = es.DataSetLossCalculator(val).calculate_score(best)
    assert score == pytest.approx(result.best_model_score, rel=1e-6)
    assert es.LocalFileModelSaver(str(tmp_path / "empty")) \
        .get_best_model() is None


# ---------------------------------------------------------------- serving


def test_router_load_and_reload(tmp_path):
    net = _net(dropout=0.0)
    x, y = _data()
    v1 = str(tmp_path / "v1.zip")
    ModelSerializer.write_model(net, v1, save_updater=False)
    router = ModelRouter(device="cpu")
    router.load("m", v1, start=False)
    model, _ = router.get("m")
    assert model.version == 1
    np.testing.assert_array_equal(model.execute([x[:4]])[0][0],
                                  net.output(x[:4]).numpy())
    net.fit(x, y)
    v2 = str(tmp_path / "v2.zip")
    ModelSerializer.write_model(net, v2, save_updater=False)
    assert router.reload("m", v2) == 2
    np.testing.assert_array_equal(model.execute([x[:4]])[0][0],
                                  net.output(x[:4]).numpy())
    bad = tmp_path / "bad.zip"
    bad.write_bytes(open(v2, "rb").read()[:1000])
    with pytest.raises(ModelLoadError):
        router.reload("m", str(bad))
    with pytest.raises(ModelLoadError):
        router.load("other", str(bad))
    assert router.model_ids() == ["m"] and model.version == 2
    other = str(tmp_path / "other.zip")
    ModelSerializer.write_model(
        MultiLayerNetwork(_conf(dropout=0.0, n_out=4)).init(device="cpu"),
        other, save_updater=False)
    with pytest.raises(ReloadRejectedError, match="topology"):
        router.reload("m", other)
    nan_net = _net(dropout=0.0)
    with torch.no_grad():
        nan_net.params[0]["W"].fill_(float("nan"))
    wrong = str(tmp_path / "nan.zip")
    ModelSerializer.write_model(nan_net, wrong, save_updater=False)
    with pytest.raises(ReloadRejectedError, match="canary"):
        router.reload("m", wrong)
    assert model.version == 2
    # int8 serving loads (no leaf of this narrow net reaches the 256
    # elements a quantized leaf needs, so it serves the fp32 outputs)
    router.load("q", v1, quantize="int8", start=False)
    q, _ = router.get("q")
    assert q.describe()["quantize"] == "int8"
    assert q._qp.quantized_fraction() == 0.0
    q.warmup()
    np.testing.assert_array_equal(
        q.execute([x[:4]])[0][0],
        ModelSerializer.restore_model(v1, device="cpu").output(
            x[:4]).numpy())
    with pytest.raises(NotImplementedError, match="item 11b"):
        router.watch("m", v1)
    router.shutdown()
