"""The port's early stopping against the JAX package's, on the CPU: a tiny
LeNet run (96 synthetic training digits, 48 test, batch 32, Sgd 0.3,
whose validation loss falls, then rises; the reference's params copied
into the port) under both trainers gives the same termination reason and
details (the improvement condition, patience 0, at epoch 3), total and
best epoch (2), and per-epoch scores within 1e-4 relative. The port's best model is a snapshot on the
net's own device that later training leaves as it was, with no
listeners; an iteration condition stops both trainers at the same
place."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from deeplearning4j_tpu import earlystopping as jes  # noqa: E402
from deeplearning4j_tpu.data.iterators import (  # noqa: E402
    MnistDataSetIterator as JMnist)
from deeplearning4j_tpu.nn import updaters as jupd  # noqa: E402
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JMLN)
from deeplearning4j_tpu.zoo.models import LeNet as JLeNet  # noqa: E402
from deeplearning4j_tpu_torch import earlystopping as tes  # noqa: E402
from deeplearning4j_tpu_torch import interop  # noqa: E402
from deeplearning4j_tpu_torch.data import MnistDataSetIterator  # noqa: E402
from deeplearning4j_tpu_torch.nn import MultiLayerNetwork  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration as TConf)

RTOL = 1e-4


def _tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _pair(lr=0.3):
    conf = JLeNet(updater=jupd.Sgd(lr)).conf()
    jnet = JMLN(conf).init()
    net = MultiLayerNetwork(TConf.from_json(conf.to_json())).init(
        device="cpu")
    interop.load_reference_mln(net, _tree(jnet.params), _tree(jnet.states),
                               _tree(jnet.opt_states))
    return jnet, net


def _iters(pkg_iter, tmp_path):
    kw = {} if pkg_iter is MnistDataSetIterator else {
        "data_dir": str(tmp_path)}  # the reference: no idx files there
    return (pkg_iter(batch=32, n_examples=96, seed=7, **kw),
            pkg_iter(batch=32, train=False, n_examples=48, seed=7, **kw))


def _config(pkg, test_iter, iteration_conditions=()):
    b = (pkg.EarlyStoppingConfiguration.builder()
         .score_calculator(pkg.DataSetLossCalculator(test_iter))
         .epoch_termination_conditions(
             pkg.MaxEpochsTerminationCondition(5),
             pkg.ScoreImprovementEpochTerminationCondition(0))
         .save_last_model())
    if iteration_conditions:
        b.iteration_termination_conditions(*iteration_conditions)
    return b.build()


class _Marker:
    def iteration_done(self, model, iteration, epoch):
        pass


def test_trainer_matches_reference(tmp_path):
    jnet, net = _pair()
    train, test = _iters(MnistDataSetIterator, tmp_path)
    jtrain, jtest = _iters(JMnist, tmp_path)
    marker = _Marker()
    net.set_listeners(marker)
    res = tes.EarlyStoppingTrainer(_config(tes, test), net, train).fit()
    jres = jes.EarlyStoppingTrainer(_config(jes, jtest), jnet, jtrain).fit()
    assert res.termination_reason.value == jres.termination_reason.value
    assert res.termination_details == jres.termination_details
    assert res.termination_details == \
        "ScoreImprovementEpochTerminationCondition"
    assert res.total_epochs == jres.total_epochs == 3
    assert res.best_model_epoch == jres.best_model_epoch == 2
    assert sorted(res.score_vs_epoch) == sorted(jres.score_vs_epoch)
    for e, s in jres.score_vs_epoch.items():
        np.testing.assert_allclose(res.score_vs_epoch[e], s, rtol=RTOL)
    np.testing.assert_allclose(res.best_model_score, jres.best_model_score,
                               rtol=RTOL)
    assert net.listeners == [marker]  # the trainer put them back

    best = res.best_model
    assert best.listeners == [] and best.device == net.device
    assert all(t.device == net.device for p in best.params
               for t in p.values())
    rescored = tes.DataSetLossCalculator(test).calculate_score(best)
    np.testing.assert_allclose(rescored, res.best_model_score, rtol=1e-6)
    # training the net on leaves the snapshot, and later copies, as they were
    before = [t.clone() for p in best.params for t in p.values()]
    net.fit(train)
    for t, b in zip((t for p in best.params for t in p.values()), before):
        assert torch.equal(t, b)
    best.fit(train)  # the copy trains on its own tensors and generator
    assert not any(torch.equal(a, b) for a, b in zip(
        (t for p in best.params for t in p.values()),
        (t for p in net.params for t in p.values())))


def test_iteration_condition_stops_both_trainers(tmp_path):
    """A max score no loss is below trips on the first iteration: both stop
    with IterationTerminationCondition, before any epoch was scored."""
    jnet, net = _pair()
    train, test = _iters(MnistDataSetIterator, tmp_path)
    jtrain, jtest = _iters(JMnist, tmp_path)
    res = tes.EarlyStoppingTrainer(_config(
        tes, test, [tes.MaxScoreIterationTerminationCondition(1e-3)]),
        net, train).fit()
    jres = jes.EarlyStoppingTrainer(_config(
        jes, jtest, [jes.MaxScoreIterationTerminationCondition(1e-3)]),
        jnet, jtrain).fit()
    assert res.termination_reason.value == jres.termination_reason.value \
        == "IterationTerminationCondition"
    assert res.termination_details == jres.termination_details
    assert res.total_epochs == jres.total_epochs == 0
    assert res.best_model is None and jres.best_model is None
    assert net.iteration == jnet.iteration == 1 and net.listeners == []


@pytest.mark.parametrize("cond,scores,stops_at", [
    ("max_epochs", [5.0, 4.0, 3.0], 2),
    ("improvement", [5.0, 4.0, 4.5, 4.2, 3.0], 4),
])
def test_epoch_conditions_match_reference(cond, scores, stops_at):
    def make(pkg):
        return (pkg.MaxEpochsTerminationCondition(2) if cond == "max_epochs"
                else pkg.ScoreImprovementEpochTerminationCondition(1, 0.1))

    for pkg in (tes, jes):
        c = make(pkg)
        c.initialize()
        hits = [c.terminate(e + 1, s) for e, s in enumerate(scores)]
        assert hits.index(True) + 1 == stops_at


def test_trainer_drives_a_graph_as_the_reference(tmp_path):
    """EarlyStoppingTrainer on a ComputationGraph (dense -> softmax, Sgd
    0.5, 60 rows in batches of 16, 3 epochs): the same reason, best epoch
    and scores (1e-4) as the reference's trainer, the graph's listeners put
    back, the best model a graph of its own on the net's device."""
    from deeplearning4j_tpu.data.iterators import (
        ArrayDataSetIterator as JArrayIter)
    from deeplearning4j_tpu.nn import ComputationGraph as JGraph
    from deeplearning4j_tpu.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.data import ArrayDataSetIterator
    from deeplearning4j_tpu_torch.nn import ComputationGraph as TGraph
    from deeplearning4j_tpu_torch.nn.computation_graph import (
        ComputationGraphConfiguration as TGConf)

    gb = (NeuralNetConfiguration.builder().seed(4).updater(jupd.Sgd(0.5))
          .graph_builder().add_inputs("in"))
    gb.add_layer("d", DenseLayer(n_out=8, activation="tanh"), "in")
    gb.add_layer("out", OutputLayer(n_in=8, n_out=3), "d")
    conf = gb.set_outputs("out").set_input_types(
        InputType.feed_forward(5)).build()
    jnet = JGraph(conf).init()
    net = TGraph(TGConf.from_json(conf.to_json())).init(device="cpu")
    interop.load_reference(net, _tree(jnet.params), _tree(jnet.states),
                           _tree(jnet.opt_states))
    rng = np.random.default_rng(9)
    x = rng.normal(size=(60, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 60)]
    vx = rng.normal(size=(20, 5)).astype(np.float32)
    vy = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 20)]
    marker = _Marker()
    net.set_listeners(marker)
    results = []
    for pkg, it, g in ((tes, ArrayDataSetIterator, net),
                       (jes, JArrayIter, jnet)):
        cfg = (pkg.EarlyStoppingConfiguration.builder()
               .score_calculator(pkg.DataSetLossCalculator(it(vx, vy,
                                                              batch=8)))
               .epoch_termination_conditions(
                   pkg.MaxEpochsTerminationCondition(3)).build())
        results.append(pkg.EarlyStoppingTrainer(
            cfg, g, it(x, y, batch=16, shuffle=True, seed=2)).fit())
    res, jres = results
    assert res.termination_details == jres.termination_details
    assert res.best_model_epoch == jres.best_model_epoch
    for e, s in jres.score_vs_epoch.items():
        np.testing.assert_allclose(res.score_vs_epoch[e], s, rtol=RTOL)
    assert net.listeners == [marker]
    best = res.best_model
    assert isinstance(best, TGraph) and best.listeners == []
    assert best.device == net.device and best.params is not net.params
