"""The port's LeNet slice against the JAX package, on the CPU.

LeNet-5 (``zoo.LeNet``: conv 5x5 -> 20, pool, conv 5x5 -> 50, pool, dense
500, softmax 10) at its published width on 28x28x1, small batches. Each
test builds the net in both packages from the same conf JSON and copies
the reference's params, optimizer state and iteration into the port with
``interop.load_reference_mln``. Tolerances:

- ``output`` within 1e-5 (absolute on probabilities, relative 1e-5);
- ``fit`` trajectories (per-step losses, params after 4 steps) under Sgd,
  Nesterovs and Adam (epsilon 1e-3: ROADMAP.md Queue 3) within 1e-4
  relative with an absolute floor of 1e-6 (docs/KERNELS.md);
- ``score`` within 1e-5 relative, the l1/l2 penalty included on the
  MultiLayerNetwork and left out on the ComputationGraph, in both
  packages;
- ``evaluate``: the same confusion matrix and metrics;
  ``evaluate_regression``: the same numbers within 1e-5 relative;
- the loss ops, weighted and unweighted, against ``ops/nn.py`` within
  1e-6 relative;
- ``fit(iterator, epochs=2)`` with shuffle: the same listener calls, in
  order, scores within 1e-4.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.data.iterators import (  # noqa: E402
    ArrayDataSetIterator as JArrayIter)
from deeplearning4j_tpu.nn import ComputationGraph as JGraph  # noqa: E402
from deeplearning4j_tpu.nn import updaters as jupd  # noqa: E402
from deeplearning4j_tpu.nn.computation_graph import (  # noqa: E402
    ComputationGraphConfiguration as JGConf)
from deeplearning4j_tpu.nn.conf import (  # noqa: E402
    MultiLayerConfiguration as JConf)
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JMLN)
from deeplearning4j_tpu.ops import nn as jnn  # noqa: E402
from deeplearning4j_tpu.zoo.models import LeNet as JLeNet  # noqa: E402
from deeplearning4j_tpu_torch import interop  # noqa: E402
from deeplearning4j_tpu_torch.data import (ArrayDataSetIterator,  # noqa: E402
                                           DataSet)
from deeplearning4j_tpu_torch.nn import ComputationGraph as TGraph  # noqa: E402
from deeplearning4j_tpu_torch.nn import MultiLayerNetwork  # noqa: E402
from deeplearning4j_tpu_torch.nn.computation_graph import (  # noqa: E402
    ComputationGraphConfiguration as TGConf)
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration as TConf)
from deeplearning4j_tpu_torch.ops import nn as tnn  # noqa: E402
from deeplearning4j_tpu_torch.zoo import LeNet  # noqa: E402

RTOL, ATOL = 1e-4, 1e-6


def _tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _pair_from(jconf):
    """(reference net, port net) from one conf, the reference's state
    copied into the port."""
    jnet = JMLN(jconf).init()
    net = MultiLayerNetwork(TConf.from_json(jconf.to_json())).init(
        device="cpu")
    interop.load_reference_mln(net, _tree(jnet.params), _tree(jnet.states),
                               _tree(jnet.opt_states), jnet.iteration)
    return jnet, net


def _lenet_conf(updater=None, l2=0.0):
    conf = JLeNet(updater=updater).conf()
    if l2:
        d = json.loads(conf.to_json())
        for lyr in d["layers"]:
            lyr["l2"] = l2
        conf = JConf.from_json(json.dumps(d))
    return conf


def _digits(n, seed):
    """(n, 28, 28, 1) images in [0, 1] and one-hot labels."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, 28, 28, 1), dtype=np.float32)
    return x, np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]


def _assert_params_close(net, jnet, rtol=RTOL, atol=ATOL):
    for i, (mine, ref) in enumerate(zip(net.params, jnet.params)):
        assert set(mine) == set(ref)
        for k in ref:
            np.testing.assert_allclose(mine[k].numpy(), np.asarray(ref[k]),
                                       rtol=rtol, atol=atol,
                                       err_msg=f"layer {i} {k}")


@pytest.fixture(scope="module")
def lenet():
    """(reference LeNet, port LeNet) at the zoo's defaults."""
    return _pair_from(_lenet_conf())


# -------------------------------------------------------------------- conf


def test_lenet_conf_json_equals_reference():
    mine = json.loads(LeNet().conf().to_json())
    assert mine == json.loads(JLeNet().conf().to_json())
    assert [lyr["@layer"] for lyr in mine["layers"]] == [
        "ConvolutionLayer", "SubsamplingLayer", "ConvolutionLayer",
        "SubsamplingLayer", "DenseLayer", "OutputLayer"]
    assert LeNet().init(device="cpu").num_params() == 431080


def test_lenet_output_matches_reference(lenet):
    jnet, net = lenet
    x, _ = _digits(5, seed=1)
    got = net.output(x)
    assert tuple(got.shape) == (5, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(jnet.output(x)),
                               rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------- fit


_UPDATERS = {
    "sgd": lambda: jupd.Sgd(0.05),
    "nesterovs": lambda: jupd.Nesterovs(0.02, momentum=0.9),
    "adam": lambda: jupd.Adam(1e-3, epsilon=1e-3),
}


@pytest.mark.parametrize("name", sorted(_UPDATERS))
def test_lenet_fit_trajectory_matches_reference(name):
    """Four fit steps on random digits: the per-step losses and the final
    params within 1e-4 relative."""
    jnet, net = _pair_from(_lenet_conf(updater=_UPDATERS[name]()))
    for s in range(4):
        x, y = _digits(6, seed=10 + s)
        jnet.fit(x, y)
        net.fit(x, y)
        np.testing.assert_allclose(net.get_score(), float(jnet.get_score()),
                                   rtol=RTOL)
    assert net.iteration == jnet.iteration == 4
    assert net.epoch == jnet.epoch == 4
    _assert_params_close(net, jnet)


# ------------------------------------------------------------------- score


def test_score_includes_the_penalty_on_the_mln_only():
    """l2 5e-4 on every layer. The MultiLayerNetwork's score adds the
    penalty (reference ``nn/multilayer.py:994-1005``), the graph's does
    not (``nn/computation_graph.py:1572-1612``): the same layers as a
    graph score lower by exactly the penalty, in both packages."""
    jnet, net = _pair_from(_lenet_conf(l2=5e-4))
    x, y = _digits(6, seed=3)
    want = float(jnet.score(x=x, y=y))
    np.testing.assert_allclose(net.score(x=x, y=y), want, rtol=1e-5)
    np.testing.assert_allclose(net.score(DataSet(x, y)), want, rtol=1e-5)
    penalty = sum(float(lyr.regularization(p))
                  for lyr, p in zip(net.layers, net.params))
    assert penalty > 1e-3
    # the same stack as a graph, in both packages
    d = json.loads(jnet.conf.to_json())
    names = [f"l{i}" for i in range(len(d["layers"]))]
    gd = {k: v for k, v in d.items() if k not in ("layers", "input_shape")}
    gd.update(inputs=["input"], outputs=[names[-1]],
              input_shapes=[d["input_shape"]],
              nodes=[{"name": n, "inputs": [prev], "node": lyr}
                     for n, prev, lyr in zip(names, ["input"] + names[:-1],
                                             d["layers"])])
    jgraph = JGraph(JGConf.from_json(json.dumps(gd))).init()
    jgraph.params = {n: p for n, p in zip(names, jnet.params)}
    jgraph.states = {n: s for n, s in zip(names, jnet.states)}
    graph = TGraph(TGConf.from_json(json.dumps(gd))).init(device="cpu")
    interop.load_reference(graph, _tree(jgraph.params), _tree(jgraph.states))
    jg = float(jgraph.score(x=x, y=y))
    np.testing.assert_allclose(graph.score(x=x, y=y), jg, rtol=1e-5)
    np.testing.assert_allclose(want - jg, penalty, rtol=1e-3)


# ---------------------------------------------------------------- evaluate


def test_evaluate_matches_reference(lenet):
    jnet, net = lenet
    x, y = _digits(37, seed=4)
    ev = net.evaluate(ArrayDataSetIterator(x, y, batch=16))
    jev = jnet.evaluate(JArrayIter(x, y, batch=16))
    np.testing.assert_array_equal(ev.confusion_matrix(),
                                  jev.confusion_matrix())
    assert ev.confusion_matrix().sum() == 37
    for metric in ("accuracy", "precision", "recall", "f1"):
        assert getattr(ev, metric)() == getattr(jev, metric)()


def _regression_conf():
    from deeplearning4j_tpu.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu.nn.layers import DenseLayer, OutputLayer

    return (NeuralNetConfiguration.builder().seed(5).list()
            .layer(DenseLayer(n_out=8, activation="tanh"))
            .layer(OutputLayer(n_in=8, n_out=3, loss="mse",
                               activation="identity"))
            .set_input_type(InputType.feed_forward(6)).build())


def test_evaluate_regression_matches_reference():
    jnet, net = _pair_from(_regression_conf())
    rng = np.random.default_rng(6)
    x = rng.normal(size=(21, 6)).astype(np.float32)
    y = rng.normal(size=(21, 3)).astype(np.float32)
    ev = net.evaluate_regression(ArrayDataSetIterator(x, y, batch=8))
    jev = jnet.evaluate_regression(JArrayIter(x, y, batch=8))
    for metric in ("mean_squared_error", "mean_absolute_error",
                   "root_mean_squared_error", "r_squared"):
        np.testing.assert_allclose(getattr(ev, metric)(),
                                   getattr(jev, metric)(), rtol=1e-5)
        np.testing.assert_allclose(getattr(ev, metric)(1),
                                   getattr(jev, metric)(1), rtol=1e-5)
    np.testing.assert_allclose(ev.pearson_correlation(2),
                               jev.pearson_correlation(2), rtol=1e-5)
    np.testing.assert_allclose(net.score(x=x, y=y), float(jnet.score(x=x, y=y)),
                               rtol=1e-5)


# ------------------------------------------------------------------ losses


_LOSS_OPS = ["mse_loss", "mae_loss", "huber_loss", "hinge_loss",
             "squared_hinge_loss", "log_loss", "poisson_loss",
             "kl_divergence", "cosine_distance_loss", "sigmoid_cross_entropy",
             "sparse_softmax_cross_entropy"]


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
@pytest.mark.parametrize("name", _LOSS_OPS)
def test_loss_ops_match_reference(name, weighted):
    """Each loss op on (5, 4) predictions in (0, 1) (the probability losses
    need them there) and labels of its kind; the weighted form with
    fractional per-example weights, one of them 0."""
    rng = np.random.default_rng(7)
    p = rng.uniform(0.05, 0.95, (5, 4)).astype(np.float32)
    if name == "sparse_softmax_cross_entropy":
        y = rng.integers(0, 4, 5).astype(np.int32)
    elif name in ("hinge_loss", "squared_hinge_loss", "sigmoid_cross_entropy",
                  "log_loss"):
        y = (rng.random((5, 4)) > 0.5).astype(np.float32)
    else:
        y = rng.uniform(0.0, 1.0, (5, 4)).astype(np.float32)
    w = (np.array([1.0, 0.5, 0.0, 2.0, 1.5], np.float32) if weighted
         else None)
    want = getattr(jnn, name)(jnp.asarray(p), jnp.asarray(y),
                              weights=None if w is None else jnp.asarray(w))
    got = getattr(tnn, name)(torch.from_numpy(p), torch.from_numpy(y),
                             weights=None if w is None else
                             torch.from_numpy(w))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("loss,act", [
    ("xent", "sigmoid"), ("mse", "identity"), ("l1", "identity"),
    ("hinge", "identity"), ("squared_hinge", "identity"),
    ("poisson", "sigmoid"), ("mcxent", "softmax")])
def test_output_layer_losses_score_as_reference(loss, act):
    """A dense net with each loss on its OutputLayer: ``score`` (the
    weighted path: the networks always pass 0/1 row weights) equals the
    reference's."""
    from deeplearning4j_tpu.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu.nn.layers import DenseLayer, OutputLayer

    conf = (NeuralNetConfiguration.builder().seed(9).list()
            .layer(DenseLayer(n_out=5, activation="tanh"))
            .layer(OutputLayer(n_in=5, n_out=3, loss=loss, activation=act))
            .set_input_type(InputType.feed_forward(4)).build())
    jnet, net = _pair_from(conf)
    rng = np.random.default_rng(10)
    x = rng.normal(size=(6, 4)).astype(np.float32)
    y = (rng.random((6, 3)) > 0.5).astype(np.float32)
    np.testing.assert_allclose(net.score(x=x, y=y),
                               float(jnet.score(x=x, y=y)), rtol=1e-5)


@pytest.mark.parametrize("loss,act", [("huber", "identity"),
                                      ("kl_divergence", "softmax"),
                                      ("cosine_proximity", "identity")])
def test_output_layer_passes_weights_by_keyword(loss, act):
    """The reference's OutputLayer passes the row weights to these losses
    positionally (``nn/layers.py:433``), where they land on huber's delta,
    kl_divergence's eps and cosine's axis, so its MultiLayerNetwork's
    ``score`` raises (ROADMAP.md Queue 3). The port passes them by keyword:
    its score equals the reference's loss op on the reference's own
    output."""
    from deeplearning4j_tpu.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu.nn.layers import DenseLayer, OutputLayer

    conf = (NeuralNetConfiguration.builder().seed(9).list()
            .layer(DenseLayer(n_out=5, activation="tanh"))
            .layer(OutputLayer(n_in=5, n_out=3, loss=loss, activation=act))
            .set_input_type(InputType.feed_forward(4)).build())
    jnet, net = _pair_from(conf)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(6, 4)).astype(np.float32)
    y = rng.uniform(0.1, 1.0, (6, 3)).astype(np.float32)
    with pytest.raises(Exception):
        jnet.score(x=x, y=y)
    op = {"huber": jnn.huber_loss, "kl_divergence": jnn.kl_divergence,
          "cosine_proximity": jnn.cosine_distance_loss}[loss]
    want = op(jnet.output(x), jnp.asarray(y), weights=jnp.ones(6))
    np.testing.assert_allclose(net.score(x=x, y=y), float(want), rtol=1e-5)


# --------------------------------------------------------------- listeners


class _Recorder:
    def __init__(self):
        self.calls = []

    def iteration_done(self, model, iteration, epoch):
        self.calls.append(("it", iteration, epoch, model.get_score()))

    def on_epoch_end(self, model):
        self.calls.append(("end", model.epoch))


def test_fit_iterator_fires_the_reference_listener_calls():
    """fit(iterator, epochs=2) over 40 shuffled digits in batches of 16
    (a ragged 8 at each epoch's end): the same calls in the same order,
    iteration and epoch equal, scores within 1e-4."""
    jnet, net = _pair_from(_lenet_conf(updater=jupd.Sgd(0.05)))
    x, y = _digits(40, seed=12)
    rec, jrec = _Recorder(), _Recorder()
    net.set_listeners(rec)
    jnet.set_listeners(jrec)
    net.fit(ArrayDataSetIterator(x, y, batch=16, shuffle=True, seed=3),
            epochs=2)
    jnet.fit(JArrayIter(x, y, batch=16, shuffle=True, seed=3), epochs=2)
    assert [c[:3] for c in rec.calls] == [c[:3] for c in jrec.calls]
    assert len(rec.calls) == 8 and rec.calls[3] == ("end", 1)
    for mine, ref in zip(rec.calls, jrec.calls):
        if mine[0] == "it":
            np.testing.assert_allclose(mine[3], ref[3], rtol=RTOL)
    _assert_params_close(net, jnet)
