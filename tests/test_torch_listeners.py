"""The port's listeners and their dispatcher against the JAX package's, on
the CPU, on small dense nets (a MultiLayerNetwork, a ComputationGraph and
a char-RNN-like LSTM stack for TBPTT), params copied from the reference:

- the calls every listener sees (iteration, epoch, score within 1e-4,
  epoch ends) at ``sync_every`` 1 and 4, against the reference at the same
  window, and the same stream at both windows;
- a TBPTT batch calls the listeners once, after its last segment, as the
  reference does;
- the end of an epoch flushes the window before ``on_epoch_end``;
- one host copy per window, and none at all with no listeners;
- what the stock listeners log and collect.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from deeplearning4j_tpu.data.iterators import (  # noqa: E402
    ArrayDataSetIterator as JArrayIter)
from deeplearning4j_tpu.nn import ComputationGraph as JGraph  # noqa: E402
from deeplearning4j_tpu.nn import listeners as jl  # noqa: E402
from deeplearning4j_tpu.nn import updaters as jupd  # noqa: E402
from deeplearning4j_tpu.nn.conf import (InputType,  # noqa: E402
                                        NeuralNetConfiguration)
from deeplearning4j_tpu.nn.layers import DenseLayer, OutputLayer  # noqa: E402
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JMLN)
from deeplearning4j_tpu.nn.recurrent import (LSTM,  # noqa: E402
                                             RnnOutputLayer)
from deeplearning4j_tpu_torch import interop  # noqa: E402
from deeplearning4j_tpu_torch.data import ArrayDataSetIterator  # noqa: E402
from deeplearning4j_tpu_torch.nn import ComputationGraph as TGraph  # noqa: E402
from deeplearning4j_tpu_torch.nn import MultiLayerNetwork  # noqa: E402
from deeplearning4j_tpu_torch.nn import listeners as tl  # noqa: E402
from deeplearning4j_tpu_torch.nn.computation_graph import (  # noqa: E402
    ComputationGraphConfiguration as TGConf)
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration as TConf)

RTOL = 1e-4


def _tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _mln_pair(sync_every=1, tbptt=0):
    b = (NeuralNetConfiguration.builder().seed(3).updater(jupd.Sgd(0.1))
         .sync_every(sync_every))
    if tbptt:
        conf = (b.tbptt_length(tbptt).list()
                .layer(LSTM(n_in=5, n_out=6))
                .layer(RnnOutputLayer(n_in=6, n_out=5))
                .set_input_type(InputType.recurrent(5)).build())
    else:
        conf = (b.list().layer(DenseLayer(n_out=7, activation="tanh"))
                .layer(OutputLayer(n_in=7, n_out=3))
                .set_input_type(InputType.feed_forward(4)).build())
    jnet = JMLN(conf).init()
    net = MultiLayerNetwork(TConf.from_json(conf.to_json())).init(
        device="cpu")
    interop.load_reference_mln(net, _tree(jnet.params), _tree(jnet.states),
                               _tree(jnet.opt_states))
    return jnet, net


def _data(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]


class _Recorder:
    """Every call, with the score as the listener reads it and whether the
    step's own clock was set (coalesced dispatch)."""

    def __init__(self):
        self.calls = []

    def iteration_done(self, model, iteration, epoch):
        self.calls.append(("it", iteration, epoch, model.get_score(),
                           model.last_iteration_wall_ns is not None))

    def on_epoch_end(self, model):
        self.calls.append(("end", model.epoch))


def _assert_same_calls(mine, ref):
    assert [c[:3] for c in mine] == [c[:3] for c in ref]
    for a, b in zip(mine, ref):
        if a[0] == "it":
            np.testing.assert_allclose(a[3], b[3], rtol=RTOL)
            assert a[4] == b[4]


@pytest.mark.parametrize("sync_every", [1, 4])
def test_mln_listener_calls_match_reference(sync_every):
    """Two epochs over 23 shuffled rows in batches of 5 (5 iterations an
    epoch, a ragged 3 last): at sync_every 4 the first window dispatches
    at iteration 4, the epoch's end flushes iteration 5."""
    jnet, net = _mln_pair(sync_every)
    x, y = _data(23, seed=1)
    rec, jrec = _Recorder(), _Recorder()
    net.set_listeners(rec)
    jnet.set_listeners(jrec)
    net.fit(ArrayDataSetIterator(x, y, batch=5, shuffle=True, seed=2),
            epochs=2)
    jnet.fit(JArrayIter(x, y, batch=5, shuffle=True, seed=2), epochs=2)
    _assert_same_calls(rec.calls, jrec.calls)
    assert len(rec.calls) == 12 and rec.calls[5] == ("end", 1)
    assert net._dispatcher.fetches == (0 if sync_every == 1 else 4)
    assert not net._dispatcher._pending


def test_sync_every_changes_when_not_what_listeners_see():
    """The same fit at sync_every 1 and 4: the same (iteration, epoch,
    score) stream, the scores equal to the bit."""
    streams = []
    for se in (1, 4):
        _, net = _mln_pair(se)
        rec = _Recorder()
        net.set_listeners(rec)
        x, y = _data(23, seed=1)
        net.fit(ArrayDataSetIterator(x, y, batch=5, shuffle=True, seed=2),
                epochs=2)
        streams.append([c[:4] for c in rec.calls])
    assert streams[0] == streams[1]


def test_epoch_end_flushes_the_window():
    """sync_every 4 and 3 iterations an epoch: no window fills, so each
    epoch's iterations reach the listeners at its end, before
    on_epoch_end."""
    _, net = _mln_pair(4)
    rec = _Recorder()
    net.add_listener(rec)
    x, y = _data(15, seed=3)
    net.fit(ArrayDataSetIterator(x, y, batch=5), epochs=2)
    assert [c[:3] for c in rec.calls] == [
        ("it", 1, 0), ("it", 2, 0), ("it", 3, 0), ("end", 1),
        ("it", 4, 1), ("it", 5, 1), ("it", 6, 1), ("end", 2)]
    assert net._dispatcher.fetches == 2


def test_no_listeners_no_host_fetch(monkeypatch):
    """With no listeners fit makes no host copy of the loss at any window:
    nothing calls tolist, item or float on a tensor."""
    fetched = []
    for name in ("tolist", "item", "__float__"):
        orig = getattr(torch.Tensor, name)

        def counting(self, *a, _orig=orig, _name=name, **k):
            fetched.append(_name)
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, counting)
    for se in (1, 4):
        _, net = _mln_pair(se)
        x, y = _data(23, seed=4)
        net.fit(ArrayDataSetIterator(x, y, batch=5), epochs=2)
        assert net._dispatcher.fetches == 0 and not net._dispatcher._pending
    assert fetched == []
    net.get_score()
    assert fetched == ["__float__"]


@pytest.mark.parametrize("sync_every", [1, 3])
def test_tbptt_calls_listeners_once_per_batch(sync_every):
    """tbptt_length 3 over T = 8 (segments of 3, 3, 2): each fit call makes
    three updates and, as the reference's segment loop does (its
    ``nn/multilayer.py:584-587``), calls the listeners once after the last
    segment, with the iteration after it and the mean of the segments'
    losses."""
    jnet, net = _mln_pair(sync_every, tbptt=3)
    rng = np.random.default_rng(5)
    eye = np.eye(5, dtype=np.float32)
    rec, jrec = _Recorder(), _Recorder()
    net.set_listeners(rec)
    jnet.set_listeners(jrec)
    for _ in range(2):
        ids = rng.integers(0, 5, size=(2, 9))
        x, y = eye[ids[:, :-1]], eye[ids[:, 1:]]
        net.fit(x, y)
        jnet.fit(x, y)
    _assert_same_calls(rec.calls, jrec.calls)
    assert [c[:3] for c in rec.calls] == [("it", 3, 0), ("end", 1),
                                          ("it", 6, 1), ("end", 2)]


def _graph_pair(sync_every):
    gb = (NeuralNetConfiguration.builder().seed(4).updater(jupd.Sgd(0.1))
          .sync_every(sync_every).graph_builder().add_inputs("in"))
    gb.add_layer("d", DenseLayer(n_out=6, activation="tanh"), "in")
    gb.add_layer("out", OutputLayer(n_in=6, n_out=3), "d")
    conf = gb.set_outputs("out").set_input_types(
        InputType.feed_forward(4)).build()
    jnet = JGraph(conf).init()
    net = TGraph(TGConf.from_json(conf.to_json())).init(device="cpu")
    interop.load_reference(net, _tree(jnet.params), _tree(jnet.states),
                           _tree(jnet.opt_states))
    return jnet, net


@pytest.mark.parametrize("sync_every", [1, 3])
def test_graph_listener_calls_match_reference(sync_every):
    jnet, net = _graph_pair(sync_every)
    x, y = _data(17, seed=6)
    rec, jrec = _Recorder(), _Recorder()
    net.set_listeners(rec)
    jnet.set_listeners(jrec)
    net.fit(ArrayDataSetIterator(x, y, batch=4, shuffle=True), epochs=2)
    jnet.fit(JArrayIter(x, y, batch=4, shuffle=True), epochs=2)
    _assert_same_calls(rec.calls, jrec.calls)
    assert len(rec.calls) == 12
    ev, jev = net.evaluate(ArrayDataSetIterator(x, y, batch=8)), \
        jnet.evaluate(JArrayIter(x, y, batch=8))
    np.testing.assert_array_equal(ev.confusion_matrix(),
                                  jev.confusion_matrix())


def test_stock_listeners_log_and_collect_as_reference():
    """ScoreIterationListener's lines (scores to six decimals),
    CollectScoresListener's pairs, PerformanceListener's iterations and
    EvaluativeListener's accuracy lines, over one epoch of 7 iterations at
    sync_every 4."""
    logs = {}

    def listeners(pkg, ev_iter):
        out = {k: [] for k in ("score", "perf", "eval")}
        logs[pkg.__name__] = out
        return [pkg.ScoreIterationListener(2, log_fn=out["score"].append),
                pkg.CollectScoresListener(3),
                pkg.PerformanceListener(2, log_fn=out["perf"].append),
                pkg.EvaluativeListener(ev_iter, 4, log_fn=out["eval"].append)]

    jnet, net = _mln_pair(4)
    x, y = _data(33, seed=7)
    mine = listeners(tl, ArrayDataSetIterator(x, y, batch=16))
    ref = listeners(jl, JArrayIter(x, y, batch=16))
    net.set_listeners(*mine)
    jnet.set_listeners(*ref)
    net.fit(ArrayDataSetIterator(x, y, batch=5))
    jnet.fit(JArrayIter(x, y, batch=5))
    a, b = logs[tl.__name__], logs[jl.__name__]
    assert len(a["score"]) == len(b["score"]) == 3
    for la, lb in zip(a["score"], b["score"]):
        assert la.split(" is ")[0] == lb.split(" is ")[0]
        np.testing.assert_allclose(float(la.split(" is ")[1]),
                                   float(lb.split(" is ")[1]), rtol=RTOL)
    assert [s[0] for s in mine[1].scores] == [s[0] for s in ref[1].scores] \
        == [3, 6]
    np.testing.assert_allclose([s[1] for s in mine[1].scores],
                               [s[1] for s in ref[1].scores], rtol=RTOL)
    assert [ln.split(":")[0] for ln in a["perf"]] == \
        [ln.split(":")[0] for ln in b["perf"]]
    assert a["eval"] == b["eval"] and len(a["eval"]) == 1
