"""The compiled-program layer (``nn/capture.py``) on the CPU: each network's
train step, TBPTT segment step and forward as a program per shape
signature, against the same network run under ``capture.disabled()``.

On the CPU a program captures nothing: it copies each batch into its
static buffers and runs the same body on them, so everything but the graph
itself is exercised here. Each case runs 4 steps from one state both ways
and holds the params, layer states, optimizer states and losses equal bit
for bit; with dropout off it also holds them within 1e-4 relative of the
reference's ``fit`` (the trajectory convention, an absolute floor of 1e-6
near 0). The cases: a MultiLayerNetwork with Adam under a step schedule,
BatchNormalization and dropout; a two-input graph with per-input masks;
TBPTT with a ragged last segment, on both networks; ``sync_every`` 4, where
each listener call must see its own step's loss. Then: every entry that
rebinds the params drops the programs (``init``, the ``interop`` loaders,
the transfer builder, early stopping's snapshots); ``export_dir`` saves
the programs' entries in an AOT store and a fresh network builds the same
programs from them (ROADMAP item 12b). The card legs are in
``tests/test_torch_cuda.py``.
"""

import contextlib
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet  # noqa: E402
from deeplearning4j_tpu.data.dataset import (  # noqa: E402
    MultiDataSet as JMultiDataSet)
from deeplearning4j_tpu.nn import layers as JL  # noqa: E402
from deeplearning4j_tpu.nn import updaters as jupd  # noqa: E402
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC  # noqa: E402,E501
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JMLN)
from deeplearning4j_tpu_torch import earlystopping as es  # noqa: E402
from deeplearning4j_tpu_torch import interop  # noqa: E402
from deeplearning4j_tpu_torch.data import DataSet, MultiDataSet  # noqa: E402
from deeplearning4j_tpu_torch.nn import MultiLayerNetwork, capture  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration as TConf)
from deeplearning4j_tpu_torch.nn.listeners import (  # noqa: E402
    CollectScoresListener)
from deeplearning4j_tpu_torch.nn.transfer import (  # noqa: E402
    FineTuneConfiguration, TransferLearning)
from deeplearning4j_tpu_torch.tree import tree_items  # noqa: E402
from deeplearning4j_tpu_torch.util import get_watcher  # noqa: E402
import test_torch_char_rnn as char_rnn  # noqa: E402
import test_torch_listeners as listeners  # noqa: E402
import test_torch_seq_graph as seq_graph  # noqa: E402

RTOL, ATOL = 1e-4, 1e-6
STEPS = 4


def _tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _leaves(net):
    """(path, tensor) of the params, layer states and optimizer states."""
    return tree_items({"params": net.params, "states": net.states,
                       "opt": net.opt_states})


def _assert_bit_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert torch.equal(x, y), path
    assert a.iteration == b.iteration


def _assert_near_reference(net, jnet):
    ref = _tree({"params": jnet.params, "states": jnet.states})
    mine = {"params": net.params, "states": net.states}
    ref_items = dict(tree_items(ref))
    for path, v in tree_items(mine):
        np.testing.assert_allclose(v.numpy(), ref_items[path], rtol=RTOL,
                                   atol=ATOL, err_msg=str(path))


def _run_both(make, batches, fit=lambda n, b: n.fit(b)):
    """Two nets from ``make()``: the program path and the eager one, the
    same batches; returns them and their per-step losses."""
    prog, eager = make(), make()
    lp, le = [], []
    for b in batches:
        fit(prog, b)
        lp.append(prog.score_value)
        with capture.disabled():
            fit(eager, b)
        le.append(eager.score_value)
    for a, b in zip(lp, le):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    _assert_bit_equal(prog, eager)
    return prog, eager, lp


# ------------------------------------------------ a MultiLayerNetwork step
_STEP = {"@schedule": "StepSchedule", "initial_value": 1e-2,
         "decay_rate": 0.5, "step": 2}


def _mln_conf(dropout):
    return (JNNC.builder().seed(6).updater(jupd.updater_from_dict(
        {"@updater": "Adam", "learning_rate": _STEP, "epsilon": 1e-3}))
        .list()
        .layer(JL.DenseLayer(n_in=4, n_out=8, activation="tanh"))
        .layer(JL.BatchNormalization())
        .layer(JL.DenseLayer(n_in=8, n_out=6, activation="relu",
                             dropout=dropout))
        .layer(JL.OutputLayer(n_in=6, n_out=3))
        .set_input_type((4,)).build())


def _mln_batches(n=STEPS):
    rng = np.random.default_rng(11)
    return [(rng.normal(size=(8, 4)).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)])
            for _ in range(n)]


@pytest.mark.parametrize("dropout", [0.0, 0.3], ids=["nodrop", "dropout"])
def test_mln_program_equals_eager_and_reference(dropout):
    """Adam under a step schedule (the step sizes change every 2
    iterations), batchnorm's running statistics, dropout from the net's
    generator: the program path equals the eager path bit for bit; without
    dropout both follow the reference's trajectory."""
    jnet = JMLN(_mln_conf(dropout)).init()
    conf = jnet.conf.to_json()

    def make():
        return interop.from_reference_json(conf, _tree(jnet.params),
                                           _tree(jnet.states), device="cpu")

    batches = _mln_batches()
    prog, _, losses = _run_both(make, batches,
                                lambda n, b: n.fit(b[0], b[1]))
    assert len(prog._aot_steps) == 1
    assert not torch.equal(prog.states[1]["mean"],
                           make().states[1]["mean"])
    if dropout:
        return
    for (x, y), loss in zip(batches, losses):
        jnet.fit(x, y)
        np.testing.assert_allclose(float(loss), float(jnet.score_value),
                                   rtol=RTOL)
    _assert_near_reference(prog, jnet)


# ------------------------------------------- a graph with per-input masks
def _two_input_batches():
    B, T, F, F2, C = (seq_graph.B, seq_graph.T, seq_graph.F, seq_graph.F2,
                      seq_graph.C)
    out = []
    for s in range(STEPS):
        rng = np.random.default_rng(40 + s)
        xa = rng.normal(size=(B, T, F)).astype(np.float32)
        xb = rng.normal(size=(B, T, F2)).astype(np.float32)
        y = np.eye(C, dtype=np.float32)[rng.integers(0, C, size=(B, T))]
        ma, mb = seq_graph._mask(B, T, 50 + s), seq_graph._mask(B, T, 60 + s)
        out.append(([xa, xb], [y], [ma, mb], [ma * mb]))
    return out


def test_graph_with_per_input_masks_program_equals_eager_and_reference():
    jconf = seq_graph._two_input_conf()
    jnet, _ = seq_graph._pair(jconf)
    batches = _two_input_batches()
    prog, _, losses = _run_both(lambda: seq_graph._pair(jconf)[1],
                                [MultiDataSet(*b) for b in batches])
    sig = next(iter(prog._aot_steps))
    assert dict(sig[3]).keys() == {"a", "b"}  # the mask dict's signature
    for b, loss in zip(batches, losses):
        jnet.fit(JMultiDataSet(*b))
        np.testing.assert_allclose(float(loss), float(jnet.score_value),
                                   rtol=RTOL)
    _assert_near_reference(prog, jnet)
    x = [batches[0][0][0], batches[0][0][1]]
    with capture.disabled():
        want = prog.output(*x)
    np.testing.assert_array_equal(prog.output(*x).numpy(), want.numpy())


# ---------------------------------------------------- TBPTT, ragged tail
def test_mln_tbptt_ragged_tail_program_equals_eager_and_reference():
    """T 10 at k 4: segments of 4, 4 and 2, the last a program of its own;
    the carries flow through the programs' static buffers."""
    jnet, _ = char_rnn._pair(tbptt=4)

    def make():
        return char_rnn._pair(tbptt=4)[1]

    batches = [char_rnn._batch(3, 10, s) for s in range(2)]
    prog, _, losses = _run_both(make, batches,
                                lambda n, b: n.fit(b[0], b[1]))
    assert prog.iteration == 6 and len(prog._tbptt_steps) == 2
    for (x, y), loss in zip(batches, losses):
        jnet.fit(x, y)
        np.testing.assert_allclose(float(loss), float(jnet.score_value),
                                   rtol=RTOL)
    _assert_near_reference(prog, jnet)


def test_graph_tbptt_ragged_tail_with_masks_program_equals_eager():
    jnet, _ = seq_graph._pair(seq_graph._seq_conf(tbptt=4))
    x, y = seq_graph._seq_batch(1)
    fm = seq_graph._mask(seq_graph.B, seq_graph.T, 2, lo=3)
    prog, _, losses = _run_both(
        lambda: seq_graph._pair(seq_graph._seq_conf(tbptt=4))[1],
        [DataSet(x, y, fm, fm)] * 2)
    assert len(prog._tbptt_steps) == 2
    for loss in losses:
        jnet.fit(JDataSet(x, y, fm, fm))
        np.testing.assert_allclose(float(loss), float(jnet.score_value),
                                   rtol=RTOL)
    _assert_near_reference(prog, jnet)


# --------------------------------------------------------- sync_every 4
def test_sync_every_window_sees_each_steps_own_loss():
    """A window of 4 queued losses: each is a copy of its step's, so the
    listener sees 8 different scores, the eager path's."""
    seen = {}
    for mode in ("program", "eager"):
        _, net = listeners._mln_pair(sync_every=4)
        collect = CollectScoresListener(1)
        net.set_listeners(collect)
        with (capture.disabled() if mode == "eager"
              else contextlib.nullcontext()):
            for s in range(8):
                net.fit(*listeners._data(6, s))
        net._dispatcher.flush()
        seen[mode] = collect.scores
    assert [i for i, _ in seen["program"]] == list(range(1, 9))
    assert seen["program"] == seen["eager"]
    assert len({s for _, s in seen["program"]}) == 8


# ------------------------------------------------ rebinding the params
def _fresh_output(conf_json, params, states, x):
    net = interop.from_reference_json(conf_json, params, states,
                                      device="cpu")
    with capture.disabled():
        return net.output(x).numpy()


def test_load_reference_after_fit_drops_the_programs():
    """After ``fit`` and ``output`` built programs, loading other params
    (the MLN and the graph loader) gives the output of a fresh net with
    those params."""
    jnet = JMLN(_mln_conf(0.0)).init()
    conf = jnet.conf.to_json()
    other = JMLN(_mln_conf(0.0)).init()
    other.fit(*_mln_batches(1)[0])
    x = _mln_batches(1)[0][0]
    net = interop.from_reference_json(conf, _tree(jnet.params),
                                      _tree(jnet.states), device="cpu")
    net.fit(*_mln_batches(1)[0])
    net.output(x)
    assert net._aot_steps and net._aot_forward
    interop.load_reference_mln(net, _tree(other.params), _tree(other.states))
    assert not net._aot_steps and not net._aot_forward
    np.testing.assert_array_equal(
        net.output(x).numpy(),
        _fresh_output(conf, _tree(other.params), _tree(other.states), x))

    jg, g = seq_graph._pair(seq_graph._seq_conf())
    xs, ys = seq_graph._seq_batch(3)
    g.fit(DataSet(xs, ys))
    g.output(xs)
    jother = type(jg)(jg.conf).init()
    interop.load_reference(g, _tree(jother.params), _tree(jother.states))
    assert not g._aot_steps and not g._aot_forward
    np.testing.assert_array_equal(
        g.output(xs).numpy(),
        _fresh_output(jg.conf.to_json(), _tree(jother.params),
                      _tree(jother.states), xs))


def test_init_transfer_and_early_stopping_drop_the_programs():
    """``init()`` again, the transfer builder and early stopping's
    snapshots bind new tensors: none keeps the source's programs."""
    jnet = JMLN(_mln_conf(0.0)).init()
    net = interop.from_reference_json(jnet.conf.to_json(),
                                      _tree(jnet.params), _tree(jnet.states),
                                      device="cpu")
    x, y = _mln_batches(1)[0]
    net.fit(x, y)
    net.output(x)
    built = net.programs()
    assert len(built) == 2
    new = (TransferLearning.Builder(net)
           .fine_tune_configuration(FineTuneConfiguration(seed=9))
           .set_feature_extractor(0).build())
    assert not new.programs()
    new.fit(x, y)
    assert net.programs() == built  # the source keeps its own
    snap = es._host_snapshot(net)
    assert not snap.programs() and snap._aot_steps is not net._aot_steps
    net.init(device="cpu")
    assert not net.programs()
    with capture.disabled():
        want = MultiLayerNetwork(net.conf).init(device="cpu").output(x)
    np.testing.assert_array_equal(net.output(x).numpy(), want.numpy())


# ----------------------------------------------------------- the rest
def test_disabled_builds_no_program():
    jnet = JMLN(_mln_conf(0.0)).init()
    net = interop.from_reference_json(jnet.conf.to_json(),
                                      _tree(jnet.params), _tree(jnet.states),
                                      device="cpu")
    with get_watcher().scope() as sc:
        with capture.disabled():
            net.fit(*_mln_batches(1)[0])
            net.output(_mln_batches(1)[0][0])
        assert sc.traces == 0 and not net.programs()
        net.fit(*_mln_batches(1)[0])
        assert sc.traces_of("MultiLayerNetwork.train_step") == 1
        assert sc.backend_compiles == 0  # nothing is captured on the CPU


def test_export_dir_raises_naming_item_12(tmp_path):
    """Item 12b ported: ``export_dir`` no longer raises. The first network
    saves one entry per program; a fresh one given the same directory and
    no shapes builds the same programs from the entries."""
    jnet = JMLN(_mln_conf(0.0)).init()
    conf_json = jnet.conf.to_json()
    net = MultiLayerNetwork(TConf.from_json(conf_json)).init(device="cpu")
    d = str(tmp_path / "aot")
    assert net.warmup([(4, 4)], export_dir=d) == 2
    warm = MultiLayerNetwork(TConf.from_json(conf_json)).init(device="cpu")
    assert warm.warmup(export_dir=d) == 2
    assert sorted(warm.programs()) == sorted(net.programs())
    _, g = seq_graph._pair(seq_graph._seq_conf())
    assert g.warmup([(2, seq_graph.T, seq_graph.F)],
                    export_dir=str(tmp_path / "aot_g")) == 2
    assert json.loads(net.conf.to_json()) == json.loads(conf_json)
