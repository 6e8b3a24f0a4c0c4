"""The port's elastic runtime (``parallel/elastic.py``) on the CPU, held to
the reference's contracts (its ``tests/test_elastic.py`` and
``tests/test_serving_resilience.py`` publish cases):

- against the reference's ``ElasticTrainer`` run on the same network (a
  MultiLayerNetwork, a ComputationGraph, a PipelinedTrainer on a
  one-device mesh) and the same batches: a SIGTERM drain and its resume,
  and an ``inject_nan`` rollback, end with the same state (params,
  optimizer states within RTOL 1e-4 / FLOOR 1e-6), iteration, epoch,
  ``resumed_from`` and ``rollbacks``;

- ``FileMembership``: two members agree on a view; a member whose
  heartbeats drop is evicted at the next regroup;
- SIGTERM drain, then resume in a fresh network, bit-identical to an
  uninterrupted run (params, optimizer states, the dropout generator) for
  a MultiLayerNetwork, a ComputationGraph, a TBPTT stack, a bucketed
  stack, a compressed ParallelWrapper and a PipelinedTrainer;
- ``inject_nan`` rolls back and completes bit-identical to a clean run
  (also under a coalesced listener window, with integer features, and
  under a PipelinedTrainer), and an exhausted rollback budget fails
  loudly;
- the two-process SIGKILL runs, plain, compressed, pipelined and a
  pipelined BERT given by its conf JSON (the card's leg, narrow), as CPU
  subprocesses with no collective (each member steps its own replica, as
  the reference's do), each under its own timeout: the killed member
  exits -9, the survivor regroups to world 1 and finishes;
- ``/healthz``'s ``elastic`` section and the scrape-time gauges;
  ``publish_archive`` followed by a ``ModelRouter.watch`` that serves the
  trained weights; ``bootstrap_elastic`` without a coordinator.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from deeplearning4j_tpu import parallel as JP  # noqa: E402
from deeplearning4j_tpu.data import \
    ArrayDataSetIterator as JArrayDataSetIterator  # noqa: E402
from deeplearning4j_tpu.nn import ComputationGraph as JCG  # noqa: E402
from deeplearning4j_tpu.nn import MultiLayerNetwork as JMLN  # noqa: E402
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNNC  # noqa: E402
from deeplearning4j_tpu.nn import layers as JL  # noqa: E402
from deeplearning4j_tpu.nn.listeners import \
    TrainingListener as JTrainingListener  # noqa: E402
from deeplearning4j_tpu.nn.updaters import Adam as JAdam  # noqa: E402
from deeplearning4j_tpu.util import faults as JF  # noqa: E402
from deeplearning4j_tpu.util import telemetry as jtm  # noqa: E402
from deeplearning4j_tpu_torch import interop  # noqa: E402
from deeplearning4j_tpu_torch.data import ArrayDataSetIterator  # noqa: E402
from deeplearning4j_tpu_torch.data.dataset import DataSet  # noqa: E402
from deeplearning4j_tpu_torch.nn import (InputType,  # noqa: E402
                                         MultiLayerNetwork,
                                         NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.computation_graph import \
    ComputationGraph  # noqa: E402
from deeplearning4j_tpu_torch.nn.layers import (DenseLayer,  # noqa: E402
                                                EmbeddingLayer, OutputLayer)
from deeplearning4j_tpu_torch.nn.listeners import \
    TrainingListener  # noqa: E402
from deeplearning4j_tpu_torch.nn.recurrent import (LSTM,  # noqa: E402
                                                   RnnOutputLayer)
from deeplearning4j_tpu_torch.parallel import (  # noqa: E402
    ElasticTrainer, FileMembership, ParallelWrapper, PipelinedTrainer,
    bootstrap_elastic)
from deeplearning4j_tpu_torch.nn.transformer import \
    TimeStepLayer  # noqa: E402
from deeplearning4j_tpu_torch.parallel import elastic as EL  # noqa: E402
from deeplearning4j_tpu_torch.tree import tree_leaves  # noqa: E402
from deeplearning4j_tpu_torch.util import telemetry as tm  # noqa: E402
from deeplearning4j_tpu_torch.util.faults import (  # noqa: E402
    DROP_HEARTBEAT, INJECT_NAN, FaultInjector, get_injector)

ADAM = {"@updater": "Adam", "learning_rate": 1e-2}
HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_torch_elastic_worker.py")
WORKER_TIMEOUT_S = 120
RTOL, FLOOR = 1e-4, 1e-6


@pytest.fixture(autouse=True)
def _clean_injector():
    get_injector().clear()
    JF.get_injector().clear()
    yield
    get_injector().clear()
    JF.get_injector().clear()
    # NaN legs flip training.* checks in the process-wide registries (the
    # port's and the reference's): put them back, so a later /healthz in
    # this process answers 200
    for t in (tm, jtm):
        _ok, checks = t.get_telemetry().health_report()
        for name, c in checks.items():
            if name.startswith("training.") and not c.get("ok"):
                t.set_health(name, True, "test cleanup (elastic NaN leg)")


def _counter(name):
    return tm.get_telemetry().counter_total(name)


def _mln(seed=0, buckets=None, tbptt=0, recurrent=False, sync_every=1,
         pipe=False, comp=None, ids=False):
    b = NeuralNetConfiguration.builder().seed(seed).updater(ADAM)
    if buckets is not None:
        b = b.batch_buckets(buckets)
    if tbptt:
        b = b.tbptt_length(tbptt)
    if sync_every > 1:
        b = b.sync_every(sync_every)
    if comp:
        b = b.grad_compression(comp, threshold=1e-3)
    if pipe:
        b = b.pipe_stages(2).n_micro(2)
    lb = b.list()
    if recurrent:
        conf = (lb.layer(LSTM(n_in=6, n_out=8))
                .layer(RnnOutputLayer(n_in=8, n_out=3))
                .set_input_type(InputType.recurrent(6, 12)).build())
    elif ids:
        conf = (lb.layer(EmbeddingLayer(n_in=4, n_out=8))
                .layer(TimeStepLayer(index=0))
                .layer(OutputLayer(n_in=8, n_out=2))
                .set_input_type(InputType.feed_forward(1)).build())
    elif pipe:
        conf = (lb.layer(DenseLayer(n_in=4, n_out=8, activation="relu"))
                .stage_boundary()
                .layer(DenseLayer(n_in=8, n_out=8, activation="tanh"))
                .stage_boundary()
                .layer(DenseLayer(n_in=8, n_out=8, activation="tanh"))
                .stage_boundary()
                .layer(OutputLayer(n_in=8, n_out=2))
                .set_input_type(InputType.feed_forward(4)).build())
    else:
        conf = (lb.layer(DenseLayer(n_in=4, n_out=8, activation="relu"))
                .layer(OutputLayer(n_in=8, n_out=2))
                .set_input_type(InputType.feed_forward(4)).build())
    return MultiLayerNetwork(conf).init(device="cpu")


def _cg(seed=3):
    g = (NeuralNetConfiguration.builder().seed(seed).updater(ADAM)
         .graph_builder().add_inputs("in")
         .add_layer("d1", DenseLayer(n_in=4, n_out=6, activation="tanh"), "in")
         .add_layer("d2", DenseLayer(n_in=4, n_out=6, activation="relu"), "in")
         .add_layer("out", OutputLayer(n_in=12, n_out=2), "d1", "d2")
         .set_outputs("out").set_input_types((4,)).build())
    return ComputationGraph(g).init(device="cpu")


def _dense_iter(batch=8, n=32, f=4, c=2, seed=0, ids=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, f)).astype(np.float32)
    if ids:  # token ids, one a row
        x = rng.integers(0, 4, (n, 1)).astype(np.int64)
    y = np.eye(c, dtype=np.float32)[rng.integers(0, c, n)]
    return lambda: ArrayDataSetIterator(x, y, batch=batch)


class _SigtermAt(TrainingListener):
    """A real SIGTERM to this process after iteration k: what a preemption
    notice does."""

    def __init__(self, at_iteration):
        self.at_iteration = at_iteration

    def iteration_done(self, model, iteration, epoch):
        if iteration == self.at_iteration:
            os.kill(os.getpid(), signal.SIGTERM)


def _equal_state(a, b):
    for name in ("params", "states", "opt_states"):
        la, lb = tree_leaves(getattr(a, name)), tree_leaves(getattr(b, name))
        assert len(la) == len(lb), name
        assert all(torch.equal(x, y) for x, y in zip(la, lb)), name
    assert torch.equal(a._gen.get_state(), b._gen.get_state())
    assert (a.iteration, a.epoch) == (b.iteration, b.epoch)


def _wrap(kind, net):
    if kind == "compress":
        return ParallelWrapper(net, replicas=2, skew_every=0)
    if kind == "pipe":
        return PipelinedTrainer(net, replicas=2, skew_every=0)
    return net


def _fit_plain(model, data, epochs):
    """A network's or a wrapper's own ``fit``, unsupervised (a pipelined
    trainer's state then synced back to its network)."""
    model.fit(data, epochs=epochs)
    if hasattr(model, "sync_model"):
        model.sync_model()


# ---------------------------------------------------------------- membership


def test_two_members_agree_and_a_dropped_heartbeat_shrinks_the_world(
        tmp_path):
    d = str(tmp_path / "members")
    b_injector = FaultInjector()
    b_injector.clear()
    a = FileMembership(d, process_id=0, world_size=2,
                       heartbeat_interval=0.05, miss_threshold=3,
                       barrier_timeout=20.0, log_fn=None)
    b = FileMembership(d, process_id=1, world_size=2,
                       heartbeat_interval=0.05, miss_threshold=3,
                       barrier_timeout=20.0, injector=b_injector,
                       log_fn=None)
    a.start()
    b.start()
    try:
        views = {}
        tb = threading.Thread(target=lambda: views.setdefault(1,
                                                              b.regroup(0)))
        tb.start()
        views[0] = a.regroup(0)
        tb.join(timeout=20)
        assert views[0].world == views[1].world == 2
        assert (views[0].rank, views[1].rank) == (0, 1)
        assert views[1].owns_batch(3) and not views[1].owns_batch(2)
        before = _counter("elastic.heartbeats_dropped_total")
        b_injector.inject(DROP_HEARTBEAT, arg=1000)
        deadline = time.monotonic() + 10
        while (_counter("elastic.heartbeats_dropped_total") <= before
               and time.monotonic() < deadline):
            time.sleep(0.02)
        time.sleep(0.05 * 5)  # past the freshness window
        view = a.regroup(1)
        assert view.world == 1 and view.members == (0,)
        assert a.regroups == 1 and a.status()["world"] == 1
    finally:
        a.stop()
        b.stop()


def test_bootstrap_without_coordinator_is_membership_only(tmp_path):
    m = bootstrap_elastic(str(tmp_path / "m"), process_id=0,
                          num_processes=1, heartbeat_interval=0.1)
    assert isinstance(m, FileMembership) and m.world_size == 1
    m.start()
    try:
        assert m.regroup(0).world == 1
    finally:
        m.stop()


# ------------------------------------------------------- drain and resume


def _drain_and_resume(build, data, tmp_path, kind="net", epochs=3,
                      kill_at=5, checkpoint_every=2):
    """fit() cut by a real SIGTERM at step ``kill_at`` and resumed from its
    checkpoint in a fresh network ends bit-identical to an uninterrupted
    run of the same steps."""
    ref = build()
    _fit_plain(_wrap(kind, ref), data(), epochs)
    net = build()
    net.listeners.append(_SigtermAt(kill_at))
    t1 = ElasticTrainer(_wrap(kind, net), str(tmp_path / "ck"),
                        checkpoint_every=checkpoint_every, log_fn=None)
    t1.fit(data(), epochs=epochs)
    assert t1.drained and t1.state == "drained"
    assert net.iteration == kill_at == t1.ckpt.latest_step()
    net2 = build()
    t2 = ElasticTrainer(_wrap(kind, net2), str(tmp_path / "ck"),
                        checkpoint_every=checkpoint_every, log_fn=None)
    t2.fit(data(), epochs=epochs)
    assert t2.resumed_from == kill_at and t2.state == "completed"
    _equal_state(net2, ref)


@pytest.mark.parametrize("case", ["mln", "cg", "tbptt", "bucketed",
                                  "compress", "pipe"])
def test_sigterm_resume_bit_identical(case, tmp_path):
    if case == "mln":
        _drain_and_resume(_mln, _dense_iter(), tmp_path)
    elif case == "cg":
        _drain_and_resume(_cg, _dense_iter(), tmp_path)
    elif case == "tbptt":
        def data():
            rng = np.random.default_rng(1)
            x = rng.standard_normal((8, 12, 6)).astype(np.float32)
            y = rng.standard_normal((8, 12, 3)).astype(np.float32)
            return ArrayDataSetIterator(x, y, batch=4)

        # tbptt 4 over T 12: 3 segments (iterations) a batch
        _drain_and_resume(lambda: _mln(seed=5, tbptt=4, recurrent=True),
                          data, tmp_path, epochs=2, kill_at=6,
                          checkpoint_every=3)
    elif case == "bucketed":
        def data():
            rng = np.random.default_rng(2)
            x = rng.standard_normal((21, 4)).astype(np.float32)
            y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 21)]
            return ArrayDataSetIterator(x, y, batch=6)

        _drain_and_resume(lambda: _mln(seed=6, buckets=(8,)), data,
                          tmp_path)
    else:
        _drain_and_resume(lambda: _mln(seed=8, comp="threshold")
                          if case == "compress" else _mln(seed=8, pipe=True),
                          _dense_iter(), tmp_path, kind=case)


def test_sigterm_drains_gracefully(tmp_path):
    net = _mln()
    net.listeners.append(_SigtermAt(4))
    before = _counter("elastic.drains_total")
    tr = ElasticTrainer(net, str(tmp_path / "ck"), checkpoint_every=10,
                        log_fn=None)
    tr.fit(_dense_iter()(), epochs=3)
    assert tr.drained and tr.state == "drained"
    assert net.iteration == 4 == tr.ckpt.latest_step()
    assert _counter("elastic.drains_total") == before + 1
    _ok, checks = tm.get_telemetry().health_report()
    assert checks["elastic.drained"]["ok"]


# ---------------------------------------------------------------- rollback


@pytest.mark.parametrize("case", ["mln", "coalesced", "ids", "pipe"])
def test_inject_nan_rolls_back_and_completes(case, tmp_path):
    build = {"mln": _mln, "ids": lambda: _mln(ids=True),
             "coalesced": lambda: _mln(seed=4, sync_every=3),
             "pipe": lambda: _mln(seed=9, pipe=True)}[case]
    kind = "pipe" if case == "pipe" else "net"
    data = _dense_iter(ids=case == "ids")
    ref = build()
    _fit_plain(_wrap(kind, ref), data(), 3)
    net = build()
    get_injector().inject(INJECT_NAN, at_step=6)
    before = _counter("elastic.rollbacks_total")
    tr = ElasticTrainer(_wrap(kind, net), str(tmp_path / "ck"),
                        checkpoint_every=3 if case != "coalesced" else 4,
                        log_fn=None)
    tr.fit(data(), epochs=3)
    assert tr.rollbacks == 1 and tr.state == "completed"
    assert _counter("elastic.rollbacks_total") == before + 1
    # the poisoned step was rolled back and replayed clean
    _equal_state(net, ref)


def test_poison_takes_labels_when_features_are_ids():
    x = np.arange(8, dtype=np.int64).reshape(2, 4)
    y = np.eye(2, dtype=np.float32)
    bad = ElasticTrainer._poison(DataSet(x, y))
    assert np.array_equal(bad.features, x) and np.isnan(bad.labels).all()
    bad = ElasticTrainer._poison(DataSet(x.astype(np.float32), y))
    assert np.isnan(bad.features).all() and np.array_equal(bad.labels, y)
    bad = ElasticTrainer._poison(DataSet(torch.from_numpy(x),
                                         torch.from_numpy(y)))
    assert torch.isnan(bad.labels).all()


def test_rollback_budget_exhausts_loudly(tmp_path):
    net = _mln()
    get_injector().inject(INJECT_NAN, at_step=2, count=-1)  # every step
    tr = ElasticTrainer(net, str(tmp_path / "ck"), checkpoint_every=2,
                        max_rollbacks=2, log_fn=None)
    with pytest.raises(RuntimeError, match="rollback budget exhausted"):
        tr.fit(_dense_iter()(), epochs=2)
    assert tr.rollbacks == 2 and tr.state == "failed"


# ------------------------------------------------- against the reference


class _JSigtermAt(JTrainingListener):
    """:class:`_SigtermAt` for a reference network."""

    def __init__(self, at_iteration):
        self.at_iteration = at_iteration

    def iteration_done(self, model, iteration, epoch):
        if iteration == self.at_iteration:
            os.kill(os.getpid(), signal.SIGTERM)


def _ref_net(case):
    """The reference network of ``case`` (the shapes of ``_mln``, ``_cg``
    and ``_mln(pipe=True)``)."""
    b = JNNC.builder().seed({"mln": 0, "cg": 3, "pipe": 9}[case]) \
        .updater(JAdam(1e-2))
    if case == "cg":
        g = (b.graph_builder().add_inputs("in")
             .add_layer("d1", JL.DenseLayer(n_in=4, n_out=6,
                                            activation="tanh"), "in")
             .add_layer("d2", JL.DenseLayer(n_in=4, n_out=6,
                                            activation="relu"), "in")
             .add_layer("out", JL.OutputLayer(n_in=12, n_out=2), "d1", "d2")
             .set_outputs("out").set_input_types((4,)).build())
        return JCG(g).init()
    if case == "pipe":
        lb = (b.pipe_stages(2).n_micro(2).list()
              .layer(JL.DenseLayer(n_in=4, n_out=8, activation="relu"))
              .stage_boundary()
              .layer(JL.DenseLayer(n_in=8, n_out=8, activation="tanh"))
              .stage_boundary()
              .layer(JL.DenseLayer(n_in=8, n_out=8, activation="tanh"))
              .stage_boundary())
    else:
        lb = b.list().layer(JL.DenseLayer(n_in=4, n_out=8,
                                          activation="relu"))
    conf = (lb.layer(JL.OutputLayer(n_in=8, n_out=2))
            .set_input_type(InputType.feed_forward(4)).build())
    return JMLN(conf).init()


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        return [i for k in sorted(tree, key=str)
                for i in _leaves(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [i for n, v in enumerate(tree)
                for i in _leaves(v, prefix + (n,))]
    a = tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) \
        else np.asarray(tree)
    return [(prefix, a)]


def _close(j, t, what):
    ji, ti = _leaves(j), _leaves(t)
    assert [p for p, _ in ji] == [p for p, _ in ti], what
    for (p, a), (_, b) in zip(ji, ti):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=FLOOR,
                                   err_msg=f"{what} {p}")


def _both_runs(case, fault, tmp_path):
    """The same supervised run under the reference's ElasticTrainer and
    the port's, from the same initial state over the same batches:
    ``drain`` (SIGTERM after step 5, then a resume in a fresh network) or
    ``nan`` (``inject_nan`` at step 6, rolled back to the step-3
    checkpoint). Returns the two final trainers and networks."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 32)]
    runs = {}
    for side in ("ref", "port"):
        if side == "ref":
            Elastic, Pipe, Iter, inj = (JP.ElasticTrainer,
                                        JP.PipelinedTrainer,
                                        JArrayDataSetIterator,
                                        JF.get_injector())
            build, nan, sig = _ref_net, JF.INJECT_NAN, _JSigtermAt
            pipe_kw = {"mesh": JP.TrainingMesh(data=1,
                                               devices=jax.devices()[:1])}
        else:
            Elastic, Pipe, Iter, inj = (ElasticTrainer, PipelinedTrainer,
                                        ArrayDataSetIterator, get_injector())
            nan, sig, pipe_kw = INJECT_NAN, _SigtermAt, {}

            def build(c):
                j = _ref_net(c)
                return interop.from_reference_json(
                    j.conf.to_json(), _np_tree(j.params),
                    _np_tree(j.states), device="cpu")

        def wrap(net):
            return (Pipe(net, replicas=2, skew_every=0, **pipe_kw)
                    if case == "pipe" else net)

        d = str(tmp_path / side)
        net = build(case)
        if fault == "drain":
            net.listeners.append(sig(5))
            t1 = Elastic(wrap(net), d, checkpoint_every=2, log_fn=None)
            t1.fit(Iter(x, y, batch=8), epochs=3)
            assert t1.drained and net.iteration == 5, side
            net = build(case)
        else:
            inj.inject(nan, at_step=6)
        model = wrap(net)
        tr = Elastic(model, d, checkpoint_every=2 if fault == "drain" else 3,
                     log_fn=None)
        tr.fit(Iter(x, y, batch=8), epochs=3)
        inj.clear()
        if case == "pipe":
            model.sync_model()
        runs[side] = (tr, net)
    return runs["ref"], runs["port"]


@pytest.mark.parametrize("fault", ["drain", "nan"])
@pytest.mark.parametrize("case", ["mln", "cg", "pipe"])
def test_elastic_run_follows_the_reference(case, fault, tmp_path):
    (jt, j), (tt, t) = _both_runs(case, fault, tmp_path)
    assert tt.state == jt.state == "completed"
    assert (tt.resumed_from, tt.rollbacks) == (jt.resumed_from,
                                               jt.rollbacks)
    assert tt.resumed_from == (5 if fault == "drain" else None)
    assert tt.rollbacks == (1 if fault == "nan" else 0)
    assert (t.iteration, t.epoch) == (j.iteration, j.epoch) == (12, 3)
    _close(j.params, t.params, f"{case} {fault} params")
    _close(j.opt_states, t.opt_states, f"{case} {fault} opt_states")


# ------------------------------------------------- two processes, SIGKILL


def _write_pipelined_bert(d):
    """The worker's ``conf`` mode input: a BERT of 4 blocks at hidden 32
    with stage marks after the embedding and blocks 2 and 4 (2 stages of
    2 blocks, 2 microbatches), dropout 0, and 4 batches of 8 token rows."""
    from deeplearning4j_tpu_torch.zoo import Bert

    base = Bert(vocab_size=97, hidden_size=32, n_layers=4, n_heads=2,
                max_length=16, hidden_dropout=0.0).conf()
    lb = (NeuralNetConfiguration.builder().seed(base.seed)
          .updater(base.updater).pipe_stages(2).n_micro(2).list())
    for i, lyr in enumerate(base.layers):
        lb.layer(lyr)
        if i in (0, 2, 4):
            lb.stage_boundary()
    os.makedirs(d)
    with open(os.path.join(d, "net.json"), "w") as f:
        f.write(lb.set_input_type(base.input_shape).build().to_json())
    rng = np.random.default_rng(5)
    x = np.stack([rng.integers(1, 97, (32, 16)),
                  (np.arange(16)[None, :] >= 8).repeat(32, 0)], axis=-1)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 32)]
    np.savez(os.path.join(d, "data.npz"), x=x.astype(np.int64), y=y,
             batch=8)


@pytest.mark.parametrize("mode", ["plain", "compress", "pipe", "conf"])
def test_sigkill_survivor_regroups_and_finishes(mode, tmp_path):
    """Two OS processes; member 1 SIGKILLs itself at step 2. The survivor
    sees its heartbeats stop, regroups to world 1 at the epoch boundary,
    takes every batch from then on and finishes; its final checkpoint
    restores what it holds bit for bit. ``conf``: a pipelined BERT written
    to the shared directory, as the card's leg runs BERT-base, eager."""
    # one intra-op thread a member: the members are tiny, and two
    # processes of a thread a core each crowd a loaded host
    env = dict(os.environ, PYTHONPATH=os.path.dirname(HERE),
               OMP_NUM_THREADS="1")
    d = str(tmp_path / "pod")
    if mode == "conf":
        _write_pipelined_bert(d)
    procs = [subprocess.Popen(
        [sys.executable, WORKER, mode, d, str(pid), "2",
         "2" if pid == 1 else "-", "cpu"]
        + (["eager"] if mode == "conf" else []),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        start_new_session=True) for pid in (0, 1)]
    try:
        out0, err0 = procs[0].communicate(timeout=WORKER_TIMEOUT_S)
        out1, _ = procs[1].communicate(timeout=WORKER_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    assert procs[1].returncode == -signal.SIGKILL
    assert not out1.strip()
    assert procs[0].returncode == 0, err0[-1500:]
    r = json.loads([ln for ln in out0.splitlines()
                    if ln.startswith("{")][-1])
    assert r["state"] == "completed"
    assert r["world_final"] == 1 and r["members_final"] == [0]
    assert r["regroups"] >= 1 and r["epoch"] == 3 and r["score_finite"]
    # 8 batches an epoch: 4 while sharded 2 ways, then all 8; ``conf``'s
    # 4 an epoch: member 1 dies in the second, so 2 + 2, then all 4
    assert r["iteration"] == (2 + 2 + 4 if mode == "conf" else 4 + 8 + 8)
    assert r["checkpoint_exact"]
    if mode == "compress":
        assert r["residual_exact"] and r["wire_bytes"] > 0
        assert r["threshold"] > 0
    if mode in ("pipe", "conf"):
        assert r["stacked_exact"] and r["pipe_stages"] == 2
        assert 0 < r["bubble_fraction"] < 1


# ---------------------------------------------------------------- surfaces


def test_healthz_has_the_elastic_section_and_gauges(tmp_path):
    from deeplearning4j_tpu_torch.util.ui_server import UIServer

    net = _mln()
    tr = ElasticTrainer(net, str(tmp_path / "ck"), checkpoint_every=50,
                        log_fn=None)
    tr.fit(_dense_iter()(), epochs=1)
    body, _ok = UIServer._healthz("cpu")
    section = json.loads(body).get("elastic", {})
    assert section, "healthz carries the elastic section"
    st = list(section.values())[-1]
    assert st["state"] == "completed"
    assert st["membership"]["world"] == 1
    assert st["last_checkpoint_step"] == net.iteration
    names = [n for n, _, _ in EL.collect_elastic_gauges()]
    assert "elastic.world_size" in names and "elastic.rollbacks" in names
    text = tm.install_default_collectors().prometheus_text()
    assert "dl4j_elastic_world_size" in text


def test_publish_archive_feeds_a_watching_router(tmp_path):
    """ElasticTrainer around a PipelinedTrainer publishes an archive at
    every checkpoint; a watching router reloads it and serves the trained
    weights."""
    from deeplearning4j_tpu_torch.serving import ModelRouter, ServingModel

    pub = str(tmp_path / "live.zip")
    serve_net = _mln(seed=4, pipe=True)
    router = ModelRouter(device="cpu", name="elastic-publish-test")
    model = ServingModel(serve_net, "cd")
    router.register(model, max_wait_ms=0.5)
    try:
        router.watch("cd", pub, interval_s=0.05)
        net = _mln(seed=3, pipe=True)
        pt = PipelinedTrainer(net, replicas=2, skew_every=0)
        before = _counter("elastic.publishes_total")
        tr = ElasticTrainer(pt, str(tmp_path / "ck"), checkpoint_every=2,
                            rollback_on_anomaly=False, publish_archive=pub,
                            log_fn=None)
        tr.fit(_dense_iter()(), epochs=2)
        assert _counter("elastic.publishes_total") > before
        assert not any(t.name == "elastic-publish"
                       for t in threading.enumerate())
        x = np.random.default_rng(1).standard_normal((2, 4)).astype(
            np.float32)
        want = net.output(torch.from_numpy(x)).numpy()
        deadline = time.time() + 20
        got = None
        while time.time() < deadline:
            got = np.asarray(router.submit("cd", x).result(timeout=30))
            if np.array_equal(got, want):
                break
            time.sleep(0.05)
        assert model.version > 1
        assert np.array_equal(got, want)
    finally:
        router.shutdown()


def test_async_checkpoint_and_snapshot_keep_their_step(tmp_path):
    """A CPU network's async checkpoint and publish snapshot hold the
    values of the step they were taken at, though the next step updates
    the tensors in place before the commit thread writes them (a fault
    once: the host copy was a view of the live CPU tensor)."""
    from deeplearning4j_tpu_torch.util.checkpoint import ShardedCheckpointer
    from deeplearning4j_tpu_torch.util.model_serializer import \
        ModelSerializer

    net = _mln()
    want = [v.clone() for v in tree_leaves(net.params)]
    snap = ModelSerializer.snapshot(net)
    ck = ShardedCheckpointer(str(tmp_path / "ck"), log_fn=None)
    ck.save(0, net, block=False)
    with torch.no_grad():
        for v in tree_leaves(net.params):
            v.add_(1.0)
    ck.wait_until_finished()
    back = _mln(seed=1)
    ck.restore(back)
    assert all(torch.equal(a, b)
               for a, b in zip(want, tree_leaves(back.params)))
    assert all(np.array_equal(a.numpy(), b) for a, b in zip(
        want, [l for p in snap["params"] for l in p.values()]))
