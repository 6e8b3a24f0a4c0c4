"""The port's ``PipelinedTrainer`` (``parallel/pipelined.py``) against the
JAX package's, on the CPU, and its own contracts.

Against the reference (its trainer on a one-device mesh, the same
``replicas``, ``pipe_stages`` and ``n_micro``; trajectories from the
reference's initialised params within RTOL 1e-4 / FLOOR 1e-6 of every
param, loss and optimizer moment, after every step):

- the dense chain of the reference's ``tests/test_pipeline_fit.py:47``
  (preamble, 2 stages of 2 layers, Adam, ragged 13-row batches in 2 lanes);
- the chain ComputationGraph (preamble ``embed``, stages ``b0``/``b1``);
- a BERT of 4 blocks at hidden 32 in 2 stages (embedding preamble, the
  TimeStep and pooler postamble), flash attention, dropout 0;
- the fused engine's trajectory against the reference's fused pipelined
  trainer.

Within the port: the pipelined step against the network's own step from
the same state; ``sync_model`` bit-exact (and the fused engine's state
through both layout conversions, a checkpoint resumed bit for bit);
compression at threshold 0 bit-equal to the uncompressed step, an active
threshold's residual carried by a checkpoint; remat through the stages
equal to no remat; a ragged batch equal to the same batch padded by hand
with 0 weights; an in-place external write adopted; ``reshard`` and
``warmup`` leaving the state as it was; bytes per device; the per-stage
cost rows.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from deeplearning4j_tpu import parallel as JP  # noqa: E402
from deeplearning4j_tpu.data import DataSet as JDS  # noqa: E402
from deeplearning4j_tpu.nn import ComputationGraph as JCG  # noqa: E402
from deeplearning4j_tpu.nn import InputType  # noqa: E402
from deeplearning4j_tpu.nn import MultiLayerNetwork as JMLN  # noqa: E402
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNNC  # noqa: E402
from deeplearning4j_tpu.nn import layers as JL  # noqa: E402
from deeplearning4j_tpu.nn.updaters import Adam  # noqa: E402
from deeplearning4j_tpu.zoo.bert import Bert as JBert  # noqa: E402
from deeplearning4j_tpu_torch import interop  # noqa: E402
from deeplearning4j_tpu_torch import parallel as TP  # noqa: E402
from deeplearning4j_tpu_torch.data.dataset import DataSet as TDS  # noqa: E402
from deeplearning4j_tpu_torch.parallel import gspmd as TG  # noqa: E402
from deeplearning4j_tpu_torch.tree import tree_leaves  # noqa: E402
from deeplearning4j_tpu_torch.util.checkpoint import \
    ShardedCheckpointer  # noqa: E402

RTOL, FLOOR = 1e-4, 1e-6
H = 16
STEPS = 4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(j):
    return interop.from_reference_json(j.conf.to_json(), _np(j.params),
                                       _np(j.states), device="cpu")


def _mesh1():
    return JP.TrainingMesh(data=1, devices=jax.devices()[:1])


def _items(tree, prefix=()):
    if isinstance(tree, dict):
        return [i for k in sorted(tree, key=str)
                for i in _items(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [i for n, v in enumerate(tree)
                for i in _items(v, prefix + (n,))]
    a = tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) \
        else np.asarray(tree)
    return [(prefix, a)]


def _close(j, t, what):
    ji, ti = _items(j), _items(t)
    assert [p for p, _ in ji] == [p for p, _ in ti], what
    for (p, a), (_, b) in zip(ji, ti):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=FLOOR,
                                   err_msg=f"{what} {p}")


def _equal(a, b, what):
    ai, bi = _items(a), _items(b)
    assert len(ai) == len(bi), what
    for (p, x), (_, y) in zip(ai, bi):
        assert x.shape == y.shape and np.array_equal(x, y), (what, p)


def _state(net):
    return {"p": net.params, "s": net.states, "o": net.opt_states}


def _dense(fused=False, comp=None, thresh=1e-3, remat=None, seed=7):
    b = JNNC.builder().seed(seed).updater(Adam(1e-2)).pipe_stages(2) \
        .n_micro(2)
    if fused:
        b = b.fused_update(True)
    if comp:
        b = b.grad_compression(comp, threshold=thresh)
    if remat:
        b = b.remat_policy(remat)
    lb = (b.list()
          .layer(JL.DenseLayer(n_in=8, n_out=H, activation="relu"))
          .stage_boundary()
          .layer(JL.DenseLayer(n_in=H, n_out=H, activation="tanh"))
          .layer(JL.DenseLayer(n_in=H, n_out=H, activation="relu"))
          .stage_boundary()
          .layer(JL.DenseLayer(n_in=H, n_out=H, activation="tanh"))
          .layer(JL.DenseLayer(n_in=H, n_out=H, activation="relu"))
          .stage_boundary()
          .layer(JL.OutputLayer(n_in=H, n_out=4, loss="mcxent",
                                activation="softmax"))
          .set_input_type(InputType.feed_forward(8)))
    return JMLN(lb.build()).init()


def _graph():
    g = (JNNC.builder().seed(5).updater(Adam(1e-2)).pipe_stages(2)
         .n_micro(2).graph_builder()
         .add_inputs("in")
         .add_layer("embed", JL.DenseLayer(n_in=8, n_out=H,
                                           activation="relu"), "in")
         .add_layer("b0", JL.DenseLayer(n_in=H, n_out=H, activation="tanh"),
                    "embed")
         .add_layer("b1", JL.DenseLayer(n_in=H, n_out=H, activation="tanh"),
                    "b0")
         .add_layer("out", JL.OutputLayer(n_in=H, n_out=4, loss="mcxent",
                                          activation="softmax"), "b1")
         .set_outputs("out").set_input_types((8,))
         .stage_boundary("embed", "b0", "b1"))
    return JCG(g.build()).init()


def _bert():
    """BERT of 4 blocks at hidden 32: stage marks after the embedding and
    after blocks 2 and 4 (embedding preamble, 2 stages of 2 blocks, the
    TimeStep and pooler postamble)."""
    conf = JBert(vocab_size=97, hidden_size=32, n_layers=4, n_heads=2,
                 max_length=16, hidden_dropout=0.0, flash=True,
                 updater=Adam(1e-3, epsilon=1e-3)).conf()
    conf.remat_stages = (1, 3, 5)
    conf.pipe_stages, conf.n_micro = 2, 2
    return JMLN(conf).init()


def _dense_data(seed=0, n=13):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 8)).astype(np.float32),
            np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)])


def _bert_data(seed=0, n=8):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(1, 97, (n, 16)),
                  (np.arange(16)[None, :] >= 8).repeat(n, 0)],
                 axis=-1).astype(np.float32)
    return x, np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)]


def _trajectory(make, data, replicas, what, steps=STEPS):
    j = make()
    t = _port(j)
    jp = JP.PipelinedTrainer(j, mesh=_mesh1(), replicas=replicas,
                             skew_every=0)
    tp = TP.PipelinedTrainer(t, replicas=replicas, skew_every=0)
    for s in range(steps):
        x, y = data(s)
        lj = float(jp.step_batch(JDS(x, y)))
        lt = float(tp.step_batch(TDS(x, y)))
        np.testing.assert_allclose(lt, lj, rtol=RTOL, atol=FLOOR,
                                   err_msg=f"{what} loss {s}")
        jp.sync_model()
        tp.sync_model()
        _close(j.params, t.params, f"{what} params {s}")
        _close(j.opt_states, t.opt_states, f"{what} opt_states {s}")
    assert t.iteration == j.iteration == steps
    return j, t, jp, tp


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


def test_dense_chain_trajectory_matches_reference():
    _, _, jp, tp = _trajectory(_dense, lambda s: _dense_data(s), 2,
                               "dense")
    assert tp.layout["pipeline"] == jp.layout["pipeline"]
    assert tp.bubble_fraction == jp.bubble_fraction == pytest.approx(1 / 3)


def test_graph_chain_trajectory_matches_reference():
    _trajectory(_graph, lambda s: _dense_data(s + 10, 12), 1, "graph")


def test_bert_two_stages_trajectory_matches_reference():
    _, t, _, tp = _trajectory(_bert, lambda s: _bert_data(s), 1, "bert",
                              steps=3)
    assert [k for k, _ in tp.part.pre] == [0]
    assert [[k for k, _ in c] for c in tp.part.stages] == [[1, 2], [3, 4]]
    assert [k for k, _ in tp.part.post] == [5, 6]


def test_fused_engine_trajectory_matches_reference():
    _trajectory(lambda: _dense(fused=True), lambda s: _dense_data(s), 2,
                "fused", steps=3)


# ---------------------------------------------------------------------------
# within the port
# ---------------------------------------------------------------------------


def _fit(pt, data, steps):
    for s in range(steps):
        x, y = data(s)
        pt.step_batch(TDS(x, y))
    pt.sync_model()
    return pt


def test_first_step_matches_the_unpipelined_step():
    """The pipelined step's loss and gradients against the network's own
    ``_gradients`` from the same state (one lane, a whole batch)."""
    j = _bert()
    t, ref = _port(j), _port(j)
    x, y = _bert_data(3)
    pt = TP.PipelinedTrainer(t, skew_every=0)
    pt._build()
    xs, ys, w = pt._shard(x, y)
    (loss, _), (_, grads) = pt._pipe_lane(xs[0], ys[0], w[0])
    l_ref, g_ref, _, _ = ref._gradients(None, torch.from_numpy(x),
                                        torch.from_numpy(y),
                                        torch.ones(x.shape[0]))
    np.testing.assert_allclose(float(loss), float(l_ref), rtol=1e-6)
    unstacked = pt._unstack_tree(
        {k: grads.get(k, {}) for k in pt._pp["params"]},
        [g_ref.get(i, {}) for i in range(len(ref.layers))])
    for i, g in g_ref.items():
        for k, v in g.items():
            np.testing.assert_allclose(unstacked[i][k].numpy(), v.numpy(),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"grad {i}.{k}")


def test_sync_model_round_trip_is_bit_exact():
    t = _port(_dense())
    pt = TP.PipelinedTrainer(t, replicas=2, skew_every=0)
    before = {k: [v.clone() for v in tree_leaves(getattr(t, k))]
              for k in ("params", "opt_states")}
    pt._build()
    pt.sync_model()
    for k, vs in before.items():
        for a, b in zip(vs, tree_leaves(getattr(t, k))):
            assert torch.equal(a, b), k
    _fit(pt, _dense_data, 2)
    again = pt._stack_tree(t.params)
    _equal(again, pt._pp["params"], "restack after sync")


def test_fused_state_conversion_and_checkpoint_resume_bit_exact(tmp_path):
    """Params and masters move together through both layout conversions:
    a checkpoint of a fused pipelined run, restored into a fresh network
    and trainer, continues bit for bit."""
    t = _port(_dense(fused=True))
    pt = _fit(TP.PipelinedTrainer(t, replicas=2, skew_every=0),
              _dense_data, 2)
    conv = pt._convert_fused_state(
        pt._convert_fused_state(t.opt_states, t._fused, pt._pp_engine,
                                to_pp=True), pt._pp_engine, t._fused,
        to_pp=False)
    _equal(conv, t.opt_states, "fused state round trip")
    ck = ShardedCheckpointer(str(tmp_path / "ck"), log_fn=None)
    ck.save(t.iteration, t, block=True)
    r = _port(_dense(fused=True))
    ck.restore(r)
    pr = TP.PipelinedTrainer(r, replicas=2, skew_every=0)
    _fit(pt, lambda s: _dense_data(s + 5), 2)
    _fit(pr, lambda s: _dense_data(s + 5), 2)
    _equal(_state(t), _state(r), "fused resume")


def test_compression_threshold_zero_is_the_uncompressed_step():
    for fused in (False, True):
        a = _port(_dense(fused=fused, comp="threshold", thresh=0.0))
        b = _port(_dense(fused=fused))
        _fit(TP.PipelinedTrainer(a, replicas=2, skew_every=0), _dense_data,
             3)
        _fit(TP.PipelinedTrainer(b, replicas=2, skew_every=0), _dense_data,
             3)
        _equal(a.params, b.params, f"t0 fused={fused}")


def test_active_compression_residual_rides_a_checkpoint(tmp_path):
    a = _port(_dense(comp="threshold", thresh=1e-3))
    pa = _fit(TP.PipelinedTrainer(a, replicas=2, skew_every=0), _dense_data,
              3)
    st = pa.compression_stats()
    assert st["wire_bytes"] > 0 and st["threshold"] > 0
    ck = ShardedCheckpointer(str(tmp_path / "ck"), log_fn=None)
    ck.save(a.iteration, a, block=True)
    b = _port(_dense(comp="threshold", thresh=1e-3))
    ck.restore(b)
    pb = TP.PipelinedTrainer(b, replicas=2, skew_every=0)
    _fit(pa, lambda s: _dense_data(s + 3), 2)
    _fit(pb, lambda s: _dense_data(s + 3), 2)
    _equal(a.params, b.params, "compressed resume params")
    _equal(a._grad_comp_state, b._grad_comp_state, "compressed residual")


def test_remat_through_stages_equals_no_remat():
    a = _port(_dense(remat="full"))
    b = _port(_dense())
    _fit(TP.PipelinedTrainer(a, replicas=2, skew_every=0), _dense_data, 3)
    _fit(TP.PipelinedTrainer(b, replicas=2, skew_every=0), _dense_data, 3)
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_ragged_batch_equals_manual_padding_with_zero_weights():
    x, y = _dense_data(0, 13)
    a = _port(_dense())
    pa = TP.PipelinedTrainer(a, skew_every=0)
    la = pa.step_batch(TDS(x, y))
    b = _port(_dense())
    pb = TP.PipelinedTrainer(b, skew_every=0)
    pb._build()
    xp = np.concatenate([x, x[-1:]])
    yp = np.concatenate([y, y[-1:]])
    xs, ys, _ = pb._shard(xp, yp)
    w = torch.tensor([[1.0] * 13 + [0.0]])
    pb._pp_sizes.write(0)
    lb, _ = pb._lane_body(xs, ys, w)
    assert float(la) == float(lb)
    _equal(pa._pp["params"], pb._pp["params"], "ragged")


def test_external_in_place_write_is_adopted():
    t = _port(_dense())
    pt = _fit(TP.PipelinedTrainer(t, replicas=2, skew_every=0), _dense_data,
              2)
    with torch.no_grad():
        t.params[0]["W"].zero_()
    pt.step_batch(TDS(*_dense_data(9)))
    pt.sync_model()
    # adopted: one Adam step from zeros is lr-scale, not the trained size
    assert float(t.params[0]["W"].abs().max()) < 0.1


def test_reshard_and_warmup_keep_the_state():
    t = _port(_dense())
    pt = _fit(TP.PipelinedTrainer(t, replicas=2, skew_every=0), _dense_data,
              2)
    before = [v.clone() for v in tree_leaves(_state(t))]
    pt.reshard()
    pt.sync_model()
    assert all(torch.equal(a, b)
               for a, b in zip(before, tree_leaves(_state(t))))
    assert pt.warmup([13, 8]) == 2
    pt.sync_model()
    assert all(torch.equal(a, b)
               for a, b in zip(before, tree_leaves(_state(t))))
    assert len(pt._programs) == 2
    pt.step_batch(TDS(*_dense_data(4)))
    assert np.isfinite(float(t.score_value))


def test_bytes_per_device_and_layout():
    t = _port(_dense())
    pt = TP.PipelinedTrainer(t, replicas=2, skew_every=0)
    pt._build()
    assert pt.param_bytes_per_device() == TG.tree_bytes(t.params)
    assert pt.opt_state_bytes_per_device() == TG.tree_bytes(t.opt_states)
    assert pt.train_state_bytes_per_device() == (
        TG.tree_bytes(t.params) + TG.tree_bytes(t.opt_states))
    assert pt.layout["pipeline"]["layers_per_stage"] == 2
    assert pt.layout["pipeline"]["pre"] == ["0"]


def test_cost_report_has_per_stage_rows():
    t = _port(_dense())
    pt = _fit(TP.PipelinedTrainer(t, replicas=2, skew_every=0), _dense_data,
              1)
    before = [v.clone() for v in tree_leaves(_state(t))]
    rep = pt.cost_report(batch_size=16, publish=False)
    names = [r.layer for r in rep.rows]
    assert "pipe:stage0" in names and "pipe:stage1" in names
    assert "(optimizer)" in names
    s0, s1 = (next(r for r in rep.rows if r.layer == f"pipe:stage{i}")
              for i in (0, 1))
    assert s0.flops == s1.flops > 0
    assert rep.devices == 1 and rep.source == "counted"
    assert all(torch.equal(a, b)
               for a, b in zip(before, tree_leaves(_state(t))))
