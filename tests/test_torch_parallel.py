"""The port's single-process data parallelism (``parallel/mesh.py``,
``parallel/gspmd.py``, ``parallel/wrapper.py``) against the JAX package's
on the CPU, and its own contracts.

Against the reference (its wrapper on its own one-device mesh with the
same ``replicas``; 3-step trajectories from the reference's initialised
params, within RTOL / FLOOR of every param and state):

- ``_pad_ragged``, ``pad_shard_batch`` and ``pad_lane_batch`` (13 rows,
  R 4, ``micro`` 2, masks) array for array; ``pairwise_sum`` bit for bit
  for R 1-9;
- ``ParallelWrapper`` deterministic (R 4) and compressed (threshold
  1e-3; the threshold, the transmitted count and the residual after every
  step, the residual's named cancellations held against their fp64
  values) on a narrow MultiLayerNetwork and a ComputationGraph with
  batchnorm, ragged batches; the TBPTT lane step of a masked LSTM stack.

Within the port, bit for bit: compressed at threshold 0 against the
uncompressed lanes (fused and per-leaf); the default fast step against
``net.fit``; a checkpoint with the compression sidecar resuming a
compressed fit; ``reshard`` and ``warmup`` leaving the residual as it
was. Refusals: a mismatched restored state, dynamic scaling with
compression, a mesh of more than one device, tensor sharding.
``ParallelInference`` (``output``, ``warmup``, ``output_async``, a bad
request) against ``net.output``.
"""

import math
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu import parallel as JP  # noqa: E402
from deeplearning4j_tpu.data import DataSet as JDS  # noqa: E402
from deeplearning4j_tpu.nn import ComputationGraph as JCG  # noqa: E402
from deeplearning4j_tpu.nn import InputType  # noqa: E402
from deeplearning4j_tpu.nn import MultiLayerNetwork as JMLN  # noqa: E402
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNNC  # noqa: E402
from deeplearning4j_tpu.nn import layers as JL  # noqa: E402
from deeplearning4j_tpu.nn import recurrent as JR  # noqa: E402
from deeplearning4j_tpu.nn.updaters import Adam  # noqa: E402
from deeplearning4j_tpu_torch import interop  # noqa: E402
from deeplearning4j_tpu_torch import parallel as TP  # noqa: E402
from deeplearning4j_tpu_torch.data.dataset import DataSet as TDS  # noqa: E402
from deeplearning4j_tpu_torch.parallel import gspmd as TG  # noqa: E402
from deeplearning4j_tpu_torch.tree import tree_leaves, tree_map  # noqa: E402
from deeplearning4j_tpu_torch.util import telemetry as tm  # noqa: E402

RTOL, FLOOR = 1e-4, 1e-6
R = 4


def _mesh1():
    return JP.TrainingMesh(data=1, devices=jax.devices()[:1])


def _mln_conf(comp=None, threshold=1e-3, fused=False, loss_scale=None,
              seed=7):
    b = JNNC.builder().seed(seed).updater(Adam(0.01))
    if fused:
        b = b.fused_update(True)
    if loss_scale:
        b = b.loss_scale(loss_scale)
    if comp:
        b = b.grad_compression(comp, threshold=threshold)
    return (b.list()
            .layer(JL.BatchNormalization())
            .layer(JL.DenseLayer(n_in=6, n_out=16, activation="relu"))
            .layer(JL.OutputLayer(n_in=16, n_out=4, loss="mcxent",
                                  activation="softmax"))
            .set_input_type(InputType.feed_forward(6)).build())


def _cg_conf(comp=None, threshold=1e-3):
    b = JNNC.builder().seed(5).updater(Adam(0.01))
    if comp:
        b = b.grad_compression(comp, threshold=threshold)
    return (b.graph_builder().add_inputs("in")
            .add_layer("bn", JL.BatchNormalization(), "in")
            .add_layer("d", JL.DenseLayer(n_in=6, n_out=12,
                                          activation="tanh"), "bn")
            .add_layer("out", JL.OutputLayer(n_in=12, n_out=4,
                                             loss="mcxent",
                                             activation="softmax"), "d")
            .set_outputs("out")
            .set_input_types(InputType.feed_forward(6)).build())


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(conf):
    """The reference net and the port's copy of it (on the CPU)."""
    j = (JCG(conf) if hasattr(conf, "nodes") else JMLN(conf)).init()
    t = interop.from_reference_json(conf.to_json(), _np(j.params),
                                    _np(j.states), device="cpu")
    return j, t


def _items(tree, prefix=()):
    """(path, array) by sorted key, for either package's trees."""
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


def _data(seed=0, n=13):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 6)).astype(np.float32),
            np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)])


# ------------------------------------------------------------------ mesh


def test_padding_equals_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((13, 3, 2)).astype(np.float32)
    y = rng.standard_normal((13, 5)).astype(np.float32)
    fm = (rng.random((13, 3)) > 0.3).astype(np.float32)
    jm, tm_ = _mesh1(), TP.TrainingMesh(devices=["cpu"])
    for div in (1, 4, 8):
        a = JP.TrainingMesh._pad_ragged(x, [y, y], div, (fm, None))
        b = TP.TrainingMesh._pad_ragged(x, [y, y], div, (fm, None))
        assert a[4:] == b[4:]
        for u, v in zip(a[:3], b[:3]):
            _equal(u, v, f"pad_ragged {div}")
        _equal(a[3][0], b[3][0], "extras")
        assert b[3][1] is None
    for args, kw in (((x, y), {}), ((x, y, (fm, None)), {})):
        _equal(jm.pad_shard_batch(*args), tm_.pad_shard_batch(*args),
               "pad_shard_batch")
    for micro in (1, 2):
        j = jm.pad_lane_batch(x, [y], R, extras={"m": fm}, micro=micro)
        t = tm_.pad_lane_batch(x, [y], R, extras={"m": fm}, micro=micro)
        _equal(j, t, f"pad_lane_batch micro {micro}")
        assert tuple(t[2].shape) == (R, 16 // R if micro == 2 else 4)
    # tensors pad as numpy does
    t2 = tm_.pad_lane_batch(torch.from_numpy(x), torch.from_numpy(y), R)
    _equal(t2, tm_.pad_lane_batch(x, y, R), "tensor inputs")


@pytest.mark.parametrize("n", range(1, 10))
def test_pairwise_sum_bit_equal(n):
    a = np.random.default_rng(n).normal(size=(n, 33)).astype(np.float32)
    assert np.array_equal(np.asarray(JP.gspmd.pairwise_sum(jnp.asarray(a))),
                          TG.pairwise_sum(torch.from_numpy(a)).numpy())
    assert np.array_equal(np.asarray(JP.gspmd.pairwise_mean(jnp.asarray(a))),
                          TG.pairwise_mean(torch.from_numpy(a)).numpy())


def test_multi_device_and_tensor_parallel_name_item_10b():
    """What needs more than one device names the ROADMAP item that brings
    it: item 10c since item 10b's one-card half was ported."""
    with pytest.raises(NotImplementedError, match="10c"):
        TP.TrainingMesh(devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="needs 2 devices"):
        TP.TrainingMesh(data=2, devices=["cpu"])
    with pytest.raises(NotImplementedError, match="10c"):
        TP.TrainingMesh(devices=["cpu"]).tensor_shard_params({}, [])
    _, t = _pair(_mln_conf())
    with pytest.raises(NotImplementedError, match="10c"):
        TP.ParallelWrapper(t, workers=2)
    with pytest.raises(NotImplementedError, match="ZeRO.*10c"):
        TG.zero_shardings(None, t.opt_states)
    # zero_optimizer is a no-op on one device, as in the reference
    assert TP.ParallelWrapper(t, zero_optimizer=True).zero_optimizer
    m = TP.TrainingMesh(devices=["cpu"])
    assert (m.n_devices, m.dcn_hosts(), m.data) == (1, 1, 1)
    assert m.layout_signature(extra=1) == JP.gspmd.layout_signature(
        _mesh1().mesh, extra=1)


# ------------------------------------------------ trajectories vs reference


#: Elements of the compressed residual outside RTOL / FLOOR of the
#: reference's, by (graph, step): each is a cancellation. The lane's
#: weight-scaled gradient and the residual it is added to are each 0.3-1.1
#: and sum to 0.002-0.04, so the packages' fp32 rounding of those operands
#: (up to 7e-6 in the reference, 2e-7 in the port) shows at up to 1.7e-4 of
#: the sum. Each is held against its fp64 value instead (``_residual64``).
_CANCELLING = {
    (False, 1): [(("residual", 0, "gamma"), (0, 4)),
                 (("residual", 1, "W"), (0, 4, 15)),
                 (("residual", 2, "W"), (0, 14, 0))],
    (True, 1): [(("residual", "d", "W"), (0, 3, 9))],
}


def _clone(tree):
    return tree_map(lambda v: v.clone(), tree)


def _residual64(net, pre, x, y, path, idx):
    """One element of the compressed residual after a lane step, in fp64
    from the port's state before the step ``pre`` (params, states,
    compression state): the lane's weight-scaled fp64 gradient plus the
    residual it carries, less its power-of-two quantum. Returns (value,
    |scaled gradient| + |residual in|)."""
    from deeplearning4j_tpu_torch.ops.compression import pow2_floor

    params, states, comp = pre
    d64 = lambda t: tree_map(  # noqa: E731
        lambda v: v.double() if v.is_floating_point() else v, t)
    xs, ys, ws = TP.TrainingMesh(devices=["cpu"]).pad_lane_batch(x, y, R)
    r = idx[0]
    (_, wsum), (_, g) = TG.make_lane_value_and_grad(net)(
        d64(params), d64(states), xs[r].double(), ys[r].double(),
        ws[r].double(), None, None)
    for k in path[1:]:
        g = g[k]
    scaled = float(g[idx[1:]]) * float(wsum)
    r_in = float(dict(_items(comp))[path][idx])
    c = scaled + r_in
    t = float(pow2_floor(comp["threshold"]))
    q = math.copysign(t, c) if t < abs(c) < t * 2.0 ** 23 else 0.0
    return c - q, abs(scaled) + abs(r_in)


def _residual_close(j, t, pre, x, y, named):
    """The compressed residual within RTOL / FLOOR of the reference's,
    element by element, but for the ``named`` (path, index) elements:
    both packages hold each of those within RTOL of its two operands'
    magnitude of its fp64 value."""
    ji, ti = _items(j._grad_comp_state), _items(t._grad_comp_state)
    assert [p for p, _ in ji] == [p for p, _ in ti]
    for (p, a), (_, b) in zip(ji, ti):
        off = ~np.isclose(b, a, rtol=RTOL, atol=FLOOR)
        for i in map(tuple, np.argwhere(off)):
            assert (p, i) in named, (f"residual {p} {i}: reference "
                                     f"{a[i]}, port {b[i]}")
    ja, ta = dict(ji), dict(ti)
    for p, i in named:
        value, operands = _residual64(t, pre, x, y, p, i)
        for who, v in (("reference", ja[p][i]), ("port", ta[p][i])):
            assert abs(float(v) - value) <= RTOL * operands, (
                p, i, who, float(v), value)


@pytest.mark.parametrize("graph", [False, True])
@pytest.mark.parametrize("comp", [None, "threshold"])
def test_wrapper_trajectory_matches_reference(graph, comp):
    conf = (_cg_conf if graph else _mln_conf)(comp=comp)
    j, t = _pair(conf)
    jw = JP.ParallelWrapper(j, mesh=_mesh1(), deterministic=True,
                            replicas=R, skew_every=0)
    tw = TP.ParallelWrapper(t, deterministic=True, replicas=R, skew_every=0)
    for step in range(3):
        x, y = _data(step, n=13 + step)  # ragged: 13, 14, 15 rows
        named = _CANCELLING.get((graph, step), []) if comp else []
        pre = named and (_clone(t.params), _clone(t.states),
                         _clone(t._grad_comp_state))
        jw.step_batch(JDS(x, y))
        tw.step_batch(TDS(x, y))
        np.testing.assert_allclose(float(t.score_value),
                                   float(j.score_value), rtol=RTOL)
        if comp:
            _residual_close(j, t, pre, x, y, named)
            js, ts = jw.compression_stats(), tw.compression_stats()
            # no element flips across the threshold on this data
            for k in ("threshold", "nnz", "dense_bytes", "elements",
                      "workers"):
                assert js[k] == ts[k], (step, k, js[k], ts[k])
    _close(j.params, t.params, "params")
    _close(j.states, t.states, "states")
    assert t.iteration == j.iteration == 3


def _lstm_conf():
    b = JNNC.builder().seed(11).updater(Adam(0.01)).tbptt_length(4)
    return (b.list()
            .layer(JR.LSTM(n_in=3, n_out=8))
            .layer(JR.RnnOutputLayer(n_in=8, n_out=3, loss="mcxent",
                                     activation="softmax"))
            .set_input_type(InputType.recurrent(3)).build())


def test_tbptt_lane_step_matches_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((6, 10, 3)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (6, 10))]
    fm = np.ones((6, 10), np.float32)
    fm[1, 7:] = 0
    fm[4, 3:] = 0
    j, t = _pair(_lstm_conf())
    jw = JP.ParallelWrapper(j, mesh=_mesh1(), deterministic=True,
                            replicas=R, skew_every=0)
    tw = TP.ParallelWrapper(t, deterministic=True, replicas=R, skew_every=0)
    jw.step_batch(JDS(x, y, features_mask=fm, labels_mask=fm))
    tw.step_batch(TDS(x, y, features_mask=fm, labels_mask=fm))
    assert t.iteration == j.iteration == 3  # 3 segments, the last ragged
    np.testing.assert_allclose(float(t.score_value), float(j.score_value),
                               rtol=RTOL)
    _close(j.params, t.params, "params")


# ------------------------------------------------------- within the port


def _port(conf):
    return _pair(conf)[1]


def _fit(net, steps=3, **kw):
    pw = TP.ParallelWrapper(net, replicas=R, skew_every=0, **kw)
    for s in range(steps):
        pw.step_batch(TDS(*_data(s, 13 + s)))
    return pw


@pytest.mark.parametrize("fused", [False, True])
def test_threshold_zero_equals_uncompressed_lanes(fused):
    a = _port(_mln_conf(fused=fused))
    b = _port(_mln_conf(comp="threshold", threshold=0.0, fused=fused))
    _fit(a, deterministic=True)
    pw = _fit(b)
    assert pw._compressor is not None and pw._uses_lanes
    _equal(a.params, b.params, "params")
    _equal(a.opt_states, b.opt_states, "opt states")
    _equal(a.states, b.states, "states")
    assert float(pw.compression_stats()["ratio"]) == 1.0


def test_static_scale_with_compression_composes():
    a = _port(_mln_conf(fused=True, loss_scale="static"))
    b = _port(_mln_conf(comp="threshold", threshold=0.0, fused=True,
                        loss_scale="static"))
    _fit(a, deterministic=True)
    _fit(b)
    _equal(a.params, b.params, "params (static scale)")
    c = _port(_mln_conf(fused=True, loss_scale="static"))
    ref = _port(_mln_conf(fused=True))
    _fit(c, deterministic=True)
    _fit(ref, deterministic=True)
    _close(ref.params, c.params, "scaled vs unscaled")


def test_lane_gradients_carry_the_engines_scale():
    """The lane body's gradients under static loss scaling are the
    unscaled lane's times the engine's scale (2^15) bit for bit, and its
    loss is the unscaled loss."""
    a = _port(_mln_conf(fused=True, loss_scale="static"))
    b = _port(_mln_conf(fused=True))
    scale = a._fused.current_scale(a.opt_states)
    assert float(scale) == 2.0 ** 15
    x, y, w = TP.TrainingMesh(devices=["cpu"]).pad_lane_batch(*_data(0), R)
    for r in range(R):
        (la, _), (_, ga) = TG.make_lane_value_and_grad(a)(
            a.params, a.states, x[r], y[r], w[r], None, None)
        (lb, _), (_, gb) = TG.make_lane_value_and_grad(b)(
            b.params, b.states, x[r], y[r], w[r], None, None)
        assert float(la) == float(lb)
        for u, v in zip(tree_leaves(ga), tree_leaves(gb)):
            assert torch.equal(u, v * scale)


def test_fast_step_equals_net_fit():
    a, b = _port(_mln_conf()), _port(_mln_conf())
    pw = TP.ParallelWrapper(b, skew_every=0)
    assert not pw._uses_lanes and pw.replicas == 1
    for s in range(3):
        x, y = _data(s)
        a.fit(x, y)
        pw.step_batch(TDS(x, y))
    _equal(a.params, b.params, "fast step")
    _equal(a.opt_states, b.opt_states, "fast step opt")
    assert float(a.score_value) == float(b.score_value)


def test_checkpoint_sidecar_resumes_exactly(tmp_path):
    from deeplearning4j_tpu_torch.util.checkpoint import ShardedCheckpointer

    batches = [TDS(*_data(s, 8)) for s in range(6)]
    ck = ShardedCheckpointer(str(tmp_path / "ck"), log_fn=None)
    a = _port(_mln_conf(comp="threshold"))
    pa = TP.ParallelWrapper(a, replicas=R, skew_every=0)
    for ds in batches[:3]:
        pa.step_batch(ds)
    ck.save(a.iteration, a)
    for ds in batches[3:]:
        pa.step_batch(ds)
    b = _port(_mln_conf(comp="threshold"))
    ck.restore(b)
    assert b._grad_comp_state is not None
    pb = TP.ParallelWrapper(b, replicas=R, skew_every=0)
    for ds in batches[3:]:
        pb.step_batch(ds)
    _equal(a.params, b.params, "params (resume)")
    _equal(a.opt_states, b.opt_states, "opt (resume)")
    _equal(a._grad_comp_state, b._grad_comp_state, "residual (resume)")
    assert any(bool(v.any()) for v in tree_leaves(
        a._grad_comp_state["residual"]))


def test_restore_without_sidecar_clears_state(tmp_path):
    from deeplearning4j_tpu_torch.util.checkpoint import ShardedCheckpointer

    ck = ShardedCheckpointer(str(tmp_path / "ck"), log_fn=None)
    plain = _port(_mln_conf())
    ck.save(0, plain)
    net = _port(_mln_conf(comp="threshold"))
    pw = _fit(net, steps=2)
    assert net._grad_comp_state is not None
    ck.restore(net)
    assert net._grad_comp_state is None
    pw.step_batch(TDS(*_data(5)))  # re-adopted: a fresh zero residual
    assert net._grad_comp_state is pw._comp_state
    fresh = _port(_mln_conf(comp="threshold"))
    ck.restore(fresh)
    pf = TP.ParallelWrapper(fresh, replicas=R, skew_every=0)
    pf.step_batch(TDS(*_data(5)))
    _equal(net._grad_comp_state, fresh._grad_comp_state, "reset residual")


def test_reshard_and_warmup_keep_residual():
    a, b = _port(_mln_conf(comp="threshold")), _port(
        _mln_conf(comp="threshold"))
    pa, pb = _fit(a, steps=2), _fit(b, steps=2)
    before = _items(b._grad_comp_state)
    pb.reshard(TP.TrainingMesh(devices=["cpu"]))
    _equal(before, _items(b._grad_comp_state), "reshard")
    assert pb.warmup([8], input_shape=(6,), label_shape=(4,)) == 1
    _equal(before, _items(b._grad_comp_state), "warmup")
    for s in (7, 8):
        pa.step_batch(TDS(*_data(s)))
        pb.step_batch(TDS(*_data(s)))
    _equal(a.params, b.params, "after reshard")
    _equal(a._grad_comp_state, b._grad_comp_state, "residual after")


def test_refusals():
    net = _port(_mln_conf(comp="threshold"))
    net._grad_comp_state = {"residual": [np.zeros((3, 3), np.float32)],
                            "threshold": np.float32(1e-3)}
    pw = TP.ParallelWrapper(net, replicas=R, skew_every=0)
    with pytest.raises(ValueError, match="grad-compression state"):
        pw.step_batch(TDS(*_data()))
    with pytest.raises(ValueError, match="dynamic"):
        TP.ParallelWrapper(_port(_mln_conf(comp="threshold", fused=True,
                                           loss_scale="dynamic")))
    pw = TP.ParallelWrapper(_port(_mln_conf(comp="threshold")),
                            grad_compression="none")
    assert pw._compressor is None
    with pytest.raises(ValueError, match="divide"):
        TP.ParallelWrapper(_port(_mln_conf(comp="threshold")), replicas=3,
                           compression_hosts=2)
    with pytest.raises(NotImplementedError, match="TBPTT"):
        TG.make_lane_tbptt_value_and_grad(_port(_cg_conf()))


def test_layout_cost_report_and_telemetry():
    tele = tm.get_telemetry()
    steps0 = tele.counter_total("train.steps_total", model="parallel")
    net = _port(_mln_conf(comp="bitmap"))
    pw = TP.ParallelWrapper(net, replicas=R, skew_every=1)
    pw.fit([TDS(*_data(0))], epochs=2)
    assert net.epoch == 2 and net.iteration == 2
    assert pw.layout["grad_compression"]["scheme"] == "bitmap"
    assert pw.layout["signature"].startswith("mesh(data=1,model=1")
    assert pw.opt_state_bytes_per_device() == TG.tree_bytes(net.opt_states)
    assert tele.gauge_values("parallel.straggler_skew_seconds") == [0.0]
    assert tele.gauge_values("parallel.replicas") == [1]
    assert tele.gauge_values("parallel.allreduce_compression_ratio")
    assert tele.counter_total("train.steps_total",
                              model="parallel") - steps0 == 2
    rep = pw.cost_report(batch_size=8, publish=False)
    assert rep.devices == 1 and rep.source == "counted"
    assert rep.totals["flops"] > 0
    assert "(optimizer)" in {r.layer for r in rep.rows}
    assert pw.average_model() is net


def test_parallel_telemetry_names_are_the_references():
    import pathlib
    import re

    import deeplearning4j_tpu.parallel as jpar

    root = pathlib.Path(jpar.__file__).parent
    src = (root / "wrapper.py").read_text() + (root / "masters.py") \
        .read_text()
    names = set(re.findall(r'"(parallel\.[a-z_]+)"', src))
    ours = {n for group in tm.PARALLEL_NAMES.values() for n in group}
    assert names == ours, (names ^ ours)


# ------------------------------------------------------ ParallelInference


def _inference_net():
    return _port(_mln_conf())


def test_parallel_inference_output_and_warmup():
    net = _inference_net()
    pi = TP.ParallelInference(net, bucketing="batch=2,4,8", batch_limit=8)
    x = np.random.default_rng(2).standard_normal((19, 6)).astype(np.float32)
    want = net.output(x).numpy()
    np.testing.assert_allclose(pi.output(x), want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pi.output(x[:3]), want[:3], rtol=1e-6,
                               atol=1e-7)
    assert pi.warmup(input_shape=(6,)) == 3
    with pytest.raises(ValueError, match="batch_buckets"):
        TP.ParallelInference(net, bucketing=False).warmup()


def test_parallel_inference_async_coalesces_and_survives_bad_requests():
    net = _inference_net()
    pi = TP.ParallelInference(net, batch_timeout_ms=50.0)
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal((n, 6)).astype(np.float32)
          for n in (1, 3, 2, 5)]
    want = [net.output(x).numpy() for x in xs]
    results = {}

    def submit(i):
        results[i] = pi.output_async(xs[i % 4]).result(timeout=60)

    threads = [threading.Thread(target=submit, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    for i, r in results.items():
        np.testing.assert_allclose(r, want[i % 4], rtol=1e-6, atol=1e-7)
    assert len(results) == 8 and pi.batches_executed < 8
    bad = pi.output_async(rng.standard_normal((2, 7)).astype(np.float32))
    with pytest.raises(Exception):
        bad.result(timeout=60)
    good = pi.output_async(xs[1])
    assert good.result(timeout=60).shape == (3, 4)
    pi.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        pi.output_async(xs[0])
