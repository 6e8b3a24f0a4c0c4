"""The port's training masters (``parallel/masters.py``) against the JAX
package's, on the CPU: 3-epoch trajectories of a narrow MultiLayerNetwork
and a ComputationGraph with batchnorm through
``ParameterAveragingTrainingMaster`` (frequency 2) and
``SharedTrainingMaster`` (threshold 1e-3, adaptive) at 4 lanes, ragged
batches, within RTOL / FLOOR of every param and state (the reference's
lanes on a 4-device mesh: its masters take one lane a device); the shared
master's residuals and thresholds and its wire accounting; the Spark
facade; the refusal of a loss-scaled network; the shared master's epoch
boundary.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from deeplearning4j_tpu import parallel as JP  # noqa: E402
from deeplearning4j_tpu.data import DataSet as JDS  # noqa: E402
from deeplearning4j_tpu_torch import parallel as TP  # noqa: E402
from deeplearning4j_tpu_torch.data.dataset import DataSet as TDS  # noqa: E402
from deeplearning4j_tpu_torch.parallel import gspmd as TG  # noqa: E402

import test_torch_parallel as P  # noqa: E402

R = 4


def _mesh4():
    return JP.TrainingMesh(data=R, devices=jax.devices()[:R])


def _batches(ds_cls, n=3):
    return [ds_cls(*P._data(s, 13)) for s in range(n)]  # ragged: 13 rows


@pytest.mark.parametrize("graph", [False, True])
def test_parameter_averaging_matches_reference(graph):
    j, t = P._pair(P._cg_conf() if graph else P._mln_conf())
    JP.ParameterAveragingTrainingMaster(
        averaging_frequency=2, mesh=_mesh4()).fit(j, _batches(JDS), epochs=1)
    TP.ParameterAveragingTrainingMaster(
        averaging_frequency=2, replicas=R).fit(t, _batches(TDS), epochs=1)
    assert t.iteration == j.iteration == 3 and t.epoch == j.epoch == 1
    np.testing.assert_allclose(float(t.score_value), float(j.score_value),
                               rtol=P.RTOL)
    P._close(j.params, t.params, "params")
    P._close(j.states, t.states, "states")


@pytest.mark.parametrize("graph", [False, True])
def test_shared_master_matches_reference(graph):
    j, t = P._pair(P._cg_conf() if graph else P._mln_conf())
    jm = JP.SharedTrainingMaster(mesh=_mesh4())
    tmaster = TP.SharedTrainingMaster(replicas=R)
    jm.fit(j, _batches(JDS), epochs=1)
    tmaster.fit(t, _batches(TDS), epochs=1)
    assert t.iteration == j.iteration == 3
    np.testing.assert_allclose(float(t.score_value), float(j.score_value),
                               rtol=P.RTOL)
    P._close(j.params, t.params, "params")
    P._close(j.states, t.states, "states")
    assert float(tmaster.last_stats["dense_bytes"]) == float(
        jm.last_stats["dense_bytes"])
    # the ratio may differ by elements whose carried value lies within
    # fp32 rounding of a threshold (a flip); none flipped on this data
    assert float(tmaster.last_stats["ratio"]) == float(
        jm.last_stats["ratio"])
    assert tmaster.threshold.shape == (R,)


@pytest.mark.parametrize("master", ["averaging", "shared"])
def test_masters_on_masked_sequences_match_reference(master):
    """A masked LSTM stack (ragged rows, per-step labels) through either
    master, 2 epochs, against the reference's."""
    from deeplearning4j_tpu.nn import InputType
    from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNNC
    from deeplearning4j_tpu.nn import recurrent as JR
    from deeplearning4j_tpu.nn.updaters import Sgd

    conf = (JNNC.builder().seed(11).updater(Sgd(0.1)).list()
            .layer(JR.LSTM(n_in=3, n_out=8))
            .layer(JR.RnnOutputLayer(n_in=8, n_out=3, loss="mcxent",
                                     activation="softmax"))
            .set_input_type(InputType.recurrent(3)).build())
    rng = np.random.default_rng(6)
    x = rng.standard_normal((7, 6, 3)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (7, 6))]
    fm = np.ones((7, 6), np.float32)
    fm[2, 4:] = 0
    fm[5, 2:] = 0
    j, t = P._pair(conf)
    if master == "averaging":
        JP.ParameterAveragingTrainingMaster(averaging_frequency=1,
                                            mesh=_mesh4()).fit(
            j, [JDS(x, y, features_mask=fm, labels_mask=fm)], epochs=2)
        TP.ParameterAveragingTrainingMaster(averaging_frequency=1,
                                            replicas=R).fit(
            t, [TDS(x, y, features_mask=fm, labels_mask=fm)], epochs=2)
    else:
        JP.SharedTrainingMaster(mesh=_mesh4()).fit(
            j, [JDS(x, y, features_mask=fm, labels_mask=fm)], epochs=2)
        TP.SharedTrainingMaster(replicas=R).fit(
            t, [TDS(x, y, features_mask=fm, labels_mask=fm)], epochs=2)
    np.testing.assert_allclose(float(t.score_value), float(j.score_value),
                               rtol=P.RTOL)
    P._close(j.params, t.params, "params")


def test_shared_master_residual_is_its_lanes_encode():
    """After a step each lane's residual and threshold are the
    accumulator's encode of that lane's gradient, taken from the state
    before the step, and of its residual: bit for bit."""
    from deeplearning4j_tpu_torch.tree import tree_map

    clone = lambda t: tree_map(lambda v: v.clone(), t)  # noqa: E731
    net = P._port(P._mln_conf())
    m = TP.SharedTrainingMaster(replicas=R)
    first, ds = _batches(TDS, 2)
    m.fit(net, [first])  # a residual that is not zero
    params, states = clone(net.params), clone(net.states)
    res_in, thr_in = clone(m.residual), m.threshold.clone()
    it = torch.tensor(net.iteration)
    x, y, w = m.mesh.pad_lane_batch(ds.features, ds.labels, R)
    lane_vg = TG.make_lane_value_and_grad(net)
    grads = [lane_vg(params, states, x[r], y[r], w[r], None, None)[1][1]
             for r in range(R)]
    m.fit(net, [ds])
    lane = lambda t, r: tree_map(lambda v: v[r], t)  # noqa: E731
    for r in range(R):
        q, res, thr, _ = m.accumulator.encode(grads[r], lane(res_in, r),
                                              thr_in[r], it)
        P._equal(res, lane(m.residual, r), f"lane {r} residual")
        assert torch.equal(thr, m.threshold[r]), r
        assert any(bool((v != 0).any()) for v in TG.tree_leaves(q)), r


def test_spark_facade_and_epoch_boundary():
    seen = []

    class EpochEnd:
        def iteration_done(self, model, it, epoch):
            pass

        def on_epoch_end(self, model):
            seen.append([p.clone() for p in TG.tree_leaves(model.params)])

    net = P._port(P._cg_conf())
    net.set_listeners(EpochEnd())
    spark = TP.SparkComputationGraph(None, net,
                                     TP.SharedTrainingMaster(replicas=R))
    assert TP.SparkDl4jMultiLayer is TP.SparkComputationGraph
    spark.fit(_batches(TDS, 2), epochs=2)
    assert net.epoch == 2 and len(seen) == 2
    # the params an epoch-end listener sees are the network's live ones
    assert all(torch.equal(a, b) for a, b in zip(
        seen[-1], TG.tree_leaves(net.params)))
    avg = P._port(P._mln_conf())
    TP.ParameterAveragingTrainingMaster(averaging_frequency=1, replicas=2)\
        .fit(avg, TDS(*P._data(0)), epochs=1)
    assert avg.epoch == 1


def test_masters_refuse_loss_scaled_models():
    net = P._port(P._mln_conf(fused=True, loss_scale="static"))
    with pytest.raises(NotImplementedError, match="loss_scale"):
        TP.SharedTrainingMaster(replicas=R).fit(net, _batches(TDS, 1))
    zeros = TG.grad_template(net)
    with pytest.raises(NotImplementedError, match="loss_scale"):
        TG.apply_updaters(net, net.params, zeros, net.opt_states,
                          net._step_sizes().views)
