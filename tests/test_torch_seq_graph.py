"""The port's masked sequence ComputationGraph against the JAX package's,
on the CPU: masks, truncated BPTT, stateful inference and sequence
bucketing in the graph.

Each test builds the graph in both packages from one conf (the reference's
JSON read by the port), copies the reference's params, optimizer state and
iteration across with ``interop.load_reference``, and feeds both the same
seeded batch. Tolerances: ``fit`` trajectories (each step's loss and the
params after 3-4 Adam steps, epsilon 1e-3) within 1e-4 relative, with an
absolute floor of 1e-6 for entries near 0 (the trajectory convention of the
port's other parity tests); ``output``, ``score`` and ``rnn_time_step``
within 2e-5.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from deeplearning4j_tpu.data.bucketing import (  # noqa: E402
    BucketingPolicy as JPolicy)
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet  # noqa: E402
from deeplearning4j_tpu.data.dataset import (  # noqa: E402
    MultiDataSet as JMultiDataSet)
from deeplearning4j_tpu.nn import layers as JL  # noqa: E402
from deeplearning4j_tpu.nn import recurrent as JR  # noqa: E402
from deeplearning4j_tpu.nn import updaters as jupd  # noqa: E402
from deeplearning4j_tpu.nn.computation_graph import (  # noqa: E402
    ComputationGraph as JGraph)
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC  # noqa: E402
from deeplearning4j_tpu_torch import interop  # noqa: E402
from deeplearning4j_tpu_torch.data import DataSet, MultiDataSet  # noqa: E402
from deeplearning4j_tpu_torch.data.bucketing import (  # noqa: E402
    BucketingPolicy)
from deeplearning4j_tpu_torch.nn import ComputationGraph  # noqa: E402
from deeplearning4j_tpu_torch.nn.computation_graph import (  # noqa: E402
    ComputationGraphConfiguration as TGConf)
from deeplearning4j_tpu_torch.tree import tree_items, tree_get  # noqa: E402

B, T, F, F2, H, C = 3, 10, 4, 3, 5, 3
RTOL, ATOL = 1e-4, 1e-6


def _builder():
    return JNNC.builder().seed(5).updater(
        jupd.Adam(learning_rate=1e-2, epsilon=1e-3))


def _seq_conf(tbptt=0, buckets=None, seq_buckets=None):
    """in -> LSTM -> GravesLSTM -> RnnOutputLayer, per-step labels."""
    b = _builder()
    if buckets is not None:
        b._batch_buckets = buckets
    if seq_buckets is not None:
        b._seq_buckets = seq_buckets
    gb = (b.graph_builder().add_inputs("in")
          .add_layer("lstm", JR.LSTM(n_in=F, n_out=H), "in")
          .add_layer("graves", JR.GravesLSTM(n_in=H, n_out=H), "lstm")
          .add_layer("out", JR.RnnOutputLayer(n_in=H, n_out=C), "graves")
          .set_outputs("out").set_input_types((T, F)))
    if tbptt:
        gb.tbptt_length(tbptt)
    return gb.build()


def _two_input_conf():
    """Two sequence inputs, each its own recurrent layer and mask, merged
    into one per-step head (a layer node with two inputs)."""
    return (_builder().graph_builder().add_inputs("a", "b")
            .add_layer("ra", JR.LSTM(n_in=F, n_out=H), "a")
            .add_layer("rb", JR.GRU(n_in=F2, n_out=H, recurrent_bias=True),
                       "b")
            .add_layer("out", JR.RnnOutputLayer(n_in=2 * H, n_out=C),
                       "ra", "rb")
            .set_outputs("out").set_input_types((T, F), (T, F2)).build())


def _classifier_conf():
    """Bidirectional LSTM -> masked average over time -> OutputLayer, and
    a second head on the last real step (two outputs)."""
    return (_builder().graph_builder().add_inputs("in")
            .add_layer("bi", JR.Bidirectional(layer=JR.LSTM(n_in=F, n_out=H),
                                              mode="concat"), "in")
            .add_layer("pool", JL.GlobalPoolingLayer(pooling_type="avg"),
                       "bi")
            .add_layer("out", JL.OutputLayer(n_in=2 * H, n_out=C), "pool")
            .add_layer("last", JR.LastTimeStep(), "bi")
            .add_layer("out2", JL.OutputLayer(n_in=2 * H, n_out=2), "last")
            .set_outputs("out", "out2").set_input_types((T, F)).build())


def _pair(jconf):
    jnet = JGraph(jconf).init()
    net = ComputationGraph(TGConf.from_json(jconf.to_json())).init(
        device="cpu")
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    interop.load_reference(net, tree(jnet.params), tree(jnet.states),
                           tree(jnet.opt_states), jnet.iteration)
    return jnet, net


def _mask(b, t, seed, lo=1):
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, t + 1, size=b)
    lens[0] = t
    return (np.arange(t)[None] < lens[:, None]).astype(np.float32)


def _seq_batch(seed, b=B, t=T, f=F, c=C):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, f)).astype(np.float32)
    y = np.eye(c, dtype=np.float32)[rng.integers(0, c, size=(b, t))]
    return x, y


def _assert_close(net, jnet):
    ref = jax.tree_util.tree_map(np.asarray, jnet.params)
    for name, tree in net.params.items():
        for path, v in tree_items(tree):
            np.testing.assert_allclose(
                v.numpy(), tree_get(ref[name], path), rtol=RTOL, atol=ATOL,
                err_msg=f"{name} {path}")


def _trajectory(net, jnet, batches, jbatches):
    for ds, jds in zip(batches, jbatches):
        net.fit(ds)
        jnet.fit(jds)
        np.testing.assert_allclose(net.get_score(), jnet.get_score(),
                                   rtol=RTOL)
    assert net.iteration == jnet.iteration
    _assert_close(net, jnet)


# ------------------------------------------------------------ masked fit


def test_masked_fit_with_a_shared_mask_matches_reference():
    """A DataSet's feature and label masks, shared by every node."""
    jnet, net = _pair(_seq_conf())
    batches, jbatches = [], []
    for s in range(3):
        x, y = _seq_batch(s)
        fm = _mask(B, T, 10 + s)
        lm = fm * (np.random.default_rng(s).random((B, T)) > 0.3)
        batches.append(DataSet(x, y, fm, lm.astype(np.float32)))
        jbatches.append(JDataSet(x, y, fm, lm.astype(np.float32)))
    _trajectory(net, jnet, batches, jbatches)


def test_masked_fit_with_per_input_masks_matches_reference():
    """A MultiDataSet's mask lists become dicts by input and output name:
    each input's recurrent layer sees its own mask, the merged head the
    first input's, its loss the label mask."""
    jnet, net = _pair(_two_input_conf())
    batches, jbatches = [], []
    for s in range(3):
        rng = np.random.default_rng(s)
        xa = rng.normal(size=(B, T, F)).astype(np.float32)
        xb = rng.normal(size=(B, T, F2)).astype(np.float32)
        y = np.eye(C, dtype=np.float32)[rng.integers(0, C, size=(B, T))]
        ma, mb = _mask(B, T, 20 + s), _mask(B, T, 30 + s)
        lm = ma * mb
        batches.append(MultiDataSet([xa, xb], [y], [ma, mb], [lm]))
        jbatches.append(JMultiDataSet([xa, xb], [y], [ma, mb], [lm]))
    _trajectory(net, jnet, batches, jbatches)


def test_masked_classifier_fit_output_score_evaluate_match_reference():
    """Bidirectional + masked pooling and LastTimeStep: fit with a feature
    mask and per-sequence labels, then ``output``, ``score`` and
    ``evaluate`` under the mask."""
    jnet, net = _pair(_classifier_conf())
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, T, F)).astype(np.float32)
    y1 = np.eye(C, dtype=np.float32)[rng.integers(0, C, size=B)]
    y2 = np.eye(2, dtype=np.float32)[rng.integers(0, 2, size=B)]
    fm = _mask(B, T, 5)
    for _ in range(3):
        net.fit(MultiDataSet([x], [y1, y2], [fm], None))
        jnet.fit(JMultiDataSet([x], [y1, y2], [fm], None))
        np.testing.assert_allclose(net.get_score(), jnet.get_score(),
                                   rtol=RTOL)
    _assert_close(net, jnet)
    outs = net.output(x, mask=fm)
    jouts = jnet.output(x, mask=fm)
    for o, jo in zip(outs, jouts):
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=2e-5)
    unmasked = net.output(x)[0].numpy()
    assert not np.allclose(unmasked, outs[0].numpy())
    np.testing.assert_allclose(
        net.score(x=[x], y=[y1, y2], mask=fm),
        jnet.score(x=[x], y=[y1, y2], mask=fm), rtol=1e-5)
    single = _pair(_seq_conf())
    xs, ys = _seq_batch(7)
    lm = _mask(B, T, 8)
    np.testing.assert_allclose(
        single[1].score(DataSet(xs, ys, lm, lm)),
        single[0].score(JDataSet(xs, ys, lm, lm)), rtol=1e-5)
    ev = single[1].evaluate([DataSet(xs, ys, features_mask=lm)])
    jev = single[0].evaluate([JDataSet(xs, ys, features_mask=lm)])
    np.testing.assert_array_equal(ev.confusion, jev.confusion)


# ---------------------------------------------------------------- TBPTT


@pytest.mark.parametrize("buckets", [None, (4,)], ids=["plain", "bucketed"])
def test_tbptt_with_a_ragged_tail_matches_reference(buckets):
    """T 10 at k 4: segments of 4, 4 and 2 (under batch buckets the tail
    pads to 4 and B 3 to 4 rows), one update each, the carries flowing
    on; masks sliced per segment."""
    jnet, net = _pair(_seq_conf(tbptt=4, buckets=buckets))
    x, y = _seq_batch(1)
    fm = _mask(B, T, 2, lo=3)
    for _ in range(2):
        net.fit(DataSet(x, y, fm, fm))
        jnet.fit(JDataSet(x, y, fm, fm))
        np.testing.assert_allclose(net.get_score(), jnet.get_score(),
                                   rtol=RTOL)
    assert net.iteration == jnet.iteration == 6
    _assert_close(net, jnet)


def test_tbptt_with_per_input_masks_matches_reference():
    jconf = _two_input_conf()
    jconf.tbptt_length = 4
    jnet, net = _pair(jconf)
    assert net.conf.tbptt_length == 4
    rng = np.random.default_rng(3)
    xa = rng.normal(size=(B, T, F)).astype(np.float32)
    xb = rng.normal(size=(B, T, F2)).astype(np.float32)
    y = np.eye(C, dtype=np.float32)[rng.integers(0, C, size=(B, T))]
    ma, mb = _mask(B, T, 40), _mask(B, T, 41)
    net.fit(MultiDataSet([xa, xb], [y], [ma, mb], [ma]))
    jnet.fit(JMultiDataSet([xa, xb], [y], [ma, mb], [ma]))
    np.testing.assert_allclose(net.get_score(), jnet.get_score(), rtol=RTOL)
    assert net.iteration == jnet.iteration == 3
    _assert_close(net, jnet)


# ---------------------------------------------------- stateful inference


def test_rnn_time_step_and_clear_match_reference():
    jnet, net = _pair(_seq_conf())
    x, _ = _seq_batch(9)
    whole = net.output(x).numpy()
    got = [net.rnn_time_step(x[:, :4]).numpy()]
    jgot = [np.asarray(jnet.rnn_time_step(x[:, :4]))]
    for t in range(4, T):
        got.append(net.rnn_time_step(x[:, t])[:, None].numpy())
        jgot.append(np.asarray(jnet.rnn_time_step(x[:, t]))[:, None])
    np.testing.assert_allclose(np.concatenate(got, 1), whole, atol=2e-5)
    np.testing.assert_allclose(np.concatenate(got, 1),
                               np.concatenate(jgot, 1), atol=2e-5)
    assert set(net._rnn_carries) == {"lstm", "graves"}
    with pytest.raises(ValueError, match="batch size"):
        net.rnn_time_step(x[:1, 0])
    net.rnn_clear_previous_state()
    np.testing.assert_allclose(net.rnn_time_step(x[:1, 0]).numpy(),
                               whole[:1, 0], atol=2e-5)


# -------------------------------------------------------- sequence buckets


def test_pad_graph_batch_under_seq_buckets_matches_reference():
    pol, jpol = (BucketingPolicy(batch_buckets=(4, 8), seq_buckets=(8, 16)),
                 JPolicy(batch_buckets=(4, 8), seq_buckets=(8, 16)))
    rng = np.random.default_rng(0)
    feats = [rng.normal(size=(3, 6, F)).astype(np.float32),
             rng.normal(size=(3, F2)).astype(np.float32)]
    labs = [rng.normal(size=(3, 6, C)).astype(np.float32)]
    m = _mask(3, 6, 1)
    for mask, lmask in ((m, m), ({"a": m, "b": None}, {"out": m}),
                        (None, None)):
        got = pol.pad_graph_batch(feats, labs, mask, lmask)
        want = jpol.pad_graph_batch(feats, labs, mask, lmask)[:4]
        for g, w in zip(got[:2], want[:2]):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
        for g, w in zip(got[2:], want[2:]):
            if isinstance(w, dict):
                assert set(g) == set(w)
                for k in w:
                    assert (g[k] is None) == (w[k] is None)
                    if w[k] is not None:
                        np.testing.assert_array_equal(g[k], w[k])
            elif w is None:
                assert g is None
            else:
                np.testing.assert_array_equal(g, w)
    padded = pol.pad_graph_batch([torch.tensor(feats[0])],
                                 [torch.tensor(labs[0])],
                                 {"in": torch.tensor(m)}, None)
    assert tuple(padded[0][0].shape) == (4, 8, F)
    assert tuple(padded[2]["in"].shape) == (4, 8)


def test_fit_under_seq_buckets_matches_reference():
    """T 6 pads to the bucket 8 with zero mask entries, B 3 to 4 rows."""
    jconf = _seq_conf(buckets=(4,), seq_buckets=(8,))
    jnet, net = _pair(jconf)
    assert json.loads(net.conf.to_json())["seq_buckets"] == [8]
    x, y = _seq_batch(12, t=6)
    fm = _mask(B, 6, 13)
    for _ in range(3):
        net.fit(DataSet(x, y, fm, fm))
        jnet.fit(JDataSet(x, y, fm, fm))
        np.testing.assert_allclose(net.get_score(), jnet.get_score(),
                                   rtol=RTOL)
    _assert_close(net, jnet)
