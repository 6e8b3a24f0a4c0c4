"""A GravesLSTM char-RNN (BASELINE #3's form: two GravesLSTM layers with
peepholes and a per-step softmax on MultiLayerNetwork) trained with
truncated BPTT in the port, against the JAX package's, on the CPU.

Narrow: 11 characters, 16 units, sequences of 10 at TBPTT 4 (segments of
4, 4 and a ragged 2). Both packages build the net from one conf (the
reference's JSON read by the port), the reference's params (peepholes
included) and optimizer state copied across with
``interop.load_reference_mln``. Tolerances: each segment's loss and the
params after each ``fit`` call within 1e-4 relative, with an absolute
floor of 1e-6 (the trajectory convention of the port's parity tests);
``rnn_time_step`` sampling distributions within 2e-5; one bf16 ``fit``
call's loss within 2^-6 relative (the logits' bf16 rounding, taken at
other places by the two packages, over three segments).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet  # noqa: E402
from deeplearning4j_tpu.nn import recurrent as JR  # noqa: E402
from deeplearning4j_tpu.nn import updaters as jupd  # noqa: E402
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC  # noqa: E402
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JMLN)
from deeplearning4j_tpu_torch import interop  # noqa: E402
from deeplearning4j_tpu_torch.data import DataSet  # noqa: E402
from deeplearning4j_tpu_torch.nn import MultiLayerNetwork  # noqa: E402
from deeplearning4j_tpu_torch.nn import NeuralNetConfiguration  # noqa: E402
from deeplearning4j_tpu_torch.nn import recurrent as TR  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration as TConf)

VOCAB, UNITS, SEQ, K = 11, 16, 10, 4
RTOL, ATOL = 1e-4, 1e-6


def _jconf(dtype="float32"):
    return (JNNC.builder().seed(12345)
            .updater(jupd.Adam(learning_rate=1e-2, epsilon=1e-3))
            .compute_dtype(dtype).tbptt_length(K).list()
            .layer(JR.GravesLSTM(n_in=VOCAB, n_out=UNITS, activation="tanh"))
            .layer(JR.GravesLSTM(n_in=UNITS, n_out=UNITS, activation="tanh"))
            .layer(JR.RnnOutputLayer(n_in=UNITS, n_out=VOCAB, loss="mcxent",
                                     activation="softmax"))
            .set_input_type((SEQ, VOCAB)).build())


def _pair(dtype="float32"):
    jnet = JMLN(_jconf(dtype)).init()
    net = MultiLayerNetwork(TConf.from_json(jnet.conf.to_json())).init(
        device="cpu")
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    interop.load_reference_mln(net, tree(jnet.params), tree(jnet.states),
                               tree(jnet.opt_states), jnet.iteration)
    return jnet, net


def _batch(b, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, size=(b, SEQ + 1))
    eye = np.eye(VOCAB, dtype=np.float32)
    return eye[ids[:, :-1]], eye[ids[:, 1:]]


def _assert_params_close(net, jnet):
    for i, (mine, ref) in enumerate(zip(net.params, jnet.params)):
        assert set(mine) == set(ref)
        for k in ref:
            np.testing.assert_allclose(mine[k].float().numpy(),
                                       np.asarray(ref[k], np.float32),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"layer {i} {k}")


def test_conf_json_both_ways():
    jconf = _jconf()
    tconf = TConf.from_json(jconf.to_json())
    assert isinstance(tconf.layers[0], TR.GravesLSTM)
    assert tconf.tbptt_length == K
    assert json.loads(tconf.to_json()) == json.loads(jconf.to_json())
    mine = (NeuralNetConfiguration.builder().seed(12345).tbptt_length(K)
            .list().layer(TR.GravesLSTM(n_in=VOCAB, n_out=UNITS))
            .layer(TR.RnnOutputLayer(n_in=UNITS, n_out=VOCAB))
            .set_input_type((SEQ, VOCAB)).build())
    assert set(MultiLayerNetwork(mine).init(device="cpu").params[0]) == {
        "W", "U", "peep", "b"}


def test_tbptt_trajectory_matches_reference():
    """Three ``fit`` calls of one batch each, every segment's loss recorded
    in both packages: 9 updates, losses and params within 1e-4."""
    jnet, net = _pair()
    seg, jseg = [], []
    inner, jinner = net._gradients, jnet._tbptt_step

    def rec(*a, **kw):
        out = inner(*a, **kw)
        seg.append(float(out[0]))
        return out

    def jrec(*a, **kw):
        out = jinner(*a, **kw)
        jseg.append(float(out[-1]))
        return out

    net._gradients = rec
    jnet._tbptt_step = jrec
    for s in range(3):
        x, y = _batch(4, s)
        net.fit(DataSet(x, y))
        jnet.fit(JDataSet(x, y))
        np.testing.assert_allclose(net.get_score(), jnet.get_score(),
                                   rtol=RTOL)
        _assert_params_close(net, jnet)
    assert net.iteration == jnet.iteration == 9
    np.testing.assert_allclose(seg, jseg, rtol=RTOL)


def test_masked_tbptt_and_sampling_match_reference():
    """A ragged feature/label mask through the segments, then sampling
    with ``rnn_time_step``: a 3-step prime, then one step at a time."""
    jnet, net = _pair()
    x, y = _batch(3, 7)
    lens = np.array([SEQ, 6, 3])
    m = (np.arange(SEQ)[None] < lens[:, None]).astype(np.float32)
    net.fit(DataSet(x, y, m, m))
    jnet.fit(JDataSet(x, y, m, m))
    np.testing.assert_allclose(net.get_score(), jnet.get_score(), rtol=RTOL)
    _assert_params_close(net, jnet)
    got = [net.rnn_time_step(x[:, :3])[:, -1].numpy()]
    want = [np.asarray(jnet.rnn_time_step(x[:, :3]))[:, -1]]
    for t in range(3, SEQ):
        got.append(net.rnn_time_step(x[:, t]).numpy())
        want.append(np.asarray(jnet.rnn_time_step(x[:, t])))
    np.testing.assert_allclose(np.stack(got), np.stack(want), atol=2e-5)
    np.testing.assert_allclose(np.stack(got).sum(-1), 1.0, atol=1e-5)


def test_bf16_fit_call_matches_reference():
    jnet, net = _pair("bfloat16")
    x, y = _batch(4, 3)
    net.fit(DataSet(x, y))
    jnet.fit(JDataSet(x, y))
    np.testing.assert_allclose(net.get_score(), jnet.get_score(),
                               rtol=2.0 ** -6)
    assert all(p.dtype == torch.float32 for lyr in net.params
               for p in lyr.values())
