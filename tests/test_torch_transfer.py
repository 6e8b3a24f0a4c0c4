"""Transfer learning on MultiLayerNetwork (``nn/transfer.py``) against the
JAX package's, on the CPU.

- ``TransferLearning.Builder`` gives the reference's conf, JSON key for
  key: a masked-LM ``Bert.tiny`` turned into a classifier (remove the
  output layer, add ``TimeStepLayer(0)``, the tanh pooler and a 2-class
  ``OutputLayer``, freeze the embeddings and the first block), and a dense
  stack through ``n_out_replace`` (its ripple over a batchnorm to the next
  ``n_in``), ``remove_layers_from_output`` and a FineTuneConfiguration
  (updater, seed, dropout on the layers that are not frozen);
- the layers that kept their shapes carry the source's params and states,
  copied; the rest are new at their new widths;
- ``FrozenLayer``'s conf moves both ways, with its ``inner`` dict, and
  ``interop.from_reference_json`` builds the transferred net, whose output
  equals the reference's;
- a fine-tuning trajectory (4 Adam steps on ragged, masked batches) from
  the same grafted params follows the reference's within 1e-4 relative,
  and the frozen params stay bit-equal to the source's in both packages.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet  # noqa: E402
from deeplearning4j_tpu.nn import layers as JL  # noqa: E402
from deeplearning4j_tpu.nn import transfer as JT  # noqa: E402
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC  # noqa: E402,E501
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JMLN)
from deeplearning4j_tpu.nn.transformer import TimeStepLayer as JTimeStep  # noqa: E402,E501
from deeplearning4j_tpu.nn.updaters import Adam as JAdam  # noqa: E402
from deeplearning4j_tpu.zoo.bert import Bert as JBert  # noqa: E402
from deeplearning4j_tpu_torch import interop  # noqa: E402
from deeplearning4j_tpu_torch.data.dataset import DataSet  # noqa: E402
from deeplearning4j_tpu_torch.nn import MultiLayerNetwork  # noqa: E402
from deeplearning4j_tpu_torch.nn import layers as L  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration as TConf)
from deeplearning4j_tpu_torch.nn.transfer import (  # noqa: E402
    FineTuneConfiguration, FrozenLayer, TransferLearning)
from deeplearning4j_tpu_torch.nn.transformer import TimeStepLayer  # noqa: E402
from deeplearning4j_tpu_torch.nn.updaters import Adam  # noqa: E402

T, VOCAB = 16, 64
RTOL, ATOL = 1e-4, 1e-6


def _tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _mlm_pair():
    jnet = JBert.tiny(max_length=T, task="mlm", vocab_size=VOCAB,
                      hidden_dropout=0.0).init()
    net = interop.from_reference_json(jnet.conf.to_json(), _tree(jnet.params),
                                      _tree(jnet.states), device="cpu")
    return jnet, net


def _to_classifier(builder_cls, net, ts, dense, out, ft, hs=128):
    return (builder_cls(net)
            .fine_tune_configuration(ft)
            .remove_output_layer()
            .add_layer(ts(index=0))
            .add_layer(dense(n_in=hs, n_out=hs, activation="tanh"))
            .add_layer(out(n_in=hs, n_out=2, loss="mcxent",
                           activation="softmax"))
            .set_feature_extractor(1)
            .build())


def _bert_transfer():
    jsrc, src = _mlm_pair()
    jnet = _to_classifier(JT.TransferLearning.Builder, jsrc, JTimeStep,
                          JL.DenseLayer, JL.OutputLayer,
                          JT.FineTuneConfiguration(
                              updater=JAdam(1e-3, epsilon=1e-3)))
    net = _to_classifier(TransferLearning.Builder, src, TimeStepLayer,
                         L.DenseLayer, L.OutputLayer,
                         FineTuneConfiguration(
                             updater=Adam(1e-3, epsilon=1e-3)))
    return jsrc, src, jnet, net


def test_bert_transfer_conf_and_graft_match_reference():
    jsrc, src, jnet, net = _bert_transfer()
    assert json.loads(net.conf.to_json()) == json.loads(jnet.conf.to_json())
    kinds = [type(lyr).__name__ for lyr in net.layers]
    assert kinds == ["FrozenLayer", "FrozenLayer", "TransformerEncoderBlock",
                     "TimeStepLayer", "DenseLayer", "OutputLayer"]
    assert type(net.layers[0].inner).__name__ == "BertEmbeddingLayer"
    for i in range(3):  # grafted: the source's, copied
        for k, v in src.params[i].items():
            assert torch.equal(net.params[i][k], v)
            assert net.params[i][k] is not v
    assert net.params[5]["W"].shape == (128, 2)
    assert net.num_params() == jnet.num_params()


def test_frozen_layer_conf_round_trips_and_loads_reference_params():
    _, _, jnet, _ = _bert_transfer()
    conf = TConf.from_json(jnet.conf.to_json())
    assert isinstance(conf.layers[1], FrozenLayer)
    assert conf.to_json() == jnet.conf.to_json()
    assert JMLN(type(jnet.conf).from_json(conf.to_json())).conf.to_json() \
        == jnet.conf.to_json()
    net = interop.from_reference_json(jnet.conf.to_json(), _tree(jnet.params),
                                      _tree(jnet.states), device="cpu")
    rng = np.random.default_rng(2)
    x = np.stack([rng.integers(0, VOCAB, (3, T)),
                  np.zeros((3, T))], -1).astype(np.float32)
    mask = np.ones((3, T), np.float32)
    mask[1, 5:] = 0.0
    ref = np.asarray(jnet.output(jnp.asarray(x), mask=jnp.asarray(mask)))
    np.testing.assert_allclose(net.output(x, mask=mask).numpy(), ref,
                               rtol=1e-4, atol=1e-6)


def _cls_batches(n=4, b=4, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = np.stack([rng.integers(0, VOCAB, (b, T)), np.zeros((b, T))],
                     -1).astype(np.float32)
        lens = rng.integers(3, T + 1, size=b)
        mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, size=b)]
        out.append((x, y, mask))
    return out


def test_frozen_fine_tune_trajectory_matches_reference():
    jsrc, src, jnet, net = _bert_transfer()
    interop.load_reference_mln(net, _tree(jnet.params), _tree(jnet.states),
                               _tree(jnet.opt_states), jnet.iteration)
    frozen_before = [{k: v.clone() for k, v in net.params[i].items()}
                     for i in (0, 1)]
    for x, y, m in _cls_batches():
        jnet.fit(JDataSet(x, y, features_mask=m))
        net.fit(DataSet(x, y, features_mask=m))
        np.testing.assert_allclose(net.get_score(), float(jnet.get_score()),
                                   rtol=RTOL)
    for i, (mine, ref) in enumerate(zip(net.params, jnet.params)):
        for k in ref:
            np.testing.assert_allclose(mine[k].numpy(), np.asarray(ref[k]),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"layer {i} {k}")
    for i in (0, 1):  # frozen: bit-equal, here and in the reference
        for k, v in frozen_before[i].items():
            assert torch.equal(net.params[i][k], v), (i, k)
            assert np.array_equal(np.asarray(jnet.params[i][k]),
                                  np.asarray(jsrc.params[i][k])), (i, k)
    assert not torch.equal(net.params[2]["Wq"], src.params[2]["Wq"])


def test_frozen_params_stay_bit_equal_over_many_steps_with_dropout():
    """Dropout 0.1 in the trainable block, Adam at its default epsilon:
    the frozen layers run in inference mode and take zero gradients, so
    Adam's update leaves them exactly as they were."""
    _, src = _mlm_pair()
    net = (TransferLearning.Builder(src)
           .fine_tune_configuration(FineTuneConfiguration(dropout=0.1))
           .set_feature_extractor(1).build())
    before = [{k: v.clone() for k, v in net.params[i].items()}
              for i in (0, 1)]
    assert net.layers[2].dropout == 0.1 and net.layers[1].dropout == 0.0
    rng = np.random.default_rng(9)
    for _ in range(6):
        x = np.stack([rng.integers(0, VOCAB, (4, T)), np.zeros((4, T))],
                     -1).astype(np.float32)
        y = np.eye(VOCAB, dtype=np.float32)[rng.integers(0, VOCAB, (4, T))]
        net.fit(x, y)
    assert net.iteration == 6 and np.isfinite(net.get_score())
    for i in (0, 1):
        for k, v in before[i].items():
            assert torch.equal(net.params[i][k], v), (i, k)
    assert not torch.equal(net.params[3]["W"], src.params[3]["W"])


def _dense_stack(pkg):
    if pkg == "ref":
        nnc, lmod = JNNC, JL
    else:
        from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
        nnc, lmod = NeuralNetConfiguration, L
    return (nnc.builder().seed(3).list()
            .layer(lmod.DenseLayer(n_in=4, n_out=8, activation="relu"))
            .layer(lmod.BatchNormalization())
            .layer(lmod.DenseLayer(n_in=8, n_out=6, activation="relu"))
            .layer(lmod.DenseLayer(n_in=6, n_out=6, activation="relu"))
            .layer(lmod.OutputLayer(n_in=6, n_out=3))
            .set_input_type((4,)).build())


def test_n_out_replace_and_removal_match_reference():
    jsrc = JMLN(_dense_stack("ref")).init()
    src = interop.from_reference_json(jsrc.conf.to_json(), _tree(jsrc.params),
                                      _tree(jsrc.states), device="cpu")
    assert json.loads(src.conf.to_json()) == json.loads(
        MultiLayerNetwork(_dense_stack("port")).conf.to_json())

    def surgery(builder, ft, out):
        return (builder.fine_tune_configuration(ft).n_out_replace(0, 5)
                .remove_layers_from_output(1)
                .add_layer(out(n_in=6, n_out=2)).build())

    jnet = surgery(JT.TransferLearning.Builder(jsrc),
                   JT.FineTuneConfiguration(updater=JAdam(1e-2), seed=7,
                                            dropout=0.2), JL.OutputLayer)
    net = surgery(TransferLearning.Builder(src),
                  FineTuneConfiguration(updater=Adam(1e-2), seed=7,
                                        dropout=0.2), L.OutputLayer)
    assert json.loads(net.conf.to_json()) == json.loads(jnet.conf.to_json())
    assert net.conf.seed == 7 and net.layers[0].n_out == 5
    assert net.layers[2].n_in == 5 and net.layers[2].n_out == 6
    assert [tuple(p["W"].shape if "W" in p else p["gamma"].shape)
            for p in net.params] == [(4, 5), (5,), (5, 6), (6, 6), (6, 2)]
    # layer 3 kept its shape and was not re-initialized: the source's
    for k, v in src.params[3].items():
        assert torch.equal(net.params[3][k], v)
    x = np.random.default_rng(1).normal(size=(6, 4)).astype(np.float32)
    assert net.output(x).shape == (6, 2)


def _adamw_frozen(pkg):
    """The Dense 4->8->6->3 stack, layer 0 frozen, fine-tuned by
    AdamW(1e-2, weight_decay=0.1)."""
    if pkg == "ref":
        nnc, lmod, tl, ftc = JNNC, JL, JT.TransferLearning, \
            JT.FineTuneConfiguration
        from deeplearning4j_tpu.nn.updaters import AdamW as adamw
    else:
        from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
        from deeplearning4j_tpu_torch.nn.updaters import AdamW as adamw
        nnc, lmod, tl, ftc = (NeuralNetConfiguration, L, TransferLearning,
                              FineTuneConfiguration)
    conf = (nnc.builder().seed(3).list()
            .layer(lmod.DenseLayer(n_in=4, n_out=8, activation="relu"))
            .layer(lmod.DenseLayer(n_in=8, n_out=6, activation="relu"))
            .layer(lmod.OutputLayer(n_in=6, n_out=3))
            .set_input_type((4,)).build())
    return conf, tl, ftc(updater=adamw(1e-2, weight_decay=0.1))


def test_frozen_layer_drifts_under_adamw_equally_in_both_packages():
    """ROADMAP Queue 3: a FrozenLayer takes the net's updater, and AdamW
    adds lr*wd*param to its zero gradient's update, so the frozen W moves
    (by up to 2.392e-3 after 3 steps here) in both packages alike."""
    jconf, jtl, jft = _adamw_frozen("ref")
    jsrc = JMLN(jconf).init()
    jnet = jtl.Builder(jsrc).fine_tune_configuration(jft) \
        .set_feature_extractor(0).build()
    conf, tl, ft = _adamw_frozen("port")
    src = interop.from_reference_json(jconf.to_json(), _tree(jsrc.params),
                                      _tree(jsrc.states), device="cpu")
    net = tl.Builder(src).fine_tune_configuration(ft) \
        .set_feature_extractor(0).build()
    interop.load_reference_mln(net, _tree(jnet.params), _tree(jnet.states))
    w0 = net.params[0]["W"].clone()
    jw0 = np.asarray(jnet.params[0]["W"])
    rng = np.random.default_rng(4)
    x = rng.normal(size=(8, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    for _ in range(3):
        jnet.fit(x, y)
        net.fit(x, y)
    moved = (net.params[0]["W"] - w0).abs().max().item()
    jmoved = float(np.abs(np.asarray(jnet.params[0]["W"]) - jw0).max())
    np.testing.assert_allclose(moved, 2.392e-3, rtol=1e-3)
    np.testing.assert_allclose(moved, jmoved, rtol=1e-5)
    np.testing.assert_allclose(net.params[0]["W"].numpy(),
                               np.asarray(jnet.params[0]["W"]), rtol=1e-6,
                               atol=1e-7)
