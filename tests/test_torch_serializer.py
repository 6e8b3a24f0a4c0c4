"""ModelSerializer archives between the packages, on the CPU.

Five nets, each built in both packages from one conf JSON: LeNet (a
MultiLayerNetwork, archived with a fitted normalizer), the char-RNN
(TextGenerationLSTM) and ``Bert.tiny`` (both with dropout 0, so the two
packages' random streams do not enter) here; a small residual
ComputationGraph (conv, batchnorm, an add vertex) and the masked
Bidirectional(LSTM) graph, Xception (32x32, one middle repeat: 34
separable convs' ``depthW``/``pointW``) and a graph whose SharedLayer
applies a dense layer's params a second time in
``test_torch_serializer_graphs.py``.

- the reference writes after 2 steps and the port restores: the
  fingerprint string equals ``str(jax.tree_util.tree_structure(...))`` of
  params, states and optimizer state; the optimizer state is equal leaf for
  leaf; outputs within 1e-5 (Bert 1e-4) relative, 1e-6 absolute; then the
  port fits 2 steps against 2 more of the reference, params within 1e-4
  relative (1e-6 absolute), the 2+2-step trajectory against 4 reference
  steps;
- the port writes after 2 steps and the reference restores: the same
  fingerprint, counters and optimizer state, and outputs within the same
  tolerance;
- ``peek_meta``; the refusals (wrong type, hand-edited structure, int8);
  the atomic write; snapshots; normalizers; and, within the port, a net
  with dropout resuming bit for bit from its archive.
"""

import json
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet  # noqa: E402
from deeplearning4j_tpu.data.normalizers import (  # noqa: E402
    NormalizerStandardize as JNorm)
from deeplearning4j_tpu.nn import layers as JL  # noqa: E402
from deeplearning4j_tpu.nn import recurrent as JR  # noqa: E402
from deeplearning4j_tpu.nn import updaters as jupd  # noqa: E402
from deeplearning4j_tpu.nn import vertices as JV  # noqa: E402
from deeplearning4j_tpu.nn.computation_graph import (  # noqa: E402
    ComputationGraph as JGraph)
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC  # noqa: E402
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JMLN)
from deeplearning4j_tpu.util.model_serializer import (  # noqa: E402
    ModelSerializer as JMS)
from deeplearning4j_tpu.zoo.bert import Bert as JBert  # noqa: E402
from deeplearning4j_tpu.zoo.models import LeNet as JLeNet  # noqa: E402
from deeplearning4j_tpu.zoo.models import Xception as JXception  # noqa: E402
from deeplearning4j_tpu.zoo.models import (  # noqa: E402
    TextGenerationLSTM as JTextGen)
from deeplearning4j_tpu_torch.data import DataSet  # noqa: E402
from deeplearning4j_tpu_torch.nn import ComputationGraph  # noqa: E402
from deeplearning4j_tpu_torch.nn import MultiLayerNetwork  # noqa: E402
from deeplearning4j_tpu_torch.nn.computation_graph import (  # noqa: E402
    ComputationGraphConfiguration as TGConf)
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration as TConf)
from deeplearning4j_tpu_torch.util.model_serializer import (  # noqa: E402
    ModelSerializer, fingerprint, jax_items)
from deeplearning4j_tpu_torch.zoo import Bert  # noqa: E402

RTOL, ATOL = 1e-4, 1e-6


def _adam():
    return jupd.Adam(learning_rate=1e-2, epsilon=1e-3)


def _resnet_conf():
    """conv -> BN -> relu -> conv -> BN, added to the input, relu, pooled,
    dense softmax: a residual block at toy width."""
    return (JNNC.builder().seed(3).updater(_adam()).graph_builder()
            .add_inputs("in")
            .add_layer("c1", JL.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                                 padding="SAME"), "in")
            .add_layer("b1", JL.BatchNormalization(), "c1")
            .add_layer("r1", JL.ActivationLayer(activation="relu"), "b1")
            .add_layer("c2", JL.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                                 padding="SAME"), "r1")
            .add_layer("b2", JL.BatchNormalization(), "c2")
            .add_vertex("add", JV.ElementWiseVertex(op="add"), "b2", "in")
            .add_layer("r2", JL.ActivationLayer(activation="relu"), "add")
            .add_layer("pool", JL.GlobalPoolingLayer(pooling_type="avg"),
                       "r2")
            .add_layer("out", JL.OutputLayer(n_in=4, n_out=3), "pool")
            .set_outputs("out").set_input_types((6, 6, 4)).build())


def _bidir_conf():
    return (JNNC.builder().seed(5).updater(_adam()).graph_builder()
            .add_inputs("in")
            .add_layer("bi", JR.Bidirectional(layer=JR.LSTM(n_in=4, n_out=5),
                                              mode="concat"), "in")
            .add_layer("pool", JL.GlobalPoolingLayer(pooling_type="avg"),
                       "bi")
            .add_layer("out", JL.OutputLayer(n_in=10, n_out=3), "pool")
            .set_outputs("out").set_input_types((7, 4)).build())


def _shared_conf():
    """A dense layer applied twice: d2 is a SharedLayer of d1 (no params
    of its own)."""
    dense = JL.DenseLayer(n_in=6, n_out=6, activation="tanh")
    return (JNNC.builder().seed(6).updater(_adam()).graph_builder()
            .add_inputs("in")
            .add_layer("d1", dense, "in")
            .add_layer("d2", JL.SharedLayer(source="d1", layer=dense), "d1")
            .add_layer("out", JL.OutputLayer(n_in=6, n_out=3), "d2")
            .set_outputs("out").set_input_types((6,)).build())


def _onehot(rng, shape, n):
    return np.eye(n, dtype=np.float32)[rng.integers(0, n, shape)]


def _model(name):
    """(reference conf, is_graph, batches [(x, y, mask)], output rtol)."""
    rng = np.random.default_rng(1)
    if name == "lenet":
        conf = JLeNet(updater=_adam()).conf()
        data = [(rng.random((6, 28, 28, 1), dtype=np.float32),
                 _onehot(rng, 6, 10), None) for _ in range(4)]
        return conf, False, data, 1e-5
    if name == "char_rnn":
        conf = JTextGen(total_unique_characters=11, units=16, dropout=0.0,
                        max_length=8).conf()
        data = [(_onehot(rng, (4, 8), 11), _onehot(rng, (4, 8), 11), None)
                for _ in range(4)]
        return conf, False, data, 1e-5
    if name == "bert_tiny":
        conf = JBert.tiny(max_length=16, hidden_dropout=0.0,
                          updater=jupd.Adam(1e-3, epsilon=1e-3)).conf()
        x = np.stack([rng.integers(5, 90, (4, 16)),
                      rng.integers(0, 2, (4, 16))], -1).astype(np.float32)
        mask = (np.arange(16)[None] < np.array([16, 9, 12, 5])[:, None]
                ).astype(np.float32)
        data = [(x, _onehot(rng, 4, 2), mask) for _ in range(4)]
        return conf, False, data, 1e-4
    if name == "xception":
        conf = JXception(num_classes=3, input_shape=(32, 32, 3),
                         middle_repeats=1, updater=_adam()).conf()
        data = [(rng.standard_normal((4, 32, 32, 3)).astype(np.float32),
                 _onehot(rng, 4, 3), None) for _ in range(4)]
        return conf, True, data, 1e-5
    if name == "shared_graph":
        data = [(rng.standard_normal((5, 6)).astype(np.float32),
                 _onehot(rng, 5, 3), None) for _ in range(4)]
        return _shared_conf(), True, data, 1e-5
    if name == "resnet_graph":
        data = [(rng.standard_normal((5, 6, 6, 4)).astype(np.float32),
                 _onehot(rng, 5, 3), None) for _ in range(4)]
        return _resnet_conf(), True, data, 1e-5
    mask = (np.arange(7)[None] < np.array([7, 3, 5])[:, None]).astype(
        np.float32)
    data = [(rng.standard_normal((3, 7, 4)).astype(np.float32),
             _onehot(rng, 3, 3), mask) for _ in range(4)]
    return _bidir_conf(), True, data, 1e-5


#: the graphs run in tests/test_torch_serializer_graphs.py
MODELS = ["lenet", "char_rnn", "bert_tiny"]


def _ref_net(conf, graph):
    return (JGraph(conf) if graph else JMLN(conf)).init()


def _port_net(conf, graph):
    if graph:
        return ComputationGraph(TGConf.from_json(conf.to_json())).init(
            device="cpu")
    return MultiLayerNetwork(TConf.from_json(conf.to_json())).init(
        device="cpu")


def _fit_ref(jnet, batch):
    x, y, m = batch
    jnet.fit(JDataSet(x, y, m, None))


def _fit_port(net, batch):
    x, y, m = batch
    net.fit(DataSet(x, y, m, None))


def _out_ref(jnet, batch):
    x, _, m = batch
    out = jnet.output(x, mask=m) if m is not None else jnet.output(x)
    return np.asarray(out[0] if isinstance(out, (list, tuple)) else out)


def _out_port(net, batch):
    x, _, m = batch
    out = net.output(x, mask=m) if m is not None else net.output(x)
    out = out[0] if isinstance(out, (list, tuple)) else out
    return out.detach().numpy()


def _ref_leaves(tree):
    return [np.asarray(v) for v in jax.tree_util.tree_leaves(tree)]


def _port_leaves(tree):
    return [v.detach().numpy() for _, v in jax_items(tree)]


def _assert_fingerprints(net, jnet):
    for attr in ("params", "states", "opt_states"):
        assert fingerprint(getattr(net, attr)) == str(
            jax.tree_util.tree_structure(getattr(jnet, attr))), attr


def _reference_archive_restores_in_the_port(name, tmp_path, then_fit=True):
    """``then_fit=False`` leaves out the 2+2-step continuation (for a net
    whose fp32 steps are too ill-conditioned to track across packages)."""
    conf, graph, data, out_rtol = _model(name)
    jnet = _ref_net(conf, graph)
    for b in data[:2]:
        _fit_ref(jnet, b)
    path = str(tmp_path / "ref.zip")
    norm = None
    if name == "lenet":
        norm = JNorm().fit(JDataSet(data[0][0].reshape(6, -1), data[0][1]))
    JMS.write_model(jnet, path, normalizer=norm)
    net = ModelSerializer.restore_model(path, device="cpu")
    assert isinstance(net, ComputationGraph if graph else MultiLayerNetwork)
    assert (net.iteration, net.epoch) == (jnet.iteration, jnet.epoch)
    _assert_fingerprints(net, jnet)
    for got, want in zip(_port_leaves(net.opt_states),
                         _ref_leaves(jnet.opt_states)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(_out_port(net, data[2]),
                               _out_ref(jnet, data[2]), rtol=out_rtol,
                               atol=ATOL)
    if norm is not None:
        got = ModelSerializer.restore_normalizer_from_file(path)
        assert json.dumps(got.to_dict(), sort_keys=True) == json.dumps(
            norm.to_dict(), sort_keys=True)
    if not then_fit:
        return
    for b in data[2:]:
        _fit_port(net, b)
        _fit_ref(jnet, b)
    assert net.iteration == jnet.iteration == 4
    for got, want in zip(_port_leaves(net.params), _ref_leaves(jnet.params)):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _port_archive_restores_in_the_reference(name, tmp_path):
    conf, graph, data, out_rtol = _model(name)
    net = _port_net(conf, graph)
    for b in data[:2]:
        _fit_port(net, b)
    path = str(tmp_path / "port.zip")
    ModelSerializer.write_model(net, path)
    jnet = JMS.restore_model(path)
    assert (jnet.iteration, jnet.epoch) == (net.iteration, net.epoch) == (
        2, 2)
    _assert_fingerprints(net, jnet)
    for got, want in zip(_port_leaves(net.opt_states),
                         _ref_leaves(jnet.opt_states)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(_port_leaves(net.params), _ref_leaves(jnet.params)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(_out_port(net, data[2]),
                               _out_ref(jnet, data[2]), rtol=out_rtol,
                               atol=ATOL)
    assert ModelSerializer.peek_meta(path) == JMS.peek_meta(path) == {
        "type": "ComputationGraph" if graph else "MultiLayerNetwork",
        "iteration": 2, "epoch": 2, "format_version": 1}


@pytest.mark.parametrize("name", MODELS)
def test_reference_archive_restores_in_the_port(name, tmp_path):
    _reference_archive_restores_in_the_port(name, tmp_path)


@pytest.mark.parametrize("name", MODELS)
def test_port_archive_restores_in_the_reference(name, tmp_path):
    _port_archive_restores_in_the_reference(name, tmp_path)


def test_refusals(tmp_path):
    conf, graph, data, _ = _model("resnet_graph")
    jnet = _ref_net(conf, graph)
    path = str(tmp_path / "g.zip")
    JMS.write_model(jnet, path)
    with pytest.raises(ValueError, match="expected MultiLayerNetwork"):
        ModelSerializer.restore_multi_layer_network(path, device="cpu")
    edited = str(tmp_path / "edited.zip")
    with zipfile.ZipFile(path) as src, zipfile.ZipFile(edited, "w") as dst:
        for item in src.namelist():
            data_b = src.read(item)
            if item == "meta.json":
                meta = json.loads(data_b)
                meta["params_structure"] = meta["params_structure"].replace(
                    "'W'", "'w'", 1)
                data_b = json.dumps(meta)
            dst.writestr(item, data_b)
    with pytest.raises(ValueError, match="param structure"):
        ModelSerializer.restore_model(edited, device="cpu")
    net = _port_net(conf, graph)
    with pytest.raises(ValueError, match="quantize"):
        ModelSerializer.write_model(net, str(tmp_path / "q.zip"),
                                    quantize="fp8")
    # int8 archives are no longer refused: the reference's restores in
    # the port as the reference restores it (tests/test_torch_quantize.py
    # holds the leaves bit for bit)
    q8 = str(tmp_path / "int8.zip")
    JMS.write_model(jnet, q8, quantize="int8")
    assert ModelSerializer.peek_meta(q8)["quantize"] == "int8"
    back = ModelSerializer.restore_model(q8, device="cpu")
    jback = JMS.restore_model(q8)
    for a, b in zip(jax.tree_util.tree_leaves(jback.params),
                    [t for _, t in jax_items(back.params)]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert back._int8_archive[0] == fingerprint(back.params)
    lost = str(tmp_path / "lost.zip")  # its scales member lost: corrupt
    with zipfile.ZipFile(q8) as src, zipfile.ZipFile(lost, "w") as dst:
        for item in src.namelist():
            if item != "quantScales.npz":
                dst.writestr(item, src.read(item))
    with pytest.raises(KeyError, match="quantScales"):
        ModelSerializer.restore_model(lost, device="cpu")


def test_write_is_atomic(tmp_path, monkeypatch):
    conf, graph, data, _ = _model("resnet_graph")
    net = _port_net(conf, graph)
    path = tmp_path / "a.zip"
    ModelSerializer.write_model(net, str(path))
    before = path.read_bytes()
    _fit_port(net, data[0])

    def broken(self, name, data_b, *a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(zipfile.ZipFile, "writestr", broken)
    with pytest.raises(OSError, match="disk full"):
        ModelSerializer.write_model(net, str(path))
    monkeypatch.undo()
    assert path.read_bytes() == before
    assert sorted(p.name for p in tmp_path.iterdir()) == ["a.zip"]


def test_snapshot_and_normalizer_members(tmp_path):
    from deeplearning4j_tpu_torch.data.normalizers import \
        NormalizerStandardize

    conf, graph, data, _ = _model("lenet")
    net = _port_net(conf, graph)
    _fit_port(net, data[0])
    snap = ModelSerializer.snapshot(net)
    _fit_port(net, data[1])      # the snapshot does not follow the net
    path = str(tmp_path / "s.zip")
    ModelSerializer.write_snapshot(snap, path)
    back = ModelSerializer.restore_multi_layer_network(path, device="cpu")
    assert back.iteration == 1
    assert ModelSerializer.restore_normalizer_from_file(path) is None
    norm = NormalizerStandardize().fit(DataSet(data[0][0].reshape(6, -1),
                                               data[0][1]))
    ModelSerializer.add_normalizer_to_model(path, norm)
    got = ModelSerializer.restore_normalizer_from_file(path)
    np.testing.assert_array_equal(np.asarray(got.mean), np.asarray(norm.mean))
    assert JMS.restore_normalizer_from_file(path).to_dict() == \
        norm.to_dict()


def test_port_resumes_bit_for_bit_with_dropout(tmp_path):
    """Within the port the dropout generator's state rides in the archive:
    a restored net's next steps equal the original's, bit for bit."""
    net = Bert.tiny(max_length=16, hidden_dropout=0.1).init(device="cpu")
    _, _, data, _ = _model("bert_tiny")
    for b in data[:2]:
        _fit_port(net, b)
    path = str(tmp_path / "d.zip")
    ModelSerializer.write_model(net, path)
    back = ModelSerializer.restore_multi_layer_network(path, device="cpu")
    for b in data[2:]:
        _fit_port(net, b)
        _fit_port(back, b)
        assert net.get_score() == back.get_score()
    for (_, a), (_, b) in zip(jax_items(net.params), jax_items(back.params)):
        assert torch.equal(a, b)
    for (_, a), (_, b) in zip(jax_items(net.opt_states),
                              jax_items(back.opt_states)):
        assert torch.equal(a, b)
