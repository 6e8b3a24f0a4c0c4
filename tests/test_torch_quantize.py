"""The port's weight-only int8 serving against the JAX package, on the CPU.

- ``QuantizedParams.from_params``: int8 leaves and scales bit-equal to the
  reference's, for a causal ``Bert.tiny``, LeNet and a residual conv graph
  (which leaves quantize, and in the archive's order);
- int8 archives cross both ways: the reference's restored by the port and
  the port's by the reference, with the dequantized params and the stashed
  int8 leaves bit-equal, and ``ModelRouter.load(quantize="int8")`` serving
  the stored leaves as they are;
- a stale stash (params written after the restore) is quantized afresh;
- ``quantize=None`` leaves the fp32 path as it is, and int8 serving (a
  classify graph, a generate model) stays within ``INT8_LOGIT_TOL`` of it,
  equal to the forward over the dequantized params; a rolling reload of an
  int8 model serves the new weights.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from deeplearning4j_tpu.nn import layers as JL  # noqa: E402
from deeplearning4j_tpu.nn import vertices as JV  # noqa: E402
from deeplearning4j_tpu.nn.computation_graph import \
    ComputationGraph as JGraph  # noqa: E402
from deeplearning4j_tpu.nn.conf import \
    NeuralNetConfiguration as JNNC  # noqa: E402
from deeplearning4j_tpu.serving.quantize import \
    QuantizedParams as JQP  # noqa: E402
from deeplearning4j_tpu.util.model_serializer import \
    ModelSerializer as JMS  # noqa: E402
from deeplearning4j_tpu.zoo.bert import Bert as JBert  # noqa: E402
from deeplearning4j_tpu.zoo.models import LeNet as JLeNet  # noqa: E402
from deeplearning4j_tpu_torch import interop  # noqa: E402
from deeplearning4j_tpu_torch.serving import (  # noqa: E402
    INT8_LOGIT_TOL, Generator, ModelRouter, QuantizedParams, ServingModel)
from deeplearning4j_tpu_torch.serving.quantize import \
    maybe_quantize  # noqa: E402
from deeplearning4j_tpu_torch.util.model_serializer import (  # noqa: E402
    ModelSerializer, jax_items)

RAGGED = [[1, 2, 3], [4, 5, 6, 7, 8], [9, 10, 11, 12, 13, 14, 15, 16, 17]]


def _graph_conf():
    """A residual conv block at a width whose filters quantize."""
    return (JNNC.builder().seed(3).graph_builder()
            .add_inputs("in")
            .add_layer("c1", JL.ConvolutionLayer(n_out=16, kernel_size=(3, 3),
                                                 padding="SAME"), "in")
            .add_layer("b1", JL.BatchNormalization(), "c1")
            .add_layer("r1", JL.ActivationLayer(activation="relu"), "b1")
            .add_layer("c2", JL.ConvolutionLayer(n_out=16, kernel_size=(3, 3),
                                                 padding="SAME"), "r1")
            .add_vertex("add", JV.ElementWiseVertex(op="add"), "c2", "in")
            .add_layer("pool", JL.GlobalPoolingLayer(pooling_type="avg"),
                       "add")
            .add_layer("out", JL.OutputLayer(n_in=16, n_out=5), "pool")
            .set_outputs("out").set_input_types((6, 6, 16)).build())


def _port(jnet):
    return interop.from_reference_json(
        jnet.conf.to_json(), jax.tree_util.tree_map(np.asarray, jnet.params),
        jax.tree_util.tree_map(np.asarray, jnet.states), device="cpu")


@pytest.fixture(scope="module")
def models():
    """{name: (reference net, port net, input batch)}."""
    rng = np.random.default_rng(4)
    bert = JBert.tiny(causal=True, task="mlm", vocab_size=97, max_length=32,
                      hidden_dropout=0.0).init()
    lenet = JLeNet().init()
    graph = JGraph(_graph_conf()).init()
    xs = {"bert": None,
          "lenet": rng.random((3, 28, 28, 1), dtype=np.float32),
          "graph": rng.standard_normal((3, 6, 6, 16)).astype(np.float32)}
    return {k: (j, _port(j), xs[k])
            for k, j in (("bert", bert), ("lenet", lenet), ("graph", graph))}


def _same_quantization(tq, jq_leaves, jq_scales):
    assert len(tq.qleaves) == len(jq_leaves)
    for a, b, sa, sb in zip(tq.qleaves, jq_leaves, tq.scales, jq_scales):
        a = a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)
        b = np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert (sa is None) == (sb is None)
        if sa is not None:
            sa = sa.cpu().numpy() if hasattr(sa, "cpu") else sa
            assert np.array_equal(np.asarray(sa), np.asarray(sb))


@pytest.mark.parametrize("name", ["bert", "lenet", "graph"])
def test_from_params_bit_equal_to_reference(models, name):
    jnet, net, _ = models[name]
    jq = JQP.from_params(jnet.params)
    tq = QuantizedParams.from_params(net.params)
    _same_quantization(tq, jq.qleaves, jq.scales)
    assert tq.quantized_fraction() == jq.quantized_fraction()
    assert tq.fp32_bytes() == jq.fp32_bytes()
    assert tq.fp32_bytes() / tq.resident_bytes() >= (
        3.5 if name == "bert" else 1.0)
    assert tq.quantized_fraction() > 0
    # rebuild is the dequantize, in the tree's own layout
    rebuilt = tq.device_put("cpu").rebuild()
    for (path, leaf), q, s in zip(jax_items(rebuilt), tq.qleaves, tq.scales):
        want = q.float() if s is None else q.float() * s
        assert torch.equal(leaf, want), path


@pytest.mark.parametrize("name", ["bert", "graph"])
def test_int8_archives_cross_both_ways(models, tmp_path, name):
    jnet, net, _ = models[name]
    ref_zip, port_zip = str(tmp_path / "ref.zip"), str(tmp_path / "port.zip")
    JMS.write_model(jnet, ref_zip, quantize="int8")
    ModelSerializer.write_model(net, port_zip, quantize="int8")
    for path in (ref_zip, port_zip):
        meta = ModelSerializer.peek_meta(path)
        assert meta["quantize"] == "int8"
        assert meta["fp32_bytes"] == JQP.from_params(jnet.params).fp32_bytes()
        jback = JMS.restore_model(path)
        back = ModelSerializer.restore_model(path, device="cpu")
        for (_, a), b in zip(jax_items(back.params),
                             jax.tree_util.tree_leaves(jback.params)):
            assert np.array_equal(a.numpy(), np.asarray(b))
        _, jq, js = jback._int8_archive
        _, tq, ts = back._int8_archive
        for a, b in zip(tq, jq):
            assert np.array_equal(a, np.asarray(b)) and a.dtype == b.dtype
        for a, b in zip(ts, js):
            assert (a is None) == (b is None)
            assert a is None or np.array_equal(a, b)
        # serving adopts the stored leaves as they are
        qp = maybe_quantize(back, "int8")
        _same_quantization(qp, jq, js)
    with pytest.raises(ValueError, match="quantize"):
        ModelSerializer.write_model(net, str(tmp_path / "x.zip"),
                                    quantize="fp8")


def test_stale_stash_is_quantized_afresh(models, tmp_path):
    jnet, net, _ = models["bert"]
    path = str(tmp_path / "m8.zip")
    ModelSerializer.write_model(net, path, quantize="int8")
    back = ModelSerializer.restore_model(path, device="cpu")
    stash = back._int8_archive
    assert np.array_equal(maybe_quantize(back, "int8").qleaves[0].numpy(),
                          stash[1][0])
    items = jax_items(back.params)
    big = max(range(len(items)), key=lambda i: items[i][1].numel())
    with torch.no_grad():
        items[big][1].add_(1.0)
    qp = maybe_quantize(back, "int8")
    fresh = QuantizedParams.from_params(back.params)
    _same_quantization(qp, fresh.qleaves, fresh.scales)
    assert not np.array_equal(qp.qleaves[big].numpy(), stash[1][big])
    with pytest.raises(ValueError, match="quantize mode"):
        maybe_quantize(back, "int4")
    assert maybe_quantize(back, None) is None


def test_classify_int8_serving(models):
    """int8 classify: within tolerance of fp32, equal to the forward over
    the dequantized leaves; quantize=None leaves the fp32 output as it
    is, and the program is noted once per bucket."""
    from deeplearning4j_tpu_torch.util.compile_watcher import get_watcher

    _, net, x = models["graph"]
    want = net.output(x).numpy()
    before = [t.clone() for _, t in jax_items(net.params)]
    q = ServingModel(net, "q", quantize="int8")
    with get_watcher().scope() as s:
        assert q.warmup() == len(q.policy.batch_buckets)
    assert s.traces_of("serving.classify_int8") == len(
        q.policy.batch_buckets)
    got, stats = q.execute([x[:1], x[1:]])
    got = np.concatenate(got)
    assert stats["recompiles"] == 0 and stats["real_rows"] == 3
    assert np.max(np.abs(got - want)) <= INT8_LOGIT_TOL
    deq = interop.from_reference_json(
        net.conf.to_json(), jax.tree_util.tree_map(
            np.asarray, jax.tree_util.tree_unflatten(
                jax.tree_util.tree_structure(models["graph"][0].params),
                [t.numpy() for _, t in jax_items(q._qp.rebuild())])),
        jax.tree_util.tree_map(np.asarray, models["graph"][0].states),
        device="cpu")
    np.testing.assert_allclose(got, deq.output(x).numpy(), atol=1e-6)
    assert all(torch.equal(a, b) for a, (_, b) in
               zip(before, jax_items(net.params)))
    f = ServingModel(net, "f")
    f.warmup()
    assert np.array_equal(np.concatenate(f.execute([x])[0]), want)
    d = q.describe()
    assert d["quantize"] == "int8"
    assert d["weight_bytes_fp32"] > d["weight_bytes_resident"]


def test_generate_int8_within_tolerance(models):
    _, net, _ = models["bert"]
    kw = dict(paged=True, block_size=4, batch_buckets=(1, 2, 4),
              prefill_buckets=(8, 16))
    g8, g32 = Generator(net, quantize="int8", **kw), Generator(net, **kw)
    assert g8._qp.fp32_bytes() / g8._qp.resident_bytes() >= 3.5
    tokens, lengths, _, _ = g8._prep(RAGGED, 4)
    tables = torch.zeros((4, g8.pool.max_blocks_per_stream),
                         dtype=torch.int64)
    l8 = g8._prefill_paged(tokens, lengths, tables)[:3]
    l32 = g32._prefill_paged(tokens, lengths, tables)[:3]
    assert float((l8 - l32).abs().max()) <= INT8_LOGIT_TOL
    out = g8.generate(RAGGED, max_new_tokens=6)
    assert all(len(r) == 6 for r in out)
    assert g8.pool.conservation()[0]


def test_router_load_int8_and_reload(models, tmp_path):
    """load(quantize="int8") of an int8 archive serves its stored leaves;
    a rolling reload swaps the int8 leaves with the net."""
    jnet, net, x = models["graph"]
    a, b = str(tmp_path / "a.zip"), str(tmp_path / "b.zip")
    ModelSerializer.write_model(net, a, quantize="int8")
    other = _port(JGraph(_graph_conf()).init())
    with torch.no_grad():
        for _, t in jax_items(other.params):
            t.mul_(-1.0)
    ModelSerializer.write_model(other, b, save_updater=False)
    router = ModelRouter(device="cpu")
    try:
        router.load("g", a, quantize="int8", start=False)
        model, _ = router.get("g")
        stored = model.net._int8_archive[1]
        _same_quantization(model._qp, stored, model.net._int8_archive[2])
        model.warmup()
        before = np.concatenate(model.execute([x])[0])
        assert router.reload("g", b) == 2
        after = np.concatenate(model.execute([x])[0])
        assert np.max(np.abs(after - other.output(x).numpy())) \
            <= INT8_LOGIT_TOL
        assert not np.array_equal(before, after)
        assert os.path.getsize(a) < os.path.getsize(b)
    finally:
        router.shutdown()
