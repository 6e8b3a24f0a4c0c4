"""The port's ResNet-50 classify-serving slice against the JAX package, on
the CPU:

- the ResNet-50 conf JSON moves between the two packages both ways;
- a narrow ResNet (7x7/s2 stem + BN + relu + SAME max-pool, a projecting
  and an identity bottleneck, global pool, softmax output; widths <= 16 at
  32x32, batch 2) built by each package's GraphBuilder gives the same
  ``output()`` from the reference's weights copied by
  ``interop.load_reference``, within 1e-4 relative (ROADMAP rule), with the
  reference at its default dispatch and on its Pallas conv kernel
  (interpret mode);
- the same graph behind the port's ModelServer answers HTTP requests with
  ``net.output`` of the same rows;
- the package imports without JAX or the JAX package.
"""

import ast
import importlib.util
import json
import pathlib
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deeplearning4j_tpu.nn.layers as JL  # noqa: E402
import deeplearning4j_tpu.nn.vertices as JV  # noqa: E402
import deeplearning4j_tpu_torch.nn.layers as TL  # noqa: E402
import deeplearning4j_tpu_torch.nn.vertices as TV  # noqa: E402
from deeplearning4j_tpu.nn import ComputationGraph as JGraph  # noqa: E402
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNNC  # noqa: E402
from deeplearning4j_tpu.nn.computation_graph import (  # noqa: E402
    ComputationGraphConfiguration as JConf)
from deeplearning4j_tpu.ops import kernels as JK  # noqa: E402
from deeplearning4j_tpu.zoo.models import ResNet50 as JResNet50  # noqa: E402
from deeplearning4j_tpu_torch import interop  # noqa: E402
from deeplearning4j_tpu_torch.data.bucketing import (  # noqa: E402
    BucketingPolicy)
from deeplearning4j_tpu_torch.nn import NeuralNetConfiguration as TNNC  # noqa: E402
from deeplearning4j_tpu_torch.nn.computation_graph import (  # noqa: E402
    ComputationGraph as TGraph, ComputationGraphConfiguration as TConf)
from deeplearning4j_tpu_torch.serving import (ModelRouter, ModelServer,  # noqa: E402
                                              QueueFullError, ServingModel)
from deeplearning4j_tpu_torch.zoo.models import ResNet50 as TResNet50  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "deeplearning4j_tpu_torch"


# ---------------------------------------------------------------- conf JSON


def test_resnet50_json_jax_to_port_and_back():
    src = JResNet50(input_shape=(32, 32, 3), num_classes=10).conf().to_json()
    back = TConf.from_json(src).to_json()
    assert json.loads(back) == json.loads(src)


def test_resnet50_json_port_to_jax_and_back():
    src = TResNet50(input_shape=(32, 32, 3), num_classes=10).conf().to_json()
    back = JConf.from_json(src).to_json()
    assert json.loads(back) == json.loads(src)
    # the same model in both packages writes the same conf
    ref = JResNet50(input_shape=(32, 32, 3), num_classes=10).conf().to_json()
    assert json.loads(src) == json.loads(ref)


def test_resnet50_full_width_graph():
    conf = TResNet50().conf()
    convs = [n for n in conf.nodes if isinstance(n.node, TL.ConvolutionLayer)]
    assert len(convs) == 53
    assert conf.input_shapes == [(224, 224, 3)]
    assert conf.nodes[-1].node.n_out == 1000


def test_chip_smoke_enumerates_resnet50_geometries():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    geoms = smoke.conv_geometries(TResNet50().conf(), batch=8)
    assert len(geoms) == 20 and sum(geoms.values()) == 53
    assert geoms[(8, 224, 224, 3, 7, 7, 64, (2, 2), "SAME", (1, 1), 1)] == 1
    assert geoms[(8, 14, 14, 256, 3, 3, 256, (1, 1), "SAME", (1, 1), 1)] == 6
    # 134 GFLOP at 67 TFLOP/s against 0 bytes: 2 ms, bound by operations
    assert smoke.bound(134e9, 0, 67e12) == {
        "bound_ms": 2.0, "ops_ms": 2.0, "bytes_ms": 0.0,
        "bound_by": "operations"}


# (case, input size, output size, window, stride, dilation, low pad,
#  input positions some window reads)
_EXTENTS = [
    ("1x1-s1", 56, 56, 1, 1, 1, 0, 56),
    ("1x1-s2", 56, 28, 1, 2, 1, 0, 28),
    ("3x3-s1-same", 56, 56, 3, 1, 1, 1, 56),
    ("7x7-s2-stem", 224, 112, 7, 2, 1, 2, 224),
    ("1x1-s2-odd", 9, 5, 1, 2, 1, 0, 5),
    ("2x2-s3-gaps", 9, 3, 2, 3, 1, 0, 6),
    ("3x3-d2-valid", 10, 6, 3, 1, 2, 0, 10),
]


@pytest.mark.parametrize("case", _EXTENTS, ids=[c[0] for c in _EXTENTS])
def test_chip_smoke_bound_reads_only_windowed_input(case):
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _, size, out, k, stride, dil, lo, want = case
    assert smoke.read_extent(size, out, k, stride, dil, lo) == want


def test_kernel_impl_vocabulary_round_trips():
    src = json.loads(
        JResNet50(input_shape=(32, 32, 3)).conf().to_json())
    src["kernel_impl"] = "pallas"
    conf = TConf.from_json(json.dumps(src))
    assert conf.kernel_impl == "cuda"
    assert json.loads(conf.to_json()) == src


# ------------------------------------------------------------ narrow ResNet


def _narrow_conf(nnc, L, V):
    """A narrow ResNet, node for node the ResNet50 zoo layout."""
    gb = nnc.builder().seed(7).graph_builder().add_inputs("input")

    def conv_bn(name, inp, n_out, k, stride=(1, 1), relu=True):
        gb.add_layer(f"{name}_conv", L.ConvolutionLayer(
            n_out=n_out, kernel_size=(k, k), stride=stride, padding="SAME",
            has_bias=False), inp)
        gb.add_layer(f"{name}_bn", L.BatchNormalization(), f"{name}_conv")
        if not relu:
            return f"{name}_bn"
        gb.add_layer(f"{name}_relu", L.ActivationLayer(activation="relu"),
                     f"{name}_bn")
        return f"{name}_relu"

    def bottleneck(name, inp, filters, stride, project):
        x = conv_bn(f"{name}_a", inp, filters[0], 1, stride=stride)
        x = conv_bn(f"{name}_b", x, filters[1], 3)
        x = conv_bn(f"{name}_c", x, filters[2], 1, relu=False)
        sc = (conv_bn(f"{name}_sc", inp, filters[2], 1, stride=stride,
                      relu=False) if project else inp)
        gb.add_vertex(f"{name}_add", V.ElementWiseVertex(op="add"), x, sc)
        gb.add_layer(f"{name}_out", L.ActivationLayer(activation="relu"),
                     f"{name}_add")
        return f"{name}_out"

    x = conv_bn("stem", "input", 8, 7, stride=(2, 2))
    gb.add_layer("stem_pool", L.SubsamplingLayer(
        kernel_size=(3, 3), stride=(2, 2), padding="SAME"), x)
    x = bottleneck("res2a", "stem_pool", (4, 4, 16), (2, 2), project=True)
    x = bottleneck("res2b", x, (4, 4, 16), (1, 1), project=False)
    gb.add_layer("avgpool", L.GlobalPoolingLayer(), x)
    gb.add_layer("output", L.OutputLayer(n_in=16, n_out=5), "avgpool")
    gb.set_outputs("output").set_input_types((32, 32, 3))
    return gb.build()


@pytest.fixture(scope="module")
def narrow():
    """(jax net with perturbed BN params/stats, numpy params, numpy
    states, input batch)."""
    jnet = JGraph(_narrow_conf(JNNC, JL, JV))

    def init():
        jnet.init()
        return jnet.params, jnet.states

    # the reference's own init, traced once, on a PRNG that compiles in a
    # fraction of threefry's time (the values only need to be random)
    prng = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", "unsafe_rbg")
    try:
        jnet.params, jnet.states = jax.jit(init)()
    finally:
        jax.config.update("jax_default_prng_impl", prng)
    rng = np.random.default_rng(11)
    for name, p in jnet.params.items():
        if "gamma" in p:  # non-trivial batchnorm, the same in both nets
            c = p["gamma"].shape[0]
            p["gamma"] = jnp.asarray(rng.uniform(0.5, 1.5, c), jnp.float32)
            p["beta"] = jnp.asarray(rng.normal(size=c) * 0.1, jnp.float32)
            s = jnet.states[name]
            s["mean"] = jnp.asarray(rng.normal(size=c) * 0.1, jnp.float32)
            s["var"] = jnp.asarray(rng.uniform(0.5, 2.0, c), jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, jnet.params)
    states = jax.tree_util.tree_map(np.asarray, jnet.states)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    return jnet, params, states, x


def test_narrow_graph_builders_write_the_same_json():
    assert (json.loads(_narrow_conf(TNNC, TL, TV).to_json())
            == json.loads(_narrow_conf(JNNC, JL, JV).to_json()))


def _port_net(jnet, params, states):
    return interop.from_reference_json(jnet.conf.to_json(), params, states,
                                       device="cpu")


@pytest.mark.parametrize("jax_impl", [None, "pallas"])
def test_narrow_resnet_output_matches_reference(narrow, jax_impl):
    """At the reference's default dispatch on both images, with the pooled
    features too; on its Pallas kernel (interpreted, a second or two per
    image on the CPU) on the first image."""
    jnet, params, states, x = narrow
    net = _port_net(jnet, params, states)
    with JK.impl_scope(jax_impl):
        if jax_impl is None:
            ref = np.asarray(jnet.output(jnp.asarray(x)))
        else:  # a forward of its own, traced under the scope
            x = x[:1]
            ref = np.asarray(jax.jit(jnet.make_forward_fn())(
                jnet.params, jnet.states, jnp.asarray(x)))
    out = net.output(x)
    assert out.device.type == "cpu" and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-7)
    if jax_impl is None:
        ref_pool = np.asarray(jnet.feed_forward(jnp.asarray(x))["avgpool"])
        pool = net.feed_forward(x)["avgpool"]
        np.testing.assert_allclose(pool.numpy(), ref_pool, rtol=1e-4,
                                   atol=1e-6)


def test_load_reference_rejects_mismatched_trees(narrow):
    jnet, params, states, _ = narrow
    net = TGraph(TConf.from_json(jnet.conf.to_json())).init(device="cpu")
    bad = dict(params)
    bad["stem_conv"] = {"W": params["stem_conv"]["W"][:, :, :, :4]}
    with pytest.raises(ValueError, match="shape"):
        interop.load_reference(net, bad, states)
    with pytest.raises(ValueError, match="node sets"):
        interop.load_reference(net, {"stem_conv": {}}, states)


def test_bf16_compute_casts_params_not_stats(narrow):
    jnet, params, states, x = narrow
    d = json.loads(jnet.conf.to_json())
    d["compute_dtype"] = "bfloat16"
    net = interop.from_reference_json(json.dumps(d), params, states,
                                      device="cpu")
    out = net.output(x)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (2, 5)
    assert net.states["stem_bn"]["mean"].dtype == torch.float32
    ref = _port_net(jnet, params, states).output(x)
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=3e-2)
    # the bf16 copies are cached, and refreshed when a param changes in place
    assert torch.equal(net.output(x), out)
    net.params["output"]["b"][0] += 1.0
    shifted = net.output(x)
    assert not torch.equal(shifted, out)
    b = params["output"]["b"].copy()
    b[0] += 1.0
    assert torch.equal(shifted, interop.from_reference_json(
        json.dumps(d), {**params, "output": {"W": params["output"]["W"],
                                             "b": b}},
        states, device="cpu").output(x))


def test_entry_points_never_drift_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = _narrow_conf(TNNC, TL, TV)
    with pytest.raises(RuntimeError, match="CUDA"):
        TGraph(conf).init()
    with pytest.raises(RuntimeError, match="CUDA"):
        TGraph(conf).init(device="cuda")


def test_inference_only_layers_name_their_slice(narrow):
    """What the port does not have yet raises, naming the slice that brings
    it (multi-device serving), and a serving kind the net cannot take is
    refused by name. Dropout in training is ported:
    a graph with dropout 0.5 on its first node trains, draws its masks
    from the graph's seeded generator (two graphs, one seed, one
    trajectory), and its inference forward applies none."""
    jnet, params, states, x = narrow
    d = json.loads(jnet.conf.to_json())
    d["nodes"][0]["node"]["dropout"] = 0.5
    y = np.eye(5, dtype=np.float32)[[0, 1]]
    nets = [interop.from_reference_json(json.dumps(d), params, states,
                                        device="cpu") for _ in range(2)]
    plain = _port_net(jnet, params, states)
    np.testing.assert_array_equal(nets[0].output(x).numpy(),
                                  plain.output(x).numpy())
    for n in nets + [plain]:
        n.fit(x, y)
    assert np.isfinite(nets[0].get_score())
    assert nets[0].get_score() == nets[1].get_score()
    assert nets[0].get_score() != plain.get_score()
    net = _port_net(jnet, params, states)
    # generate serves decoder-only LMs (tests/test_torch_decode.py): this
    # graph is refused by what it lacks; int8 classify serves it
    with pytest.raises(ValueError, match="BertEmbeddingLayer"):
        ServingModel(net, "m", kind="generate")
    with pytest.raises(ValueError, match="serving kind"):
        ServingModel(net, "m", kind="embed")
    q = ServingModel(net, "m", quantize="int8")
    assert q.describe()["quantize"] == "int8"
    with pytest.raises(NotImplementedError, match="use_mesh"):
        ServingModel(net, "m", use_mesh=True)


def test_conf_batch_buckets_pad_and_slice(narrow):
    jnet, params, states, x = narrow
    d = json.loads(jnet.conf.to_json())
    d["batch_buckets"] = [4]
    net = interop.from_reference_json(json.dumps(d), params, states,
                                      device="cpu")
    out = net.output(x[:1])  # runs at the bucket's 4 rows, returns 1
    assert tuple(out.shape) == (1, 5)
    np.testing.assert_allclose(
        out.numpy(), _port_net(jnet, params, states).output(x[:1]).numpy(),
        rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------------ serving


@pytest.mark.parametrize("n", [1, 3, 32, 33, 70])
def test_plan_serving_batch_matches_reference(n):
    from deeplearning4j_tpu.data.bucketing import BucketingPolicy as JPolicy

    buckets = (1, 2, 4, 8, 16, 32)
    assert (BucketingPolicy(batch_buckets=buckets).plan_serving_batch(n)
            == JPolicy(batch_buckets=buckets).plan_serving_batch(n))


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def test_model_server_answers_with_net_output(narrow):
    jnet, params, states, _ = narrow
    net = _port_net(jnet, params, states)
    model = ServingModel(net, "narrow", bucketing=BucketingPolicy(
        batch_buckets=(1, 2, 4, 8)))
    router = ModelRouter()
    router.register(model, max_wait_ms=1.0)
    server = ModelServer(router, port=0).start()
    try:
        rng = np.random.default_rng(5)
        for rows in (1, 3, 2):
            x = rng.normal(size=(rows, 32, 32, 3)).astype(np.float32)
            status, body = _post(f"{server.url}/v1/models/narrow/infer",
                                 {"inputs": x.tolist()})
            assert status == 200 and body["model"] == "narrow"
            got = np.asarray(body["outputs"], np.float32)
            assert got.shape == (rows, 5)
            np.testing.assert_allclose(got, net.output(x).numpy(),
                                       rtol=1e-5, atol=1e-7)
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{server.url}/v1/models/nope/infer", {"inputs": [[0.0]]})
        assert e.value.code == 404
        with urllib.request.urlopen(f"{server.url}/healthz") as r:
            health = json.loads(r.read())
        assert health["status"] == "ok"
        assert health["checks"]["devices"] == {"ok": True, "detail": "cpu"}
        # the serving section lists the model (keyed by router name when
        # this process holds more than one router)
        serving = health["serving"]
        assert any("narrow" in r["models"]
                   for r in [serving, *serving.values()]
                   if isinstance(r, dict) and "models" in r)
        with urllib.request.urlopen(f"{server.url}/v1/models") as r:
            desc = json.loads(r.read())["models"]["narrow"]
        assert desc["warmed"] and desc["counts"]["completed"] == 3
        assert desc["chunks_executed"] == 3
    finally:
        server.stop()


def test_scheduler_sheds_when_queue_full(narrow):
    jnet, params, states, _ = narrow
    model = ServingModel(_port_net(jnet, params, states), "q")
    router = ModelRouter()
    router.register(model, queue_limit=1, start=False)
    x = np.zeros((1, 32, 32, 3), np.float32)
    router.submit("q", x)
    with pytest.raises(QueueFullError):
        router.submit("q", x)
    router.shutdown()


# ------------------------------------------------------------------ imports


def test_package_imports_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import deeplearning4j_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'deeplearning4j_tpu' or k.startswith('deeplearning4j_tpu.')]"
        "\n"
        "assert len(mods) >= 20 and not bad, (mods, bad)\n"
        "new = {'deeplearning4j_tpu_torch.' + m for m in ("
        "'ops.attention', 'ops.kernels.attention', 'nn.transformer', "
        "'nn.multilayer', 'zoo.bert', 'ops.kernels.lstm', 'ops.random', "
        "'nn.recurrent', 'data.iterators', 'data.normalizers', "
        "'eval', 'eval.classification', 'eval.regression', "
        "'nn.listeners', 'earlystopping', 'nlp', 'nlp.tokenization', "
        "'nlp.bert_iterator', 'nn.transfer', 'nn.attention', 'tree', "
        "'ops.elementwise', 'ops.reduce', 'ops.shape_ops', 'ops.rnn', "
        "'ops.linalg', 'ops.image', 'ops.signal', 'ops.updater_ops', "
        "'ops.compression', 'ops.nlp_ops', 'ops.op_cases', 'ops._compat', "
        "'util.model_serializer', 'util.checkpoint', "
        "'serving.resilience', 'samediff', 'samediff.core', 'imports', "
        "'imports.protomini', 'imports.tf_proto', 'imports.tf_import', "
        "'imports.onnx_import', 'imports.graph_cases', 'config', "
        "'util.telemetry', 'util.faults', 'native', 'native.dataset', "
        "'data.prefetch', 'data.image_iterator', 'nlp.vectorizer', "
        "'datavec', 'datavec.records', 'datavec.transform', "
        "'datavec.executor', 'datavec.iterators', 'serving.generate', "
        "'serving.paged', 'serving.quantize', 'serving.fleet', "
        "'serving.fleet_worker', 'util.slo', 'util.health', "
        "'util.ui_server')}\n"
        "assert new <= set(mods), sorted(new - set(mods))\n"
        "bad = [k for k in sys.modules if k == 'orbax' or "
        "k.startswith('orbax.')]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_samediff_and_imports_load_without_frameworks():
    """SameDiff and the three importers import and run with jax,
    tensorflow, google.protobuf, onnx, h5py and the JAX package made
    unimportable (the Keras importer on a keras_cases file)."""
    code = (
        "import sys\n"
        "BLOCK = ('jax', 'jaxlib', 'tensorflow', 'google.protobuf', 'onnx',"
        " 'h5py', 'deeplearning4j_tpu')\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if any(name == b or name.startswith(b + '.') for b in BLOCK):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import numpy as np\n"
        "from deeplearning4j_tpu_torch.samediff import SameDiff\n"
        "from deeplearning4j_tpu_torch.imports import (import_graph_def, "
        "import_onnx, graph_cases, KerasModelImport)\n"
        "sd = import_onnx(graph_cases.lstm_onnx(input_size=3, hidden=4, "
        "batch=2, seq_len=5), device='cpu')\n"
        "y = sd.output({'x': np.ones((2, 5, 3), np.float32)}, ['y'])['y']\n"
        "assert y.shape == (2, 5, 4)\n"
        "gd, names = graph_cases.resnet50_graph_def(image_size=32, "
        "classes=3)\n"
        "sd = import_graph_def(gd, device='cpu')\n"
        "k = sd.tf_name_map[names['probabilities'] + ':0']\n"
        "p = sd.output({'input_1': np.ones((1, 32, 32, 3), np.float32)}, "
        "[k])[k]\n"
        "assert p.shape == (1, 3) and abs(p.sum() - 1) < 1e-5\n"
        "import tempfile, os\n"
        "from deeplearning4j_tpu_torch.imports import keras_cases\n"
        "p = keras_cases.lstm_h5(os.path.join(tempfile.mkdtemp(), 'l.h5'),"
        " steps=5, features=3, units=4)\n"
        "net = KerasModelImport.import_keras_model_and_weights(p, "
        "device='cpu')\n"
        "assert net.output(np.ones((2, 5, 3), np.float32)).shape == "
        "(2, 5, 4)\n"
        "bad = [k for k in sys.modules if any(k == b or k.startswith(b + '.')"
        " for b in BLOCK)]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_no_port_source_names_jax():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "deeplearning4j_tpu"), (
                    f"{f.relative_to(REPO)} imports {n}")
