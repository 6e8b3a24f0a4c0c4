"""Keras import parity: the same Keras file into the reference's importer
(``deeplearning4j_tpu.imports.keras_import``, h5py) and the port's
(``deeplearning4j_tpu_torch.imports.keras_import``, h5mini), on the CPU.

- Every case of ``tests/test_keras_import.py`` (legacy ``.h5`` and
  ``.keras`` v3; the four applications of its corpus, at its own sizes,
  in ``test_torch_keras_corpus.py``) runs with the importer returning a
  :class:`DualNet`: both packages
  import the file, their conf JSON and param trees must be equal, and each
  ``output`` must agree within rtol 1e-4 / atol 1e-5 (the reference
  file's tightest); the port's output goes back to the reference test,
  which holds it against tf.keras's at the test's own tolerance. An error
  of the reference's importer must come from the port's with the same
  class.
- MobileNetV2 (alpha 0.35, 32x32) through ``keras_cases``' file, its
  head made an OutputLayer in both: Sgd steps (one at batch 4, two at
  batch 8), each loss and tensor within 1e-4 relative of the reference's
  fp64 run (``jax.enable_x64``) or no farther from it than 3x the
  reference's own fp32 run is (the fp32 steps of random conv nets are
  ill-conditioned in both packages).
- ``keras_cases.mobilenet_v2_config`` equals what tf.keras's legacy save
  writes, field for field, and its files load in tf.keras; the small
  Sequential cases agree across tf.keras and both importers.
- The reference faults the port mirrors: Keras ``ReLU(6.0)`` imports as a
  plain relu in both.
- Unsupported layers raise ``KerasImportError`` with the reference's
  message; archives of an imported MobileNetV2 cross both ways, and so do
  its params through ``interop``.
- The port imports a ``keras_cases`` file, legacy and ``.keras``, with
  h5py, tensorflow, jax and the JAX package unimportable.
"""

import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")
torch = pytest.importorskip("torch")

import jax  # noqa: E402

from deeplearning4j_tpu.imports import keras_import as ref_k  # noqa: E402
from deeplearning4j_tpu_torch import interop  # noqa: E402
from deeplearning4j_tpu_torch import tree as ttree  # noqa: E402
from deeplearning4j_tpu_torch.imports import keras_cases  # noqa: E402
from deeplearning4j_tpu_torch.imports import keras_import as port_k  # noqa: E402

from test_torch_samediff import (_same_error, reference_cases,  # noqa: E402
                                 run_reference_case)

import test_keras_import  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_RTOL, OUT_ATOL, TRAJ_RTOL = 1e-4, 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread while this module runs (the suite runs six
    workers on eight cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


class DualNet:
    """A network imported by both packages from one file. ``output`` runs
    both and returns the port's (numpy); every other attribute is the
    reference's network (the reference test's transfer-learning leg)."""

    def __init__(self, ref, port):
        assert json.loads(port.conf.to_json()) == json.loads(
            ref.conf.to_json())
        self.ref, self.port = ref, port
        rp = _np_tree(ref.params)
        pp = interop.to_numpy(port)["params"]
        r_items = dict(ttree.tree_items(rp))
        p_items = dict(ttree.tree_items(pp))
        assert set(r_items) == set(p_items)
        for path, a in r_items.items():
            np.testing.assert_array_equal(p_items[path],
                                          np.asarray(a, np.float32))

    def output(self, *xs):
        r, p = self.ref.output(*xs), self.port.output(*xs)
        rs = list(r) if isinstance(r, (list, tuple)) else [r]
        ps = list(p) if isinstance(p, (list, tuple)) else [p]
        assert len(rs) == len(ps)
        outs = []
        for a, b in zip(ps, rs):
            a = a.detach().numpy()
            np.testing.assert_allclose(a, np.asarray(b), rtol=OUT_RTOL,
                                       atol=OUT_ATOL)
            outs.append(a)
        return outs if isinstance(r, (list, tuple)) else outs[0]

    def __getattr__(self, name):
        return getattr(self.ref, name)


class DualKerasModelImport:
    @staticmethod
    def import_keras_model_and_weights(path):
        r, p = _same_error(
            lambda: ref_k.KerasModelImport.import_keras_model_and_weights(
                path),
            lambda: port_k.KerasModelImport.import_keras_model_and_weights(
                path, device="cpu"))
        return DualNet(r, p)


PATCHES = [(test_keras_import, "KerasModelImport", DualKerasModelImport)]


@pytest.mark.parametrize("module_name,cls,name,kwargs", reference_cases(
    test_keras_import, lambda c, n: c != "TestKerasFullModelCorpus"))
def test_reference_case_on_both(module_name, cls, name, kwargs, tmp_path):
    """Each case of tests/test_keras_import.py but its corpus (in
    tests/test_torch_keras_corpus.py, so another worker takes it)."""
    tf.keras.backend.clear_session()
    run_reference_case(module_name, cls, name, kwargs, tmp_path, PATCHES)


def test_builder_tables_equal():
    assert set(port_k._LAYER_BUILDERS) == set(ref_k._LAYER_BUILDERS)
    assert len(port_k._LAYER_BUILDERS) == 51
    assert port_k._MERGE_VERTICES == ref_k._MERGE_VERTICES
    assert set(port_k._RNN_BUILDERS_FOR_BIDIR) == set(
        ref_k._RNN_BUILDERS_FOR_BIDIR)
    for name in ("Conv2D", "PReLU", "ConvLSTM2D", "BatchNormalization",
                 "SpatialDropout1D"):
        assert port_k._to_snake_case(name) == ref_k._to_snake_case(name)


# ------------------------------------------------------------ keras_cases


def _diff(a, b, path=""):
    """Paths where two JSON trees differ."""
    if type(a) is not type(b):
        return [path]
    if isinstance(a, dict):
        return ([f"{path}/{k}" for k in set(a) ^ set(b)]
                + [d for k in set(a) & set(b)
                   for d in _diff(a[k], b[k], f"{path}/{k}")])
    if isinstance(a, list):
        if len(a) != len(b):
            return [path]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in _diff(x, y, f"{path}[{i}]")]
    return [] if a == b else [path]


@pytest.mark.parametrize("kw", [
    {}, {"input_shape": (32, 32, 3), "alpha": 0.35, "include_top": False,
         "pooling": "avg"},
    {"input_shape": (35, 33, 3), "alpha": 1.4, "classes": 7},
    {"input_shape": (64, 64, 3), "alpha": 0.5, "include_top": False,
     "pooling": "max"}], ids=["224", "32-a035-avg", "35x33-a14", "64-max"])
def test_mobilenet_v2_config_equals_tf_keras(kw, tmp_path):
    """The legacy save's model_config, whole, and every layer's weight
    names and shapes in save order."""
    h5py = pytest.importorskip("h5py")
    tf.keras.backend.clear_session()
    model = tf.keras.applications.MobileNetV2(weights=None, **kw)
    path = str(tmp_path / "m.h5")
    model.save(path)
    with h5py.File(path, "r") as f:
        want = json.loads(f.attrs["model_config"])
        mw = f["model_weights"]
        want_w = {k: [(n, tuple(mw[k][n].shape))
                      for n in mw[k].attrs["weight_names"]]
                  for k in mw.attrs["layer_names"]}
    got, weights = keras_cases.mobilenet_v2_config(**kw)
    assert _diff(got, want) == []
    assert list(weights) == list(want_w)
    assert {k: [(n, tuple(s)) for n, s in v] for k, v in weights.items()} \
        == want_w
    if not kw:
        counts = keras_cases.mobilenet_v2_counts()
        assert counts["params"] == model.count_params() == 3538984
        assert (counts["DepthwiseConv2D"], counts["Conv2D"],
                counts["BatchNormalization"], counts["ReLU"], counts["Add"],
                counts["ZeroPadding2D"]) == (17, 35, 52, 35, 10, 4)


@pytest.mark.parametrize("case", ["conv1d", "depthwise", "lstm"])
def test_sequential_cases_load_in_tf_keras_and_both_importers(case,
                                                              tmp_path):
    path = str(tmp_path / f"{case}.h5")
    make, shape = {
        "conv1d": (lambda p: keras_cases.conv1d_h5(
            p, length=16, channels=4, filters=(8, 6)), (3, 16, 4)),
        "depthwise": (lambda p: keras_cases.depthwise_h5(
            p, size=9, channels=3), (2, 9, 9, 3)),
        "lstm": (lambda p: keras_cases.lstm_h5(
            p, steps=5, features=4, units=6), (3, 5, 4)),
    }[case]
    make(path)
    x = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    tf.keras.backend.clear_session()
    golden = np.asarray(tf.keras.models.load_model(path, compile=False)(x))
    net = DualKerasModelImport.import_keras_model_and_weights(path)
    np.testing.assert_allclose(net.output(x), golden, atol=1e-5, rtol=1e-4)


def test_relu_max_value_is_dropped_in_both_packages(tmp_path):
    """ROADMAP Queue 3: Keras's ReLU layer imports as a plain relu in both
    packages (reference ``keras_import.py:849``): on x = [[10, -1, 3, 7]]
    ReLU(6.0) caps 10 and 7 at 6 in tf.keras, and the imports do not."""
    tf.keras.utils.set_random_seed(5)
    m = tf.keras.Sequential([tf.keras.layers.Input((4,)),
                             tf.keras.layers.ReLU(6.0),
                             tf.keras.layers.Dense(2)])
    path = str(tmp_path / "relu6.h5")
    m.save(path)
    x = np.array([[10.0, -1.0, 3.0, 7.0]], np.float32)
    keras_out = np.asarray(m(x))
    net = DualKerasModelImport.import_keras_model_and_weights(path)
    got = net.output(x)  # the port's, equal to the reference's
    w, b = (np.asarray(v) for v in m.layers[-1].get_weights())
    np.testing.assert_allclose(got, np.maximum(x, 0) @ w + b, rtol=1e-6)
    np.testing.assert_allclose(keras_out, np.minimum(np.maximum(x, 0), 6)
                               @ w + b, rtol=1e-6)
    assert np.abs(got - keras_out).max() > 0.1
    lyr = net.port.conf.layers[0]
    assert (type(lyr).__name__, lyr.activation, lyr.activation_args) == (
        "ActivationLayer", "relu", None)


@pytest.mark.parametrize("build", [
    lambda: [tf.keras.layers.Input((5, 3)),
             tf.keras.layers.Conv1D(2, 2, padding="causal")],
    lambda: [tf.keras.layers.Input((5, 3)),
             tf.keras.layers.GRU(2, reset_after=False)],
    lambda: [tf.keras.layers.Input((4,)),
             tf.keras.layers.Dense(2, activation="leaky_relu")],
    lambda: [tf.keras.layers.Input((5, 3)), tf.keras.layers.Masking()],
    lambda: [tf.keras.layers.Input((5, 4, 3)),
             tf.keras.layers.TimeDistributed(tf.keras.layers.Conv1D(2, 1))],
    lambda: [tf.keras.layers.Input((4, 4, 2)),
             tf.keras.layers.GlobalAveragePooling2D(keepdims=True)],
    lambda: [tf.keras.layers.Input((4,)), tf.keras.layers.Reshape((2, 2))],
], ids=["causal", "gru-reset-before", "leaky-string", "masking-last",
        "td-conv", "keepdims", "reshape"])
def test_unsupported_layers_raise_the_reference_message(build, tmp_path):
    tf.keras.backend.clear_session()
    path = str(tmp_path / "u.h5")
    tf.keras.Sequential(build()).save(path)
    with pytest.raises(Exception) as ref_err:
        ref_k.KerasModelImport.import_keras_model_and_weights(path)
    with pytest.raises(Exception) as port_err:
        port_k.KerasModelImport.import_keras_model_and_weights(
            path, device="cpu")
    assert type(port_err.value).__name__ == type(ref_err.value).__name__
    assert str(port_err.value) == str(ref_err.value)
    if type(ref_err.value).__name__ == "KerasImportError":
        assert isinstance(port_err.value, port_k.KerasImportError)


def test_keras_v3_unused_weight_groups_refused_as_in_the_reference(
        tmp_path):
    """A .keras whose weight store holds a group no config layer claims:
    both importers raise the same KerasImportError."""
    tf.keras.backend.clear_session()
    m = tf.keras.Sequential([tf.keras.layers.Input((3,)),
                             tf.keras.layers.Dense(2)])
    path = str(tmp_path / "m.keras")
    m.save(path)
    with zipfile.ZipFile(path) as z:
        members = {n: z.read(n) for n in z.namelist()}
    cfg = json.loads(members["config.json"])
    cfg["config"]["layers"][1]["class_name"] = "Dense2"  # slug drifts
    members["config.json"] = json.dumps(cfg).encode()
    bad = str(tmp_path / "bad.keras")
    with zipfile.ZipFile(bad, "w") as z:
        for n, data in members.items():
            z.writestr(n, data)
    errs = []
    for call in (lambda: ref_k.KerasModelImport.import_keras_model_and_weights(
            bad), lambda: port_k.KerasModelImport.
            import_keras_model_and_weights(bad, device="cpu")):
        with pytest.raises(Exception) as e:
            call()
        errs.append((type(e.value).__name__, str(e.value)))
    assert errs[0] == errs[1] and errs[0][0] == "KerasImportError"
    assert "did not match any config layer" in errs[0][1]


# ----------------------------------------------------------- MobileNetV2


def _small_mobilenet(tmp_path, classes=10):
    path = keras_cases.mobilenet_v2_h5(
        str(tmp_path / "mnv2.h5"), input_shape=(32, 32, 3), alpha=0.35,
        classes=classes, seed=12345)
    return path, DualKerasModelImport.import_keras_model_and_weights(path)


def _trainable_pair(net, updater):
    """Both packages' networks from the reference's imported conf with an
    OutputLayer head and the reference's imported params and states, and a
    third, the reference's in float64 (built, like every call of it, under
    ``jax.enable_x64``)."""
    from deeplearning4j_tpu.nn import ComputationGraph as JGraph
    from deeplearning4j_tpu.nn.computation_graph import (
        ComputationGraphConfiguration as JConf)
    from deeplearning4j_tpu_torch.nn import ComputationGraph as TGraph
    from deeplearning4j_tpu_torch.nn.computation_graph import (
        ComputationGraphConfiguration as TConf)

    conf_json = keras_cases.with_output_head(net.ref.conf.to_json(),
                                             updater)
    p, s = _np_tree(net.ref.params), _np_tree(net.ref.states)

    def ref(dtype):
        jnet = JGraph(JConf.from_json(conf_json)).init()
        jnet.params = jax.tree_util.tree_map(
            lambda a: jax.numpy.asarray(a, dtype), p)
        jnet.states = jax.tree_util.tree_map(
            lambda a: jax.numpy.asarray(a, dtype), s)
        return jnet

    with jax.enable_x64(True):
        j64 = ref(np.float64)
    tnet = interop.load_reference(
        TGraph(TConf.from_json(conf_json)).init(device="cpu"), p, s)
    return ref(np.float32), j64, tnet


def _check_tree(got, ref32, ref64, what):
    """Each tensor of the port's fp32 run within TRAJ_RTOL (of its largest
    value) of the reference's fp64 run, or no farther from it than 3x the
    reference's own fp32 run is."""
    for path, e in ttree.tree_items(ref64):
        g, r = ttree.tree_get(got, path), ttree.tree_get(ref32, path)
        dist = float(np.abs(g - e).max())
        noise = float(np.abs(r - e).max())
        assert dist <= max(TRAJ_RTOL * float(np.abs(e).max()), 3.0 * noise,
                           1e-7), (what, path, dist, noise)


@pytest.mark.parametrize("batch,steps", [(4, 1), (8, 2)],
                         ids=["b4-1step", "b8-2steps"])
def test_mobilenet_v2_sgd_trajectory_matches_reference(batch, steps,
                                                       tmp_path):
    """keras_cases' MobileNetV2 (alpha 0.35, 32x32) imported by both, its
    head an OutputLayer: the inference activations, then Sgd steps in the
    port and in the reference in fp32 and in fp64. Each loss and tensor of
    the port within 1e-4 relative of the reference's fp64 run, or no
    farther from it than 3x the reference's own fp32 run is. In training
    the last blocks' batchnorms normalise N values a channel (1x1 maps),
    so the fp32 trajectory is chaotic in either package: at batch 4 the
    reference's fp32 loss is 25% from its fp64 loss at the second step,
    and at batch 8 9% at the third (where the port's is 9% from it too),
    so batch 4 runs one step and batch 8 two. Within those the port's
    losses sit within 0.07x (batch 8) and 0.27x (batch 4) of the gate and
    its tensors within 0.41x and 0.52x."""
    from deeplearning4j_tpu_torch.nn.updaters import Sgd

    _, net = _small_mobilenet(tmp_path)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(batch, 32, 32, 3)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, batch)]
    net.output(x)  # both, within OUT_ATOL
    ff_r = net.ref.feed_forward(x)
    ff_p = net.port.feed_forward(x)
    for k in ("global_average_pooling2d", "block_16_project_BN",
              "block_1_pad", "block_1_depthwise"):
        np.testing.assert_allclose(ff_p[k].numpy(), np.asarray(ff_r[k]),
                                   atol=2e-5, rtol=1e-4)
    j32, j64, tnet = _trainable_pair(net, Sgd(learning_rate=0.05).to_dict())
    for step in range(steps):
        j32.fit(x, y)
        with jax.enable_x64(True):
            j64.fit(x.astype(np.float64), y.astype(np.float64))
            l64 = float(j64.score_value)
            exact = {w: _np_tree(getattr(j64, w))
                     for w in ("params", "states")}
        tnet.fit(x, y)
        l32, lp = float(j32.score_value), float(tnet.get_score())
        assert abs(lp - l64) <= max(TRAJ_RTOL * abs(l64),
                                    3.0 * abs(l32 - l64)), (step, lp, l32,
                                                            l64)
        assert exact["params"]["Conv1"]["W"].dtype == np.float64
        mine = interop.to_numpy(tnet)
        for what in ("params", "states"):
            _check_tree(mine[what], _np_tree(getattr(j32, what)),
                        exact[what], f"{what}, step {step}")


def test_imported_archives_cross_both_ways(tmp_path):
    """An imported MobileNetV2's ModelSerializer archive, written by either
    package, restores in the other with the same outputs; its params also
    cross through interop.from_reference_json."""
    from deeplearning4j_tpu.util.model_serializer import (
        ModelSerializer as JSer)
    from deeplearning4j_tpu_torch.util import ModelSerializer as TSer

    _, net = _small_mobilenet(tmp_path, classes=4)
    x = np.random.default_rng(3).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(net.ref.output(x))
    TSer.write_model(net.port, str(tmp_path / "port.zip"))
    JSer.write_model(net.ref, str(tmp_path / "ref.zip"))
    back_ref = JSer.restore_model(str(tmp_path / "port.zip"))
    back_port = TSer.restore_model(str(tmp_path / "ref.zip"), device="cpu")
    np.testing.assert_allclose(np.asarray(back_ref.output(x)), want,
                               atol=1e-6)
    np.testing.assert_allclose(back_port.output(x).numpy(), want, atol=1e-6)
    via = interop.from_reference_json(net.ref.conf.to_json(),
                                      _np_tree(net.ref.params),
                                      _np_tree(net.ref.states), device="cpu")
    np.testing.assert_allclose(via.output(x).numpy(), want, atol=1e-6)


def test_layers_spatial_param_trees_cross_through_interop():
    """An MLN of the new param-holding layers (PReLU's alpha, the
    depthwise, 1-D, locally connected and element-wise W/b) built by the
    reference: its params into the port by conf JSON and back out equal,
    outputs within 2e-5."""
    from deeplearning4j_tpu.nn import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNNC
    from deeplearning4j_tpu.nn import layers as JL
    from deeplearning4j_tpu.nn import layers_spatial as JS

    conf = (JNNC.builder().seed(2).list()
            .layer(JS.DepthwiseConvolution2D(depth_multiplier=2,
                                             stride=(2, 2)))
            .layer(JS.PReLULayer())
            .layer(JS.LocallyConnected2D(n_out=3, kernel_size=(2, 2)))
            .layer(JS.ElementWiseMultiplicationLayer(activation="tanh"))
            .layer(JL.OutputLayer(n_out=4))
            .set_input_type((9, 9, 2)).build())
    jnet = JMLN(conf).init()
    p, s = _np_tree(jnet.params), _np_tree(jnet.states)
    tnet = interop.from_reference_json(conf.to_json(), p, s, device="cpu")
    back = dict(ttree.tree_items(interop.to_numpy(tnet)["params"]))
    want = dict(ttree.tree_items(p))
    assert set(back) == set(want) and {path[1] for path in want} == {
        "W", "b", "alpha", "w"}
    for path, a in want.items():
        np.testing.assert_array_equal(back[path], a)
    x = np.random.default_rng(1).normal(size=(3, 9, 9, 2)).astype(
        np.float32)
    np.testing.assert_allclose(tnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), atol=2e-5)


def test_import_without_h5py_tensorflow_or_jax(tmp_path):
    """keras_cases files, legacy HDF5 and a .keras zip (its config.json
    and the same weights in the v3 store's layout), imported with h5py,
    tensorflow, jax and the JAX package unimportable."""
    code = (
        "import sys, json, zipfile\n"
        "BLOCK = ('jax', 'jaxlib', 'tensorflow', 'h5py', 'keras',"
        " 'deeplearning4j_tpu')\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if any(name == b or name.startswith(b + '.') for b in BLOCK):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import numpy as np\n"
        "from deeplearning4j_tpu_torch.imports import (KerasModelImport,"
        " keras_cases, h5mini)\n"
        f"d = {str(tmp_path)!r}\n"
        "p = keras_cases.mobilenet_v2_h5(d + '/m.h5', input_shape=(32, 32,"
        " 3), alpha=0.35, classes=3)\n"
        "net = KerasModelImport.import_keras_model_and_weights(p,"
        " device='cpu')\n"
        "y = net.output(np.ones((2, 32, 32, 3), np.float32)).numpy()\n"
        "assert y.shape == (2, 3) and abs(y.sum() - 2) < 1e-5\n"
        "p = keras_cases.conv1d_h5(d + '/c.h5', length=16, channels=4,"
        " filters=(8, 6))\n"
        "f = h5mini.File(p)\n"
        "cfg = json.loads(f.attrs['model_config'])\n"
        "w = h5mini.Writer()\n"
        "for name, sub in (('conv1d', 'conv1d'), ('conv1d_1', 'conv1d_1'),"
        " ('dense', 'dense')):\n"
        "    g = f['model_weights'][name]\n"
        "    for i, wn in enumerate(g.attrs['weight_names']):\n"
        "        w.create_dataset(f'layers/{sub}/vars/{i}', g[wn][()])\n"
        "with zipfile.ZipFile(d + '/c.keras', 'w') as z:\n"
        "    z.writestr('config.json', json.dumps(cfg))\n"
        "    z.writestr('model.weights.h5', w.tobytes())\n"
        "a = KerasModelImport.import_keras_model_and_weights(d + '/c.keras',"
        " device='cpu')\n"
        "b = KerasModelImport.import_keras_model_and_weights(p,"
        " device='cpu')\n"
        "x = np.random.default_rng(0).normal(size=(2, 16, 4)).astype("
        "np.float32)\n"
        "assert np.array_equal(a.output(x).numpy(), b.output(x).numpy())\n"
        "bad = [k for k in sys.modules if any(k == b or k.startswith(b + '.')"
        " for b in BLOCK)]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
