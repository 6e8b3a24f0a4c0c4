"""The conv zoo's nine models against the JAX package's, on the CPU: SimpleCNN,
AlexNet, VGG16, VGG19, Darknet19, SqueezeNet, Xception, InceptionResNetV1
and FaceNetNN4Small2, each at a small input (the sizes the reference's own
tests/test_zoo.py runs them at; Xception at 64x64 with one middle repeat).

- the conf JSON of each equals the reference's, and the reference's JSON
  reads back into the port unchanged;
- the param trees have the reference's structure (its ``jax.tree_util``
  fingerprint) and shapes; Xception at its published 299x299x3 and 1000
  classes has 22,855,952 params and 34 separable and 6 plain convs;
- with the same params in both (the port's seeded draws, copied into the
  reference and loaded into a port net through ``interop``), every
  activation of ``feed_forward`` within 2e-5 of the reference's, relative
  to the activation's largest value where that exceeds 1 (docs/KERNELS.md:
  conv forward 2e-5 on unit-scale values);
- a 3-step ``fit`` trajectory under Sgd(0.05) for Xception, SqueezeNet
  (MergeVertex; its DropoutLayer at rate 0, as the two packages' random
  streams differ) and InceptionResNetV1 (Scale, Merge, L2Normalize):
  losses within 1e-4 relative, every param and layer-state tensor within
  1e-4 relative L2, or within 3x the reference's distance from its own
  run on the same batch in another row order where the fp32 step is that
  ill-conditioned (see the test). Sgd, not the zoo's Adam: a batchnorm
  whose output reaches another batch-statistic batchnorm through a conv
  (Xception's and InceptionResNetV1's residual blocks) has its beta's
  gradient at the level of rounding noise in either package, which
  Adam's per-element normalisation turns into steps of the learning rate
  with its sign, and SqueezeNet's relu units near zero flip between the
  packages after one Adam step (each step's gradients agree within 3e-6
  at the same params); Adam's arithmetic is held to the reference's in
  tests/test_torch_train.py, and the zoo's Adam trains these nets on the
  card in chip_smoke.py's conv_zoo phase.

The reference's weights are initialized as zeros (its own draws compile
per shape and are replaced anyway).
"""

import contextlib
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.nn import weights as JW  # noqa: E402
from deeplearning4j_tpu.nn.computation_graph import (  # noqa: E402
    ComputationGraph as JGraph)
from deeplearning4j_tpu.nn.layers import DropoutLayer as JDropout  # noqa: E402
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JMLN)
from deeplearning4j_tpu.nn.updaters import Sgd as JSgd  # noqa: E402
from deeplearning4j_tpu.zoo import models as JZ  # noqa: E402
from deeplearning4j_tpu_torch import interop  # noqa: E402
from deeplearning4j_tpu_torch import tree as ttree  # noqa: E402
from deeplearning4j_tpu_torch.nn.computation_graph import (  # noqa: E402
    ComputationGraphConfiguration as TGConf)
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration as TConf)
from deeplearning4j_tpu_torch.nn import layers as TL  # noqa: E402
from deeplearning4j_tpu_torch.util.model_serializer import (  # noqa: E402
    fingerprint, jax_items)
from deeplearning4j_tpu_torch.zoo import models as TZ  # noqa: E402

FWD_RTOL, TRAJ_RTOL = 2e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread while this module runs: under the suite's six
    workers on eight cores, the OpenMP regions of the port's plain conv
    path oversubscribe the cores and an Xception step takes ~100x its time
    alone (80 s against 0.35 s); on one thread it takes 0.3-0.7 s either
    way."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: (model, its kwargs): the reference's tests/test_zoo.py sizes
MODELS = {
    "SimpleCNN": {"num_classes": 7, "input_shape": (32, 32, 3)},
    "AlexNet": {"num_classes": 5, "input_shape": (128, 128, 3)},
    "VGG16": {"num_classes": 4, "input_shape": (32, 32, 3)},
    "VGG19": {"num_classes": 4, "input_shape": (32, 32, 3)},
    "Darknet19": {"num_classes": 6, "input_shape": (64, 64, 3)},
    "SqueezeNet": {"num_classes": 9, "input_shape": (64, 64, 3)},
    "Xception": {"num_classes": 3, "input_shape": (64, 64, 3),
                 "middle_repeats": 1},
    "InceptionResNetV1": {"num_classes": 5, "input_shape": (96, 96, 3)},
    "FaceNetNN4Small2": {"num_classes": 11, "input_shape": (96, 96, 3)},
}


@contextlib.contextmanager
def _zero_weights():
    """The reference's weight draws as zeros (numpy): its init then
    compiles nothing per shape."""
    init = JW.init
    JW.init = lambda key, name, shape, dtype=jnp.float32: np.zeros(
        tuple(shape), np.float32)
    try:
        yield
    finally:
        JW.init = init


def _confs(name, updater=None):
    kw = MODELS[name]
    if updater is None:
        return getattr(JZ, name)(**kw).conf(), getattr(TZ, name)(**kw).conf()
    return (getattr(JZ, name)(updater=updater, **kw).conf(),
            getattr(TZ, name)(updater=updater.to_dict(), **kw).conf())


def _pair(jconf, tconf):
    """(reference net, port net) holding the port's seeded params: the
    port's draws as numpy, set into the reference's zero-initialized net and
    loaded into a port net built from the reference's conf JSON."""
    graph = hasattr(tconf, "nodes")
    src = (TZ.ComputationGraph if graph else TZ.MultiLayerNetwork)(
        tconf).init(device="cpu")
    params = ttree.tree_map(lambda t: t.numpy(), src.params)
    states = ttree.tree_map(lambda t: t.numpy(), src.states)
    with _zero_weights():
        jnet = (JGraph if graph else JMLN)(jconf).init()
    to_j = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)  # noqa
    jnet.params, jnet.states = to_j(params), to_j(states)
    net = interop.from_reference_json(jconf.to_json(), params, states,
                                      device="cpu")
    return jnet, net


def _batch(shape, classes, n=2, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n,) + tuple(shape)).astype(np.float32),
            np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)])


@pytest.mark.parametrize("name", sorted(MODELS))
def test_conf_json_and_param_tree_match_reference(name):
    jconf, tconf = _confs(name)
    jd = json.loads(jconf.to_json())
    assert json.loads(tconf.to_json()) == jd
    back = (TGConf if hasattr(tconf, "nodes") else TConf).from_json(
        jconf.to_json())
    assert json.loads(back.to_json()) == jd
    jnet, net = _pair(jconf, tconf)
    assert fingerprint(net.params) == str(
        jax.tree_util.tree_structure(jnet.params))
    assert fingerprint(net.states) == str(
        jax.tree_util.tree_structure(jnet.states))
    assert [tuple(v.shape) for _, v in jax_items(net.params)] == [
        np.shape(a) for a in jax.tree_util.tree_leaves(jnet.params)]
    assert net.num_params() == jnet.num_params()


def test_xception_published_form():
    conf = TZ.Xception(input_shape=(299, 299, 3)).conf()
    kinds = [type(n.node).__name__ for n in conf.nodes]
    assert kinds.count("SeparableConvolution2D") == 34
    assert kinds.count("ConvolutionLayer") == 6
    assert kinds.count("BatchNormalization") == 40
    assert kinds.count("ElementWiseVertex") == 12
    net = TZ.ComputationGraph(conf).init(device="cpu")
    assert net.num_params() == 22_855_952
    assert net._shape_of["exit_relu4"] == (10, 10, 2048)
    assert net._shape_of["mid0_add"] == (19, 19, 728)


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= FWD_RTOL * scale, (what, err, scale)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_feed_forward_matches_reference(name):
    jconf, tconf = _confs(name)
    jnet, net = _pair(jconf, tconf)
    x, _ = _batch(MODELS[name]["input_shape"], MODELS[name]["num_classes"])
    ref, got = jnet.feed_forward(x), net.feed_forward(x)
    if isinstance(ref, dict):
        assert set(got) == set(ref)
        for k in ref:
            _close(got[k].numpy(), ref[k], (name, k))
    else:
        assert len(got) == len(ref)
        for i, (g, r) in enumerate(zip(got, ref)):
            _close(g.numpy(), r, (name, i))
    _close(net.output(x).numpy(), jnet.output(x), (name, "output"))


def _no_dropout(conf, drop):
    """The conf with every DropoutLayer node at rate 0."""
    for n in conf.nodes:
        if type(n.node).__name__ == "DropoutLayer":
            n.node = drop(rate=0.0)
    return conf


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / max(float(np.linalg.norm(np.asarray(b))), 1e-30))


#: the batch order of the reference's second run: the same step in exact
#: arithmetic, summed in another order
_PERM = [2, 0, 3, 1]


@pytest.mark.parametrize("name", ["Xception", "SqueezeNet",
                                  "InceptionResNetV1"])
def test_fit_trajectory_matches_reference(name):
    """3 steps in both packages from the same params, and the reference a
    second time on the same batch in another row order (the same
    trajectory in exact arithmetic): each loss and each tensor of the
    params and layer states within 1e-4 relative of the reference's, or
    no farther from it than 3x the reference's own repeat is, where the
    fp32 step is that ill-conditioned: the betas of the batchnorms whose
    shift a later batchnorm absorbs (their gradients are rounding noise,
    from zero), and all of InceptionResNetV1's upstream of block8, whose
    last batchnorm normalises over 4 values a channel (1x1 spatial at
    96x96, batch 4): there both packages' gradients sit about 1e-2 from
    the same step in fp64."""
    jconf, tconf = _confs(name, JSgd(0.05))
    jconf = _no_dropout(jconf, JDropout)
    tconf = _no_dropout(tconf, TL.DropoutLayer)
    jnet, net = _pair(jconf, tconf)
    jrep, _ = _pair(jconf, tconf)
    jrep._train_step = jnet._train_step  # one compile: a pure function
    x, y = _batch(MODELS[name]["input_shape"], MODELS[name]["num_classes"],
                  n=4, seed=1)
    for _ in range(3):
        jnet.fit(x, y)
        jrep.fit(x[_PERM], y[_PERM])
        net.fit(x, y)
        want = float(jnet.score_value)
        floor = _rel(float(jrep.score_value), want)
        assert _rel(net.get_score(), want) <= max(TRAJ_RTOL, 3 * floor)
    out = interop.to_numpy(net)
    for what in ("params", "states"):
        ref = dict(jax_items(jax.tree_util.tree_map(np.asarray,
                                                    getattr(jnet, what))))
        rep = dict(jax_items(jax.tree_util.tree_map(np.asarray,
                                                    getattr(jrep, what))))
        mine = dict(jax_items(out[what]))
        assert set(mine) == set(ref)
        for path, b in ref.items():
            err, floor = _rel(mine[path], b), _rel(rep[path], b)
            assert err <= max(TRAJ_RTOL, 3 * floor), (what, path, err,
                                                      floor)


def test_xception_bf16_forward_tracks_fp32():
    """compute_dtype bfloat16: the separable convs take bf16 operands and
    the network's probabilities stay within 2^-5 of the fp32 net's."""
    jconf, tconf = _confs("Xception")
    _, net = _pair(jconf, tconf)
    net16 = TZ.ComputationGraph(dataclasses.replace(
        net.conf, compute_dtype="bfloat16")).init(device="cpu")
    net16.params, net16.states = net.params, net.states
    x, _ = _batch(MODELS["Xception"]["input_shape"], 3)
    y16 = net16.output(x)
    assert y16.dtype == torch.bfloat16
    assert float((y16.float() - net.output(x)).abs().max()) <= 2.0 ** -5
