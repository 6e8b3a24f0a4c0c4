"""The port's CompileWatcher, ``warmup`` and RecompileListener against the
reference's, on the CPU (``util/compile_watcher.py``, ``nn/listeners.py``).

One build of a program per signature counts as one trace, as one trace of
a jitted function does in the reference: ``_shape_of`` gives the same
signature for a tensor as the reference for the array it came from;
``warmup`` builds as many programs for each network, train and inference,
as the reference compiles; ``RecompileListener`` reports the same
(iteration, function, new traces) over a ragged run of batch sizes, with
and without ``batch_buckets``; ``ServingModel.warmup`` primes as many.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.nn import layers as JL  # noqa: E402
from deeplearning4j_tpu.nn import updaters as jupd  # noqa: E402
from deeplearning4j_tpu.nn.computation_graph import (  # noqa: E402
    ComputationGraph as JGraph)
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC  # noqa: E402,E501
from deeplearning4j_tpu.nn.listeners import (  # noqa: E402
    RecompileListener as JRecompile)
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JMLN)
from deeplearning4j_tpu.serving.model import (  # noqa: E402
    ServingModel as JServingModel)
from deeplearning4j_tpu.util import compile_watcher as jcw  # noqa: E402
from deeplearning4j_tpu_torch.nn import ComputationGraph, MultiLayerNetwork  # noqa: E402,E501
from deeplearning4j_tpu_torch.nn.computation_graph import (  # noqa: E402
    ComputationGraphConfiguration as TGConf)
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration as TConf)
from deeplearning4j_tpu_torch.nn.listeners import RecompileListener  # noqa: E402
from deeplearning4j_tpu_torch.serving import ServingModel  # noqa: E402
from deeplearning4j_tpu_torch.util import compile_watcher as cw  # noqa: E402


def _arrays():
    rng = np.random.default_rng(0)
    return [
        rng.normal(size=(2, 3)).astype(np.float32),
        rng.integers(0, 5, size=(4,)).astype(np.int32),
        np.ones((2, 2), bool),
        None,
        [np.zeros((1, 2), np.float32), None],
        {"b": np.zeros((3,), np.float32), "a": None},
        (np.zeros((2, 1, 4), np.int64),),
        7,
    ]


def _to_torch(a):
    if isinstance(a, np.ndarray):
        return torch.from_numpy(a)
    if isinstance(a, (list, tuple)):
        return type(a)(_to_torch(v) for v in a)
    if isinstance(a, dict):
        return {k: _to_torch(v) for k, v in a.items()}
    return a


@pytest.mark.parametrize("i", range(len(_arrays())))
def test_shape_of_matches_reference(i):
    a = _arrays()[i]
    want = jcw._shape_of(a)
    assert cw._shape_of(a) == want
    assert cw._shape_of(_to_torch(a)) == want


def test_shape_of_names_bf16_as_the_reference():
    j = jnp.zeros((2, 3), jnp.bfloat16)
    assert cw._shape_of(torch.zeros((2, 3), dtype=torch.bfloat16)) == \
        jcw._shape_of(j)


# ------------------------------------------------------------ the nets
def _mln_conf(buckets=None):
    b = JNNC.builder().seed(2).updater(jupd.Sgd(0.1))
    if buckets is not None:
        b._batch_buckets = buckets
    return (b.list().layer(JL.DenseLayer(n_in=5, n_out=6, activation="tanh"))
            .layer(JL.OutputLayer(n_in=6, n_out=3))
            .set_input_type((5,)).build())


def _graph_conf(buckets=None):
    b = JNNC.builder().seed(2).updater(jupd.Sgd(0.1))
    if buckets is not None:
        b._batch_buckets = buckets
    return (b.graph_builder().add_inputs("a", "b")
            .add_layer("da", JL.DenseLayer(n_in=5, n_out=4), "a")
            .add_layer("db", JL.DenseLayer(n_in=2, n_out=4), "b")
            .add_layer("out", JL.OutputLayer(n_in=8, n_out=3), "da", "db")
            .set_outputs("out").set_input_types((5,), (2,)).build())


def _pair(kind, buckets=None):
    if kind == "mln":
        jconf = _mln_conf(buckets)
        return (JMLN(jconf).init(),
                MultiLayerNetwork(TConf.from_json(jconf.to_json())).init(
                    device="cpu"))
    jconf = _graph_conf(buckets)
    return (JGraph(jconf).init(),
            ComputationGraph(TGConf.from_json(jconf.to_json())).init(
                device="cpu"))


@pytest.mark.parametrize("kind", ["mln", "graph"])
@pytest.mark.parametrize("train,inference", [(True, True), (True, False),
                                             (False, True)],
                         ids=["both", "train", "inference"])
def test_warmup_counts_match_reference(kind, train, inference):
    """The default shapes (the conf's buckets) and explicit ones, then the
    same again (nothing new to build); the programs warmup built are the
    ones ``fit`` and ``output`` then dispatch to."""
    jnet, net = _pair(kind, buckets=(2, 4))
    kw = dict(train=train, inference=inference)
    for shapes in (None, None):
        assert net.warmup(shapes, **kw) == jnet.warmup(shapes, **kw)
    if kind == "mln":
        extra = [(3, 5), (6, 5)]
    else:
        extra = [[(3, 5), (3, 2)], [(6, 5), (6, 2)]]
    assert net.warmup(extra, **kw) == jnet.warmup(extra, **kw) == \
        2 * (train + inference)
    before = cw.get_watcher().total_traces()
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 4)]
    if kind == "mln":
        net.fit(x, y)
        net.output(x)
    else:
        xb = rng.normal(size=(4, 2)).astype(np.float32)
        net.fit([x, xb], [y])
        net.output(x, xb)
    # only what warmup did not build was built now
    assert cw.get_watcher().total_traces() - before == \
        (not train) + (not inference)


def test_warmup_needs_explicit_buckets_or_shapes():
    _, net = _pair("mln")
    with pytest.raises(ValueError, match="batch_buckets"):
        net.warmup()
    _, g = _pair("graph")
    with pytest.raises(ValueError, match="batch_buckets"):
        g.warmup()
    with pytest.raises(ValueError, match="2 graph inputs"):
        g.warmup([[(2, 5)]])


_RAGGED = (8, 8, 5, 8, 3, 8, 5, 1, 8)


def _fit_sizes(net, kind, sizes):
    rng = np.random.default_rng(4)
    for n in sizes:
        x = rng.normal(size=(n, 5)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
        if kind == "mln":
            net.fit(x, y)
        else:
            net.fit([x, rng.normal(size=(n, 2)).astype(np.float32)], [y])


@pytest.mark.parametrize("kind", ["mln", "graph"])
@pytest.mark.parametrize("buckets", [None, (4, 8)], ids=["plain", "bucketed"])
def test_recompile_listener_events_match_reference(kind, buckets):
    """A ragged run of batch sizes: each new size builds a program after
    the grace iteration (an event) unless a bucket absorbs it."""
    jnet, net = _pair(kind, buckets)
    jl, tl = JRecompile(grace=1, log_fn=lambda s: None), \
        RecompileListener(grace=1, log_fn=lambda s: None)
    jnet.set_listeners(jl)
    net.set_listeners(tl)
    _fit_sizes(jnet, kind, _RAGGED)
    _fit_sizes(net, kind, _RAGGED)
    assert tl.events == jl.events
    fn = ("MultiLayerNetwork" if kind == "mln" else "ComputationGraph") + \
        ".train_step"
    assert all(e[1] == fn for e in tl.events)
    assert len(tl.events) == (3 if buckets is None else 1)


def test_serving_warmup_primes_as_many_as_the_reference():
    jconf = _mln_conf()
    jnet = JMLN(jconf).init()
    net = MultiLayerNetwork(TConf.from_json(jconf.to_json())).init(
        device="cpu")
    jm, m = JServingModel(jnet, "m"), ServingModel(net, "m")
    assert m.policy.batch_buckets == jm.policy.batch_buckets
    assert m.warmup() == jm.warmup() == len(m.policy.batch_buckets)
    assert sorted(k[1][0][0][0] for k in net._aot_forward) == \
        sorted(m.policy.batch_buckets)
    assert not net._aot_steps
    assert m.warmup() == jm.warmup() == 0
