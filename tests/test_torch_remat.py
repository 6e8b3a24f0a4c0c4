"""Remat stages and stage barriers (``util/xla_tuning.py``, the networks'
``_build_segments`` and ``_loss_remat``) on the CPU, against the JAX
package and against the port's own plain path.

- every policy of ``policy_names()``, with and without ``stage_barriers``,
  on a small conv ComputationGraph with ``stage_boundary`` marks (a
  residual add inside a stage, a dense layer in the last one) and on a
  small MultiLayerNetwork with ``remat_stages``: one ``fit`` step's loss,
  params and running statistics equal the port's plain step bit for bit
  (the CPU is deterministic, and remat must not change the arithmetic);
- against the reference's ``_loss_remat``: the graph under ``save_conv``
  with barriers and the layer stack under ``full``, one step, loss and
  params within 1e-4 relative (the trajectory convention, an absolute
  floor of 1e-6) and running statistics within 1e-5;
- dropout inside a stage draws the plain path's mask, and the generator
  moves once a step;
- the recompute's conv forwards, counted by a spy on the plain conv
  forward: none under ``save_conv``, one per conv of the stages under
  ``full``; the dense product's recompute reuses its output under
  ``save_dots`` and its gradients are the plain path's;
- the stage segmentation refuses what the reference refuses;
- ``RematPolicySpace`` / ``XlaFlagsSpace`` candidates against the
  reference's, and a measured sweep of the remat space on the CPU.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from deeplearning4j_tpu.nn import ComputationGraph as JGraph  # noqa: E402
from deeplearning4j_tpu.nn import layers as JL  # noqa: E402
from deeplearning4j_tpu.nn import updaters as jupd  # noqa: E402
from deeplearning4j_tpu.nn import vertices as JV  # noqa: E402
from deeplearning4j_tpu.nn.conf import \
    NeuralNetConfiguration as JNNC  # noqa: E402
from deeplearning4j_tpu.nn.multilayer import \
    MultiLayerNetwork as JMLN  # noqa: E402
from deeplearning4j_tpu.tuning import space as jspace  # noqa: E402
from deeplearning4j_tpu_torch import interop  # noqa: E402
from deeplearning4j_tpu_torch.nn.computation_graph import (  # noqa: E402
    ComputationGraph as TGraph, ComputationGraphConfiguration as TConf)
from deeplearning4j_tpu_torch.nn.conf import \
    MultiLayerConfiguration as TMConf  # noqa: E402
from deeplearning4j_tpu_torch.nn.multilayer import \
    MultiLayerNetwork as TMLN  # noqa: E402
from deeplearning4j_tpu_torch.ops.kernels import conv as kconv  # noqa: E402
from deeplearning4j_tpu_torch.tuning import space as tspace  # noqa: E402
from deeplearning4j_tpu_torch.util import xla_tuning as xt  # noqa: E402

RTOL, FLOOR = 1e-4, 1e-6
POLICIES = xt.policy_names()


def _tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _graph_conf(policy, barriers, dropout=0.0):
    """conv-bn-relu | conv-bn + residual add, relu, pool, dense | output:
    two stages before the loss head (the reference's builder, whose JSON
    the port reads)."""
    b = JNNC.builder().seed(5).updater(jupd.Sgd(0.1))
    if policy is not None:
        b.remat_policy(policy)
    if barriers:
        b.stage_barriers(True)
    gb = b.graph_builder().add_inputs("in")
    gb.add_layer("c1", JL.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                           padding="SAME"), "in")
    gb.add_layer("bn1", JL.BatchNormalization(), "c1")
    gb.add_layer("r1", JL.ActivationLayer(activation="relu"), "bn1")
    gb.stage_boundary("r1")
    gb.add_layer("c2", JL.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                           padding="SAME"), "r1")
    gb.add_layer("bn2", JL.BatchNormalization(), "c2")
    gb.add_vertex("add", JV.ElementWiseVertex(op="add"), "r1", "bn2")
    gb.add_layer("r2", JL.ActivationLayer(activation="relu"), "add")
    gb.add_layer("pool", JL.GlobalPoolingLayer(), "r2")
    gb.add_layer("d", JL.DenseLayer(n_out=6, activation="tanh",
                                    dropout=dropout), "pool")
    gb.stage_boundary("d")
    gb.add_layer("out", JL.OutputLayer(n_out=3), "d")
    return gb.set_outputs("out").set_input_types((8, 8, 3)).build()


def _mln_conf(policy, barriers, dropout=0.0):
    b = JNNC.builder().seed(9).updater(jupd.Adam(1e-2))
    if policy is not None:
        b.remat_policy(policy)
    if barriers:
        b.stage_barriers(True)
    return (b.list()
            .layer(JL.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                       padding="SAME", has_bias=False))
            .layer(JL.BatchNormalization())
            .layer(JL.ActivationLayer(activation="relu"))
            .stage_boundary()
            .layer(JL.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                       padding="SAME", activation="relu"))
            .stage_boundary()
            .layer(JL.DenseLayer(n_out=6, activation="tanh",
                                 dropout=dropout))
            .layer(JL.OutputLayer(n_out=3))
            .set_input_type((6, 6, 2)).build())


def _batch(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, shape[0])]
    return x, y


@pytest.fixture(scope="module")
def graph_ref():
    """The reference graph's initial params/states, and its state after
    one ``fit`` step under ``save_conv`` with barriers (``_loss_remat``)."""
    jnet = JGraph(_graph_conf("save_conv", True)).init()
    p0, s0 = _tree(jnet.params), _tree(jnet.states)
    x, y = _batch((4, 8, 8, 3))
    jnet.fit(x, y)
    return p0, s0, (x, y), dict(loss=float(jnet.score_value),
                                params=_tree(jnet.params),
                                states=_tree(jnet.states))


@pytest.fixture(scope="module")
def mln_ref():
    jnet = JMLN(_mln_conf("full", False)).init()
    p0, s0 = _tree(jnet.params), _tree(jnet.states)
    x, y = _batch((4, 6, 6, 2), seed=1)
    jnet.fit(x, y)
    return p0, s0, (x, y), dict(loss=float(jnet.score_value),
                                params=_tree(jnet.params),
                                states=_tree(jnet.states))


def _port_graph(policy, barriers, p0, s0, dropout=0.0):
    net = TGraph(TConf.from_json(_graph_conf(policy, barriers,
                                             dropout).to_json()))
    net.init(device="cpu")
    interop.load_reference(net, p0, s0)
    return net


def _port_mln(policy, barriers, p0, s0, dropout=0.0):
    net = TMLN(TMConf.from_json(_mln_conf(policy, barriers,
                                          dropout).to_json()))
    net.init(device="cpu")
    interop.load_reference_mln(net, p0, s0)
    return net


def _leaves(tree):
    from deeplearning4j_tpu_torch.tree import tree_items

    if isinstance(tree, list):
        tree = {str(i): t for i, t in enumerate(tree)}
    return {"/".join(map(str, k)): np.asarray(v.detach() if hasattr(
        v, "detach") else v) for k, v in tree_items(tree)}


def _assert_equal_nets(a, b):
    assert float(a.score_value) == float(b.score_value)
    for tree in ("params", "states", "opt_states"):
        la, lb = _leaves(getattr(a, tree)), _leaves(getattr(b, tree))
        assert la.keys() == lb.keys()
        for k in la:
            np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


def _assert_close_to_ref(net, ref):
    got_p, want_p = _leaves(net.params), _leaves(ref["params"])
    for k in want_p:
        np.testing.assert_allclose(got_p[k], want_p[k], rtol=RTOL,
                                   atol=FLOOR, err_msg=k)
    got_s, want_s = _leaves(net.states), _leaves(ref["states"])
    for k in want_s:
        np.testing.assert_allclose(got_s[k], want_s[k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(net.score_value), ref["loss"],
                               rtol=RTOL, atol=FLOOR)


# ------------------------------------------------------------- the graph
@pytest.mark.parametrize("barriers", [False, True], ids=["plain", "barriers"])
@pytest.mark.parametrize("policy", POLICIES)
def test_graph_policy_equals_the_plain_step(graph_ref, policy, barriers):
    p0, s0, (x, y), _ = graph_ref
    plain = _port_graph(None, False, p0, s0)
    remat = _port_graph(policy, barriers, p0, s0)
    assert plain._segments is None
    assert (remat._segments is None) == (policy == "none" and not barriers)
    plain.fit(x, y)
    remat.fit(x, y)
    _assert_equal_nets(plain, remat)


def test_graph_save_conv_matches_reference_loss_remat(graph_ref):
    p0, s0, (x, y), ref = graph_ref
    net = _port_graph("save_conv", True, p0, s0)
    stages, keep, tail = net._segments
    assert [[n.name for n in s] for s in stages] == [
        ["c1", "bn1", "r1"], ["c2", "bn2", "add", "r2", "pool", "d"]]
    # the names a later stage or the tail reads (the reference's rule):
    # the first stage's input and inner activations are dropped
    assert "r1" in keep[0] and not {"in", "c1", "bn1"} & keep[0]
    assert keep[1] == {"d"} and [n.name for n in tail] == ["out"]
    net.fit(x, y)
    _assert_close_to_ref(net, ref)


# ------------------------------------------------------- the layer stack
@pytest.mark.parametrize("barriers", [False, True], ids=["plain", "barriers"])
@pytest.mark.parametrize("policy", POLICIES)
def test_mln_policy_equals_the_plain_step(mln_ref, policy, barriers):
    p0, s0, (x, y), _ = mln_ref
    plain = _port_mln(None, False, p0, s0)
    remat = _port_mln(policy, barriers, p0, s0)
    plain.fit(x, y)
    remat.fit(x, y)
    _assert_equal_nets(plain, remat)


def test_mln_full_matches_reference_loss_remat(mln_ref):
    p0, s0, (x, y), ref = mln_ref
    net = _port_mln("full", False, p0, s0)
    assert net._segments == ([(0, 3), (3, 4)], 4)
    net.fit(x, y)
    _assert_close_to_ref(net, ref)


@pytest.mark.parametrize("policy", ["full", "save_conv"])
def test_dropout_in_a_stage_draws_the_plain_mask(mln_ref, policy):
    """The stage's dense layer draws dropout from the net's generator:
    the recompute reuses the forward's draw, so the step equals the plain
    one bit for bit and the generator moved exactly as far."""
    p0, s0, (x, y), _ = mln_ref
    conf = _mln_conf(None, False, dropout=0.5)
    conf.remat_stages = (3, 5)  # the dense layer inside the second stage
    plain = TMLN(TMConf.from_json(conf.to_json())).init(device="cpu")
    conf.remat_policy = policy
    remat = TMLN(TMConf.from_json(conf.to_json())).init(device="cpu")
    assert remat._segments == ([(0, 3), (3, 5)], 5)
    for net in (plain, remat):
        interop.load_reference_mln(net, p0, s0)
    for _ in range(2):
        plain.fit(x, y)
        remat.fit(x, y)
    _assert_equal_nets(plain, remat)
    assert torch.equal(plain._gen.get_state(), remat._gen.get_state())


# ------------------------------------------------------ what recomputes
def _count_conv_forwards(monkeypatch):
    calls = []
    real = kconv.conv2d

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(kconv, "conv2d", spy)
    return calls


@pytest.mark.parametrize("policy,extra", [
    ("none", 0), ("save_all", 0), ("save_conv", 0), ("save_conv_dots", 0),
    ("full", 2), ("save_dots", 2)])
def test_recompute_conv_forwards(graph_ref, monkeypatch, policy, extra):
    """Two convs, one per stage: the plain step runs 2 conv forwards; a
    policy that keeps conv outputs recomputes none of them, one that does
    not recomputes both."""
    p0, s0, (x, y), _ = graph_ref
    net = _port_graph(policy, False, p0, s0)
    calls = _count_conv_forwards(monkeypatch)
    net.fit(x, y)
    assert len(calls) == 2 + extra


def test_save_dots_reuses_the_dense_product(graph_ref, monkeypatch):
    """Under ``save_dots`` the stage's dense product runs once (its
    recompute takes the kept output), and its hand-written backward gives
    the plain path's gradients (the graph test above holds the params)."""
    p0, s0, (x, y), _ = graph_ref
    products = []
    real = torch.matmul

    def spy(a, b, *rest, **k):
        if a.dim() == 2 and b.dim() == 2 and b.shape == (4, 6):
            products.append(1)
        return real(a, b, *rest, **k)

    for policy, want in (("full", 2), ("save_dots", 1)):
        net = _port_graph(policy, False, p0, s0)
        products.clear()
        monkeypatch.setattr(torch, "matmul", spy)
        net.fit(x, y)
        monkeypatch.setattr(torch, "matmul", real)
        assert len(products) == want, policy


def test_tags_are_identity_outside_a_stage():
    x = torch.ones(3)
    assert xt.tag(x, xt.CONV_OUT) is x and xt.reuse(xt.CONV_OUT) is None
    assert xt.barrier(x) is x and not xt.keeps(xt.DOT_OUT)
    assert xt.checkpoint_stage(len, "none") is len
    assert xt.checkpoint_stage(len, "save_all") is len


# ------------------------------------------------------- segmentation
def test_segmentation_refuses_what_the_reference_refuses():
    conf = TConf.from_json(_graph_conf("full", False).to_json())
    conf.remat_stages = ("nope",)
    with pytest.raises(ValueError, match="not a node"):
        TGraph(conf)
    conf.remat_stages = ("out",)
    with pytest.raises(ValueError, match="output layer"):
        TGraph(conf)
    m = TMConf.from_json(_mln_conf("full", False).to_json())
    m.remat_stages = (6,)  # six layers: the loss head stays unwrapped
    with pytest.raises(ValueError, match="out of range"):
        TMLN(m)
    with pytest.raises(ValueError, match="unknown remat policy"):
        xt.resolve_policy("bogus")
    assert xt.resolve_policy("full") == (True, frozenset())
    assert xt.resolve_policy("save_all") == (True, xt.SAVE_ALL)
    assert xt.resolve_policy("none") == (False, None)


def test_conf_json_round_trips_both_ways():
    for conf in (_graph_conf("save_conv", True), _mln_conf("full", True)):
        cls = TConf if hasattr(conf, "nodes") else TMConf
        port = cls.from_json(conf.to_json())
        assert port.to_json() == conf.to_json()


# --------------------------------------------------------- tuning spaces
def test_policy_names_match_the_reference():
    from deeplearning4j_tpu.util import xla_tuning as jxt

    assert xt.policy_names() == jxt.policy_names()
    assert xt.XLA_FLAG_CANDIDATES == jxt.XLA_FLAG_CANDIDATES


def test_space_candidates_match_the_reference():
    ctx = {}
    for name, ref in (("remat_policy", jspace.RematPolicySpace()),
                      ("xla_flags", jspace.XlaFlagsSpace())):
        port = tspace.get_space(name)
        assert [c.as_dict() for c in port.enumerate(ctx)] == \
            [c.as_dict() for c in ref.enumerate(ctx)]
        assert port.key(ctx).digest() == ref.key(ctx).digest() or \
            port.signature(ctx) == ref.signature(ctx)
        assert port.scope == ref.scope == "conf"
        assert port.measurable == ref.measurable
    flags = tspace.get_space("xla_flags")
    ok = [flags.validate(c, ctx) for c in flags.enumerate(ctx)]
    assert ok[0] == (True, "")
    assert all(not good and "no XLA" in why for good, why in ok[1:])


def test_remat_space_sweep_on_the_cpu(tmp_path):
    """Every policy passes the gate with no difference at all (the CPU is
    deterministic), and the winner is what the builder then defaults to
    with the database armed."""
    from deeplearning4j_tpu_torch import tuning
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration

    db = tuning.TuningDatabase(str(tmp_path / "db"))
    driver = tuning.MeasurementDriver(db, runs=1, min_window_s=0.0)
    res = driver.sweep(tuning.get_space("remat_policy"),
                       {"steps": 2, "device": "cpu"})
    rows = {r["label"]: r for r in res["measured"]}
    assert set(rows) == {f"policy:{n}" for n in POLICIES}
    assert all(r["admitted"] and r["max_diff"] == 0.0
               for r in rows.values())
    tuning.set_database(str(tmp_path / "db"))
    try:
        got = NeuralNetConfiguration.builder()._knobs["remat_policy"]
    finally:
        tuning.set_database(None)
    assert got == res["winner"]["params"]["remat_policy"]
