"""The port's GPipe schedule and stage partition (``parallel/pipeline.py``,
``parallel/pipelined.py``'s ``stage_partition``) against the JAX
package's, on the CPU.

- ``gpipe_scan`` against the reference's ``gpipe_scan`` and its
  ``sequential_reference`` on the same stage function and params (S 1-4,
  1-5 microbatches), within 2e-5; the port runs S x n_micro stage calls,
  the valid pairs of the schedule, and autograd through the schedule sums
  each microbatch's gradient into its stage's slice of the stacked
  gradient; ``pipeline_forward`` pads a ragged batch as the reference's;
- ``bubble_fraction`` equal to the reference's;
- ``stage_partition``'s partitions and every refusal, with the
  reference's message, on the same networks;
- the conf JSON with ``pipe_stages``/``n_micro`` read and written by both
  packages; the ``DL4J_TPU_PIPE_STAGES`` default; ``PipeScheduleSpace``'s
  candidates equal to the reference's.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu import config as JCFG  # noqa: E402
from deeplearning4j_tpu import parallel as JP  # noqa: E402
from deeplearning4j_tpu.nn import ComputationGraph as JCG  # noqa: E402
from deeplearning4j_tpu.nn import InputType  # noqa: E402
from deeplearning4j_tpu.nn import MultiLayerNetwork as JMLN  # noqa: E402
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNNC  # noqa: E402
from deeplearning4j_tpu.nn import layers as JL  # noqa: E402
from deeplearning4j_tpu.nn.computation_graph import \
    ComputationGraphConfiguration as JCGConf  # noqa: E402
from deeplearning4j_tpu.nn.conf import \
    MultiLayerConfiguration as JConf  # noqa: E402
from deeplearning4j_tpu.nn.updaters import Adam, Sgd  # noqa: E402
from deeplearning4j_tpu.parallel import pipeline as JPL  # noqa: E402
from deeplearning4j_tpu.tuning import space as JSPACE  # noqa: E402
from deeplearning4j_tpu_torch import config as TCFG  # noqa: E402
from deeplearning4j_tpu_torch import interop  # noqa: E402
from deeplearning4j_tpu_torch import parallel as TP  # noqa: E402
from deeplearning4j_tpu_torch.data.dataset import DataSet as TDS  # noqa: E402
from deeplearning4j_tpu_torch.nn import \
    NeuralNetConfiguration as TNNC  # noqa: E402
from deeplearning4j_tpu_torch.nn import layers as TL  # noqa: E402
from deeplearning4j_tpu_torch.nn.computation_graph import \
    ComputationGraphConfiguration as TCGConf  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import \
    MultiLayerConfiguration as TConf  # noqa: E402
from deeplearning4j_tpu_torch.parallel import pipeline as TPL  # noqa: E402
from deeplearning4j_tpu_torch.tuning import space as TSPACE  # noqa: E402

H = 16
TOL = 2e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(j):
    return interop.from_reference_json(j.conf.to_json(), _np(j.params),
                                       _np(j.states), device="cpu")


def _stage_params(rng, s, width=8):
    return [{"W": (rng.standard_normal((width, width)) * 0.4)
             .astype(np.float32),
             "b": (rng.standard_normal(width) * 0.1).astype(np.float32)}
            for _ in range(s)]


def _j_stage(p, x):
    return jnp.tanh(x @ p["W"] + p["b"])


def _t_stage(p, x):
    return torch.tanh(x @ p["W"] + p["b"])


def _tp(params):
    return [{k: torch.from_numpy(v) for k, v in p.items()} for p in params]


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,m", [(1, 3), (2, 1), (2, 4), (3, 2), (4, 4),
                                 (4, 5)])
def test_gpipe_scan_matches_reference(s, m):
    rng = np.random.default_rng(10 * s + m)
    params = _stage_params(rng, s)
    micro = rng.standard_normal((m, 3, 8)).astype(np.float32)
    want = np.asarray(JPL.gpipe_scan(
        _j_stage, JPL.stack_stage_params(
            [jax.tree_util.tree_map(jnp.asarray, p) for p in params]),
        jnp.asarray(micro)))
    seq = np.stack([np.asarray(JPL.sequential_reference(
        _j_stage, [jax.tree_util.tree_map(jnp.asarray, p) for p in params],
        jnp.asarray(micro[i]))) for i in range(m)])
    calls = []

    def stage(p, x):
        calls.append(1)
        return _t_stage(p, x)

    got = TPL.gpipe_scan(stage, TPL.stack_stage_params(_tp(params)),
                         torch.from_numpy(micro)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, seq, atol=TOL, rtol=TOL)
    # only the valid (stage, microbatch) pairs run, in schedule order
    assert len(calls) == s * m == len(TPL.schedule(s, m))
    assert [t for t, _, _ in TPL.schedule(s, m)] == sorted(
        t for t, _, _ in TPL.schedule(s, m))


def test_gpipe_scan_gradient_is_the_sum_over_microbatches():
    """Autograd through views of one stacked leaf accumulates: the stacked
    gradient equals the sum of each microbatch's own gradient of the
    sequential stages."""
    rng = np.random.default_rng(3)
    params = _stage_params(rng, 2)
    micro = torch.from_numpy(rng.standard_normal((4, 3, 8))
                             .astype(np.float32))
    stacked = TPL.stack_stage_params(_tp(params))
    for v in stacked.values():
        v.requires_grad_(True)
    out = TPL.gpipe_scan(_t_stage, stacked, micro)
    gw, gb = torch.autograd.grad((out ** 2).sum(),
                                 [stacked["W"], stacked["b"]])
    want_w = torch.zeros_like(gw)
    want_b = torch.zeros_like(gb)
    for i in range(micro.shape[0]):
        per = [{k: v.clone().requires_grad_(True) for k, v in p.items()}
               for p in _tp(params)]
        y = TPL.sequential_reference(_t_stage, per, micro[i])
        grads = torch.autograd.grad((y ** 2).sum(),
                                    [per[s][k] for s in range(2)
                                     for k in ("W", "b")])
        want_w += torch.stack([grads[0], grads[2]])
        want_b += torch.stack([grads[1], grads[3]])
    np.testing.assert_allclose(gw.numpy(), want_w.numpy(), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(gb.numpy(), want_b.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_gpipe_scan_refuses_ragged_stacks():
    bad = {"W": torch.zeros(2, 8, 8), "b": torch.zeros(3, 8)}
    for mod, arg in ((TPL, bad), (JPL, {"W": jnp.zeros((2, 8, 8)),
                                        "b": jnp.zeros((3, 8))})):
        with pytest.raises(ValueError, match="leading dims differ"):
            mod.gpipe_scan(lambda p, x: x, arg,
                           (torch.zeros if mod is TPL else jnp.zeros)(
                               (2, 3, 8)))


def test_pipeline_forward_pads_a_ragged_batch():
    rng = np.random.default_rng(5)
    params = _stage_params(rng, 4)
    x = rng.standard_normal((10, 8)).astype(np.float32)
    got = TPL.pipeline_forward(_t_stage, TPL.stack_stage_params(_tp(params)),
                               torch.from_numpy(x), n_micro=4)
    want = JPL.sequential_reference(
        _j_stage, [jax.tree_util.tree_map(jnp.asarray, p) for p in params],
        jnp.asarray(x))
    assert tuple(got.shape) == (10, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=1e-4)


@pytest.mark.parametrize("s,m", [(2, 2), (4, 12), (1, 8), (4, 4), (4, 8),
                                 (3, 7)])
def test_bubble_fraction_is_the_references(s, m):
    assert TPL.bubble_fraction(s, m) == JPL.bubble_fraction(s, m)
    assert TP.bubble_fraction is TPL.bubble_fraction


def test_bubble_fraction_refuses_zero():
    for mod in (TPL, JPL):
        with pytest.raises(ValueError):
            mod.bubble_fraction(2, 0)


# ---------------------------------------------------------------------------
# the partition
# ---------------------------------------------------------------------------


def _builder(updater=None, pipe=True):
    b = JNNC.builder().seed(7).updater(updater or Adam(1e-2))
    return b.pipe_stages(2).n_micro(2) if pipe else b


def _chain(widths=(H, H, H, H), acts=("tanh", "relu", "tanh", "relu"),
           bounds=(1, 3, 5), updaters=None, bn_at=None):
    lb = _builder().list()
    lb.layer(JL.DenseLayer(n_in=8, n_out=H, activation="relu"))
    n_in = H
    for i, (w, a) in enumerate(zip(widths, acts), start=1):
        if i in bounds:
            lb.stage_boundary()
        if bn_at == i:
            lb.layer(JL.BatchNormalization())
            continue
        kw = {} if not updaters else {"updater": updaters[i - 1]}
        lb.layer(JL.DenseLayer(n_in=n_in, n_out=w, activation=a, **kw))
        n_in = w
    if len(widths) + 1 in bounds:
        lb.stage_boundary()
    lb.layer(JL.OutputLayer(n_in=n_in, n_out=4, loss="mcxent",
                            activation="softmax"))
    return JMLN(lb.set_input_type(InputType.feed_forward(8)).build()).init()


def _partition_keys(part):
    return ([k for k, _ in part.pre],
            [[k for k, _ in c] for c in part.stages],
            [k for k, _ in part.post], part.head[0], list(part.order))


def test_partition_matches_reference():
    j = _chain()
    t = _port(j)
    assert _partition_keys(TP.stage_partition(t, 2)) == _partition_keys(
        JP.stage_partition(j, 2)) == (
        [0], [[1, 2], [3, 4]], [], 5, [0, 1, 2, 3, 4, 5])


def _cg(chain=True, two_inputs=False, vertex=False):
    b = _builder().graph_builder()
    if two_inputs:
        b = b.add_inputs("a", "b").add_layer(
            "d", JL.DenseLayer(n_in=8, n_out=4, activation="tanh"), "a")
        b = b.add_layer("out", JL.OutputLayer(
            n_in=4, n_out=2, loss="mcxent", activation="softmax"), "d")
        return JCG(b.set_outputs("out").set_input_types((8,), (8,))
                   .build()).init()
    b = (b.add_inputs("in")
         .add_layer("embed", JL.DenseLayer(n_in=8, n_out=H,
                                           activation="relu"), "in")
         .add_layer("b0", JL.DenseLayer(n_in=H, n_out=H, activation="tanh"),
                    "embed"))
    if vertex:
        from deeplearning4j_tpu.nn.vertices import ScaleVertex

        b = b.add_vertex("sc", ScaleVertex(2.0), "b0")
        b = b.add_layer("b1", JL.DenseLayer(n_in=H, n_out=H,
                                            activation="tanh"), "sc")
    else:
        b = b.add_layer("b1", JL.DenseLayer(n_in=H, n_out=H,
                                            activation="tanh"),
                        "b0" if chain else "embed")
    b = (b.add_layer("out", JL.OutputLayer(n_in=H, n_out=4, loss="mcxent",
                                           activation="softmax"), "b1")
         .set_outputs("out").set_input_types((8,))
         .stage_boundary("embed", "b0", "b1"))
    return JCG(b.build()).init()


def test_graph_chain_partition_matches_reference():
    j = _cg()
    t = _port(j)
    assert _partition_keys(TP.stage_partition(t, 2)) == _partition_keys(
        JP.stage_partition(j, 2))
    assert [k for k, _ in TP.stage_partition(t, 2).pre] == ["embed"]


def _refusal(make, match, exc=ValueError, stages=2):
    j = make()
    t = _port(j)
    msgs = []
    for mod, net in ((JP, j), (TP, t)):
        with pytest.raises(exc, match=match) as ei:
            mod.stage_partition(net, stages)
        msgs.append(str(ei.value))
    return msgs


@pytest.mark.parametrize("case,match", [
    ("drift", "layer configs differ"),
    ("shapes", "configs differ"),
    ("updaters", "configs differ"),
    ("few_chunks", "pipe_stages=4 needs at least 4"),
    ("batchnorm", "floating-point state"),
    ("not_chain", "linear chain"),
    ("vertex", "LAYER nodes"),
    ("two_inputs", "single-input single-output"),
    ("one_stage", "pipe_stages must be >= 2"),
])
def test_partition_refusals_are_the_references(case, match):
    makes = {
        "drift": lambda: _chain(widths=(H, H), acts=("tanh", "relu"),
                                bounds=(1, 2, 3)),
        "shapes": lambda: _chain(widths=(H, 2 * H), acts=("tanh", "tanh"),
                                 bounds=(1, 2, 3)),
        "updaters": lambda: _chain(widths=(H, H), acts=("tanh", "tanh"),
                                   bounds=(1, 2, 3),
                                   updaters=[Adam(1e-2), Sgd(0.1)]),
        "few_chunks": _chain,
        "batchnorm": lambda: _chain(widths=(H, H, H, H), bounds=(1, 3, 5),
                                    bn_at=1),
        "not_chain": lambda: _cg(chain=False),
        "vertex": lambda: _cg(vertex=True),
        "two_inputs": lambda: _cg(two_inputs=True),
        "one_stage": _chain,
    }
    stages = {"few_chunks": 4, "one_stage": 1}.get(case, 2)
    if case == "batchnorm":
        # a batchnorm layer in each stage keeps the stages identical, and
        # the refusal is the state's
        def make():
            lb = _builder().list()
            lb.layer(JL.DenseLayer(n_in=8, n_out=H, activation="relu"))
            for _ in range(2):
                lb.stage_boundary()
                lb.layer(JL.BatchNormalization())
                lb.layer(JL.DenseLayer(n_in=H, n_out=H, activation="tanh"))
            lb.stage_boundary()
            lb.layer(JL.OutputLayer(n_in=H, n_out=4, loss="mcxent",
                                    activation="softmax"))
            return JMLN(lb.set_input_type(InputType.feed_forward(8))
                        .build()).init()
        makes[case] = make
    _refusal(makes[case], match, stages=stages)


def test_trainer_refusals_are_the_references():
    """TBPTT, masks and a head without per-example weights (the trainer's
    own refusals), each where the reference refuses it."""
    j = _chain()
    conf = j.conf
    conf.tbptt_length = 5
    jt = JMLN(conf).init()
    tt = _port(jt)
    with pytest.raises(NotImplementedError, match="TBPTT"):
        JP.PipelinedTrainer(jt, mesh=JP.TrainingMesh(
            data=1, devices=jax.devices()[:1]))
    with pytest.raises(NotImplementedError, match="TBPTT"):
        TP.PipelinedTrainer(tt)
    t = _port(_chain())
    pt = TP.PipelinedTrainer(t, skew_every=0)
    ds = TDS(np.zeros((4, 8), np.float32), np.eye(4, dtype=np.float32))
    ds.features_mask = np.ones((4, 1), np.float32)
    with pytest.raises(NotImplementedError, match="masks"):
        pt.step_batch(ds)
    # a pipe axis that does not divide the stages
    mesh = TP.TrainingMesh(devices=["cpu"])
    mesh.pipe = 3
    with pytest.raises(ValueError, match="must divide pipe_stages"):
        TP.PipelinedTrainer(_port(_chain()), mesh=mesh)

    class NoWeights(TL.OutputLayer):
        def compute_loss(self, params, state, x, y, *, training=False,
                         gen=None):
            return super().compute_loss(params, state, x, y,
                                        training=training, gen=gen)

    t = _port(_chain())
    t.layers[-1] = NoWeights(n_in=H, n_out=4, loss="mcxent",
                             activation="softmax")
    with pytest.raises(ValueError, match="per-example weights"):
        TP.PipelinedTrainer(t)


def test_tp_rules_name_item_10c():
    with pytest.raises(NotImplementedError, match="10c"):
        TP.PipelinedTrainer(_port(_chain()), tp_rules=[(r"W", (None, "m"))])


# ---------------------------------------------------------------------------
# conf knobs, the environment default, the tuning space
# ---------------------------------------------------------------------------


def test_conf_json_carries_pipe_knobs_both_ways():
    jconf = _chain().conf
    tconf = TConf.from_json(jconf.to_json())
    assert (tconf.knobs["pipe_stages"], tconf.knobs["n_micro"]) == (2, 2)
    back = JConf.from_json(tconf.to_json())
    assert (back.pipe_stages, back.n_micro) == (2, 2)
    assert json.loads(tconf.to_json()) == json.loads(jconf.to_json())
    tb = (TNNC.builder().seed(7).pipe_stages(3).n_micro(6).list()
          .layer(TL.DenseLayer(n_in=4, n_out=4))
          .layer(TL.OutputLayer(n_in=4, n_out=2, loss="mcxent",
                                activation="softmax"))
          .set_input_type(InputType.feed_forward(4)).build())
    jb = JConf.from_json(tb.to_json())
    assert (jb.pipe_stages, jb.n_micro) == (3, 6)
    g = _cg().conf
    tg = TCGConf.from_json(g.to_json())
    assert (tg.knobs["pipe_stages"], tg.knobs["n_micro"]) == (2, 2)
    gb = JCGConf.from_json(tg.to_json())
    assert (gb.pipe_stages, gb.n_micro) == (2, 2)
    for mod in (JNNC, TNNC):
        with pytest.raises(ValueError):
            mod.builder().pipe_stages(-1)
        with pytest.raises(ValueError):
            mod.builder().n_micro(-1)


def test_env_pipe_stages_default(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_PIPE_STAGES", "4")
    monkeypatch.setattr(JCFG.Environment, "_instance", None)
    monkeypatch.setattr(TCFG.Environment, "_instance", None)
    try:
        def conf(nnc, layers):
            return (nnc.builder().list()
                    .layer(layers.DenseLayer(n_in=4, n_out=4))
                    .layer(layers.OutputLayer(n_in=4, n_out=2,
                                              loss="mcxent",
                                              activation="softmax"))
                    .set_input_type(InputType.feed_forward(4)).build())

        assert conf(JNNC, JL).pipe_stages == 4
        assert conf(TNNC, TL).knobs["pipe_stages"] == 4
        assert TCFG.get_environment().default_pipe_stages == 4
    finally:
        monkeypatch.setattr(JCFG.Environment, "_instance", None)
        monkeypatch.setattr(TCFG.Environment, "_instance", None)
    monkeypatch.delenv("DL4J_TPU_PIPE_STAGES")
    assert TCFG.get_environment().default_pipe_stages == 0
    monkeypatch.setattr(TCFG.Environment, "_instance", None)


@pytest.mark.parametrize("stages", [2, 4])
def test_pipe_schedule_space_is_the_references(stages):
    j = JSPACE.get_space("pipe_schedule")
    t = TSPACE.get_space("pipe_schedule")
    ctx = {"pipe_stages": stages}
    assert not t.measurable and not j.measurable
    assert (t.name, t.op, t.scope) == (j.name, j.op, j.scope)
    assert t.signature(ctx) == j.signature(ctx)
    assert [c.as_dict() for c in t.enumerate(ctx)] == [
        {"label": c.label, "impl": c.impl, "params": dict(c.params),
         "is_default": c.is_default} for c in j.enumerate(ctx)]
