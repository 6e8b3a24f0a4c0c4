"""The port's cost model (``util/cost_model.py``, ``cost_report`` on both
networks) against the JAX package's, on the CPU.

The reference reads its FLOPs from XLA's cost analysis of the compiled
step; the port counts the eager step's aten ops and the hand kernels'
wrappers by the same conventions. Checked here:

- the reference's own ``TestMlnCostReport``, ``TestCgCostReport`` and
  ``TestSurfaces`` cases run on the port (``_torch_port_cases``), with the
  source named ``counted`` where the reference says ``xla``, the port's
  counting (``count_step``) where the reference patches its cost analysis,
  and the dropout generator's state where the reference keeps a PRNG key.
  Left out: ``TestHloParser`` (the HLO text parser and XLA's compiled
  totals have no counterpart in an eager step) and
  ``TestFlagshipResNet50`` (slow-marked in the reference);
- conv, dense, LSTM and attention layers: the port's
  ``analytic_layer_flops`` equals the reference's exactly, and a counted
  step's forward product FLOPs equal it too (the LSTM's less its 10·H
  elementwise estimate a step, which the count replaces with the ops);
- the counted step's FLOP total within 5% of the reference's own
  ``cost_report`` total for LeNet, a small graph and a narrow ResNet
  (the same bottleneck blocks as ResNet-50 at 16x16, widths 64-256);
- ``profile=True`` leaves params, layer states, optimizer states and the
  dropout generator bit-equal; MFU is None without a peak.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(__file__))
from _torch_port_cases import expose, port_copy  # noqa: E402

from deeplearning4j_tpu.nn import layers as JL  # noqa: E402
from deeplearning4j_tpu.nn import recurrent as JR  # noqa: E402
from deeplearning4j_tpu.nn import attention as JA  # noqa: E402
from deeplearning4j_tpu.nn.computation_graph import (  # noqa: E402
    ComputationGraph as JGraph)
from deeplearning4j_tpu.util import cost_model as jcm  # noqa: E402
from deeplearning4j_tpu_torch.nn import layers as TL  # noqa: E402
from deeplearning4j_tpu_torch.nn import recurrent as TR  # noqa: E402
from deeplearning4j_tpu_torch.nn import attention as TA  # noqa: E402
from deeplearning4j_tpu_torch.nn import (InputType,  # noqa: E402
                                         MultiLayerNetwork,
                                         NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.computation_graph import (  # noqa: E402
    ComputationGraph)
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.updaters import Sgd  # noqa: E402
from deeplearning4j_tpu_torch.tree import tree_leaves  # noqa: E402
from deeplearning4j_tpu_torch.util import cost_model as cm  # noqa: E402

_cases = port_copy(
    "test_cost_model",
    replace=(('"xla"', '"counted"'),
             ('monkeypatch.setattr(cm, "compiled_totals", unavailable)',
              'monkeypatch.setattr(cm, "count_step", unavailable)'),
             ("np.asarray(net._rng_key).copy()",
              "net._gen.get_state().numpy().copy()"),
             ("np.asarray(net._rng_key)", "net._gen.get_state().numpy()")))
expose(_cases, ["TestMlnCostReport", "TestCgCostReport", "TestSurfaces"],
       globals())


# ---------------------------------------------------------------------------
# per-layer FLOPs
# ---------------------------------------------------------------------------

def _layer_cases():
    """(name, reference layer, port layer, input shape without the batch,
    the port net's layers and input type for the counted step)."""
    return {
        "conv": (JL.ConvolutionLayer(n_in=3, n_out=8, kernel_size=(3, 3),
                                     padding="VALID"),
                 TL.ConvolutionLayer(n_in=3, n_out=8, kernel_size=(3, 3),
                                     padding="VALID"),
                 (10, 10, 3), InputType.convolutional(10, 10, 3),
                 TL.OutputLayer(n_out=4)),
        "dense": (JL.DenseLayer(n_in=20, n_out=7),
                  TL.DenseLayer(n_in=20, n_out=7), (20,),
                  InputType.feed_forward(20), TL.OutputLayer(n_out=4)),
        "lstm": (JR.LSTM(n_in=5, n_out=6), TR.LSTM(n_in=5, n_out=6),
                 (9, 5), InputType.recurrent(5, 9),
                 TR.RnnOutputLayer(n_in=6, n_out=4)),
        "attention": (JA.SelfAttentionLayer(n_in=8, n_out=8, n_heads=2),
                      TA.SelfAttentionLayer(n_in=8, n_out=8, n_heads=2),
                      (6, 8), InputType.recurrent(8, 6),
                      TR.RnnOutputLayer(n_in=8, n_out=4)),
    }


@pytest.mark.parametrize("kind", ["conv", "dense", "lstm", "attention"])
def test_layer_forward_flops_equal_reference_analytic(kind):
    jl, tl, in_shape, itype, head = _layer_cases()[kind]
    b = 3
    ref = jcm.analytic_layer_flops(jl, in_shape, 0)
    assert cm.analytic_layer_flops(tl, in_shape, 0) == ref
    net = MultiLayerNetwork(
        NeuralNetConfiguration.builder().seed(0).updater(Sgd(0.1)).list()
        .layer(tl).layer(head).set_input_type(itype).build()).init(
            device="cpu")
    x = torch.as_tensor(np.random.default_rng(0).normal(
        size=(b,) + in_shape), dtype=torch.float32)
    y = torch.zeros((b,) + tuple(net._output_shape))
    twin = net._cost_shadow()
    w = torch.ones(b)
    rec = cm.count_step(lambda: (twin._step_sizes(),
                                 twin._train_body(x, y, w, None, None)))
    row = rec.by_key[(net._layer_tags[0], "fwd")]
    expected = ref * b
    if kind == "lstm":  # the 10·H a step is the formula's elementwise part
        expected -= 10.0 * 6 * 9 * b
    assert row["product_flops"] == expected
    # the elementwise ops come on top, counted, never below the products
    assert row["flops"] >= row["product_flops"]
    assert rec.by_key[(net._layer_tags[0], "bwd")]["product_flops"] > 0


def test_analytic_rows_equal_reference_rows(monkeypatch):
    """Where a step cannot be counted both packages give the same
    source=analytic table, row for row."""
    from deeplearning4j_tpu.zoo.models import LeNet as JLeNet

    jnet = JLeNet().init()
    tnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jnet.conf.to_json())).init(device="cpu")

    def unavailable(*a):
        raise cm.CostAnalysisUnavailable("no dispatch modes")

    def ref_unavailable(compiled):
        raise jcm.CostAnalysisUnavailable("no cost analysis")

    monkeypatch.setattr(cm, "count_step", unavailable)
    monkeypatch.setattr(jcm, "compiled_totals", ref_unavailable)
    tr = tnet.cost_report(batch_size=4, publish=False)
    jr = jnet.cost_report(batch_size=4, publish=False)
    assert tr.source == jr.source == "analytic"
    assert [(r.layer, r.params, r.flops_fwd, r.flops_bwd, r.bytes_accessed)
            for r in tr.rows] == [
        (r.layer, r.params, r.flops_fwd, r.flops_bwd, r.bytes_accessed)
        for r in jr.rows]


# ---------------------------------------------------------------------------
# step totals against the reference's XLA count
# ---------------------------------------------------------------------------

def _narrow_resnet(pkg, w=32):
    """ResNet-50's stem and bottleneck blocks (1x1, 3x3, 1x1, projection
    shortcut, batchnorm, relu, add) at 16x16x3, widths 2w-8w."""
    if pkg == "ref":
        from deeplearning4j_tpu.nn import NeuralNetConfiguration as B
        from deeplearning4j_tpu.nn import InputType as IT
        from deeplearning4j_tpu.nn.updaters import Adam
        from deeplearning4j_tpu.nn.vertices import ElementWiseVertex
        L = JL
    else:
        from deeplearning4j_tpu_torch.nn import NeuralNetConfiguration as B
        from deeplearning4j_tpu_torch.nn import InputType as IT
        from deeplearning4j_tpu_torch.nn.updaters import Adam
        from deeplearning4j_tpu_torch.nn.vertices import ElementWiseVertex
        L = TL
    gb = B.builder().seed(3).updater(Adam(1e-3)).graph_builder() \
        .add_inputs("input")

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

    def bottleneck(name, inp, f, stride, project):
        x = conv_bn(f"{name}_a", inp, f[0], 1, stride=stride)
        x = conv_bn(f"{name}_b", x, f[1], 3)
        x = conv_bn(f"{name}_c", x, f[2], 1, relu=False)
        sc = conv_bn(f"{name}_sc", inp, f[2], 1, stride=stride,
                     relu=False) if project else inp
        gb.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), x, sc)
        gb.add_layer(f"{name}_out", L.ActivationLayer(activation="relu"),
                     f"{name}_add")
        return f"{name}_out"

    x = conv_bn("stem", "input", 2 * w, 3)
    x = bottleneck("res2a", x, (w, w, 4 * w), (1, 1), True)
    x = bottleneck("res2b", x, (w, w, 4 * w), (1, 1), False)
    x = bottleneck("res3a", x, (2 * w, 2 * w, 8 * w), (2, 2), True)
    gb.add_layer("avgpool", L.GlobalPoolingLayer(), x)
    gb.add_layer("output", L.OutputLayer(n_in=8 * w, n_out=10), "avgpool")
    gb.set_outputs("output")
    gb.set_input_types(IT.convolutional(16, 16, 3))
    return gb.build()


def _small_graph(pkg):
    if pkg == "ref":
        from deeplearning4j_tpu.nn import NeuralNetConfiguration as B
        from deeplearning4j_tpu.nn.updaters import Adam
        L = JL
    else:
        from deeplearning4j_tpu_torch.nn import NeuralNetConfiguration as B
        from deeplearning4j_tpu_torch.nn.updaters import Adam
        L = TL
    b = B.builder().seed(0).updater(Adam(1e-3)).graph_builder() \
        .add_inputs("in")
    b.add_layer("fc1", L.DenseLayer(n_in=32, n_out=32, activation="relu"),
                "in")
    b.add_layer("fc2", L.DenseLayer(n_in=32, n_out=32, activation="relu"),
                "fc1")
    b.add_layer("out", L.OutputLayer(n_in=32, n_out=10), "fc2")
    b.set_outputs("out").set_input_types((32,))
    return b.build()


def _nets(kind):
    if kind == "lenet":
        from deeplearning4j_tpu.zoo.models import LeNet as JLeNet

        jnet = JLeNet().init()
        return jnet, MultiLayerNetwork(MultiLayerConfiguration.from_json(
            jnet.conf.to_json())).init(device="cpu")
    build = _small_graph if kind == "small_graph" else _narrow_resnet
    jnet = JGraph(build("ref")).init()
    return jnet, ComputationGraph(build("port")).init(device="cpu")


@pytest.mark.parametrize("kind", ["lenet", "small_graph", "narrow_resnet"])
def test_step_flops_within_5pct_of_reference(kind):
    jnet, tnet = _nets(kind)
    jr = jnet.cost_report(batch_size=4, publish=False)
    tr = tnet.cost_report(batch_size=4, publish=False)
    assert jr.source == "xla" and tr.source == "counted"
    assert tr.flops_per_step == pytest.approx(jr.flops_per_step, rel=0.05)
    assert not tr.uncounted_ops
    # every conv launch is reported by its wrapper, forward and gradients
    if kind != "small_graph":
        assert tr.kernels["conv2d_fwd"]["calls"] == tr.kernels[
            "conv2d_wgrad"]["calls"] > 0


def test_profile_leaves_state_bit_equal_and_mfu_needs_a_peak(monkeypatch):
    monkeypatch.delenv("DL4J_TPU_PEAK_FLOPS", raising=False)
    net = ComputationGraph(_narrow_resnet("port", w=4)).init(device="cpu")
    x = np.random.default_rng(1).normal(size=(4, 16, 16, 3)).astype(
        np.float32)
    net.fit(x, np.eye(10, dtype=np.float32)[[0, 1, 2, 3]])  # Adam state
    before = [t.clone() for t in tree_leaves(
        [net.params, net.states, net.opt_states])]
    gen = net._gen.get_state().clone()
    it = net.iteration
    rep = net.cost_report(batch_size=4, profile=True, steps=1,
                          publish=False)
    after = tree_leaves([net.params, net.states, net.opt_states])
    assert len(after) == len(before)
    assert all(torch.equal(a, b) for a, b in zip(after, before))
    assert torch.equal(net._gen.get_state(), gen) and net.iteration == it
    assert rep.step_time_s > 0 and rep.device_time_s > 0
    assert rep.mfu is None and rep.peak_flops is None
    monkeypatch.setenv("DL4J_TPU_PEAK_FLOPS", "bf16=9.89e14,fp32=6.7e13")
    rep2 = net.cost_report(batch_size=4, profile=True, steps=1,
                           publish=False)
    assert rep2.peak_flops == 6.7e13 and 0 < rep2.mfu < 1


def test_peak_flops_table_never_guesses(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_PEAK_FLOPS", "bf16=9.89e14,fp32=6.7e13")
    assert cm.peak_flops_from_env("bfloat16") == 9.89e14
    assert cm.peak_flops_from_env(torch.float32) == 6.7e13
    assert cm.peak_flops_from_env("float16") is None
    monkeypatch.setenv("DL4J_TPU_PEAK_FLOPS", "nonsense")
    assert cm.peak_flops_from_env("fp32") is None
    monkeypatch.delenv("DL4J_TPU_PEAK_FLOPS")
    assert cm.peak_flops_from_env() is None


def test_scopes_cost_nothing_when_nothing_records():
    assert cm.layer_scope("x") is cm.layer_scope("y")
    assert cm.optimizer_scope() is cm.layer_scope("x")
    assert cm.kernel_cost("conv2d_fwd", lambda: 1 / 0) is cm.layer_scope("x")
