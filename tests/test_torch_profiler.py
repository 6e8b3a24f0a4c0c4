"""The port's profiler, health monitor, stats pipeline and gradient checker
(``util/profiler.py``, ``util/health.py``, ``util/stats.py``,
``autodiff/gradcheck.py``) against the JAX package's, on the CPU.

The reference's own ``tests/test_observability.py`` runs on the port
(``_torch_port_cases``, every case, with torch tensors where it builds
``jnp`` arrays). Then, on the same inputs in both packages:

- ``OpProfiler`` counts the same invocations of the same ``exec_op``
  sequence;
- ``StatsListener`` records of the same LeNet run (params copied across,
  Sgd): score and every per-layer parameter and update statistic within
  1e-5 (relative, 1e-6 absolute floor);
- ``TrainingHealthMonitor`` flags the same anomalies at the same
  iterations when one batch is poisoned with NaN, and under
  ``panic=True`` the port raises ``NaNPanicError``, also when the batch is
  poisoned by ``DL4J_TPU_FAULTS=inject_nan``;
- the device-trace parser reads a Chrome trace's busy time, names and
  nesting as the reference's XPlane readers do;
- ``check_gradients`` agrees with ``torch.autograd.gradcheck`` (a correct
  and a planted wrong backward, the conv's custom VJP) at the reference's
  defaults (eps 1e-6, max relative error 1e-5, min absolute error 1e-8).
  The reference's gradcheck cannot be imported under JAX 0.9.0
  (``autodiff/gradcheck.py:25``, ROADMAP Queue 3), so torch's checker is
  the yardstick.
"""

import json
import math
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(__file__))
from _torch_port_cases import expose, port_copy  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.ops import registry as jreg  # noqa: E402
from deeplearning4j_tpu.util import health as jhealth  # noqa: E402
from deeplearning4j_tpu.util import profiler as jprof  # noqa: E402
from deeplearning4j_tpu.util import stats as jstats  # noqa: E402
from deeplearning4j_tpu.zoo.models import LeNet as JLeNet  # noqa: E402
from deeplearning4j_tpu.nn.updaters import Sgd as JSgd  # noqa: E402
from deeplearning4j_tpu_torch import interop  # noqa: E402
from deeplearning4j_tpu_torch.autodiff import gradcheck as gc  # noqa: E402
from deeplearning4j_tpu_torch.nn import MultiLayerNetwork  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.ops import registry as treg  # noqa: E402
from deeplearning4j_tpu_torch.util import faults  # noqa: E402
from deeplearning4j_tpu_torch.util import health  # noqa: E402
from deeplearning4j_tpu_torch.util import profiler as prof  # noqa: E402
from deeplearning4j_tpu_torch.util import stats  # noqa: E402

_cases = port_copy("test_observability",
                   replace=(("import jax.numpy as jnp",
                             "import torch as jnp  # the port's tensors"),))
expose(_cases, ["TestOpProfiler", "TestSummary", "TestStats"], globals())


# ---------------------------------------------------------------------------
# OpProfiler
# ---------------------------------------------------------------------------

def test_op_profiler_counts_the_same_invocations():
    seq = [("add", 2), ("mul", 2), ("matmul", 2), ("sum", 1), ("add", 2),
           ("tanh", 1), ("log", 1), ("add", 2)]
    x = np.abs(np.random.default_rng(0).normal(size=(4, 4))) + 0.5
    counts = []
    for reg, P, arr in ((jreg, jprof, jnp.asarray),
                        (treg, prof, torch.as_tensor)):
        p = P.OpProfiler(P.ProfilerConfig())
        with p.profile():
            for name, arity in seq:
                reg.exec_op(name, *([arr(x)] * arity))
        counts.append(dict(p.invocations))
        assert all(ns > 0 for ns in p.total_ns.values())
    assert counts[0] == counts[1] == {"add": 3, "mul": 1, "matmul": 1,
                                      "sum": 1, "tanh": 1, "log": 1}


def test_profiler_refuses_to_sync_inside_a_capture(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)

    class FakeCuda:
        is_cuda = True
        device = "cuda:0"

    monkeypatch.setattr(prof, "_tensors", lambda out: [FakeCuda()])
    with pytest.raises(RuntimeError, match="CUDA-graph capture"):
        prof._sync_for("add", None)


def test_profiling_flag_installs_the_hook_at_import(tmp_path):
    import subprocess

    code = ("import torch, deeplearning4j_tpu_torch\n"
            "from deeplearning4j_tpu_torch.ops import registry\n"
            "from deeplearning4j_tpu_torch.util.profiler import OpProfiler\n"
            "registry.exec_op('add', torch.ones(2), torch.ones(2))\n"
            "assert dict(OpProfiler.get_instance().invocations) == "
            "{'add': 1}\n"
            "import sys; assert 'jax' not in sys.modules\n")
    env = dict(os.environ, DL4J_TPU_PROFILING="1")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


# ---------------------------------------------------------------------------
# the trace parser
# ---------------------------------------------------------------------------

def _trace(path, events):
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)


def test_trace_parser_busy_time_names_and_nesting(tmp_path):
    k = lambda n, ts, dur, pid=0, tid=7: {  # noqa: E731
        "ph": "X", "cat": "kernel", "name": n, "pid": pid, "tid": tid,
        "ts": ts, "dur": dur}
    _trace(tmp_path / "trace.json", [
        k("dl4j_conv2d_fma", 0, 100), k("dl4j_conv2d_fma", 50, 100, tid=8),
        k("spin_kernel", 300, 1000), k("flash_fwd", 2000, 10, pid=1),
        {"ph": "X", "cat": "cpu_op", "name": "layer:a", "pid": 9, "tid": 1,
         "ts": 0, "dur": 500},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": 9,
         "tid": 1, "ts": 10, "dur": 5},
        {"ph": "i", "name": "marker", "ts": 3}])
    path = str(tmp_path)
    ms, names = prof.trace_device_ms(path, by_name=True,
                                     exclude=lambda n: "spin" in n)
    assert ms == pytest.approx(0.160)       # union of 0-150 and 2000-2010
    assert names == {"dl4j_conv2d_fma": 0.2, "flash_fwd": 0.01}
    assert prof.trace_event_ms(path, "dl4j_conv2d_fma") == pytest.approx(0.2)
    assert prof.trace_event_counts(path) == {
        "dl4j_conv2d_fma": 2, "spin_kernel": 1, "flash_fwd": 1}
    rows = prof.trace_mapped_ms(
        path, lambda e: e["name"] if e["cat"] == "cpu_op" else None)
    assert rows == {"layer:a": pytest.approx(0.5)}  # the nested op not again


# ---------------------------------------------------------------------------
# StatsListener and TrainingHealthMonitor against the reference
# ---------------------------------------------------------------------------

def _lenet_pair():
    jnet = JLeNet(updater=JSgd(0.05)).init()
    tnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jnet.conf.to_json())).init(device="cpu")
    interop.load_reference_mln(
        tnet, [{k: np.asarray(v) for k, v in p.items()} for p in jnet.params],
        [{k: np.asarray(v) for k, v in s.items()} for s in jnet.states])
    return jnet, tnet


def _batches(n, poison_at=None):
    rng = np.random.default_rng(5)
    out = []
    for i in range(n):
        x = rng.normal(size=(8, 28, 28, 1)).astype(np.float32)
        if i == poison_at:
            x[:] = np.nan
        y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 8)]
        out.append((x, y))
    return out


def _close(a, b):
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return abs(a - b) <= 1e-6 + 1e-5 * abs(b)


def test_stats_listener_records_match_the_reference():
    jnet, tnet = _lenet_pair()
    js, ts = jstats.InMemoryStatsStorage(), stats.InMemoryStatsStorage()
    jnet.listeners.append(jstats.StatsListener(js, collect_histograms=True))
    tnet.listeners.append(stats.StatsListener(ts, collect_histograms=True))
    for x, y in _batches(3):
        jnet._fit_batch(x, y)
        tnet._fit_batch(x, y)
    assert len(js.records) == len(ts.records) == 3
    for jr, tr in zip(js.records, ts.records):
        assert jr["iteration"] == tr["iteration"]
        assert _close(tr["score"], jr["score"])
        for group in ("params", "updates"):
            assert set(tr.get(group, {})) == set(jr.get(group, {}))
            for key, s in jr.get(group, {}).items():
                for stat in ("mean", "std", "min", "max", "l2"):
                    assert _close(tr[group][key][stat], s[stat]), \
                        (group, key, stat, tr[group][key][stat], s[stat])
                assert sum(tr[group][key]["hist"]) == sum(s["hist"])
    assert "updates" in ts.records[-1] and "compile" in ts.records[-1]


@pytest.fixture
def healthy_after():
    """The monitors below publish ``training.finite`` False into both
    packages' process-wide telemetry; put it back, or a later test in the
    same process (a server's ``/healthz``) answers 503."""
    yield
    from deeplearning4j_tpu.util import telemetry as jtm
    from deeplearning4j_tpu_torch.util import telemetry as ttm

    for t in (jtm, ttm):
        t.set_health("training.finite", True, "")


def test_health_monitor_flags_the_same_anomalies(healthy_after):
    jnet, tnet = _lenet_pair()
    kw = dict(window=2, warmup=2, log_fn=None)
    jm = jhealth.TrainingHealthMonitor(**kw)
    tm_ = health.TrainingHealthMonitor(**kw)
    jnet.listeners.append(jm)
    tnet.listeners.append(tm_)
    for x, y in _batches(6, poison_at=3):
        jnet._fit_batch(x, y)
        tnet._fit_batch(x, y)
    got = [(i, k) for i, k, _ in tm_.anomalies]
    assert got == [(i, k) for i, k, _ in jm.anomalies]
    assert (4, "loss_non_finite") in got and (4, "params_non_finite") in got
    assert tm_.state()["last_probe"][0] is False


def test_health_monitor_panics_on_an_injected_nan(monkeypatch,
                                                  healthy_after):
    """``DL4J_TPU_FAULTS=inject_nan@2``: the fault fires at iteration 2
    (the seam the reference's elastic trainer uses, ``parallel/elastic.py
    :833``), the batch goes in poisoned, and ``panic=True`` raises."""
    monkeypatch.setenv("DL4J_TPU_FAULTS", "inject_nan@2")
    monkeypatch.setattr(faults.FaultInjector, "_instance", None)
    _, tnet = _lenet_pair()
    tnet.listeners.append(health.TrainingHealthMonitor(
        window=1, panic=True, log_fn=None))
    inj = faults.get_injector()
    with pytest.raises(prof.NaNPanicError, match="loss_non_finite"):
        for x, y in _batches(5):
            if inj.fire(faults.INJECT_NAN, step=tnet.iteration):
                x = np.full_like(x, np.nan)
            tnet._fit_batch(x, y)
    assert tnet.iteration == 3 and inj.log == [("inject_nan", 2)]
    monkeypatch.setattr(faults.FaultInjector, "_instance", None)


def test_crash_dump_of_a_graph_names_its_nodes(tmp_path):
    from deeplearning4j_tpu_torch.zoo import ResNet50

    net = ResNet50(num_classes=4, input_shape=(32, 32, 3)).init(device="cpu")
    p = tmp_path / "crash.json"
    stats.CrashReportingUtil.write_crash_dump(net, str(p), ValueError("x"))
    info = json.loads(p.read_text())
    assert info["param_bytes"]["stem_conv.W"] == 7 * 7 * 3 * 64 * 4
    assert info["backend"] == "cpu" and info["exception"] == "ValueError('x')"


# ---------------------------------------------------------------------------
# gradcheck
# ---------------------------------------------------------------------------

class _WrongTanh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = torch.tanh(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (1 - y * y) * 1.01  # planted 1% error


def test_gradcheck_defaults_are_the_references():
    assert (gc.DEFAULT_EPS, gc.DEFAULT_MAX_REL_ERROR,
            gc.DEFAULT_MIN_ABS_ERROR) == (1e-6, 1e-5, 1e-8)


@pytest.mark.parametrize("case", ["matmul_tanh", "conv_vjp", "wrong"])
def test_check_gradients_agrees_with_torch_gradcheck(case):
    from deeplearning4j_tpu_torch.ops import nn as nnops

    rng = np.random.default_rng(3)
    if case == "conv_vjp":  # the conv's custom autograd Function
        def fn(x, w):
            return torch.sin(nnops.conv2d(x, w, strides=(2, 1))).sum()
        args = [rng.normal(size=(2, 5, 5, 3)), rng.normal(size=(3, 3, 3, 4))]
    elif case == "wrong":
        def fn(x, w):
            return _WrongTanh.apply(x @ w).sum()
        args = [rng.normal(size=(3, 4)), rng.normal(size=(4, 2))]
    else:
        def fn(x, w):
            return torch.tanh(x @ w).pow(2).sum()
        args = [rng.normal(size=(3, 4)), rng.normal(size=(4, 2))]
    ours = gc.check_gradients(fn, [np.asarray(a) for a in args])
    theirs = torch.autograd.gradcheck(
        fn, [torch.tensor(a, dtype=torch.float64, requires_grad=True)
             for a in args], eps=gc.DEFAULT_EPS, rtol=gc.DEFAULT_MAX_REL_ERROR,
        atol=gc.DEFAULT_MIN_ABS_ERROR, raise_exception=False)
    assert ours.passed == theirs == (case != "wrong"), ours
    # arrays past 64 entries are checked on a seeded subset of 64
    assert ours.n_params == sum(min(a.size, 64) for a in args)


def test_check_model_gradients_on_a_layer_tree():
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer

    lyr = DenseLayer(n_in=4, n_out=3, activation="tanh")
    params, _ = lyr.initialize(torch.Generator().manual_seed(0), (4,))
    x = torch.as_tensor(np.random.default_rng(2).normal(size=(5, 4)))

    def loss(p):
        return lyr.apply(p, {}, x.to(p["W"].dtype))[0].square().sum()

    res = gc.check_model_gradients(loss, params)
    assert res.passed and res.n_params == 4 * 3 + 3, res
