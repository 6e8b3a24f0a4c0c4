"""The port's telemetry, fault injector and environment flags
(``util/telemetry.py``, ``util/faults.py``, ``config.py``) against the
reference's.

The reference's registry cases (``tests/test_telemetry.py::TestRegistry``)
run here on the port (``_torch_port_cases``). The tests below record the
same counters, gauges, histograms, spans and health checks into both
registries and require the same Prometheus text and the same Chrome trace
(names, phases, arguments, thread rows); forked ETL workers' spans come
back under their own PIDs; the fault specs and retry policy behave as the
reference's; the environment flags read the same variables.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(__file__))
from _torch_port_cases import expose, port_copy  # noqa: E402

import deeplearning4j_tpu.config as ref_config  # noqa: E402
import deeplearning4j_tpu.util.faults as ref_faults  # noqa: E402
import deeplearning4j_tpu.util.telemetry as ref_tm  # noqa: E402
import deeplearning4j_tpu_torch.config as port_config  # noqa: E402
import deeplearning4j_tpu_torch.util.faults as port_faults  # noqa: E402
import deeplearning4j_tpu_torch.util.telemetry as port_tm  # noqa: E402

_cases = port_copy("test_telemetry", drop=("import jax\n",
                                           "util.health import"))
expose(_cases, ["TestRegistry"], globals())


def _fresh(tm):
    """A registry of its own (not the process singleton), enabled."""
    t = tm.Telemetry()
    t.enabled = True
    return t


def _record(t):
    t.counter_inc("prefetch.batches_total", 3)
    t.counter_inc("prefetch.stalls_total")
    t.counter_inc("etl.records_total", 64, stage="transform")
    t.gauge_set("prefetch.queue_depth", 2)
    t.gauge_set("serving.queue", 1.5, model='m"1\n')
    for v in (0.0004, 0.003, 0.07, 2.0, 100.0):
        t.observe("prefetch.stall_seconds", v)
    t.set_health("etl", True, "fine")
    t.set_health("device", False, "lost")
    t.event("prefetch.etl_wait", 1_000_000_000, 1_000_250_000,
            tid=7, tname="dl4j-tpu-prefetch", batch=1)
    t.event("prefetch.device_put", 1_000_250_000, 1_000_300_000, tid=7,
            tname="dl4j-tpu-prefetch")
    t.merge_events([{"name": "etl.transform_chunk", "ph": "X", "pid": 4242,
                     "tid": 1, "tname": "MainThread", "ts": 999_000_000,
                     "dur": 5_000_000, "args": {"chunk": 0}}])
    return t


def test_prometheus_text_equal():
    ref = _record(_fresh(ref_tm)).prometheus_text()
    port = _record(_fresh(port_tm)).prometheus_text()
    assert port == ref
    assert "dl4j_prefetch_stalls_total 1" in port
    assert 'dl4j_prefetch_stall_seconds_bucket{le="+Inf"} 5' in port


def test_chrome_trace_and_snapshot_equal():
    def strip(trace):
        # process rows name the recording PID, and the main thread's id
        # differs between the two calls: compare the rest
        return [{k: v for k, v in e.items() if k != "pid"}
                for e in trace["traceEvents"]]

    ref, port = _record(_fresh(ref_tm)), _record(_fresh(port_tm))
    assert strip(port.chrome_trace()) == strip(ref.chrome_trace())
    assert port.snapshot() == ref.snapshot()


def test_spans_nest_on_the_calling_thread():
    out = []
    for tm in (ref_tm, port_tm):
        t = _fresh(tm)
        with t.span("outer", k=1):
            with t.span("inner"):
                t.instant("mark", v=2)
        out.append([(e["name"], e["ph"], e.get("args")) for e in
                    t.drain_events()])
    assert out[0] == out[1]
    assert ("inner", "X", {"parent": "outer"}) in out[1]


def test_disabled_registry_records_nothing():
    t = _fresh(port_tm)
    t.enabled = False
    _record(t)
    assert t.snapshot() == {"counters": {}, "gauges": {}, "histograms": {},
                            "health": {"etl": {"ok": True, "detail": "fine"},
                                       "device": {"ok": False,
                                                  "detail": "lost"}}}
    with t.span("x") as s:
        assert s is port_tm._NULL_SPAN


def test_forked_worker_spans_carry_child_pids():
    from deeplearning4j_tpu_torch.datavec import (
        MultiProcessTransformExecutor, Schema, TransformProcess)

    tele = port_tm.get_telemetry()
    was = tele.enabled
    tele.reset()
    tele.enabled = True
    try:
        tp = (TransformProcess.builder(
            Schema.builder().add_column_double("v").build())
            .double_math_op("v", "add", 1.0).build())
        out = MultiProcessTransformExecutor(
            tp, num_workers=2, min_records_per_worker=8).execute(
            [[float(i)] for i in range(64)])
        assert out == [[i + 1.0] for i in range(64)]
        events = tele.drain_events()
        pids = {e["pid"] for e in events
                if e["name"] == "etl.transform_chunk"}
        assert len(pids) == 2 and os.getpid() not in pids
        assert tele.snapshot()["counters"]["etl.chunks_total"] == 2
    finally:
        tele.enabled = was
        tele.reset()


def test_device_memory_collector_never_initialises_cuda():
    import torch

    if torch.cuda.is_initialized():
        pytest.skip("CUDA already initialised in this process")
    assert port_tm.device_memory_stats() == []
    assert not torch.cuda.is_initialized()


def test_compile_collector_reads_the_port_watcher():
    from deeplearning4j_tpu_torch.util.compile_watcher import get_watcher

    w = get_watcher()
    got = dict((n, v) for n, _, v in port_tm._collect_compile())
    assert got["xla.traces_total"] == w.counts()["total_traces"]
    assert "xla.backend_compiles_total" in got


def test_default_collectors_leave_out_the_compile_cache():
    t = port_tm.get_telemetry()
    saved, flag = list(t._collectors), port_tm._defaults_installed
    try:
        t._collectors.clear()
        port_tm._defaults_installed = False
        port_tm.install_default_collectors()
        names = [f.__name__ for f in t._collectors]
        assert "_collect_compile_cache" not in names
        assert names[:2] == ["_collect_compile", "_collect_device_memory"]
        t.prometheus_text()  # guarded collectors of unported modules: quiet
    finally:
        t._collectors[:] = saved
        port_tm._defaults_installed = flag


@pytest.mark.parametrize("spec", [
    "kill_etl_worker", "inject_nan@5,stall_prefetch:3.0",
    "serving_slow_batch@2:40, drop_heartbeat"])
def test_fault_specs_parse_as_the_reference(spec):
    def norm(faults):
        return [(f.kind, f.at_step, f.arg) for f in faults]

    assert norm(port_faults.parse_fault_spec(spec)) == norm(
        ref_faults.parse_fault_spec(spec))


def test_unknown_fault_kind_raises_in_both():
    for mod in (ref_faults, port_faults):
        with pytest.raises(ValueError):
            mod.parse_fault_spec("melt_the_card")


def test_injector_fires_once_and_retry_policy_delays():
    inj = port_faults.FaultInjector()
    inj.inject(port_faults.STALL_PREFETCH, arg=0.5)
    assert inj.armed(port_faults.STALL_PREFETCH)
    f = inj.fire(port_faults.STALL_PREFETCH)
    assert f is not None and f.arg == 0.5
    assert inj.fire(port_faults.STALL_PREFETCH) is None
    kw = dict(max_attempts=4, base_delay=0.1, max_delay=0.3, jitter=0.0)
    assert port_faults.RetryPolicy(**kw).delays() == \
        ref_faults.RetryPolicy(**kw).delays()
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "done"

    assert port_faults.RetryPolicy(max_attempts=3, base_delay=0.0).run(
        flaky, name="t", retry_on=(OSError,)) == "done"
    with pytest.raises(port_faults.RetryExhaustedError):
        port_faults.RetryPolicy(max_attempts=2, base_delay=0.0).run(
            lambda: (_ for _ in ()).throw(OSError("x")), name="t",
            retry_on=(OSError,))


def test_environment_reads_the_same_flags(monkeypatch):
    for k, v in {"DL4J_TPU_ETL_WORKERS": "3", "DL4J_TPU_BUCKETS": "pow2",
                 "DL4J_TPU_TELEMETRY": "0", "DL4J_TPU_FAULTS": "inject_nan@5",
                 "DL4J_TPU_VERBOSE": "1",
                 "DL4J_TPU_TRACE_SAMPLE": "0.5"}.items():
        monkeypatch.setenv(k, v)
    keys = ("etl_workers", "default_buckets", "telemetry", "fault_spec",
            "debug", "verbose", "trace_sample")
    ref = ref_config.Environment()
    port = port_config.Environment()
    assert [getattr(port, k) for k in keys] == [getattr(ref, k) for k in keys]
    monkeypatch.setenv("DL4J_TPU_ETL_WORKERS", "-1")
    with pytest.raises(ValueError, match="DL4J_TPU_ETL_WORKERS"):
        port_config.Environment()


def test_environment_drives_the_telemetry_switch(monkeypatch):
    monkeypatch.setattr(port_config.Environment, "_instance", None)
    tele = port_tm.get_telemetry()
    was = tele.enabled
    try:
        env = port_config.get_environment()
        env.set_telemetry(False)
        assert not port_tm.enabled()
        env.set_telemetry(True)
        assert port_tm.enabled()
    finally:
        tele.enabled = was
        monkeypatch.setattr(port_config.Environment, "_instance", None)


def test_etl_workers_flag_sizes_the_executor(monkeypatch):
    from deeplearning4j_tpu_torch.datavec import executor

    monkeypatch.setattr(port_config.Environment, "_instance", None)
    monkeypatch.setenv("DL4J_TPU_ETL_WORKERS", "3")
    try:
        assert executor._default_workers() == 3
    finally:
        monkeypatch.setattr(port_config.Environment, "_instance", None)
