"""The port's serving resilience layer against the reference's, on the CPU.

- ``CircuitBreaker``, ``SloEngine`` and ``BrownoutController`` of both
  packages driven by one injected clock through the same seeded sequences
  of outcomes: the states, ``opens``/``closes``, ``status()`` and
  ``evaluate()`` are equal after every event;
- ``_LatencyWindow`` quantiles and ``FlightRecorder`` dumps are equal;
- both packages' ``BatchScheduler`` + ``ServingModel`` on one tiny
  classifier (the reference's params copied with ``interop``), one request
  in flight at a time (the faults' ``@nth`` counts batch cycles), under the
  same ``DL4J_TPU_FAULTS``: the per-request outcomes (200 / 429 / 500 /
  503), the breaker's transitions, the restart count and the flight
  recorder's records are equal, every 200 answer within 1e-5;
- ``watch`` follows an archive republished with ``os.replace`` and keeps
  the old version when a truncated one is published;
- the HTTP routes (``/healthz``, ``/slo``, ``/metrics``, ``/admin/status``,
  ``/admin/drain``, ``debug/requests``, ``reload``, ``X-Request-Id``)
  answer the reference server's status codes and JSON keys.

The reference's own ``tests/test_serving_resilience.py`` runs here on the
port too (``_torch_port_cases``), its two cases of the elastic runtime's
archive publisher included.
"""

import http.client
import json
import os
import random
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _torch_port_cases import expose, port_copy  # noqa: E402

from deeplearning4j_tpu.nn import (InputType, MultiLayerNetwork,  # noqa: E402
                                   NeuralNetConfiguration)
from deeplearning4j_tpu.nn.layers import DenseLayer, OutputLayer  # noqa: E402
from deeplearning4j_tpu.nn.updaters import Adam  # noqa: E402
from deeplearning4j_tpu.serving import model as j_model  # noqa: E402
from deeplearning4j_tpu.serving import resilience as j_res  # noqa: E402
from deeplearning4j_tpu.serving import router as j_router  # noqa: E402
from deeplearning4j_tpu.serving import scheduler as j_sched  # noqa: E402
from deeplearning4j_tpu.serving import server as j_server  # noqa: E402
from deeplearning4j_tpu.util import faults as j_fl  # noqa: E402
from deeplearning4j_tpu.util import slo as j_slo  # noqa: E402
from deeplearning4j_tpu.util import telemetry as j_tm  # noqa: E402
from deeplearning4j_tpu.util.model_serializer import \
    ModelSerializer as JMS  # noqa: E402
from deeplearning4j_tpu_torch import interop  # noqa: E402
from deeplearning4j_tpu_torch.serving import model as p_model  # noqa: E402
from deeplearning4j_tpu_torch.serving import resilience as p_res  # noqa: E402
from deeplearning4j_tpu_torch.serving import router as p_router  # noqa: E402
from deeplearning4j_tpu_torch.serving import scheduler as p_sched  # noqa: E402
from deeplearning4j_tpu_torch.serving import server as p_server  # noqa: E402
from deeplearning4j_tpu_torch.util import faults as p_fl  # noqa: E402
from deeplearning4j_tpu_torch.util import slo as p_slo  # noqa: E402
from deeplearning4j_tpu_torch.util import telemetry as p_tm  # noqa: E402
from deeplearning4j_tpu_torch.util.model_serializer import \
    ModelSerializer as PMS  # noqa: E402

# the reference's own cases on the port (restores and routers on the CPU)
_ref = port_copy("test_serving_resilience", replace=(
    ("ModelRouter(name=", 'ModelRouter(device="cpu", name='),
    ("load_updater=False)", 'load_updater=False, device="cpu")')))
expose(_ref, [n for n in dir(_ref) if n.startswith("Test")], globals())

REF = dict(res=j_res, sched=j_sched, model=j_model, router=j_router,
           server=j_server, fl=j_fl, slo=j_slo, tm=j_tm)
PORT = dict(res=p_res, sched=p_sched, model=p_model, router=p_router,
            server=p_server, fl=p_fl, slo=p_slo, tm=p_tm,
            router_kw={"device": "cpu"})  # the port restores on the card
TOL = 1e-5


def _dense(seed=0, n_in=10, n_out=4):
    conf = (NeuralNetConfiguration.builder().seed(seed).updater(Adam(1e-3))
            .batch_buckets((2, 4, 8)).list()
            .layer(DenseLayer(n_in=n_in, n_out=24, activation="relu"))
            .layer(OutputLayer(n_in=24, n_out=n_out, loss="mcxent",
                               activation="softmax"))
            .set_input_type(InputType.feed_forward(n_in)).build())
    return MultiLayerNetwork(conf).init()


def _port(jnet):
    return interop.from_reference_json(
        jnet.conf.to_json(), jax.tree_util.tree_map(np.asarray, jnet.params),
        jax.tree_util.tree_map(np.asarray, jnet.states), device="cpu")


@pytest.fixture(scope="module")
def nets():
    jnet = _dense(0)
    return jnet, _port(jnet)


def _x(rows, seed):
    return np.random.default_rng(seed).normal(size=(rows, 10)).astype(
        np.float32)


# ------------------------------------------------------------- the breaker


def _breaker_events(seed, n=120):
    rng = random.Random(seed)
    return [rng.choice(("error", "error", "success", "allow", "allow",
                        "advance")) for _ in range(n)], rng


@pytest.mark.parametrize("seed,kw", [
    (0, {}),
    (1, {"consecutive_errors": 2, "cooldown_s": 3.0}),
    (2, {"consecutive_errors": 100, "error_rate": 0.5, "window": 8,
         "min_samples": 4, "half_open_probes": 2}),
    (3, {"consecutive_errors": 1, "cooldown_s": 1.0, "half_open_probes": 3}),
])
def test_breaker_steps_equal_the_reference(seed, kw):
    clock = [0.0]
    both = [pkg["res"].CircuitBreaker(clock=lambda: clock[0],
                                      model_id="parity", **kw)
            for pkg in (REF, PORT)]
    events, rng = _breaker_events(seed)
    for i, ev in enumerate(events):
        if ev == "advance":
            clock[0] += rng.choice((0.5, 1.0, 2.5, 6.0))
            continue
        seen = []
        for br in both:
            if ev == "allow":
                try:
                    br.allow()
                    seen.append(("admitted",))
                except (j_res.CircuitOpenError, p_res.CircuitOpenError) as e:
                    seen.append(("open", e.http_status,
                                 round(e.retry_after_s, 9)))
            else:
                getattr(br, f"record_{ev}")()
                seen.append(())
            seen.append((br.state, br.opens, br.closes, br.state_value(),
                         br.status()))
        assert seen[:2] == seen[2:], (i, ev)


# ---------------------------------------------- the SLO engine and brownout


class _FakeRouter:
    def __init__(self):
        self.calls = []

    def set_brownout(self, lanes=()):
        self.calls.append(tuple(lanes))


def _slo_run(pkg, seed, model):
    """One seeded traffic story through one package's engine and a
    brownout controller hung off it; returns every evaluation (without
    its wall time) and the controller's state after each."""
    clock = [1000.0]
    eng = pkg["slo"].SloEngine(clock=lambda: clock[0])
    eng.register(pkg["slo"].SloObjective(
        f"{model}-avail", "availability", target=0.9, model=model,
        windows=(5.0, 20.0)))
    eng.register(pkg["slo"].SloObjective(
        f"{model}-p99", "latency_p99", target=50.0, model=model,
        lane="interactive", windows=(10.0,)))
    router = _FakeRouter()
    ctrl = pkg["res"].BrownoutController(router)
    eng.on_breach(ctrl._on_breach)
    eng.on_recover(ctrl._on_recover)
    breaches = []
    eng.on_breach(lambda name, detail: breaches.append((name, detail)))
    eng.on_recover(lambda name: breaches.append((name,)))
    tm, rng, out = pkg["tm"], random.Random(seed), []
    try:
        for _ in range(40):
            clock[0] += rng.choice((0.5, 1.0, 3.0, 8.0))
            good, bad = rng.randrange(0, 20), rng.choice((0, 0, 1, 5, 30))
            if good:
                tm.counter("serving.completed_total", good, model=model,
                           lane="interactive")
            if bad:
                tm.counter("serving.shed_total", bad, model=model,
                           reason="deadline", lane="batch")
            tm.gauge("serving.latency_p99_seconds",
                     rng.choice((0.01, 0.03, 0.08)), model=model,
                     lane="interactive")
            doc = eng.evaluate()
            out.append((doc["objectives"], ctrl.status(),
                         list(router.calls), list(breaches)))
    finally:
        eng.reset()
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slo_engine_and_brownout_equal_the_reference(seed):
    model = f"slo-parity-{seed}"
    ref, port = _slo_run(REF, seed, model), _slo_run(PORT, seed, model)
    assert len(ref) == len(port)
    for i, (a, b) in enumerate(zip(ref, port)):
        assert a == b, i
    assert any(r[1]["active"] for r in ref)  # the story breached


def test_slo_module_api_equal_the_reference():
    for pkg in (REF, PORT):
        pkg["slo"].reset()
        assert pkg["slo"].current_status() == {}
        assert pkg["slo"].collect_slo_gauges() == []
    docs = []
    for pkg in (REF, PORT):
        pkg["slo"].register(pkg["slo"].SloObjective(
            "api-avail", "availability", target=0.99, model="slo-api",
            windows=(60.0,)))
        try:
            rows = pkg["slo"].collect_slo_gauges()
            status = pkg["slo"].current_status()
            docs.append((sorted((n, tuple(sorted(lab.items())))
                                for n, lab, _ in rows),
                         [{k: v for k, v in o.items()}
                          for o in status["objectives"]]))
        finally:
            pkg["slo"].reset()
    assert docs[0] == docs[1]


# -------------------------------------- latency window and flight recorder


def test_latency_window_and_flight_recorder_equal_the_reference():
    rng = random.Random(4)
    wins = [j_sched._LatencyWindow(size=16), p_sched._LatencyWindow(size=16)]
    recs = [j_sched.FlightRecorder(capacity=8),
            p_sched.FlightRecorder(capacity=8)]
    qs = (0.0, 0.1, 0.5, 0.9, 0.99, 1.0)
    assert wins[0].quantiles(qs) == wins[1].quantiles(qs)
    for i in range(100):
        v = rng.random() * rng.choice((1e-3, 1.0, 10.0))
        rec = {"id": f"r{i}", "status": rng.choice(("ok", "shed", "error")),
               "total_ms": round(v, 3)}
        for w, r in zip(wins, recs):
            w.add(v)
            r.record(dict(rec))
        assert wins[0].quantiles(qs) == wins[1].quantiles(qs), i
        assert wins[0].quantile(0.5) == wins[1].quantile(0.5)
        for last in (None, 0, 3, 100):
            assert recs[0].dump(last) == recs[1].dump(last)
        assert len(recs[0]) == len(recs[1])


# ------------------------------------------- scheduler under armed faults

#: (fault spec, events); "req" submits one request and waits for it,
#: "advance" moves the breaker's clock, "brownout" sheds lanes
_SCENARIOS = {
    "breaker": (
        "serving_compute_error@3,serving_compute_error@4,"
        "serving_compute_error@5,serving_worker_crash@7,"
        "serving_slow_batch@8:30",
        [("req", "interactive", 2), ("req", "interactive", 3),
         ("req", "interactive", 2), ("req", "batch", 1),
         ("req", "interactive", 4),           # third error: opens
         ("req", "interactive", 2),           # open: 503, no batch
         ("advance", 6.0),
         ("req", "interactive", 5),           # half-open probe closes it
         ("req", "batch", 2),                 # the crash: 500, restart
         ("req", "interactive", 8),           # slow batch, served
         ("brownout", ("batch",)),
         ("req", "batch", 2), ("req", "interactive", 1),
         ("brownout", ()),
         ("req", "batch", 3), ("shutdown",), ("req", "interactive", 2)]),
    "dead_worker": (
        "serving_worker_crash@2,serving_compute_error@4",
        [("req", "interactive", 2), ("req", "interactive", 2),
         ("req", "interactive", 1), ("req", "interactive", 2),
         ("req", "interactive", 3)]),
}


def _code(pkg, exc):
    res = pkg["res"]
    if isinstance(exc, res.ShedError):
        return exc.http_status
    if isinstance(exc, (KeyError, ValueError, TypeError)):
        return 400
    return 500


def _drive(pkg, net, spec, events, max_restarts):
    fl = pkg["fl"]
    clock = [0.0]
    old_env = os.environ.get("DL4J_TPU_FAULTS")
    os.environ["DL4J_TPU_FAULTS"] = spec
    fl.FaultInjector._instance = None  # re-read the environment
    try:
        model = pkg["model"].ServingModel(net, "m")
        model.warmup()
        breaker = pkg["res"].CircuitBreaker(clock=lambda: clock[0],
                                            model_id="m",
                                            consecutive_errors=3,
                                            cooldown_s=5.0)
        sched = pkg["sched"].BatchScheduler(
            model, max_wait_ms=0.5, breaker=breaker,
            max_restarts=max_restarts).start()
        outcomes, answers, breaker_seen = [], [], []
        crashes = 0
        for i, ev in enumerate(events):
            if ev[0] == "advance":
                clock[0] += ev[1]
                continue
            if ev[0] == "brownout":
                sched.set_brownout(ev[1])
                continue
            if ev[0] == "shutdown":
                sched.shutdown()
                continue
            x = _x(ev[2], i)
            try:
                out = sched.submit(x, lane=ev[1]).result(timeout=30)
                outcomes.append(200)
                answers.append(np.asarray(out))
            except Exception as e:  # noqa: BLE001 - the outcome
                outcomes.append(_code(pkg, e))
                answers.append(None)
                crashes += isinstance(e, pkg["res"].WorkerCrashedError)

            # the watchdog's bookkeeping (the breaker's error, the restart
            # count, a dead worker's flag) finishes after the futures fail
            def settled():
                return sched._restarts >= crashes and (
                    crashes <= max_restarts or sched._worker_dead)

            deadline = time.monotonic() + 10
            while not settled() and time.monotonic() < deadline:
                time.sleep(0.01)
            breaker_seen.append((breaker.state, breaker.opens,
                                 breaker.closes))
        stats = sched.stats()
        flight = [(r["status"], r["cause"], r["lane"], r["rows"],
                   r["bucket"]) for r in sched.flight.dump()]
        restarts = sched._restarts
        dead = sched._worker_dead
        sched.shutdown()
        return dict(outcomes=outcomes, answers=answers,
                    breaker=breaker_seen, breaker_status=breaker.status(),
                    restarts=restarts, dead=dead, flight=flight,
                    shed=stats["shed"], errors=stats["errors"],
                    completed=stats["completed"],
                    lanes={k: {kk: v[kk] for kk in ("completed", "errors",
                                                    "shed")}
                           for k, v in stats["lanes"].items()})
    finally:
        fl.get_injector().clear()
        fl.FaultInjector._instance = None
        if old_env is None:
            os.environ.pop("DL4J_TPU_FAULTS", None)
        else:
            os.environ["DL4J_TPU_FAULTS"] = old_env
        pkg["tm"].set_health("serving.worker.m", True, "test cleanup")


@pytest.mark.parametrize("name,max_restarts", [("breaker", 3),
                                               ("dead_worker", 0)])
def test_scheduler_outcomes_equal_the_reference(nets, name, max_restarts):
    jnet, net = nets
    spec, events = _SCENARIOS[name]
    ref = _drive(REF, jnet, spec, events, max_restarts)
    port = _drive(PORT, net, spec, events, max_restarts)
    for key in ("outcomes", "breaker", "breaker_status", "restarts", "dead",
                "flight", "shed", "errors", "completed", "lanes"):
        assert ref[key] == port[key], key
    for a, b in zip(ref["answers"], port["answers"]):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(b, a, rtol=0, atol=TOL)
    if name == "breaker":
        assert ref["outcomes"] == [200, 200, 500, 500, 500, 503, 200, 500,
                                   200, 429, 200, 200, 503]
    else:
        assert ref["outcomes"] == [200, 500, 503, 503, 503]


# ------------------------------------------------------------------ watch


def test_watch_follows_a_republished_archive(nets, tmp_path):
    jnet, net = nets
    router = p_router.ModelRouter(name="watch", device="cpu")
    router.register(p_model.ServingModel(net, "w"), max_wait_ms=0.5)
    model, _sched = router.get("w")
    model.warmup()
    pub = str(tmp_path / "live.zip")
    JMS.write_model(jnet, pub, save_updater=False)
    x = _x(3, 7)
    rejected0 = p_tm.get_telemetry().counter_total(
        "serving.reload_rejected_total", model="w")
    try:
        router.watch("w", pub, interval_s=0.05)
        new = _dense(5)
        tmp = pub + ".next"
        JMS.write_model(new, tmp, save_updater=False)
        os.replace(tmp, pub)
        deadline = time.time() + 30
        while model.version == 1 and time.time() < deadline:
            time.sleep(0.05)
        assert model.version == 2
        got = np.asarray(router.submit("w", x).result(timeout=30))
        np.testing.assert_allclose(got, np.asarray(new.output(x)), rtol=0,
                                   atol=TOL)
        # a truncated publish is refused; version 2 keeps serving
        data = open(pub, "rb").read()
        with open(tmp, "wb") as f:
            f.write(data[: len(data) // 2])
        os.replace(tmp, pub)
        deadline = time.time() + 30
        while (p_tm.get_telemetry().counter_total(
                "serving.reload_rejected_total", model="w") == rejected0
               and time.time() < deadline):
            time.sleep(0.05)
        assert p_tm.get_telemetry().counter_total(
            "serving.reload_rejected_total", model="w",
            reason="load_error") == rejected0 + 1
        assert model.version == 2
        again = np.asarray(router.submit("w", x).result(timeout=30))
        np.testing.assert_array_equal(again, got)
        assert router.unwatch("w")
    finally:
        router.shutdown()


# ------------------------------------------------------------- the routes


def _http(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        raw = None if body is None else json.dumps(body).encode()
        conn.request(method, path, body=raw, headers=headers or {})
        r = conn.getresponse()
        data = r.read()
        hdrs = dict(r.getheaders())
    finally:
        conn.close()
    if hdrs.get("Content-Type", "").startswith("application/json"):
        return r.status, json.loads(data), hdrs
    return r.status, data.decode(), hdrs


def _routes(pkg, net, good, bad):
    router = pkg["router"].ModelRouter(name="routes",
                                       **pkg.get("router_kw", {}))
    router.register(pkg["model"].ServingModel(net, "m"), max_wait_ms=0.5)
    pkg["slo"].reset()
    server = pkg["server"].ModelServer(router, port=0).start()
    port, seen = server.port, []

    def keys(status, body, hdrs, *extra):
        seen.append((status, sorted(body) if isinstance(body, dict)
                     else None, *extra))
        return body

    try:
        st, body, hdrs = _http(port, "POST", "/v1/models/m/infer",
                               {"inputs": _x(2, 1).tolist()},
                               {"X-Request-Id": "caller-7"})
        keys(st, body, hdrs, hdrs.get("X-Request-Id"), body["request_id"])
        outputs = np.asarray(body["outputs"])
        st, body, hdrs = _http(port, "GET",
                               "/v1/models/m/debug/requests?last=1")
        rec = keys(st, body, hdrs)["requests"][0]
        seen.append((sorted(rec), rec["id"], rec["status"], rec["rows"]))
        st, body, hdrs = _http(port, "GET", "/v1/models/nope/debug/requests")
        keys(st, body, hdrs)
        st, body, hdrs = _http(port, "GET", "/healthz")
        keys(st, body, hdrs, body["status"])
        # the serving section (this process may hold other routers)
        model_keys = set(next(
            (r["models"]["m"] for r in [body["serving"],
                                        *body["serving"].values()]
             if isinstance(r, dict) and "m" in r.get("models", {})), {}))
        st, body, hdrs = _http(port, "GET", "/slo")
        keys(st, body, hdrs, body)
        st, text, hdrs = _http(port, "GET", "/metrics")
        seen.append((st, [fam in text for fam in (
            "serving_requests_total", "serving_completed_total",
            "serving_batches_total", "serving_queue_depth",
            "serving_breaker_state", "serving_model_version",
            "serving_request_latency_seconds_bucket",
            "serving_flight_recorder_depth")]))
        st, body, hdrs = _http(port, "GET", "/admin/status")
        keys(st, body, hdrs, body["models"], body["draining"])
        st, body, hdrs = _http(port, "POST", "/v1/models/m/reload",
                               {"path": good})
        keys(st, body, hdrs, body.get("version"))
        st, body, hdrs = _http(port, "POST", "/v1/models/m/reload",
                               {"path": bad})
        keys(st, body, hdrs, body.get("error"))
        st, body, hdrs = _http(port, "POST", "/v1/models/m/reload", {})
        keys(st, body, hdrs)
        st, body, hdrs = _http(port, "POST", "/v1/models/nope/infer",
                               {"inputs": [[0.0] * 10]})
        keys(st, body, hdrs, "X-Request-Id" in hdrs)
        st, body, hdrs = _http(port, "GET", "/nope")
        keys(st, body, hdrs)
        st, body, hdrs = _http(port, "POST", "/admin/drain", {})
        keys(st, body, hdrs, body)
        assert server.wait_drained(timeout=30)
        st, body, hdrs = _http(port, "POST", "/v1/models/m/infer",
                               {"inputs": _x(1, 2).tolist()},
                               {"X-Request-Id": "late"})
        keys(st, body, hdrs, hdrs.get("Retry-After"),
             hdrs.get("X-Request-Id"))
        st, body, hdrs = _http(port, "GET", "/healthz")
        keys(st, body, hdrs, body["status"])
        st, body, hdrs = _http(port, "GET", "/admin/status")
        keys(st, body, hdrs, body["draining"], body["drained"])
    finally:
        server.stop()
        pkg["tm"].set_health("serving.accepting", True, "test cleanup")
        pkg["tm"].set_health("serving.drained", True, "test cleanup")
    return seen, outputs, model_keys


def test_routes_answer_the_reference_codes_and_keys(nets, tmp_path):
    jnet, net = nets
    good = str(tmp_path / "good.zip")
    JMS.write_model(_dense(3), good, save_updater=False)
    data = open(good, "rb").read()
    bad = str(tmp_path / "bad.zip")
    with open(bad, "wb") as f:
        f.write(data[: len(data) // 2])
    ref, ref_out, ref_keys = _routes(REF, jnet, good, bad)
    port, port_out, port_keys = _routes(PORT, net, good, bad)
    assert port == ref
    # the port's model section has every reference key (and its own:
    # counts, recompiles, device, params, chunks_executed)
    assert ref_keys and ref_keys <= port_keys, ref_keys - port_keys
    np.testing.assert_allclose(port_out, ref_out, rtol=0, atol=TOL)
    codes = [s[0] for s in ref if isinstance(s[0], int)]
    assert codes == [200, 200, 404, 200, 200, 200, 200, 200, 409, 400,
                     404, 404, 200, 503, 503, 200]


def test_port_archive_serves_as_the_reference_reads_it(nets, tmp_path):
    """The fleet's and the watcher's archives cross both ways: the port
    writes one, the reference restores it, and both answer alike."""
    jnet, net = nets
    path = str(tmp_path / "port.zip")
    PMS.write_model(net, path, save_updater=False)
    back = JMS.restore_model(path, load_updater=False)
    x = _x(4, 9)
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(back.output(x)), rtol=0, atol=TOL)
