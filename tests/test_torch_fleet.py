"""The port's serving fleet against the reference's, on the CPU.

- ``rendezvous_score``, ``rendezvous_pick`` and ``affinity_key`` are bit
  for bit the reference's over seeded keys and member sets;
  ``_relabel_metrics`` and ``fleet_spec`` give the reference's output;
- the reference's stub-fleet contracts (``tests/test_fleet.py``: request
  ids and ``Retry-After`` across the hop, affinity, failover, 502, 503,
  draining, rolling reload, ``/v1/fleet``, metrics fan-in) run on the
  port's ``FleetRouter`` (``_torch_port_cases``);
- a real fleet of two worker processes on the CPU (spec device "cpu")
  serving a tiny classifier with the reference's params and a tiny causal
  BERT LM from the reference's archives: answers within 1e-5 of the
  reference net's ``output``, greedy tokens equal to the reference
  ``Generator``'s and each head's streams on ``rendezvous_pick``'s worker;
  a SIGKILLed worker failed over (8 of 8 answered) and respawned into the
  ring; a rolling reload under traffic with no answer but 200; ``/metrics``
  relabelled per worker; ``stop()`` drains every worker to exit code 0.
"""

import http.client
import json
import os
import random
import re
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_port_cases import expose, port_copy  # noqa: E402

from deeplearning4j_tpu.nn import (InputType, MultiLayerNetwork,  # noqa: E402
                                   NeuralNetConfiguration)
from deeplearning4j_tpu.nn.layers import DenseLayer, OutputLayer  # noqa: E402
from deeplearning4j_tpu.nn.updaters import Adam  # noqa: E402
from deeplearning4j_tpu.serving import Generator as JGen  # noqa: E402
from deeplearning4j_tpu.serving import fleet as j_fleet  # noqa: E402
from deeplearning4j_tpu.util.model_serializer import \
    ModelSerializer as JMS  # noqa: E402
from deeplearning4j_tpu.zoo.bert import Bert as JBert  # noqa: E402
from deeplearning4j_tpu_torch.ops.kernels import KERNELS  # noqa: E402
from deeplearning4j_tpu_torch.serving import fleet as p_fleet  # noqa: E402
from deeplearning4j_tpu_torch.util import telemetry as p_tm  # noqa: E402

# the reference's stub-fleet contracts on the port's FleetRouter
_ref = port_copy("test_fleet")
expose(_ref, ["TestRendezvous", "TestStubFleet"], globals())

TOL = 1e-5
VOCAB = 97
HEAD = 4


# ----------------------------------------------------------------- hashing


def _keys(seed, n=300):
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        model = rng.choice(("m", "lm", "bert-base", ""))
        toks = [rng.randrange(0, 30522) for _ in range(rng.randrange(0, 40))]
        head = rng.choice((0, 1, 4, 16, 32))
        out.append((model, toks, head))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rendezvous_bit_equal_the_reference(seed):
    rng = random.Random(100 + seed)
    for model, toks, head in _keys(seed):
        key = p_fleet.affinity_key(model, toks, head)
        assert key == j_fleet.affinity_key(model, toks, head)
        if key is None:
            continue
        members = [f"w{i}" for i in rng.sample(range(16),
                                               rng.randrange(1, 9))]
        for m in members:
            assert p_fleet.rendezvous_score(key, m) == \
                j_fleet.rendezvous_score(key, m)
        assert p_fleet.rendezvous_pick(key, members) == \
            j_fleet.rendezvous_pick(key, members)
    with pytest.raises(ValueError):
        p_fleet.rendezvous_pick(b"k", [])


def test_relabel_and_fleet_spec_equal_the_reference():
    tele = p_tm.get_telemetry()
    tele.counter_inc("serving.requests_total", model="m", lane="batch")
    tele.gauge_set("serving.queue_depth", 3, model="m")
    tele.observe("serving.request_latency_seconds", 0.01, model="m",
                 lane="interactive")
    texts = [tele.prometheus_text(),
             '# TYPE up gauge\nup 1\nweird line\nx{a="1",b="2"} 2.5\n\n'
             'nan_metric NaN\n']
    for text in texts:
        for wid in ("w0", "w12"):
            assert p_fleet._relabel_metrics(text, wid) == \
                j_fleet._relabel_metrics(text, wid)
    models = [{"id": "clf", "path": "/m/clf.zip", "kind": "classify",
               "register": {"max_wait_ms": 1.0}},
              {"id": "lm", "path": "/m/lm.zip", "kind": "generate",
               "model_kw": {"bucketing": {"batch_buckets": [1, 2]},
                            "block_size": 16}}]
    for env in (None, {"DL4J_TPU_TRACE_SAMPLE": "1"}):
        assert p_fleet.fleet_spec(models, env=env) == \
            j_fleet.fleet_spec(models, env=env)
    assert p_fleet.fleet_spec(models, device="cpu")["device"] == "cpu"
    assert p_fleet.default_affinity_head() == \
        j_fleet.default_affinity_head()


# ------------------------------------------------------------ a real fleet


def _dense(seed):
    conf = (NeuralNetConfiguration.builder().seed(seed)
            .updater(Adam(1e-3)).batch_buckets((1, 2, 4)).list()
            .layer(DenseLayer(n_in=8, n_out=16, activation="relu"))
            .layer(OutputLayer(n_in=16, n_out=4, loss="mcxent",
                               activation="softmax"))
            .set_input_type(InputType.feed_forward(8)).build())
    return MultiLayerNetwork(conf).init()


def _post(port, path, body, headers=None, timeout=60):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, body=json.dumps(body).encode(),
                     headers={"Content-Type": "application/json",
                              **(headers or {})})
        r = conn.getresponse()
        data = r.read()
        return r.status, json.loads(data) if data else {}, \
            dict(r.getheaders())
    finally:
        conn.close()


def _get(port, path, timeout=30):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


PROMPTS = [[5, 9, 1, 3, 11, 12, 13], [5, 9, 1, 3, 20, 21],
           [7, 7, 2, 8, 30, 31, 32, 33, 34], [7, 7, 2, 8, 40]]


@pytest.fixture(scope="module")
def fleet_env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fleet")
    net = _dense(0)
    clf = str(tmp / "clf.zip")
    JMS.write_model(net, clf, save_updater=False)
    lm = JBert.tiny(causal=True, task="mlm", vocab_size=VOCAB,
                    max_length=32, hidden_dropout=0.0).init()
    lm_path = str(tmp / "lm.zip")
    JMS.write_model(lm, lm_path, save_updater=False)
    want = JGen(lm, paged=False, batch_buckets=(1, 2, 4),
                prefill_buckets=(8, 16)).generate(PROMPTS, max_new_tokens=6)
    spec = p_fleet.fleet_spec(
        models=[{"id": "clf", "path": clf, "kind": "classify",
                 "register": {"max_wait_ms": 1.0, "queue_limit": 128}},
                {"id": "lm", "path": lm_path, "kind": "generate",
                 "register": {"max_wait_ms": 1.0},
                 "model_kw": {"bucketing": "batch=1,2,4;seq=8,16",
                              "block_size": 4, "pool_blocks": 64}}],
        device="cpu")
    fleet = p_fleet.FleetRouter(spec, n_workers=2, health_interval_s=0.1,
                                affinity_head=HEAD, name="cpufleet",
                                fleet_dir=str(tmp / "run")).start()
    x = np.random.RandomState(3).normal(size=(3, 8)).astype(np.float32)
    yield {"fleet": fleet, "net": net, "x": x, "tmp": tmp, "want": want}
    fleet.stop()


class TestCpuFleet:
    def test_classify_equals_the_reference_net(self, fleet_env):
        fleet, net, x = fleet_env["fleet"], fleet_env["net"], fleet_env["x"]
        oracle = np.asarray(net.output(x))
        for i in range(4):
            rows = x[: 1 + i % 3]
            st, body, hdrs = _post(fleet.port, "/v1/models/clf/infer",
                                   {"inputs": rows.tolist()},
                                   headers={"X-Request-Id": f"clf-{i}"})
            assert st == 200 and hdrs.get("X-Request-Id") == f"clf-{i}"
            np.testing.assert_allclose(np.asarray(body["outputs"]),
                                       oracle[: len(rows)], rtol=0, atol=TOL)

    def test_workers_report_their_kernel_counts(self, fleet_env):
        """Each worker's ``/v1/models`` carries its own process's kernel
        counts: on the CPU every op takes its plain version, so nothing
        is launched and nothing counts as plain on a card."""
        fleet = fleet_env["fleet"]
        zeros = dict.fromkeys(KERNELS, 0)
        for w in fleet._ring():
            st, raw = _get(w.port, "/v1/models")
            body = json.loads(raw)
            assert st == 200 and "clf" in body["models"]
            assert body["kernels"] == {"launches": zeros,
                                       "plain_on_cuda": zeros}

    def test_generate_equals_the_reference_and_keeps_affinity(self,
                                                               fleet_env):
        fleet, want = fleet_env["fleet"], fleet_env["want"]
        ring = sorted(w.worker_id for w in fleet._ring())
        for i, p in enumerate(PROMPTS):
            rid = f"gen-{i}"
            st, body, _h = _post(fleet.port, "/v1/models/lm/generate",
                                 {"prompt_tokens": p, "max_new_tokens": 6},
                                 headers={"X-Request-Id": rid})
            assert st == 200 and body["tokens"] == [want[i]]
            owner = p_fleet.rendezvous_pick(
                p_fleet.affinity_key("lm", p, HEAD), ring)
            recs = [r for r in fleet.debug_requests("lm") if r["id"] == rid]
            assert [r["worker"] for r in recs] == [owner]
        assert fleet.status()["routing_decisions"]["affinity"] >= 4

    def test_sigkill_fails_over_and_respawns(self, fleet_env):
        fleet, x = fleet_env["fleet"], fleet_env["x"]
        victim = fleet._ring()[0]
        os.kill(victim.pid, 9)
        ok = 0
        for _ in range(8):
            st, _body, _h = _post(fleet.port, "/v1/models/clf/infer",
                                  {"inputs": x.tolist()}, timeout=30)
            ok += st == 200
        assert ok == 8
        deadline = time.monotonic() + 60
        while len(fleet._ring()) < 2 and time.monotonic() < deadline:
            time.sleep(0.1)
        assert len(fleet._ring()) == 2
        assert fleet.worker(victim.worker_id).restarts >= 1
        assert fleet.worker(victim.worker_id).pid != victim.pid or \
            fleet.worker(victim.worker_id).proc.poll() is None

    def test_rolling_reload_under_traffic(self, fleet_env):
        fleet, x = fleet_env["fleet"], fleet_env["x"]
        net2 = _dense(7)
        path2 = str(fleet_env["tmp"] / "clf2.zip")
        JMS.write_model(net2, path2, save_updater=False)
        stop, codes = threading.Event(), []

        def traffic():
            while not stop.is_set():
                st, _b, _h = _post(fleet.port, "/v1/models/clf/infer",
                                   {"inputs": x.tolist()}, timeout=30)
                codes.append(st)

        t = threading.Thread(target=traffic, daemon=True)
        t.start()
        try:
            st, body, _h = _post(fleet.port, "/v1/models/clf/reload",
                                 {"path": path2}, timeout=120)
        finally:
            stop.set()
            t.join(timeout=30)
        assert st == 200 and sorted(body["versions"]) == ["w0", "w1"]
        assert all(v >= 2 for v in body["versions"].values())
        assert codes and set(codes) == {200}
        oracle2 = np.asarray(net2.output(x))
        for _ in range(4):
            st, body, _h = _post(fleet.port, "/v1/models/clf/infer",
                                 {"inputs": x.tolist()})
            np.testing.assert_allclose(np.asarray(body["outputs"]), oracle2,
                                       rtol=0, atol=TOL)
        # a later respawn loads the new archive
        assert [m["path"] for m in fleet.spec["models"]
                if m["id"] == "clf"] == [path2]

    def test_metrics_relabelled_and_stop_drains_to_exit_0(self, fleet_env):
        fleet = fleet_env["fleet"]
        st, data = _get(fleet.port, "/metrics")
        text = data.decode()
        assert st == 200
        for wid in ("w0", "w1"):
            assert re.search(r'serving_completed_total\{worker="%s",' % wid,
                             text), wid
        assert 'serving_fleet_ring_size{fleet="cpufleet"} 2' in text
        st, data = _get(fleet.port, "/healthz")
        assert st == 200 and json.loads(data)["ring"] == ["w0", "w1"]
        fleet.stop()
        assert [w.proc.returncode for w in fleet.workers] == [0, 0]


def test_worker_without_a_device_is_reported(tmp_path):
    """A spec naming no device sends the workers to the card; without one
    each exits non-zero and ``start`` raises with the worker's log."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the workers would boot on it")
    path = str(tmp_path / "clf.zip")
    JMS.write_model(_dense(1), path, save_updater=False)
    spec = p_fleet.fleet_spec(models=[{"id": "clf", "path": path}])
    fleet = p_fleet.FleetRouter(spec, n_workers=1, boot_timeout_s=60,
                                fleet_dir=str(tmp_path / "run"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet.start()
    assert fleet.workers[0].proc.returncode not in (None, 0)
