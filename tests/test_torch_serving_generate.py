"""The port's generate serving route, on the CPU: ModelServer -> ModelRouter
-> BatchScheduler -> ServingModel(kind="generate") -> Generator.

- ``POST /v1/models/<id>/generate`` answers the reference ``Generator``'s
  greedy tokens (one prompt, a list, concurrent requests, eos), ``infer``
  and ``generate`` on the wrong kinds are client errors;
- a pinned pool too small for a request sheds it with 429 and
  ``Retry-After`` (the scheduler counts ``shed_pool_exhausted``), leaks no
  block, and the next request is served;
- ``ModelRouter.load(kind="generate", draft_path=, quantize=)`` restores
  the target and the draft from archives and decodes speculatively;
- a chunked prefill on the batch lane yields between chunks to a queued
  interactive batch (``_drain_priority_once``), which finishes first;
- the canary, ``describe`` and the swap of a rolling reload carry the
  generator.
"""

import json
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from deeplearning4j_tpu.serving import Generator as JGen  # noqa: E402
from deeplearning4j_tpu.zoo.bert import Bert as JBert  # noqa: E402
from deeplearning4j_tpu_torch import interop  # noqa: E402
from deeplearning4j_tpu_torch.serving import (  # noqa: E402
    BatchScheduler, ModelRouter, ModelServer, ServingModel)
from deeplearning4j_tpu_torch.util.model_serializer import \
    ModelSerializer  # noqa: E402

VOCAB = 97
SPEC = "batch=1,2,4;seq=8,16"
BUCKETS = dict(batch_buckets=(1, 2, 4), prefill_buckets=(8, 16))
RAGGED = [[1, 2, 3], [4, 5, 6, 7, 8], [9, 10, 11, 12, 13, 14, 15, 16, 17]]


def _port(jnet):
    return interop.from_reference_json(
        jnet.conf.to_json(), jax.tree_util.tree_map(np.asarray, jnet.params),
        jax.tree_util.tree_map(np.asarray, jnet.states), device="cpu")


@pytest.fixture(scope="module")
def nets():
    jnet = JBert.tiny(causal=True, task="mlm", vocab_size=VOCAB,
                      max_length=32, hidden_dropout=0.0).init()
    jdraft = JBert.draft(vocab_size=VOCAB, max_length=32, seed=7).init()
    return jnet, _port(jnet), _port(jdraft)


@pytest.fixture(scope="module")
def want(nets):
    """The reference's greedy tokens for each RAGGED prompt alone (rows
    do not depend on their batch)."""
    gen = JGen(nets[0], paged=False, **BUCKETS)
    return {n: gen.generate(RAGGED, max_new_tokens=n) for n in (5, 8)}


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def test_http_generate_route(nets, want):
    _, net, _ = nets
    router = ModelRouter(device="cpu")
    router.register(ServingModel(net, "lm", kind="generate",
                                 bucketing=SPEC, block_size=4),
                    max_wait_ms=20.0)
    server = ModelServer(router, port=0).start()
    url = f"{server.url}/v1/models/lm/generate"
    try:
        status, body, _ = _post(url, {"prompt_tokens": RAGGED,
                                      "max_new_tokens": 8})
        assert status == 200 and body["tokens"] == want[8]
        status, body, _ = _post(url, {"prompt_tokens": RAGGED[2],
                                      "max_new_tokens": 5,
                                      "lane": "interactive"})
        assert status == 200 and body["tokens"] == [want[5][2]]
        with ThreadPoolExecutor(3) as pool:
            outs = list(pool.map(lambda p: _post(url, {
                "prompt_tokens": [p], "max_new_tokens": 5}), RAGGED))
        assert [o[1]["tokens"][0] for o in outs] == want[5]
        eos = want[8][0][2]
        status, body, _ = _post(url, {"prompts": [RAGGED[0]],
                                      "max_new_tokens": 8, "eos_id": eos})
        assert body["tokens"] == [want[8][0][:3]]
        status, body, _ = _post(url, {"max_new_tokens": 8})
        assert status == 400
        status, body, _ = _post(f"{server.url}/v1/models/nope/generate",
                                {"prompt_tokens": [1]})
        assert status == 404
        with urllib.request.urlopen(f"{server.url}/v1/models") as r:
            desc = json.loads(r.read())["models"]["lm"]
        assert desc["kind"] == "generate"
        assert desc["kv_pool"]["streams"] == 0
        assert desc["counts"]["completed"] >= 8
        model, _ = router.get("lm")
        assert model.generator.pool.conservation()[0]
    finally:
        server.stop()


def test_pool_exhaustion_sheds_429(nets):
    _, net, _ = nets
    router = ModelRouter(device="cpu")
    router.register(ServingModel(net, "small", kind="generate",
                                 bucketing="batch=1,2;seq=8", block_size=4,
                                 pool_blocks=2), max_wait_ms=1.0)
    server = ModelServer(router, port=0).start()
    url = f"{server.url}/v1/models/small/generate"
    try:
        status, body, headers = _post(url, {"prompt_tokens": [1] * 8,
                                            "max_new_tokens": 20})
        assert status == 429
        assert body["error"] == "PoolExhaustedError"
        assert int(headers["Retry-After"]) >= 1
        model, sched = router.get("small")
        assert sched.counts["shed_pool_exhausted"] == 1
        assert sched.counts.get("errors", 0) == 0
        assert model.generator.pool.conservation()[0]
        assert model.generator.pool.free_blocks() == 2
        status, body, _ = _post(url, {"prompt_tokens": [1, 2],
                                      "max_new_tokens": 4})
        assert status == 200 and len(body["tokens"][0]) == 4
        ok, detail = model.canary_check()
        assert ok, detail
    finally:
        server.stop()


def test_router_load_draft_and_int8(nets, tmp_path, want):
    _, net, draft = nets
    target, dpath = str(tmp_path / "lm.zip"), str(tmp_path / "draft.zip")
    ModelSerializer.write_model(net, target, save_updater=False)
    ModelSerializer.write_model(draft, dpath, save_updater=False)
    router = ModelRouter(device="cpu")
    try:
        router.load("spec", target, kind="generate", draft_path=dpath,
                    bucketing=SPEC, block_size=4, spec_tokens=3,
                    start=False)
        model, _ = router.get("spec")
        assert model.generator.draft is not None
        assert model.generator.spec_tokens == 3
        model.warmup()
        got, stats = model.execute([np.asarray(p) for p in RAGGED],
                                   max_new_tokens=8)
        assert got == want[8]
        assert len(stats["draft_accept_rate"]) == 3
        assert stats["recompiles"] == 0
        assert model.describe()["speculative"]["spec_tokens"] == 3
        router.load("q8", target, kind="generate", quantize="int8",
                    bucketing=SPEC, block_size=4, start=False)
        q8, _ = router.get("q8")
        assert q8.describe()["quantize"] == "int8"
        out, _ = q8.execute([np.asarray(RAGGED[1])], max_new_tokens=4)
        assert len(out[0]) == 4
    finally:
        router.shutdown()


def test_chunked_prefill_yields_to_interactive(nets):
    """A long batch-lane prompt prefilled in chunks of 4: between its
    chunks the scheduler runs the interactive request queued meanwhile,
    which therefore completes before the outer batch."""
    _, net, _ = nets
    model = ServingModel(net, "chunky", kind="generate", bucketing=SPEC,
                         block_size=4, prefill_chunk=4)
    assert model.supports_chunked_prefill
    model.warmup()
    sched = BatchScheduler(model, max_wait_ms=1.0)
    order, inner = [], []
    gen = model.generator
    orig = gen._prefill_window_paged

    def first_chunk_submits(*a):
        if not inner:  # while the outer batch runs: an interactive request
            fut = sched.submit(np.asarray(RAGGED[0]), lane="interactive",
                               max_new_tokens=3)
            fut.add_done_callback(lambda f: order.append("interactive"))
            inner.append(fut)
        return orig(*a)

    gen._prefill_window_paged = first_chunk_submits
    sched.start()
    try:
        outer = sched.submit(np.asarray(list(range(1, 15))), lane="batch",
                             max_new_tokens=4)
        outer.add_done_callback(lambda f: order.append("batch"))
        assert len(outer.result(timeout=60)) == 4
        assert len(inner[0].result(timeout=60)) == 3
    finally:
        sched.shutdown()
        gen._prefill_window_paged = orig
    assert order == ["interactive", "batch"]
    assert sched.counts["prefill_yield_preemptions"] == 1
    assert sched.stats()["last_batch"]["prefill_chunks"] == 4
    assert gen.pool.free_blocks() == gen.pool.num_blocks


def test_interactive_batch_never_yields(nets):
    _, net, _ = nets
    model = ServingModel(net, "chunky", kind="generate", bucketing=SPEC,
                         block_size=4, prefill_chunk=4)
    seen = []
    real = model.execute

    def spy(payloads, _yield=None, **opts):
        seen.append(_yield)
        return real(payloads, _yield=_yield, **opts)

    model.execute = spy
    sched = BatchScheduler(model, max_wait_ms=1.0).start()
    try:
        sched.submit(np.asarray(RAGGED[2]), lane="interactive",
                     max_new_tokens=2).result(timeout=60)
        sched.submit(np.asarray(RAGGED[2]), lane="batch",
                     max_new_tokens=2).result(timeout=60)
    finally:
        sched.shutdown()
    assert seen[0] is None and seen[1] is not None


def test_reload_and_options_coalescing(nets, tmp_path, want):
    """Requests with other options never share a batch; a rolling reload
    of a generate model swaps its generator between batches."""
    _, net, _ = nets
    router = ModelRouter(device="cpu")
    router.register(ServingModel(net, "lm", kind="generate", bucketing=SPEC,
                                 block_size=4), max_wait_ms=50.0,
                    start=False)
    model, sched = router.get("lm")
    model.warmup()
    order = (0, 2, 1)  # two requests of 5 tokens, then one of 8
    futs = [sched.submit(np.asarray(RAGGED[i]), lane="batch",
                         max_new_tokens=n) for i, n in zip(order, (5, 5, 8))]
    sched.start()
    try:
        got = [f.result(timeout=60) for f in futs]
        assert got == [want[5][0], want[5][2], want[8][1]]
        assert sched.counts["batches"] == 2
        path = str(tmp_path / "lm.zip")
        ModelSerializer.write_model(net, path, save_updater=False)
        old = model.generator
        assert router.reload("lm", path) == 2
        assert model.generator is not old
        assert router.submit("lm", np.asarray(RAGGED[1]),
                             max_new_tokens=8).result(timeout=60) \
            == want[8][1]
    finally:
        router.shutdown()
