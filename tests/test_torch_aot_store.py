"""The compile-time half of item 12 on the CPU: the AOT store
(``util/aot_store.py``) behind ``warmup(export_dir=)``, the persistent
kernel-library cache (``util/compile_cache.py``), the environment's
builder defaults, and the captured ``score``, ``rnn_time_step`` and
``feed_forward`` (``nn/capture.py`` programs), against the JAX package
where it has the same thing.

- the store's key misses on each of its inputs (tag, conf, signature,
  torch and CUDA versions, the package digest, an environment bit); a
  truncated entry is a miss, never an error; saves from several threads
  at once leave one readable entry; hits, misses and saves are counted;
- a warm start across processes: a first process saves a network's
  archive and warms it with ``export_dir``; a second one (a subprocess,
  on the CPU) restores the archive, warms from the store with no shapes
  given, builds the same programs and answers bit-equal;
- ``compile_cache``: the library path follows the cache directory, and
  ``cache_entries``/``clear_persistent_cache`` count and prune it;
- ``DL4J_TPU_COMPUTE_DTYPE``, ``DL4J_TPU_SYNC_EVERY`` and
  ``DL4J_TPU_FUSED_UPDATE`` give the builder the defaults the reference's
  builder takes;
- captured ``score``, ``rnn_time_step`` (its carries the program's
  static inputs) and ``feed_forward`` on both networks equal the eager
  ones bit for bit and the reference's within 1e-5.
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))

import test_torch_seq_graph as seq_graph  # noqa: E402
from deeplearning4j_tpu import config as ref_config  # noqa: E402
from deeplearning4j_tpu.nn import layers as JL  # noqa: E402
from deeplearning4j_tpu.nn import recurrent as JR  # noqa: E402
from deeplearning4j_tpu.nn import updaters as jupd  # noqa: E402
from deeplearning4j_tpu.nn.conf import \
    NeuralNetConfiguration as JNNC  # noqa: E402
from deeplearning4j_tpu.nn.multilayer import \
    MultiLayerNetwork as JMLN  # noqa: E402
from deeplearning4j_tpu_torch import config as port_config  # noqa: E402
from deeplearning4j_tpu_torch import interop  # noqa: E402
from deeplearning4j_tpu_torch.nn import capture  # noqa: E402
from deeplearning4j_tpu_torch.nn import layers as TL  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import \
    MultiLayerConfiguration as TMConf  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import \
    NeuralNetConfiguration as TNNC  # noqa: E402
from deeplearning4j_tpu_torch.nn.multilayer import \
    MultiLayerNetwork as TMLN  # noqa: E402
from deeplearning4j_tpu_torch.ops.kernels import _build  # noqa: E402
from deeplearning4j_tpu_torch.util import aot_store  # noqa: E402
from deeplearning4j_tpu_torch.util import compile_cache  # noqa: E402
from deeplearning4j_tpu_torch.util import telemetry as tm  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dense_conf(buckets=(2, 4)):
    b = JNNC.builder().seed(4).updater(jupd.Adam(1e-2))
    b.batch_buckets(list(buckets))
    return (b.list()
            .layer(JL.DenseLayer(n_out=6, activation="tanh"))
            .layer(JL.BatchNormalization())
            .layer(JL.OutputLayer(n_out=3))
            .set_input_type((5,)).build())


def _count(name):
    return tm.get_telemetry().snapshot()["counters"].get(name, 0)


# ------------------------------------------------------------ the key
def test_key_misses_on_each_input(tmp_path, monkeypatch):
    store = aot_store.AotStore(str(tmp_path))
    conf = _dense_conf().to_json()
    sig = ((("shape", (4, 5)), "float32"), None)
    base = store.key("mln_forward", conf, sig)
    assert base == store.key("mln_forward", conf, sig)
    keys = {base,
            store.key("mln_train_step", conf, sig),
            store.key("mln_forward", conf.replace("12345", "54321")
                      if "12345" in conf else conf + " ", sig),
            store.key("mln_forward", conf, ((("shape", (8, 5)),
                                             "float32"), None))}
    monkeypatch.setattr(torch, "__version__", "0.0.0")
    keys.add(store.key("mln_forward", conf, sig))
    monkeypatch.undo()
    monkeypatch.setattr(torch.version, "cuda", "0.0")
    keys.add(store.key("mln_forward", conf, sig))
    monkeypatch.undo()
    monkeypatch.setattr(aot_store, "_pkg_digest_cache", "edited")
    keys.add(store.key("mln_forward", conf, sig))
    monkeypatch.undo()
    monkeypatch.setenv("DL4J_TORCH_KERNEL_IMPL", "exact")
    keys.add(store.key("mln_forward", conf, sig))
    assert len(keys) == 8
    # a source edit changes the digest the key is made of
    digest = aot_store.package_digest()
    assert len(digest) == 64 and digest == aot_store.package_digest()


def test_truncated_entry_is_a_miss(tmp_path):
    store = aot_store.AotStore(str(tmp_path))
    conf = _dense_conf().to_json()
    key = store.key("mln_forward", conf, "sig")
    path = store.save(key, {"tag": "mln_forward", "sig": "sig",
                            "args": None, "plans": []})
    hits, misses = _count("aot_store.hits_total"), \
        _count("aot_store.misses_total")
    assert store.load(key)["tag"] == "mln_forward"
    data = open(path).read()
    with open(path, "w") as f:
        f.write(data[:len(data) // 2])
    assert store.load(key) is None
    assert store.find(conf) == []
    assert store.load(store.key("other", conf, "sig")) is None
    assert _count("aot_store.hits_total") == hits + 1
    assert _count("aot_store.misses_total") == misses + 3


def test_concurrent_saves_leave_a_readable_entry(tmp_path):
    store = aot_store.AotStore(str(tmp_path))
    key = store.key("t", "{}", "s")
    entry = {"tag": "t", "sig": "s", "args": None,
             "plans": [["fwd", list(range(200))]] * 50}
    threads = [threading.Thread(target=store.save, args=(key, entry))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert store.load(key) == entry and store.entries() == 1
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_args_encode_and_decode():
    args = ({"a": torch.zeros(2, 3), "b": torch.ones(2, dtype=torch.int64)},
            [torch.zeros(1, dtype=torch.bfloat16), None], None)
    enc = json.loads(json.dumps(aot_store.encode_args(args)))
    back = aot_store.decode_args(enc, torch.device("cpu"))
    assert capture.dispatch_sig(*back) == capture.dispatch_sig(*args)


# ------------------------------------------------------ the warm start
_WARM = r"""
import json, sys
import numpy as np
import torch
from deeplearning4j_tpu_torch.util import ModelSerializer, telemetry as tm
d, arch, x_path, out_path = sys.argv[1:5]
net = ModelSerializer.restore_model(arch, device="cpu")
built = net.warmup(export_dir=d)
x = torch.from_numpy(np.load(x_path))
progs = sorted(net.programs())
y = net.output(x).numpy()
np.save(out_path, y)
c = tm.get_telemetry().snapshot()["counters"]
print(json.dumps({"built": built, "programs": progs,
                  "hits": c.get("aot_store.hits_total", 0),
                  "saves": c.get("aot_store.saves_total", 0),
                  "jax": any(m == "jax" or m.startswith("jax.")
                             for m in sys.modules)}))
"""


def test_warm_start_in_a_second_process(tmp_path):
    from deeplearning4j_tpu_torch.util import ModelSerializer

    net = TMLN(TMConf.from_json(_dense_conf().to_json())).init(device="cpu")
    rng = np.random.default_rng(0)
    net.fit(rng.normal(size=(4, 5)).astype(np.float32),
            np.eye(3, dtype=np.float32)[[0, 1, 2, 0]])
    arch = str(tmp_path / "net.zip")
    ModelSerializer.write_model(net, arch)
    cold = ModelSerializer.restore_model(arch, device="cpu")
    d = str(tmp_path / "aot")
    saves = _count("aot_store.saves_total")
    assert cold.warmup(export_dir=d) == 4  # train + forward, 2 buckets
    assert _count("aot_store.saves_total") == saves + 4
    assert aot_store.AotStore(d).entries() == 4
    x = rng.normal(size=(3, 5)).astype(np.float32)  # pads to bucket 4
    np.save(tmp_path / "x.npy", x)
    want = cold.output(x).numpy()
    proc = subprocess.run(
        [sys.executable, "-c", _WARM, d, arch, str(tmp_path / "x.npy"),
         str(tmp_path / "y.npy")],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["built"] == 4 and got["hits"] == 4 and got["saves"] == 0
    assert got["programs"] == sorted(cold.programs())
    assert not got["jax"]
    np.testing.assert_array_equal(np.load(tmp_path / "y.npy"), want)


# ------------------------------------------------------ compile cache
def test_compile_cache_points_the_kernel_library(tmp_path):
    was = compile_cache.cache_dir()
    d = str(tmp_path / "cc")
    try:
        assert compile_cache.enable_persistent_cache(d) == d
        assert compile_cache.cache_dir() == d
        assert _build.library_path().parent == _build.Path(d)
        assert compile_cache.cache_entries() == 0
        for name in (_build.library_path().name,
                     "libdl4j_torch_kernels_0123456789abcdef.so", "x.log"):
            open(os.path.join(d, name), "w").close()
        assert compile_cache.cache_entries() == 2
        got = {n: v for n, _, v in tm._collect_compile_cache()}
        assert got == {"compile_cache.enabled": 1,
                       "compile_cache.entries": 2}
        compile_cache.clear_persistent_cache()
        assert compile_cache.cache_entries() == 0 and os.path.isdir(d)
        compile_cache.disable_persistent_cache()
        assert compile_cache.cache_dir() is None
        assert _build.library_path().parent == _build.BUILD_DIR
    finally:
        if was is not None:
            compile_cache.enable_persistent_cache(was)


def test_environment_applies_the_compile_cache_once(tmp_path, monkeypatch):
    d = str(tmp_path / "env_cc")
    monkeypatch.setenv("DL4J_TPU_COMPILE_CACHE", d)
    monkeypatch.setattr(port_config.Environment, "_instance", None)
    try:
        env = port_config.get_environment()
        assert env.compile_cache_dir == d and env._compile_cache_applied
        assert compile_cache.cache_dir() == d and os.path.isdir(d)
        assert ref_config.Environment().compile_cache_dir == d
    finally:
        compile_cache.disable_persistent_cache()
        monkeypatch.setattr(port_config.Environment, "_instance", None)


# --------------------------------------------- the builder's defaults
def test_environment_defaults_match_the_reference_builder(monkeypatch):
    for k, v in {"DL4J_TPU_COMPUTE_DTYPE": "bfloat16",
                 "DL4J_TPU_SYNC_EVERY": "3",
                 "DL4J_TPU_FUSED_UPDATE": "1"}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(port_config.Environment, "_instance", None)
    monkeypatch.setattr(ref_config.Environment, "_instance", None)
    try:
        jconf = JNNC.builder().list().layer(
            JL.OutputLayer(n_in=2, n_out=2)).set_input_type((2,)).build()
        tconf = TNNC.builder().list().layer(
            TL.OutputLayer(n_in=2, n_out=2)).set_input_type((2,)).build()
        k = tconf.knobs
        assert tconf.compute_dtype == jconf.compute_dtype == "bfloat16"
        assert k["sync_every"] == jconf.sync_every == 3
        assert k["fused_update"] is jconf.fused_update is True
        assert json.loads(TMConf.from_json(jconf.to_json()).to_json()) == \
            json.loads(jconf.to_json())
        monkeypatch.setenv("DL4J_TPU_SYNC_EVERY", "0")
        with pytest.raises(ValueError, match="DL4J_TPU_SYNC_EVERY"):
            port_config.Environment()
    finally:
        monkeypatch.setattr(port_config.Environment, "_instance", None)
        monkeypatch.setattr(ref_config.Environment, "_instance", None)


# ------------------------------------------------- the captured paths
def _rnn_conf():
    return (JNNC.builder().seed(8).list()
            .layer(JR.LSTM(n_in=5, n_out=8))
            .layer(JR.RnnOutputLayer(n_in=8, n_out=5))
            .set_input_type((None, 5)).build())


def test_captured_paths_equal_eager_and_reference_mln():
    jnet = JMLN(_rnn_conf()).init()
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    nets = []
    for _ in range(2):
        net = TMLN(TMConf.from_json(jnet.conf.to_json())).init(device="cpu")
        interop.load_reference_mln(net, tree(jnet.params), tree(jnet.states))
        nets.append(net)
    cap, eager = nets
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 4, 5)).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (3, 4))]
    with capture.disabled():
        e_score = eager.score(x=x, y=y)
        e_ff = eager.feed_forward(x)
        e_steps = [eager.rnn_time_step(x[:, t]) for t in range(4)]
    c_score = cap.score(x=x, y=y)
    c_ff = cap.feed_forward(x)
    c_steps = [cap.rnn_time_step(x[:, t]) for t in range(4)]
    names = {p.fn_name for p in cap.programs().values()}
    assert names == {"MultiLayerNetwork.loss_eval",
                     "MultiLayerNetwork.feed_forward",
                     "MultiLayerNetwork.rnn_time_step"}
    assert c_score == e_score
    for a, b in zip(c_ff + c_steps, e_ff + e_steps):
        assert torch.equal(a, b)
    # the carries live in the program's static inputs
    prog = next(iter(cap._aot_rnn.values()))
    assert cap._rnn_carries is prog.inputs[0] and prog.replays == 0
    np.testing.assert_allclose(c_score, float(jnet.score(x=x, y=y)),
                               rtol=1e-5)
    for a, b in zip(c_ff, jnet.feed_forward(x)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    for t in range(4):
        np.testing.assert_allclose(c_steps[t].numpy(),
                                   np.asarray(jnet.rnn_time_step(x[:, t])),
                                   rtol=1e-5, atol=1e-6)
    cap.rnn_clear_previous_state()
    assert torch.equal(cap.rnn_time_step(x[:, 0]), c_steps[0])


def test_captured_paths_equal_eager_and_reference_graph():
    jnet, cap = seq_graph._pair(seq_graph._seq_conf())
    _, eager = seq_graph._pair(seq_graph._seq_conf())
    x, y = seq_graph._seq_batch(3)
    with capture.disabled():
        e_score = eager.score(x=x, y=y)
        e_ff = eager.feed_forward(x)
        e_steps = [eager.rnn_time_step(x[:, t]) for t in range(3)]
    c_score = cap.score(x=x, y=y)
    c_ff = cap.feed_forward(x)
    c_steps = [cap.rnn_time_step(x[:, t]) for t in range(3)]
    names = {p.fn_name for p in cap.programs().values()}
    assert names == {"ComputationGraph.loss_eval",
                     "ComputationGraph.feed_forward",
                     "ComputationGraph.rnn_time_step"}
    assert c_score == e_score and c_ff.keys() == e_ff.keys()
    for k in c_ff:
        assert torch.equal(c_ff[k], e_ff[k])
    for a, b in zip(c_steps, e_steps):
        assert torch.equal(a, b)
    np.testing.assert_allclose(c_score, float(jnet.score(x=x, y=y)),
                               rtol=1e-5)
    j_ff = jnet.feed_forward(x)
    for k in ("lstm", "graves", "out"):
        np.testing.assert_allclose(c_ff[k].numpy(), np.asarray(j_ff[k]),
                                   rtol=1e-5, atol=1e-6)
    for t in range(3):
        np.testing.assert_allclose(c_steps[t].numpy(),
                                   np.asarray(jnet.rnn_time_step(x[:, t])),
                                   rtol=1e-5, atol=1e-6)


def test_fleet_worker_spec_carries_export_dir(tmp_path):
    """A fleet spec's ``model_kw`` ``export_dir`` reaches the worker's
    ServingModel (it raised before item 12b), whose warmup saves its
    forward programs' entries there; a clone keeps it."""
    from deeplearning4j_tpu_torch.serving.fleet_worker import build_router
    from deeplearning4j_tpu_torch.util import ModelSerializer

    net = TMLN(TMConf.from_json(_dense_conf().to_json())).init(device="cpu")
    arch = str(tmp_path / "net.zip")
    ModelSerializer.write_model(net, arch)
    d = str(tmp_path / "aot")
    router = build_router({"device": "cpu", "models": [
        {"id": "m", "path": arch, "kind": "classify",
         "model_kw": {"export_dir": d,
                      "bucketing": {"batch_buckets": [2, 4]}}}]})
    try:
        model, _ = router.get("m")
        assert model.export_dir == d
        assert model.warmup() == 2
        assert aot_store.AotStore(d).entries() == 2
        assert model.clone_with_net(model.net).export_dir == d
    finally:
        router.shutdown()
