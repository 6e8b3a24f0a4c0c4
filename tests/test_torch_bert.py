"""The port's BERT classify slice against the JAX package, on the CPU.

- ``Bert.tiny(max_length=16)`` built as a MultiLayerNetwork in both
  packages, the reference's params copied across with
  ``interop.load_reference_mln``: ``output`` within 1e-4 relative (ROADMAP
  rule), with ``flash`` True, False and "auto", with and without a ragged
  padding mask (one row padded to a single real token);
- the conf JSON moves between the packages both ways, and both packages
  write the same conf for the same model (tiny, and base at full width with
  bf16 compute and the forced-kernel mode);
- ``Bert.base`` has the reference's 109,483,778 params;
- the port's ModelServer serves the port's MLN over HTTP with
  ``net.output``'s probabilities;
- bf16 compute rounds float token ids in both packages alike (id 30000
  arrives as 29952), a reference behaviour recorded in ROADMAP.md Queue 3;
- ``score`` (the inference loss, masked and not) against the reference's;
- ``fit`` trains ``Bert.tiny`` (its trajectory against the reference's is
  ``tests/test_torch_bert_train.py``).

None of this imports ``deeplearning4j_tpu.autodiff``.
"""

import json
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.nn.conf import (  # noqa: E402
    MultiLayerConfiguration as JConf)
from deeplearning4j_tpu.zoo.bert import Bert as JBert  # noqa: E402
from deeplearning4j_tpu_torch import interop  # noqa: E402
from deeplearning4j_tpu_torch.data.bucketing import (  # noqa: E402
    BucketingPolicy)
from deeplearning4j_tpu_torch.nn import MultiLayerNetwork  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration as TConf)
from deeplearning4j_tpu_torch.serving import (ModelRouter,  # noqa: E402
                                              ModelServer, ServingModel)
from deeplearning4j_tpu_torch.zoo import Bert as TBert  # noqa: E402

T = 16
VOCAB = 30522


def _ids(rows, seed):
    """(rows, T, 2) float [token ids, segment ids], as a client sends them."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, VOCAB, size=(rows, T))
    segments = (np.arange(T)[None, :] >= rng.integers(1, T, size=(rows, 1)))
    return np.stack([tokens, segments], axis=-1).astype(np.float32)


def _ragged_mask(rows):
    mask = np.ones((rows, T), np.float32)
    mask[1, 9:] = 0.0
    mask[2, 1:] = 0.0  # one real token
    return mask


@pytest.fixture(scope="module", params=[True, False, "auto"],
                ids=["flash", "exact", "auto"])
def pair(request):
    """(reference net, port net with its params) for one ``flash`` mode."""
    jnet = JBert.tiny(max_length=T, flash=request.param).init()
    params = jax.tree_util.tree_map(np.asarray, jnet.params)
    states = jax.tree_util.tree_map(np.asarray, jnet.states)
    net = interop.from_reference_json(jnet.conf.to_json(), params, states,
                                      device="cpu")
    return jnet, net


@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
def test_bert_tiny_output_matches_reference(pair, masked):
    jnet, net = pair
    x = _ids(4, seed=1)
    mask = _ragged_mask(4) if masked else None
    ref = np.asarray(jnet.output(jnp.asarray(x), mask=mask))
    out = net.output(x, mask=mask)
    assert isinstance(net, MultiLayerNetwork)
    assert out.dtype == torch.float32 and tuple(out.shape) == (4, 2)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-7)


def test_bert_tiny_encoder_states_match_reference(pair):
    """Every layer's activation (feed_forward), not only the softmax."""
    jnet, net = pair
    x = _ids(2, seed=2)
    refs = jnet.feed_forward(jnp.asarray(x))
    outs = net.feed_forward(x)
    assert len(outs) == len(refs) == len(net.layers) + 1
    for ref, out in zip(refs[1:], outs[1:]):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-5)


def test_integer_ids_equal_float_ids(pair):
    _, net = pair
    x = _ids(2, seed=3)
    assert torch.equal(net.output(x), net.output(x.astype(np.int64)))


def test_interop_hands_params_back(pair):
    jnet, net = pair
    back = interop.to_numpy(net)
    assert set(back) == {"params", "states"}
    for mine, ref in zip(back["params"], jnet.params):
        assert set(mine) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(mine[k], np.asarray(ref[k]))


# ----------------------------------------------------------------- conf JSON

_CONFS = {
    "tiny": dict(max_length=T),
    "base-512-bf16-pallas": dict(max_length=512, flash=True,
                                 compute_dtype="bfloat16"),
}


@pytest.mark.parametrize("name", list(_CONFS))
def test_conf_json_jax_to_port_and_back(name):
    maker = JBert.tiny if name == "tiny" else JBert.base
    src = maker(**_CONFS[name]).conf().to_json()
    if name != "tiny":
        d = json.loads(src)
        d["kernel_impl"] = "pallas"
        src = json.dumps(d)
    conf = TConf.from_json(src)
    if name != "tiny":
        assert conf.kernel_impl == "cuda"
    assert json.loads(conf.to_json()) == json.loads(src)


@pytest.mark.parametrize("name", list(_CONFS))
def test_conf_json_port_to_jax_and_back(name):
    tmaker = TBert.tiny if name == "tiny" else TBert.base
    jmaker = JBert.tiny if name == "tiny" else JBert.base
    src = tmaker(**_CONFS[name]).conf().to_json()
    assert json.loads(JConf.from_json(src).to_json()) == json.loads(src)
    assert json.loads(src) == json.loads(jmaker(**_CONFS[name]).conf()
                                         .to_json())


def test_bert_base_full_width_param_count():
    conf = TBert.base(max_length=512).conf()
    assert conf.input_shape == (512, 2)
    assert len(conf.layers) == 1 + 12 + 3
    net = MultiLayerNetwork(conf).init(device="cpu")
    # the reference's count, from its layers' own shapes (no params made)
    jconf = JBert.base(max_length=512).conf()
    shape, ref = tuple(jconf.input_shape), 0
    for lyr in jconf.layers:
        tree, _ = jax.eval_shape(lyr.initialize, jax.random.PRNGKey(0), shape)
        ref += sum(int(np.prod(a.shape))
                   for a in jax.tree_util.tree_leaves(tree))
        shape = lyr.output_shape(shape)
    assert net.num_params() == ref == 109_483_778


# ------------------------------------------------------------------ serving


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_model_server_serves_the_mln():
    net = TBert.tiny(max_length=T, flash=True).init(device="cpu")
    model = ServingModel(net, "bert", bucketing=BucketingPolicy(
        batch_buckets=(1, 2, 4)))
    router = ModelRouter()
    router.register(model, max_wait_ms=1.0)
    server = ModelServer(router, port=0).start()  # warms (b, 16, 2) buckets
    try:
        for rows, seed in ((1, 4), (3, 5), (6, 6)):
            x = _ids(rows, seed)
            body = _post(f"{server.url}/v1/models/bert/infer",
                         {"inputs": x.tolist()})
            got = np.asarray(body["outputs"], np.float32)
            assert got.shape == (rows, 2)
            np.testing.assert_allclose(got, net.output(x).numpy(), rtol=1e-6,
                                       atol=1e-7)
        assert model.warmed and model.chunks_executed == 4  # 6 = 4 + 2
    finally:
        server.stop()


def test_serving_warmup_needs_a_fixed_length():
    net = TBert.tiny(max_length=T).init(device="cpu")
    net.conf.input_shape = (None, 2)
    with pytest.raises(ValueError, match="fixed"):
        ServingModel(net, "bert").warmup()


def test_mln_batch_buckets_pad_and_slice():
    net = TBert.tiny(max_length=T).init(device="cpu")
    x = _ids(3, seed=7)
    plain = net.output(x)
    net.conf.batch_buckets = (4,)
    net._bucketing = BucketingPolicy(batch_buckets=(4,))
    out = net.output(x)  # runs at 4 rows, returns 3
    assert tuple(out.shape) == (3, 2)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), rtol=1e-6,
                               atol=1e-7)


# --------------------------------------------------------------------- bf16


def test_bf16_rounds_float_token_ids_in_both_packages():
    """compute_dtype bfloat16 casts the float (B, T, 2) input to bf16 before
    the embedding truncates it to ints, in the reference
    (``multilayer.py:195-198``, ``transformer.py:66-68``) and in the port
    alike: token id 30000 embeds as id 29952."""
    jnet = JBert.tiny(max_length=T, compute_dtype="bfloat16").init()
    params = jax.tree_util.tree_map(np.asarray, jnet.params)
    states = jax.tree_util.tree_map(np.asarray, jnet.states)
    net = interop.from_reference_json(jnet.conf.to_json(), params, states,
                                      device="cpu")
    x = np.zeros((1, T, 2), np.float32)
    x[0, :, 0] = 30000.0
    ref = np.asarray(jnet.feed_forward(jnp.asarray(x))[1].astype(jnp.float32))
    got = net.feed_forward(x)[1].float().numpy()
    rounded = x.copy()
    rounded[0, :, 0] = 29952.0
    exact = x.astype(np.int64)
    want = net.feed_forward(rounded.astype(np.int64))[1].float().numpy()
    assert np.array_equal(got, want)
    assert not np.array_equal(got, net.feed_forward(exact)[1].float()
                              .numpy())
    np.testing.assert_allclose(got, ref, rtol=0, atol=2.0 ** -6)


# ------------------------------------------------------------- not ported


@pytest.mark.parametrize("method", ["fit", "score", "rnn_time_step"])
def test_unported_mln_methods_name_the_roadmap(method):
    """Each of these methods is ported now. ``fit`` trains a net with
    encoder blocks (the flash path through the FlashAttention Function):
    ``Bert.tiny`` with the flash path forced, on one batch repeated, its
    loss falls over eight Adam steps. ``score`` is ported (the LeNet slice):
    ``Bert.tiny``'s inference loss, with a ragged padding mask, matches the
    reference's within 1e-4 relative. ``rnn_time_step`` is ported: on a
    stack without recurrent layers it is the plain forward."""
    if method == "score":
        jnet = JBert.tiny(max_length=T).init()
        tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
        net = interop.from_reference_json(jnet.conf.to_json(),
                                          tree(jnet.params),
                                          tree(jnet.states), device="cpu")
        x, mask = _ids(4, seed=9), _ragged_mask(4)
        y = np.eye(2, dtype=np.float32)[[0, 1, 1, 0]]
        from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
        from deeplearning4j_tpu_torch.data import DataSet
        want = float(jnet.score(JDataSet(x, y, features_mask=mask)))
        got = net.score(DataSet(x, y, features_mask=mask))
        np.testing.assert_allclose(got, want, rtol=1e-4)
        np.testing.assert_allclose(net.score(x=x, y=y),
                                   float(jnet.score(x=x, y=y)), rtol=1e-4)
        assert got != net.score(x=x, y=y)
        return
    if method == "rnn_time_step":
        net = TBert.tiny(max_length=T).init(device="cpu")
        x = _ids(1, seed=8)
        np.testing.assert_allclose(net.rnn_time_step(x).numpy(),
                                   net.output(x).numpy(), rtol=1e-6,
                                   atol=1e-7)
        return
    net = TBert.tiny(max_length=T, flash=True,
                     hidden_dropout=0.0).init(device="cpu")
    x, y = _ids(4, seed=8), np.eye(2, dtype=np.float32)[[1, 0, 0, 1]]
    losses = []
    for _ in range(8):
        net.fit(x, y)
        losses.append(net.get_score())
    assert net.iteration == 8 and np.isfinite(losses).all()
    assert losses[-1] < 0.5 * losses[0], losses


def test_mlm_task_output_matches_reference():
    """With RnnOutputLayer ported, ``Bert.tiny(task="mlm")`` builds in both
    packages from the same conf; its per-token vocabulary softmax matches
    the reference's within 1e-4 relative, with a ragged padding mask."""
    jnet = JBert.tiny(max_length=T, task="mlm").init()
    assert json.loads(TBert.tiny(max_length=T, task="mlm").conf().to_json()) \
        == json.loads(jnet.conf.to_json())
    params = jax.tree_util.tree_map(np.asarray, jnet.params)
    states = jax.tree_util.tree_map(np.asarray, jnet.states)
    net = interop.from_reference_json(jnet.conf.to_json(), params, states,
                                      device="cpu")
    x, mask = _ids(3, seed=12), _ragged_mask(3)
    got = net.output(x, mask=mask).numpy()
    assert got.shape == (3, T, VOCAB)
    ref = np.asarray(jnet.output(jnp.asarray(x), mask=jnp.asarray(mask)))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-9)


def test_entry_point_needs_a_card_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TBert.tiny(max_length=T).init()
