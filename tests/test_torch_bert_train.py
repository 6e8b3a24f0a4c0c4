"""BERT training on MultiLayerNetwork against the JAX package, on the CPU.

``Bert.tiny`` (2 layers, hidden 128, 2 heads) at S 16, batch 4, built in
both packages from the same conf with the reference's params, optimizer
state and iteration copied into the port (``interop.load_reference_mln``),
``hidden_dropout`` 0 (JAX keys and torch generators never give the same
masks). Four ``fit`` steps of BertIterator batches over the repository's
own text, each with a ragged padding mask: the per-step losses and the
params after them within 1e-4 relative (docs/KERNELS.md's trajectory
convention), with an absolute floor of 1e-6 for entries near 0, under
Adam(1e-3) at epsilon 1e-3 (at 1e-8 Adam follows the rounding noise of
near-zero gradients, such as Wk's component that the softmax cancels, in
both packages: ROADMAP.md Queue 3). Cases:
``flash`` True (the FlashAttention Function: the plain forward and the
ported ``_flash_bwd`` here) and False (exact attention), classification,
``task="mlm"`` on UNSUPERVISED batches with their ``labels_mask``,
``causal=True`` (the GPT-style blocks), and a ragged 3-row batch under
batch buckets (4, 8), whose padded row takes no gradient.

The encoder's dropout repair: ``hidden_dropout`` applies in training only,
to the attention and the FFN outputs, drawing from the net's generator:
inference and training at rate 0 equal the reference's block, and at 0.1
each of the two sublayer outputs loses close to a tenth of its entries.
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet  # noqa: E402
from deeplearning4j_tpu.nn.transformer import (  # noqa: E402
    TransformerEncoderBlock as JBlock)
from deeplearning4j_tpu.nn.updaters import Adam as JAdam  # noqa: E402
from deeplearning4j_tpu.zoo.bert import Bert as JBert  # noqa: E402
from deeplearning4j_tpu_torch import interop  # noqa: E402
from deeplearning4j_tpu_torch.nlp import (BertIterator,  # noqa: E402
                                          BertWordPieceTokenizer, Vocab)
from deeplearning4j_tpu_torch.nn import MultiLayerNetwork  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration as TConf)
from deeplearning4j_tpu_torch.nn.transformer import (  # noqa: E402
    TransformerEncoderBlock)
from deeplearning4j_tpu_torch.ops import random as randops  # noqa: E402
from deeplearning4j_tpu_torch.zoo import Bert  # noqa: E402

T, BATCH, STEPS = 16, 4, 4
RTOL, ATOL = 1e-4, 1e-6
ROOT = Path(__file__).resolve().parents[1]


def _corpus(n=BATCH * STEPS + 1):
    """Lines of SURVEY.md cut to their first 2, 5, 8 or 11 words in turn,
    so every batch has rows that pad (the mask is ragged)."""
    lines = [ln.strip() for ln in (ROOT / "SURVEY.md").read_text(
        encoding="utf-8").splitlines() if len(ln.split()) > 3]
    return [" ".join(ln.split()[:2 + 3 * (i % 4)])
            for i, ln in enumerate(lines[:n])]


def _batches(task, n_rows=BATCH):
    lines = _corpus()
    vocab = Vocab.build(lines)
    it = BertIterator(BertWordPieceTokenizer(vocab), task=task,
                      max_length=T, batch_size=n_rows, sentences=lines,
                      labels=[len(s) % 2 for s in lines], n_classes=2,
                      seed=7)
    return vocab, list(it)[:STEPS]


def _pair(**kw):
    jnet = JBert.tiny(max_length=T, hidden_dropout=0.0,
                      updater=JAdam(1e-3, epsilon=1e-3), **kw).init()
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    net = MultiLayerNetwork(TConf.from_json(jnet.conf.to_json())).init(
        device="cpu")
    interop.load_reference_mln(net, tree(jnet.params), tree(jnet.states),
                               tree(jnet.opt_states), jnet.iteration)
    return jnet, net


def _fit_both(jnet, net, batches):
    scores = []
    for ds in batches:
        jnet.fit(JDataSet(ds.features, ds.labels, ds.features_mask,
                          ds.labels_mask))
        net.fit(ds)
        scores.append((net.get_score(), float(jnet.get_score())))
    return scores


def _assert_close(net, jnet, scores):
    for mine, ref in scores:
        np.testing.assert_allclose(mine, ref, rtol=RTOL)
    assert net.iteration == jnet.iteration == len(scores)
    for i, (mine, ref) in enumerate(zip(net.params, jnet.params)):
        assert set(mine) == set(ref)
        for k in ref:
            np.testing.assert_allclose(mine[k].numpy(),
                                       np.asarray(ref[k], np.float32),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"layer {i} {k}")


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "exact"])
@pytest.mark.parametrize("task,causal", [
    ("classification", False), ("mlm", False), ("classification", True)],
    ids=["classification", "mlm", "causal"])
def test_fit_trajectory_matches_reference(task, causal, flash):
    it_task = (BertIterator.SEQ_CLASSIFICATION if task == "classification"
               else BertIterator.UNSUPERVISED)
    vocab, batches = _batches(it_task)
    assert all(ds.features_mask.min() == 0.0 for ds in batches)
    kw = {"task": task, "causal": causal, "flash": flash}
    if task == "mlm":
        kw["vocab_size"] = len(vocab)
        assert all(ds.labels_mask.sum() > 0 for ds in batches)
    jnet, net = _pair(**kw)
    _assert_close(net, jnet, _fit_both(jnet, net, batches))


def _ref_grads(jnet, x, y, w, m):
    """The reference's gradients of its loss on one batch (dropout off:
    the keys are drawn but unused)."""
    keys = list(jax.random.split(jax.random.PRNGKey(0), len(jnet.params)))

    def loss(p):
        return jnet._loss(p, jnet.states, jnp.asarray(x), jnp.asarray(y),
                          keys, jnp.asarray(w), jnp.asarray(m))[0]

    return jax.tree_util.tree_map(np.asarray, jax.grad(loss)(jnet.params))


def test_ragged_batch_under_buckets_matches_reference():
    """Three rows pad to the bucket of 4 in both packages; the padded row
    is fully masked and weighted 0, so it adds no gradient: the port's
    gradients of the padded batch equal those of the three rows alone,
    within rtol 1e-5 / atol 1e-7, or no farther from them (each tensor's
    largest difference) than 3x the reference's own padded gradients are
    from its three-row gradients. Padding changes the fp32 summation
    order in both packages: the reference's own padded gradients miss
    the elementwise gate too (by 1.2e-6 on the embedding tables, CPU), and
    which elements the port's miss it by depends on the machine's
    kernels."""
    _, batches = _batches(BertIterator.SEQ_CLASSIFICATION, n_rows=3)
    jnet, net = _pair(flash=True)
    jnet.conf.batch_buckets = (4, 8)
    net.conf.batch_buckets = (4, 8)
    jnet.__init__(jnet.conf)
    jnet.init()
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    net = MultiLayerNetwork(net.conf).init(device="cpu")
    interop.load_reference_mln(net, tree(jnet.params), tree(jnet.states),
                               tree(jnet.opt_states), jnet.iteration)
    ds = batches[0]
    x, y, m = (torch.from_numpy(a) for a in (ds.features, ds.labels,
                                             ds.features_mask))
    pad = net._bucketing.pad_batch(x, y, m, None)
    w = torch.tensor([1.0, 1.0, 1.0, 0.0])
    _, g_pad, _, _ = net._gradients(None, pad[0], pad[1], w, pad[2])
    _, g_3, _, _ = net._gradients(None, x, y, torch.ones(3), m)
    j_pad = _ref_grads(jnet, *(t.numpy() for t in pad[:2]), w.numpy(),
                       pad[2].numpy())
    j_3 = _ref_grads(jnet, ds.features, ds.labels, np.ones(3, np.float32),
                     ds.features_mask)
    for i in g_3:
        for k in g_3[i]:
            a, b = g_pad[i][k].numpy(), g_3[i][k].numpy()
            if np.allclose(a, b, rtol=1e-5, atol=1e-7):
                continue
            own = float(np.abs(j_pad[i][k] - j_3[i][k]).max())
            assert float(np.abs(a - b).max()) <= 3 * own, (i, k, own)
    _assert_close(net, jnet, _fit_both(jnet, net, batches[:3]))


# ------------------------------------------------------------ dropout


def _block_pair(rate, pre_norm=False):
    jblock = JBlock(hidden_size=32, n_heads=2, hidden_dropout=rate,
                    pre_norm=pre_norm, flash=False)
    params, _ = jblock.initialize(jax.random.PRNGKey(3), (T, 32))
    block = TransformerEncoderBlock(hidden_size=32, n_heads=2,
                                    hidden_dropout=rate, pre_norm=pre_norm,
                                    flash=False)
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    x = np.random.default_rng(4).normal(size=(3, T, 32)).astype(np.float32)
    return jblock, params, block, tparams, x


@pytest.mark.parametrize("pre_norm", [False, True], ids=["post-ln", "pre-ln"])
def test_encoder_dropout_applies_in_training_only(pre_norm, monkeypatch):
    jblock, params, block, tparams, x = _block_pair(0.1, pre_norm)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    gen = torch.Generator().manual_seed(5)
    ref_inf = np.asarray(jblock.apply(params, {}, jx)[0])
    got_inf = block.apply(tparams, {}, tx, training=False, gen=gen)[0]
    np.testing.assert_allclose(got_inf.numpy(), ref_inf, rtol=1e-5,
                               atol=1e-5)
    # rate 0 in training: the reference's training output, no draw taken
    j0, p0, b0, t0, _ = _block_pair(0.0, pre_norm)
    ref_train0 = np.asarray(j0.apply(p0, {}, jx, training=True,
                                     key=jax.random.PRNGKey(0))[0])
    state = gen.get_state()
    got_train0 = b0.apply(t0, {}, tx, training=True, gen=gen)[0]
    assert torch.equal(gen.get_state(), state)
    np.testing.assert_allclose(got_train0.numpy(), ref_train0, rtol=1e-5,
                               atol=1e-5)
    # rate 0.1: two draws from the generator, about a tenth zeroed each
    seen = []
    inner = randops.dropout

    def recording(h, g, rate, training=True):
        out = inner(h, g, rate, training)
        seen.append(float(((out == 0) & (h != 0)).float().mean()))
        return out

    monkeypatch.setattr(randops, "dropout", recording)
    got = block.apply(tparams, {}, tx, training=True, gen=gen)[0]
    assert len(seen) == 2
    for share in seen:
        assert abs(share - 0.1) < 0.02, seen
    assert not torch.allclose(got, got_inf)
    assert not torch.equal(gen.get_state(), state)


def test_fit_draws_encoder_dropout_from_the_net_generator():
    """The same net and batch trained twice from one seed gives the same
    loss; with hidden_dropout 0.1 the loss differs from rate 0's."""
    _, batches = _batches(BertIterator.SEQ_CLASSIFICATION)

    def first_loss(rate):
        net = Bert.tiny(max_length=T, hidden_dropout=rate).init(device="cpu")
        net.fit(batches[0])
        return net.get_score()

    assert first_loss(0.1) == first_loss(0.1)
    assert first_loss(0.1) != first_loss(0.0)


def test_conf_json_with_dropout_moves_between_packages():
    jconf = JBert.tiny(max_length=T, hidden_dropout=0.1, causal=True).conf()
    mine = Bert.tiny(max_length=T, hidden_dropout=0.1, causal=True).conf()
    assert json.loads(mine.to_json()) == json.loads(jconf.to_json())
    assert TConf.from_json(jconf.to_json()).to_json() == mine.to_json()
