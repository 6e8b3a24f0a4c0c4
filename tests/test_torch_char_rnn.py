"""The port's char-RNN slice against the JAX package, on the CPU.

``TextGenerationLSTM`` (two LSTMs and an RnnOutputLayer on
MultiLayerNetwork), narrow: 11 characters, 16 units, dropout 0 where the
comparison is with the reference (JAX keys and torch generators never give
the same masks). Each test builds the net in both packages from the same
conf and copies the reference's params, optimizer state and iteration into
the port with ``interop.load_reference_mln``. Tolerances:

- ``output`` and fp32 ``fit`` trajectories (per-step losses, params after
  3-4 Adam steps) within 1e-4 relative (docs/KERNELS.md, the trajectory
  convention), with an absolute floor of 1e-6 for entries near 0;
- one bf16 step: the loss within 2^-7 relative (the largest bf16 rounding
  step of the logits, the two packages rounding at other places), the
  params within 2 * lr + 2^-7 of their scale (Adam moves each entry by up
  to lr in a direction a gradient near 0 may flip).

Also: the conf JSON both ways; TBPTT with a ragged last segment, batch
buckets and masks; ``rnn_time_step``; dropout's statistics.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet  # noqa: E402
from deeplearning4j_tpu.nn.conf import (  # noqa: E402
    MultiLayerConfiguration as JConf)
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JMLN)
from deeplearning4j_tpu.zoo.models import (  # noqa: E402
    TextGenerationLSTM as JTextGen)
from deeplearning4j_tpu_torch import interop  # noqa: E402
from deeplearning4j_tpu_torch.data.dataset import DataSet  # noqa: E402
from deeplearning4j_tpu_torch.nn import MultiLayerNetwork  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration as TConf)
from deeplearning4j_tpu_torch.ops import random as randops  # noqa: E402
from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM  # noqa: E402

VOCAB, UNITS = 11, 16
RTOL, ATOL = 1e-4, 1e-6


def _jconf(dropout=0.0, dtype="float32", tbptt=0, buckets=None):
    conf = JTextGen(total_unique_characters=VOCAB, units=UNITS,
                    dropout=dropout, max_length=10,
                    compute_dtype=dtype).conf()
    conf.tbptt_length = tbptt
    conf.batch_buckets = buckets
    return conf


def _pair(**kw):
    """(reference net, port net) from the same conf, the reference's
    params, optimizer state and iteration copied into the port."""
    jnet = JMLN(_jconf(**kw)).init()
    net = MultiLayerNetwork(TConf.from_json(jnet.conf.to_json())).init(
        device="cpu")
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    interop.load_reference_mln(net, tree(jnet.params), tree(jnet.states),
                               tree(jnet.opt_states), jnet.iteration)
    return jnet, net


def _batch(b, t, seed):
    """One-hot characters and next-character labels, (b, t, VOCAB)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, size=(b, t + 1))
    eye = np.eye(VOCAB, dtype=np.float32)
    return eye[ids[:, :-1]], eye[ids[:, 1:]]


def _masks(b, t, seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(t // 2, t + 1, size=b)
    lens[0] = t
    fmask = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)
    lmask = fmask * (rng.random((b, t)) > 0.2)
    return fmask, lmask.astype(np.float32)


def _assert_params_close(net, jnet, rtol=RTOL, atol=ATOL):
    for i, (mine, ref) in enumerate(zip(net.params, jnet.params)):
        assert set(mine) == set(ref)
        for k in ref:
            np.testing.assert_allclose(mine[k].float().numpy(),
                                       np.asarray(ref[k], np.float32),
                                       rtol=rtol, atol=atol,
                                       err_msg=f"layer {i} {k}")


# -------------------------------------------------------------------- conf


def test_conf_json_both_ways():
    jconf = _jconf(dropout=0.2, tbptt=4, buckets=(2, 4))
    tconf = TConf.from_json(jconf.to_json())
    assert json.loads(tconf.to_json()) == json.loads(jconf.to_json())
    assert tconf.tbptt_length == 4 and tconf.batch_buckets == (2, 4)
    mine = TextGenerationLSTM(total_unique_characters=VOCAB, units=UNITS,
                              max_length=10).conf()
    back = JConf.from_json(mine.to_json())
    assert json.loads(back.to_json()) == json.loads(
        JTextGen(total_unique_characters=VOCAB, units=UNITS,
                 max_length=10).conf().to_json())


def test_builder_tbptt_length_round_trips():
    from deeplearning4j_tpu_torch.nn import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.recurrent import LSTM, RnnOutputLayer

    conf = (NeuralNetConfiguration.builder().tbptt_length(7).list()
            .layer(LSTM(n_in=3, n_out=4))
            .layer(RnnOutputLayer(n_in=4, n_out=3)).build())
    assert conf.tbptt_length == 7
    assert JConf.from_json(conf.to_json()).tbptt_length == 7


# ------------------------------------------------------------------ output


def test_output_matches_reference():
    jnet, net = _pair()
    x, _ = _batch(3, 10, seed=1)
    got = net.output(x)
    assert tuple(got.shape) == (3, 10, VOCAB)
    np.testing.assert_allclose(got.numpy(), np.asarray(jnet.output(x)),
                               rtol=RTOL, atol=ATOL)


def test_output_with_mask_matches_reference():
    jnet, net = _pair()
    x, _ = _batch(3, 10, seed=2)
    fmask, _ = _masks(3, 10, seed=3)
    np.testing.assert_allclose(
        net.output(x, mask=fmask).numpy(),
        np.asarray(jnet.output(x, mask=jnp.asarray(fmask))),
        rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------------- fit


def _fit_both(jnet, net, batches):
    """One fit call per batch in both, a (x, y) pair as arrays and a
    (x, y, feature mask, label mask) tuple as a DataSet; their per-call
    scores side by side."""
    scores = []
    for args in batches:
        if len(args) == 2:
            jnet.fit(*args)
            net.fit(*args)
        else:
            jnet.fit(JDataSet(*args))
            net.fit(DataSet(*args))
        scores.append((net.get_score(), float(jnet.get_score())))
    return scores


def test_fit_adam_steps_match_reference():
    jnet, net = _pair()
    batches = [_batch(3, 10, seed=10 + s) for s in range(4)]
    scores = _fit_both(jnet, net, batches)
    for mine, ref in scores:
        np.testing.assert_allclose(mine, ref, rtol=RTOL)
    assert net.iteration == jnet.iteration == 4
    _assert_params_close(net, jnet)


@pytest.mark.parametrize("buckets", [None, (4, 8)], ids=["plain", "buckets"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "masks"])
def test_fit_tbptt_matches_reference(buckets, masked):
    """tbptt_length 4 over T = 10: segments of 4, 4 and a ragged 2, each an
    update; three rows run as four under the (4, 8) buckets."""
    jnet, net = _pair(tbptt=4, buckets=buckets)
    batches = []
    for s in range(3):
        x, y = _batch(3, 10, seed=20 + s)
        batches.append((x, y) + (_masks(3, 10, seed=30 + s) if masked
                                 else ()))
    scores = _fit_both(jnet, net, batches)
    for mine, ref in scores:
        np.testing.assert_allclose(mine, ref, rtol=RTOL)
    assert net.iteration == jnet.iteration == 9
    _assert_params_close(net, jnet)


def test_tbptt_carries_are_detached():
    """The carry handed to the next segment is a detached tensor, so the
    next segment's gradients depend on its value only: gradients stop at
    segment boundaries, as the reference's do."""
    _, net = _pair(tbptt=4)
    x, y = (torch.from_numpy(a) for a in _batch(2, 8, seed=40))
    w = torch.ones(2)
    _, _, _, c1 = net._gradients(net._init_carries(2, torch.float32),
                                 x[:, :4], y[:, :4], w)
    leaves = [t for c in c1 if c is not None for t in c]
    assert len(leaves) == 4
    assert all(t.grad_fn is None and not t.requires_grad for t in leaves)
    _, g2, _, _ = net._gradients(c1, x[:, 4:], y[:, 4:], w)
    fresh = [None if c is None else tuple(t.clone() for t in c) for c in c1]
    _, g2_fresh, _, _ = net._gradients(fresh, x[:, 4:], y[:, 4:], w)
    for i in g2:
        for k in g2[i]:
            assert torch.equal(g2[i][k], g2_fresh[i][k])


def test_fit_bf16_step_matches_reference():
    jnet, net = _pair(dtype="bfloat16")
    x, y = _batch(3, 10, seed=50)
    (mine, ref), = _fit_both(jnet, net, [(x, y)])
    np.testing.assert_allclose(mine, ref, rtol=2.0 ** -7)
    lr = 1e-3
    for i, (p, r) in enumerate(zip(net.params, jnet.params)):
        for k in r:
            ref_k = np.asarray(r[k], np.float32)
            tol = 2 * lr + 2.0 ** -7 * np.abs(ref_k).max()
            np.testing.assert_allclose(p[k].float().numpy(), ref_k, rtol=0,
                                       atol=tol, err_msg=f"layer {i} {k}")
            assert p[k].dtype == torch.float32  # params stay fp32


def test_bf16_tbptt_carries_stay_bf16():
    _, net = _pair(dtype="bfloat16", tbptt=4)
    carries = net._init_carries(2, torch.bfloat16)
    assert [None if c is None else c[0].dtype for c in carries] == [
        torch.bfloat16, torch.bfloat16, None]
    x, y = _batch(2, 10, seed=51)
    net.fit(x, y)
    assert np.isfinite(net.get_score()) and net.iteration == 3


# ----------------------------------------------------------- rnn_time_step


def test_rnn_time_step_matches_full_forward_and_reference():
    jnet, net = _pair()
    x, _ = _batch(2, 6, seed=60)
    full = net.output(x).numpy()
    steps = [net.rnn_time_step(x[:, t]).numpy() for t in range(3)]
    steps.append(net.rnn_time_step(x[:, 3:]).numpy())  # a 3-step chunk
    got = np.concatenate([np.stack(steps[:3], 1), steps[3]], axis=1)
    np.testing.assert_allclose(got, full, rtol=RTOL, atol=ATOL)
    ref = [np.asarray(jnet.rnn_time_step(jnp.asarray(x[:, t])))
           for t in range(6)]
    np.testing.assert_allclose(got, np.stack(ref, 1), rtol=RTOL, atol=ATOL)


def test_rnn_clear_previous_state_and_batch_change():
    _, net = _pair()
    x, _ = _batch(2, 3, seed=61)
    first = net.rnn_time_step(x[:, 0]).numpy()
    second = net.rnn_time_step(x[:, 0]).numpy()
    assert not np.allclose(first, second)  # the carry moved on
    with pytest.raises(ValueError, match="batch size"):
        net.rnn_time_step(x[:1, 0])
    net.rnn_clear_previous_state()
    np.testing.assert_array_equal(net.rnn_time_step(x[:, 0]).numpy(), first)


# ----------------------------------------------------------------- dropout


def test_dropout_keep_fraction_and_scale():
    rate, n = 0.2, 200_000
    x = torch.full((n,), 3.0)
    y = randops.dropout(x, torch.Generator().manual_seed(0), rate)
    kept = y != 0
    frac = float(kept.float().mean())
    sigma = np.sqrt(rate * (1 - rate) / n)
    assert abs(frac - (1 - rate)) < 4 * sigma
    assert torch.equal(y[kept], torch.full_like(y[kept], 3.0 / (1 - rate)))


def test_dropout_identity_outside_training_and_seeded():
    x = torch.randn((64, 32), generator=torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(7)
    assert randops.dropout(x, gen, 0.5, training=False) is x
    assert randops.dropout(x, gen, 0.0) is x
    a = randops.dropout(x, torch.Generator().manual_seed(7), 0.5)
    b = randops.dropout(x, torch.Generator().manual_seed(7), 0.5)
    c = randops.dropout(x, torch.Generator().manual_seed(8), 0.5)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.dtype == x.dtype
    assert randops.dropout(x.bfloat16(), gen, 0.5).dtype == torch.bfloat16


def test_fit_applies_dropout_from_the_net_generator():
    """Dropout 0.2 changes the training loss and nothing at inference; two
    nets from one seed draw the same masks, so they train alike."""
    x, y = _batch(3, 10, seed=70)
    nets = [TextGenerationLSTM(total_unique_characters=VOCAB, units=UNITS,
                               dropout=d).init(device="cpu")
            for d in (0.2, 0.2, 0.0)]
    np.testing.assert_array_equal(nets[0].output(x).numpy(),
                                  nets[2].output(x).numpy())
    for n in nets:
        n.fit(x, y)
    assert nets[0].get_score() == nets[1].get_score()
    assert nets[0].get_score() != nets[2].get_score()
    for pa, pb in zip(nets[0].params, nets[1].params):
        for k in pa:
            assert torch.equal(pa[k], pb[k])


def test_char_rnn_learns_on_cpu():
    """A few Adam steps with TBPTT and dropout on one repeated batch lower
    the loss."""
    net = TextGenerationLSTM(total_unique_characters=VOCAB, units=UNITS,
                             dropout=0.2).init(device="cpu")
    net.conf.tbptt_length = 5
    x, y = _batch(4, 10, seed=80)
    losses = []
    for _ in range(6):
        net.fit(x, y)
        losses.append(net.get_score())
    assert net.iteration == 12
    assert losses[-1] < losses[0]
