"""The port's tokenizers and BertIterator against the JAX package's
(``deeplearning4j_tpu/nlp``), on the CPU: the same text and seed give the
same vocabulary, tokens and ids, and batches whose arrays are bit-equal
(features, masks, labels, MLM's label mask). The text is the repository's
own (no vocabulary or dataset may be fetched); ``Vocab.load`` reads a small
file the test writes.
"""

from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from deeplearning4j_tpu.nlp import bert_iterator as jbi  # noqa: E402
from deeplearning4j_tpu.nlp import tokenization as jtok  # noqa: E402
from deeplearning4j_tpu_torch.data.dataset import DataSet  # noqa: E402
from deeplearning4j_tpu_torch.nlp import (BertIterator,  # noqa: E402
                                          BertWordPieceTokenizer,
                                          DefaultTokenizer, Vocab)

ROOT = Path(__file__).resolve().parents[1]


def _lines(name="SURVEY.md", n=60):
    text = (ROOT / name).read_text(encoding="utf-8")
    return [ln for ln in text.splitlines() if ln.strip()][:n]


TEXTS = ["Héllo, Wörld! It's  a test.", "BERT-base: 12 layers; 768 hidden.",
         "unaffable unknownpiece", "", "   \t  ", "naïve café (résumé)"]


@pytest.mark.parametrize("lower,strip", [(True, True), (False, False),
                                         (True, False)])
def test_default_tokenizer_matches_reference(lower, strip):
    mine = DefaultTokenizer(lower_case=lower, strip_accents=strip)
    ref = jtok.DefaultTokenizer(lower_case=lower, strip_accents=strip)
    for text in TEXTS + _lines():
        assert mine.tokenize(text) == ref.tokenize(text)


@pytest.mark.parametrize("max_size", [30000, 50])
def test_vocab_build_matches_reference(max_size):
    lines = _lines() + _lines("ROADMAP.md")
    mine, ref = Vocab.build(lines, max_size), jtok.Vocab.build(lines,
                                                               max_size)
    assert mine.tokens == ref.tokens
    assert len(mine) == len(ref) <= max_size
    assert mine.tokens[:5] == ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    assert mine.id("no-such-token") == mine.id("[UNK]") == 1


def test_vocab_load_and_wordpiece_match_reference(tmp_path):
    tokens = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "un", "##aff",
              "##able", "aff", "hello", ",", "!", "test", "##s", "x" * 120]
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(tokens[:5]) + "\n\n" + "\n".join(tokens[5:])
                    + "\n", encoding="utf-8")
    mine, ref = Vocab.load(str(path)), jtok.Vocab.load(str(path))
    assert mine.tokens == ref.tokens == tokens
    tm = BertWordPieceTokenizer(mine)
    tr = jtok.BertWordPieceTokenizer(ref)
    for text in TEXTS + ["unaffable tests, hello!", "x" * 101, "x" * 120]:
        assert tm.tokenize(text) == tr.tokenize(text)
        assert tm.encode(text) == tr.encode(text)
    assert tm.tokenize("unaffable") == ["un", "##aff", "##able"]
    assert tm.tokenize("unknownpiece") == ["[UNK]"]


def _pair_iters(task, seed, **kw):
    lines = _lines()
    jv = jtok.Vocab.build(lines)
    v = Vocab.build(lines)
    labels = [len(s) % 3 for s in lines]
    common = dict(task=task, max_length=24, batch_size=7, seed=seed,
                  sentences=lines, labels=labels, **kw)
    return (BertIterator(BertWordPieceTokenizer(v), **common),
            jbi.BertIterator(jtok.BertWordPieceTokenizer(jv), **common))


def _assert_batches_equal(mine, ref):
    got, want = list(mine), list(ref)
    assert len(got) == len(want) > 1
    assert len(got[-1].features) < len(got[0].features)  # ragged last batch
    for g, w in zip(got, want):
        assert isinstance(g, DataSet)
        for name in ("features", "labels", "features_mask", "labels_mask"):
            a, b = getattr(g, name), getattr(w, name)
            if b is None:
                assert a is None
                continue
            b = np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert np.array_equal(a, b), name
    return got


@pytest.mark.parametrize("seed", [0, 12345])
def test_classification_batches_bit_equal(seed):
    mine, ref = _pair_iters(BertIterator.SEQ_CLASSIFICATION, seed)
    got = _assert_batches_equal(mine, ref)
    ds = got[0]
    assert ds.features.shape == (7, 24, 2) and ds.labels.shape == (7, 3)
    assert ds.labels_mask is None
    assert (ds.features_mask.sum(1) <= 24).all()


@pytest.mark.parametrize("seed", [0, 12345])
def test_masked_lm_batches_bit_equal(seed):
    mine, ref = _pair_iters(BertIterator.UNSUPERVISED, seed)
    got = _assert_batches_equal(mine, ref)
    lm = np.concatenate([ds.labels_mask for ds in got])
    fm = np.concatenate([ds.features_mask for ds in got])
    assert 0.05 < lm.sum() / fm.sum() < 0.25  # about mask_prob of the real
    assert not (lm * (1 - fm)).any()
    # reset restarts the masker; the next pass is the same
    mine.reset()
    ref.reset()
    _assert_batches_equal(mine, ref)


def test_masked_lm_seeds_differ():
    a, _ = _pair_iters(BertIterator.UNSUPERVISED, 0)
    b, _ = _pair_iters(BertIterator.UNSUPERVISED, 1)
    assert not np.array_equal(next(iter(a)).features,
                              next(iter(b)).features)


@pytest.mark.parametrize("max_length", [12, 64])
def test_sentence_pairs_bit_equal(max_length):
    lines = _lines()
    pairs = list(zip(lines[0::2], lines[1::2]))
    v, jv = Vocab.build(lines), jtok.Vocab.build(lines)
    common = dict(max_length=max_length, batch_size=4,
                  sentence_pairs=pairs, labels=[i % 2 for i in
                                                range(len(pairs))])
    got = _assert_batches_equal(
        BertIterator(BertWordPieceTokenizer(v), **common),
        jbi.BertIterator(jtok.BertWordPieceTokenizer(jv), **common))
    segs = got[0].features[..., 1]
    assert segs.max() == 1.0  # the second sentence's segment
    if max_length == 12:
        assert (got[0].features_mask.sum(1) == 12).all()  # truncated


def test_iterator_refuses_what_the_reference_refuses():
    tok = BertWordPieceTokenizer(Vocab.build(["a b"]))
    with pytest.raises(ValueError, match="unknown task"):
        BertIterator(tok, task="nsp", sentences=["a"])
    with pytest.raises(ValueError, match="sentences or sentence_pairs"):
        BertIterator(tok)
    with pytest.raises(ValueError, match="requires labels"):
        BertIterator(tok, sentences=["a"])
