"""BertIterator: text -> BERT training batches (counterpart of
deeplearning4j_tpu/nlp/bert_iterator.py; DL4J's BertIterator).

Tasks SEQ_CLASSIFICATION (labelled sentences or sentence pairs, for the
[CLS] readout) and UNSUPERVISED (masked LM, BertMaskedLMMasker's 80/10/10
rule), with FIXED_LENGTH truncation and padding. Batches are the port's
:class:`DataSet` of numpy arrays, bit-equal to the reference's for the same
text and seed: features (B, T, 2) float32 [token ids, segment ids],
``features_mask`` (B, T); labels one-hot (B, C) for classification, and
(B, T, V) with ``labels_mask`` (the masked positions) for masked LM.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.nlp.tokenization import BertWordPieceTokenizer


class BertIterator:
    """Reference ``:25``. The masker draws from
    ``np.random.default_rng(seed)``, restarted by :meth:`reset`."""

    SEQ_CLASSIFICATION = "seq_classification"
    UNSUPERVISED = "unsupervised"

    def __init__(self, tokenizer: BertWordPieceTokenizer, *,
                 task: str = SEQ_CLASSIFICATION, max_length: int = 128,
                 batch_size: int = 32,
                 sentences: Optional[Sequence[str]] = None,
                 labels: Optional[Sequence[int]] = None,
                 sentence_pairs: Optional[Sequence[Tuple[str, str]]] = None,
                 n_classes: Optional[int] = None, mask_prob: float = 0.15,
                 seed: int = 0):
        if task not in (self.SEQ_CLASSIFICATION, self.UNSUPERVISED):
            raise ValueError(f"unknown task {task!r}")
        if sentences is None and sentence_pairs is None:
            raise ValueError("provide sentences or sentence_pairs")
        if task == self.SEQ_CLASSIFICATION and labels is None:
            raise ValueError("SEQ_CLASSIFICATION requires labels")
        self.tokenizer = tokenizer
        self.vocab = tokenizer.vocab
        self.task = task
        self.max_length = max_length
        self.batch_size = batch_size
        self.sentences = sentences
        self.labels = labels
        self.sentence_pairs = sentence_pairs
        if n_classes is None and labels is not None and len(labels):
            n_classes = int(max(labels)) + 1
        self.n_classes = n_classes
        self.mask_prob = mask_prob
        self._seed = seed
        self._rng = np.random.default_rng(seed)

    def reset(self):
        """Restart the masker's random stream (reference ``:62``)."""
        self._rng = np.random.default_rng(self._seed)

    def _encode_one(self, i: int) -> Tuple[np.ndarray, np.ndarray, int]:
        """(ids (T,), segments (T,), true length) of example ``i``
        (reference ``:66``): ``[CLS] a [SEP]``, or ``[CLS] a [SEP] b [SEP]``
        with the longer side truncated first, padded with ``[PAD]``."""
        v = self.vocab
        t_max = self.max_length
        if self.sentence_pairs is not None:
            a, b = self.sentence_pairs[i]
            ta = self.tokenizer.encode(a)
            tb = self.tokenizer.encode(b)
            budget = t_max - 3
            while len(ta) + len(tb) > budget:
                (ta if len(ta) >= len(tb) else tb).pop()
            ids = [v.id(v.CLS)] + ta + [v.id(v.SEP)] + tb + [v.id(v.SEP)]
            segs = [0] * (len(ta) + 2) + [1] * (len(tb) + 1)
        else:
            t = self.tokenizer.encode(self.sentences[i])[:t_max - 2]
            ids = [v.id(v.CLS)] + t + [v.id(v.SEP)]
            segs = [0] * len(ids)
        n = len(ids)
        out = np.full((t_max,), v.id(v.PAD), np.int32)
        out[:n] = ids
        so = np.zeros((t_max,), np.int32)
        so[:n] = segs
        return out, so, n

    def _mask_tokens(self, ids: np.ndarray, n: int):
        """BertMaskedLMMasker (reference ``:91``): each position of the
        first ``n`` that is not [CLS], [SEP] or [PAD] is chosen with
        ``mask_prob``; a chosen one becomes [MASK] (80%), a random id
        (10%) or stays (10%). Returns (masked ids, labels, label mask)."""
        v = self.vocab
        labels = ids.copy()
        lmask = np.zeros_like(ids, np.float32)
        special = {v.id(v.CLS), v.id(v.SEP), v.id(v.PAD)}
        masked = ids.copy()
        for t in range(n):
            if ids[t] in special or self._rng.random() >= self.mask_prob:
                continue
            lmask[t] = 1.0
            r = self._rng.random()
            if r < 0.8:
                masked[t] = v.id(v.MASK)
            elif r < 0.9:
                masked[t] = self._rng.integers(0, len(v))
        return masked, labels, lmask

    def _emit(self, idxs: List[int]) -> DataSet:
        """One batch of the examples ``idxs`` (reference ``:110``)."""
        b, t = len(idxs), self.max_length
        feats = np.zeros((b, t, 2), np.float32)
        fmask = np.zeros((b, t), np.float32)
        if self.task == self.SEQ_CLASSIFICATION:
            y = np.zeros((b, self.n_classes), np.float32)
            for j, i in enumerate(idxs):
                ids, segs, n = self._encode_one(i)
                feats[j, :, 0], feats[j, :, 1] = ids, segs
                fmask[j, :n] = 1.0
                y[j, int(self.labels[i])] = 1.0
            return DataSet(feats, y, features_mask=fmask)
        y = np.zeros((b, t, len(self.vocab)), np.float32)
        lmask = np.zeros((b, t), np.float32)
        for j, i in enumerate(idxs):
            ids, segs, n = self._encode_one(i)
            masked, labels, lm = self._mask_tokens(ids, n)
            feats[j, :, 0], feats[j, :, 1] = masked, segs
            fmask[j, :n] = 1.0
            y[j, np.arange(t), labels] = 1.0
            lmask[j] = lm
        return DataSet(feats, y, features_mask=fmask, labels_mask=lmask)

    def __iter__(self):
        """Batches of ``batch_size`` in order, the last one ragged
        (reference ``:134``)."""
        n = len(self.sentence_pairs if self.sentence_pairs is not None
                else self.sentences)
        for s in range(0, n, self.batch_size):
            yield self._emit(list(range(s, min(s + self.batch_size, n))))
