"""Bag-of-words / TF-IDF text vectorizers.

Reference parity: org.deeplearning4j.bagofwords.vectorizer.
{BagOfWordsVectorizer, TfidfVectorizer} (deeplearning4j-nlp, path-cite,
mount empty this round) and datavec-data-nlp's TfidfRecordReader, which
wraps the same weighting. The reference builds a VocabCache over a
LabelAwareIterator and emits one dense row per document;
``vectorize(text, label)`` returns the (features, one-hot label) pair its
DataSet carries.

Weighting (documented choice, matching the reference's TfidfVectorizer):
tf = raw count in the document, idf = log10(N_docs / doc_frequency);
BagOfWords emits raw counts. Vocabulary is filtered by
``min_word_frequency`` (total corpus count) like the reference builder.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizer


class BagOfWordsVectorizer:
    def __init__(self, min_word_frequency: int = 1, tokenizer=None):
        self.min_word_frequency = int(min_word_frequency)
        self.tokenizer = tokenizer or DefaultTokenizer()
        self.vocab: Dict[str, int] = {}
        self.doc_freq: Optional[np.ndarray] = None
        self.n_docs = 0
        self.labels: List[str] = []

    # -- fitting -------------------------------------------------------------
    def fit(self, docs: Sequence[str], labels: Optional[Sequence[str]] = None):
        counts: Dict[str, int] = {}
        per_doc_tokens = []
        for d in docs:
            toks = self.tokenizer.tokenize(d)
            per_doc_tokens.append(toks)
            for t in toks:
                counts[t] = counts.get(t, 0) + 1
        kept = sorted(t for t, c in counts.items()
                      if c >= self.min_word_frequency)
        self.vocab = {t: i for i, t in enumerate(kept)}
        self.n_docs = len(docs)
        df = np.zeros(len(self.vocab), np.int64)
        for toks in per_doc_tokens:
            for t in set(toks):
                i = self.vocab.get(t)
                if i is not None:
                    df[i] += 1
        self.doc_freq = df
        if labels is not None:
            self.labels = sorted(set(labels))
        return self

    # -- weighting (overridden by TfidfVectorizer) ---------------------------
    def _weight(self, tf: np.ndarray) -> np.ndarray:
        return tf.astype(np.float32)

    # -- transform -----------------------------------------------------------
    def transform(self, doc: str) -> np.ndarray:
        if self.doc_freq is None:
            raise RuntimeError("fit() first")
        tf = np.zeros(len(self.vocab), np.float32)
        for t in self.tokenizer.tokenize(doc):
            i = self.vocab.get(t)
            if i is not None:
                tf[i] += 1.0
        return self._weight(tf)

    def fit_transform(self, docs: Sequence[str],
                      labels: Optional[Sequence[str]] = None) -> np.ndarray:
        self.fit(docs, labels)
        return np.stack([self.transform(d) for d in docs])

    def vectorize(self, text: str, label: str):
        """(features, one-hot label) — the reference's DataSet pair."""
        if label not in self.labels:
            raise ValueError(f"unknown label {label!r}; fit() with labels")
        y = np.zeros(len(self.labels), np.float32)
        y[self.labels.index(label)] = 1.0
        return self.transform(text), y

    def index_of(self, word: str) -> int:
        return self.vocab.get(word, -1)


class TfidfVectorizer(BagOfWordsVectorizer):
    """tf * log10(N/df) weighting (reference TfidfVectorizer.tfidfWord)."""

    def _weight(self, tf: np.ndarray) -> np.ndarray:
        idf = np.zeros_like(tf)
        nz = self.doc_freq > 0
        idf[nz] = np.log10(self.n_docs / self.doc_freq[nz])
        return (tf * idf).astype(np.float32)

    def tfidf_word(self, word: str, count_in_doc: int) -> float:
        i = self.vocab.get(word)
        if i is None or self.doc_freq[i] == 0:
            return 0.0
        return count_in_doc * math.log10(self.n_docs / self.doc_freq[i])
