"""Tokenizers: the default whitespace/punctuation tokenizer and BERT's
WordPiece (counterpart of deeplearning4j_tpu/nlp/tokenization.py; DL4J's
DefaultTokenizer and BertWordPieceTokenizer).

Pure Python on the host, the port's own copy of the reference's: the same
text and vocabulary give the same tokens and ids.
"""

from __future__ import annotations

import string
import unicodedata
from typing import Dict, Iterable, List, Optional


class Vocab:
    """Token <-> id table (reference ``:18``). File format: one token per
    line, id = line number (BERT's ``vocab.txt``)."""

    PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"

    def __init__(self, tokens: Iterable[str]):
        self.tokens: List[str] = list(tokens)
        self.index: Dict[str, int] = {t: i for i, t in enumerate(self.tokens)}

    @classmethod
    def load(cls, path: str) -> "Vocab":
        """A ``vocab.txt``: one token a line, empty lines skipped."""
        with open(path, encoding="utf-8") as f:
            return cls([ln.rstrip("\n") for ln in f if ln.rstrip("\n")])

    @classmethod
    def build(cls, corpus: Iterable[str], max_size: int = 30000) -> "Vocab":
        """A word-level vocabulary of a corpus: the five special tokens,
        then the words of :class:`DefaultTokenizer` by falling count, ties
        in alphabetical order, up to ``max_size`` in all."""
        counts: Dict[str, int] = {}
        tok = DefaultTokenizer()
        for line in corpus:
            for w in tok.tokenize(line.lower()):
                counts[w] = counts.get(w, 0) + 1
        special = [cls.PAD, cls.UNK, cls.CLS, cls.SEP, cls.MASK]
        words = sorted(counts, key=lambda w: (-counts[w], w))
        return cls(special + words[:max_size - len(special)])

    def __len__(self):
        return len(self.tokens)

    def __contains__(self, t):
        return t in self.index

    def id(self, token: str) -> int:
        return self.index.get(token, self.index.get(self.UNK, 0))

    def token(self, i: int) -> str:
        return self.tokens[i]


class DefaultTokenizer:
    """Whitespace and punctuation splitting, optionally lower-cased and
    accent-stripped (reference ``:61``; BERT's BasicTokenizer)."""

    def __init__(self, lower_case: bool = True, strip_accents: bool = True):
        self.lower_case = lower_case
        self.strip_accents = strip_accents

    def tokenize(self, text: str) -> List[str]:
        if self.lower_case:
            text = text.lower()
        if self.strip_accents:
            text = "".join(c for c in unicodedata.normalize("NFD", text)
                           if unicodedata.category(c) != "Mn")
        out: List[str] = []
        cur = ""
        for ch in text:
            if ch.isspace() or ch in string.punctuation:
                if cur:
                    out.append(cur)
                    cur = ""
                if not ch.isspace():
                    out.append(ch)
            else:
                cur += ch
        if cur:
            out.append(cur)
        return out


class BertWordPieceTokenizer:
    """Greedy longest-match-first WordPiece over the basic tokens (reference
    ``:96``): a word with no cover becomes ``[UNK]``, continuation pieces
    take the ``##`` prefix."""

    def __init__(self, vocab: Vocab, lower_case: bool = True,
                 max_chars_per_word: int = 100):
        self.vocab = vocab
        self.basic = DefaultTokenizer(lower_case=lower_case)
        self.max_chars_per_word = max_chars_per_word

    def tokenize(self, text: str) -> List[str]:
        pieces: List[str] = []
        for word in self.basic.tokenize(text):
            pieces.extend(self._wordpiece(word))
        return pieces

    def encode(self, text: str) -> List[int]:
        return [self.vocab.id(t) for t in self.tokenize(text)]

    def _wordpiece(self, word: str) -> List[str]:
        """Reference ``:118``."""
        if len(word) > self.max_chars_per_word:
            return [Vocab.UNK]
        if word in self.vocab:
            return [word]
        out: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece: Optional[str] = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [Vocab.UNK]
            out.append(piece)
            start = end
        return out
