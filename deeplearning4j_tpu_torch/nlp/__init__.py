"""NLP of the port (counterpart of deeplearning4j_tpu/nlp): the tokenizers
and the BERT data pipeline. Word2Vec, GloVe, FastText, the word-vector
serializer and the vectorizers are not ported yet (ROADMAP.md Queue 1
item 13)."""

from deeplearning4j_tpu_torch.nlp.bert_iterator import BertIterator
from deeplearning4j_tpu_torch.nlp.tokenization import (BertWordPieceTokenizer,
                                                       DefaultTokenizer,
                                                       Vocab)

__all__ = ["BertIterator", "BertWordPieceTokenizer", "DefaultTokenizer",
           "Vocab"]
