"""NLP of the port (counterpart of deeplearning4j_tpu/nlp): the tokenizers,
the BERT data pipeline and the bag-of-words and TF-IDF vectorizers
(``vectorizer.py``, which datavec's TfidfRecordReader wraps). Word2Vec,
GloVe, FastText and the word-vector serializer are not ported yet
(ROADMAP.md Queue 1 item 13)."""

from deeplearning4j_tpu_torch.nlp.bert_iterator import BertIterator
from deeplearning4j_tpu_torch.nlp.tokenization import (BertWordPieceTokenizer,
                                                       DefaultTokenizer,
                                                       Vocab)
from deeplearning4j_tpu_torch.nlp.vectorizer import (BagOfWordsVectorizer,
                                                     TfidfVectorizer)

__all__ = ["BagOfWordsVectorizer", "BertIterator", "BertWordPieceTokenizer",
           "DefaultTokenizer", "TfidfVectorizer", "Vocab"]
