"""BERT (counterpart of deeplearning4j_tpu/zoo/bert.py): the native
transformer-encoder zoo model on MultiLayerNetwork.

Input convention (the reference's, nlp.BertIterator's): features (B, T, 2)
stacked [token ids, segment ids], an optional (B, T) feature mask.

``task="classification"``: embeddings -> ``n_layers`` encoder blocks ->
[CLS] (``TimeStepLayer(0)``) -> tanh pooler -> softmax over
``num_classes``. ``task="mlm"``: embeddings -> blocks -> a per-token
softmax over the vocabulary (``RnnOutputLayer``), trained on
``nlp.BertIterator``'s UNSUPERVISED batches (their ``labels_mask`` picks
the masked tokens). Both tasks train with ``fit``, and so do the causal
(GPT-style) blocks: the flash path through the ``FlashAttention`` Function.
"""

from __future__ import annotations

import dataclasses

from deeplearning4j_tpu_torch.nn import InputType
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.recurrent import RnnOutputLayer
from deeplearning4j_tpu_torch.nn.transformer import (BertEmbeddingLayer,
                                                     TimeStepLayer,
                                                     TransformerEncoderBlock)
from deeplearning4j_tpu_torch.zoo.models import ZooModel


@dataclasses.dataclass
class Bert(ZooModel):
    """Configurable BERT encoder. ``base()``/``large()``/``tiny()``/
    ``draft()`` give the reference's sizes."""

    vocab_size: int = 30522
    hidden_size: int = 768
    n_layers: int = 12
    n_heads: int = 12
    ffn_size: int = 0  # 0 -> 4*hidden
    max_length: int = 128
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    task: str = "classification"
    num_classes: int = 2
    flash: object = "auto"  # True | False | "auto" (measured-crossover dispatch)
    causal: bool = False

    @classmethod
    def base(cls, **kw):
        kw.setdefault("hidden_size", 768)
        kw.setdefault("n_layers", 12)
        kw.setdefault("n_heads", 12)
        return cls(**kw)

    @classmethod
    def large(cls, **kw):
        kw.setdefault("hidden_size", 1024)
        kw.setdefault("n_layers", 24)
        kw.setdefault("n_heads", 16)
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw):
        """BERT-tiny (2 layers, hidden 128): test size."""
        kw.setdefault("hidden_size", 128)
        kw.setdefault("n_layers", 2)
        kw.setdefault("n_heads", 2)
        return cls(**kw)

    @classmethod
    def draft(cls, **kw):
        """The reference's draft-model size (1 layer, hidden 64, causal, no
        dropout, masked-LM head) for speculative decoding."""
        kw.setdefault("hidden_size", 64)
        kw.setdefault("n_layers", 1)
        kw.setdefault("n_heads", 1)
        kw.setdefault("hidden_dropout", 0.0)
        kw.setdefault("causal", True)
        kw.setdefault("task", "mlm")
        return cls(**kw)

    def conf(self):
        lb = self._builder().list()
        lb.layer(BertEmbeddingLayer(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            max_position=self.max_length,
            type_vocab_size=self.type_vocab_size,
            dropout=self.hidden_dropout))
        for _ in range(self.n_layers):
            lb.layer(TransformerEncoderBlock(
                hidden_size=self.hidden_size, n_heads=self.n_heads,
                ffn_size=self.ffn_size, hidden_dropout=self.hidden_dropout,
                flash=self.flash, causal=self.causal))
        if self.task == "classification":
            lb.layer(TimeStepLayer(index=0))  # [CLS]
            lb.layer(DenseLayer(n_in=self.hidden_size,
                                n_out=self.hidden_size,
                                activation="tanh"))  # pooler
            lb.layer(OutputLayer(n_in=self.hidden_size,
                                 n_out=self.num_classes, loss="mcxent",
                                 activation="softmax"))
        elif self.task == "mlm":
            lb.layer(RnnOutputLayer(n_in=self.hidden_size,
                                    n_out=self.vocab_size, loss="mcxent",
                                    activation="softmax"))
        else:
            raise ValueError(f"unknown task {self.task!r}")
        lb.set_input_type(InputType.recurrent(2, self.max_length))
        return lb.build()
