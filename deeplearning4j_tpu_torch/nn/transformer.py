"""Transformer encoder layers: BERT embeddings and the encoder block
(counterpart of deeplearning4j_tpu/nn/transformer.py).

Sequences are (B, T, H). Each block is two residual sublayers: the Q/K/V,
output and FFN projections are plain matrix products (the reference leaves
them to XLA), and the attention is ``ops/attention.py``: the flash-attention
kernel (``csrc/flash_fwd.cu``) or the exact path, by ``flash`` through
``resolve_flash`` (``"auto"``: the H100 crossover). A (B, T) padding mask
(1 = attend) takes the flash path too, masked per key inside the kernel.

Params are dicts keyed as the reference keys them (``word``/``pos``/
``type``/``gamma``/``beta``; ``Wq``..``b2``, ``ln1_g``..``ln2_b``), with
(in, out) projection weights, so the reference's params copy across as
they are.

The encoder block trains on both paths: the exact attention through
autograd, the flash path through ``FlashAttention`` (the kernel's forward,
the reference's ``_flash_bwd`` as its backward). In training it applies
``hidden_dropout`` to the attention output and to the FFN output, drawing
twice from the network's generator (the reference splits its key in two);
``attn_dropout`` is kept as config and, as in the reference, never applied.
The embedding applies its ``dropout`` to its output in training, as the
reference does. Not ported yet: ``embed_step``/``embed_window``,
``prefill``/``decode_step`` and the paged methods (the generate serving
slice).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from deeplearning4j_tpu_torch.nn import activations as act
from deeplearning4j_tpu_torch.nn.layers import Layer, register_layer
from deeplearning4j_tpu_torch.ops import attention as attn_ops
from deeplearning4j_tpu_torch.ops import random as randops


def _layer_norm(x, gamma, beta, eps=1e-12):
    """The reference's layer norm (``:35``): mean, biased variance
    (``jnp.var``), eps 1e-12, in x's type."""
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mu) / torch.sqrt(var + eps) * gamma + beta


def _normal(gen, shape, r):
    return torch.randn(shape, generator=gen) * r


def _take(table, ids):
    """``jnp.take(table, ids, axis=0)``: a negative id counts from the end,
    and an id outside [-V, V) gives a row of NaN (JAX's fill mode) rather
    than an error on the device."""
    n = table.shape[0]
    ids = torch.where(ids < 0, ids + n, ids)
    valid = (ids >= 0) & (ids < n)
    rows = table.index_select(0, ids.clamp(0, n - 1).reshape(-1))
    rows = rows.reshape(ids.shape + table.shape[1:])
    return torch.where(valid[..., None], rows, float("nan"))


@register_layer
@dataclasses.dataclass(frozen=True)
class BertEmbeddingLayer(Layer):
    """BERT input embeddings: word + learned position + token type, then
    layer norm. Input: (B, T) token ids, or (B, T, 2) stacked [token ids,
    segment ids]; float ids are truncated to integers, as the reference's
    ``astype(int32)`` does (so in a bf16 net they arrive rounded to bf16)."""

    vocab_size: int = 0
    hidden_size: int = 0
    max_position: int = 512
    type_vocab_size: int = 2
    init_range: float = 0.02

    def initialize(self, gen, input_shape):
        r = self.init_range
        hs = self.hidden_size
        return {
            "word": _normal(gen, (self.vocab_size, hs), r),
            "pos": _normal(gen, (self.max_position, hs), r),
            "type": _normal(gen, (self.type_vocab_size, hs), r),
            "gamma": torch.ones((hs,)),
            "beta": torch.zeros((hs,)),
        }, {}

    def apply(self, params, state, x, *, training=False, gen=None):
        if x.dim() == 3:
            tokens = x[..., 0].to(torch.int64)
            segments = x[..., 1].to(torch.int64)
        else:
            tokens = x.to(torch.int64)
            segments = torch.zeros_like(tokens)
        t = tokens.shape[1]
        h = (_take(params["word"], tokens) + params["pos"][None, :t]
             + _take(params["type"], segments))
        h = _layer_norm(h, params["gamma"], params["beta"])
        return self._maybe_dropout(h, training, gen), state

    def output_shape(self, input_shape):
        return (input_shape[0], self.hidden_size)


@register_layer
@dataclasses.dataclass(frozen=True)
class TransformerEncoderBlock(Layer):
    """One transformer encoder block (BERT layout, post-LN):

        h = LN(x + MHA(x));  out = LN(h + FFN(h))

    ``pre_norm=True`` is the pre-LN variant (GPT style); ``causal=True``
    adds the autoregressive mask. ``mask``: (B, T) padding mask, masked
    keys are never attended to, and masked positions of the output are
    zeroed (reference ``:215-216``)."""

    hidden_size: int = 0
    n_heads: int = 1
    ffn_size: int = 0  # default 4*hidden
    activation: str = "gelu"
    attn_dropout: float = 0.0
    hidden_dropout: float = 0.0
    init_range: float = 0.02
    flash: Any = "auto"  # True | False | "auto" (measured-crossover dispatch)
    pre_norm: bool = False
    causal: bool = False

    @property
    def _ffn(self):
        return self.ffn_size or 4 * self.hidden_size

    def initialize(self, gen, input_shape):
        hs, f, r = self.hidden_size, self._ffn, self.init_range
        return {
            "Wq": _normal(gen, (hs, hs), r), "bq": torch.zeros((hs,)),
            "Wk": _normal(gen, (hs, hs), r), "bk": torch.zeros((hs,)),
            "Wv": _normal(gen, (hs, hs), r), "bv": torch.zeros((hs,)),
            "Wo": _normal(gen, (hs, hs), r), "bo": torch.zeros((hs,)),
            "ln1_g": torch.ones((hs,)), "ln1_b": torch.zeros((hs,)),
            "W1": _normal(gen, (hs, f), r), "b1": torch.zeros((f,)),
            "W2": _normal(gen, (f, hs), r), "b2": torch.zeros((hs,)),
            "ln2_g": torch.ones((hs,)), "ln2_b": torch.zeros((hs,)),
        }, {}

    def _qkv(self, params, x):
        """Per-head projections: (B, T, H) -> three (B, nh, T, dh) views."""
        b, t, hs = x.shape
        nh = self.n_heads
        dh = hs // nh

        def split(y):
            return y.reshape(b, t, nh, dh).permute(0, 2, 1, 3)

        return (split(x @ params["Wq"] + params["bq"]),
                split(x @ params["Wk"] + params["bk"]),
                split(x @ params["Wv"] + params["bv"]))

    def _proj_out(self, params, o):
        b, nh, t, dh = o.shape
        o = o.permute(0, 2, 1, 3).reshape(b, t, nh * dh)
        return o @ params["Wo"] + params["bo"]

    def _mha(self, params, x, mask):
        t = x.shape[1]
        q, k, v = self._qkv(params, x)
        if attn_ops.resolve_flash(self.flash, t, t, mask, device=x.device,
                                  head_dim=q.shape[-1]):
            o = attn_ops.flash_attention(q, k, v, causal=self.causal,
                                         mask=mask)
        else:
            amask = None if mask is None else mask[:, None, None, :].to(
                torch.bool)
            o = attn_ops.dot_product_attention(q, k, v, mask=amask,
                                               causal=self.causal)
        return self._proj_out(params, o)

    def _attn_input(self, params, x):
        """What the attention sublayer sees: LN(x) pre-norm, x post-norm."""
        return (_layer_norm(x, params["ln1_g"], params["ln1_b"])
                if self.pre_norm else x)

    def _ffn_block(self, params, h):
        fn = act.resolve(self.activation)
        return fn(h @ params["W1"] + params["b1"]) @ params["W2"] + params["b2"]

    def _finish(self, params, x, a, training=False, gen=None):
        """Residual + layer norm + FFN after the attention output ``a``
        (reference ``:186-207``), with ``hidden_dropout`` on each sublayer's
        output in training: the attention output's mask drawn first, then
        the FFN output's."""

        def drop(h):
            if training and self.hidden_dropout > 0.0 and gen is not None:
                return randops.dropout(h, gen, self.hidden_dropout)
            return h

        if self.pre_norm:
            h = x + drop(a)
            f = self._ffn_block(
                params, _layer_norm(h, params["ln2_g"], params["ln2_b"]))
            return h + drop(f)
        h = _layer_norm(x + drop(a), params["ln1_g"], params["ln1_b"])
        return _layer_norm(h + drop(self._ffn_block(params, h)),
                           params["ln2_g"], params["ln2_b"])

    def apply(self, params, state, x, *, training=False, gen=None,
              mask=None):
        a = self._mha(params, self._attn_input(params, x), mask)
        out = self._finish(params, x, a, training, gen)
        if mask is not None:
            out = out * mask[..., None].to(out.dtype)
        return out, state

    def output_shape(self, input_shape):
        return (input_shape[0], self.hidden_size)


@register_layer
@dataclasses.dataclass(frozen=True)
class TimeStepLayer(Layer):
    """One time step of (B, T, F) -> (B, F); index 0 is BERT's [CLS]
    readout."""

    index: int = 0

    def apply(self, params, state, x, *, training=False, gen=None):
        return x[:, self.index], state

    def output_shape(self, input_shape):
        return (input_shape[-1],)
