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
reference does.

The decode tier (``serving/generate.py``) runs the block's cache methods:
``prefill``/``decode_step`` over a contiguous (B, H, max_length, Dh) cache
and ``prefill_paged``/``prefill_resume_paged``/``decode_window_paged``
over a slot-flat paged pool, with the embedding's ``embed_step``/
``embed_window``. They share ``_qkv``, ``_proj_out`` and ``_finish`` with
``apply``, and the prompt's attention is the exact one, never the flash
kernel, so paged, contiguous and full-recompute decode compute the same
rows. Unlike the reference's, which return new buffers (its executables
donate them), these write the cache or pool in place and return it: the
buffers are static state of the serving programs.
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

    def embed_step(self, params, tokens, positions):
        """One decode step's embedding (reference ``:81``): ``tokens``
        (B,) at per-row ``positions`` (B,) -> (B, H), the word + position +
        type-0 sum and layer norm of :meth:`apply`, so a token embedded on
        its own matches the whole sequence's embedding at its position."""
        return self.embed_window(params, tokens, positions)

    def embed_window(self, params, tokens, positions):
        """A window's embedding (reference ``:92``): ``tokens`` (B, W) at
        per-row ``positions`` (B, W) -> (B, W, H), every token as
        :meth:`embed_step` embeds it."""
        h = (_take(params["word"], tokens.to(torch.int64))
             + _take(params["pos"], positions.to(torch.int64))
             + params["type"][0])
        return _layer_norm(h, params["gamma"], params["beta"])

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

    # --------------------------------------------------- KV-cache decoding

    def _require_causal(self):
        if not self.causal:
            raise ValueError("prefill/decode_step need causal=True blocks")

    def _prompt_attention(self, q, k, v, mask):
        """The prompt's causal attention: the exact path, as the
        reference's prefill takes it, whatever ``flash`` says."""
        amask = None if mask is None else mask[:, None, None, :].to(
            torch.bool)
        return attn_ops.dot_product_attention(q, k, v, mask=amask,
                                              causal=True)

    def init_cache(self, batch: int, max_len: int, dtype=torch.float32,
                   device=None):
        """An empty K/V cache of ``batch`` rows and ``max_len`` positions
        (reference ``:228``): two distinct (B, H, max_len, Dh) buffers."""
        dh = self.hidden_size // self.n_heads
        shape = (batch, self.n_heads, max_len, dh)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def prefill(self, params, x, cache, mask=None):
        """Causal forward over the prompt (B, T, H), writing positions
        [0, T) of ``cache`` in place (reference ``:238``); returns (out,
        cache). ``mask``: the (B, T) padding mask. Padding positions write
        values that every later read masks out, and generation overwrites
        position ``length`` before attending to it."""
        self._require_causal()
        q, k, v = self._qkv(params, self._attn_input(params, x))
        t = x.shape[1]
        cache["k"][:, :, :t] = k.to(cache["k"].dtype)
        cache["v"][:, :, :t] = v.to(cache["v"].dtype)
        o = self._prompt_attention(q, k, v, mask)
        return self._finish(params, x, self._proj_out(params, o)), cache

    def decode_step(self, params, x_t, cache, positions):
        """One autoregressive step (reference ``:349``): ``x_t`` (B, 1, H)
        at per-row ``positions`` (B,). Writes this step's K/V at each row's
        position, in place, and attends the query over ``k_pos <=
        position``. Returns (out (B, 1, H), cache)."""
        q, k, v = self._qkv(params, self._attn_input(params, x_t))
        length = cache["k"].shape[2]
        rows = torch.arange(x_t.shape[0], device=x_t.device)
        pos = positions.to(torch.int64)
        cache["k"][rows, :, pos] = k[:, :, 0].to(cache["k"].dtype)
        cache["v"][rows, :, pos] = v[:, :, 0].to(cache["v"].dtype)
        keys = torch.arange(length, device=x_t.device)
        amask = (keys[None, :] <= pos[:, None])[:, None, None, :]
        o = attn_ops.dot_product_attention(q, cache["k"], cache["v"],
                                           mask=amask)
        return self._finish(params, x_t, self._proj_out(params, o)), cache

    # ------------------------------------------------- paged KV-cache path

    def init_pool(self, num_slots: int, dtype=torch.float32, device=None):
        """An empty slot-flat K/V pool of this layer (reference ``:270``):
        two distinct (S, H, Dh) buffers."""
        dh = self.hidden_size // self.n_heads
        shape = (num_slots, self.n_heads, dh)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def _pool_write(self, pool, slots_flat, k, v):
        """Scatter (N, H, Dh) K/V rows at flat slots (N,), in place
        (reference ``:279``). Collisions happen only in the trash block,
        garbage on garbage that every read masks out."""
        idx = slots_flat.to(torch.int64)
        pool["k"][idx] = k.to(pool["k"].dtype)
        pool["v"][idx] = v.to(pool["v"].dtype)
        return pool

    def _rows(self, t):
        """(B, nh, T, dh) -> (B * T, nh, dh), the pool's row layout."""
        b, nh, w, dh = t.shape
        return t.permute(0, 2, 1, 3).reshape(b * w, nh, dh)

    def prefill_paged(self, params, x, pool, slots, mask=None):
        """Causal forward over the prompt (B, T, H), scattering each
        position's K/V into the paged ``pool`` at ``slots`` (B, T)
        (reference ``:288``); the attention runs over the projected q/k/v
        as :meth:`prefill`'s does, so the hidden states are the contiguous
        prefill's."""
        self._require_causal()
        q, k, v = self._qkv(params, self._attn_input(params, x))
        self._pool_write(pool, slots.reshape(-1), self._rows(k),
                         self._rows(v))
        o = self._prompt_attention(q, k, v, mask)
        return self._finish(params, x, self._proj_out(params, o)), pool

    def prefill_resume_paged(self, params, x_w, pool, slots, positions,
                             limits=None):
        """Prefill of a prompt's suffix (reference ``:306``): ``x_w``
        (B, W, H) at per-row absolute ``positions`` (B, W), resuming where
        each stream's prefix-cache hit ends, against the K/V its cached
        blocks hold. Write-then-attend through the page table with each
        query masked to ``k_pos <= position`` is the verify window's rule,
        so it is :meth:`decode_window_paged`; ``limits`` is each row's last
        prompt position (later columns write to the trash block)."""
        return self.decode_window_paged(params, x_w, pool, slots, positions,
                                        limits=limits)

    def decode_window_paged(self, params, x_w, pool, slots, positions,
                            limits=None):
        """W autoregressive steps in one call (reference ``:324``):
        ``x_w`` (B, W, H) at per-row ``positions`` (B, W). Writes the
        window's K/V at each token's slot, then attends each query over
        ``k_pos <= position`` through the page table. W = 1 is the decode
        step, W > 1 the speculative verify window. ``limits`` (B,): each
        stream's last valid position; writes past it go to the trash
        block. Returns (out (B, W, H), pool)."""
        q, k, v = self._qkv(params, self._attn_input(params, x_w))
        pos = positions.to(torch.int64)
        # a column past the table (a verify window overhanging max_length)
        # reads the last slot's index and, past its limit, writes to trash
        wslots = torch.gather(slots.to(torch.int64), 1,
                              pos.clamp(max=slots.shape[1] - 1))
        if limits is not None:
            wslots = torch.where(pos <= limits.to(torch.int64)[:, None],
                                 wslots, 0)
        self._pool_write(pool, wslots.reshape(-1), self._rows(k),
                         self._rows(v))
        o = attn_ops.paged_attention(q, pool["k"], pool["v"], slots, pos)
        return self._finish(params, x_w, self._proj_out(params, o)), pool

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
