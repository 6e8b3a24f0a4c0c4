"""Attention layers: SelfAttention, LearnedSelfAttention, RecurrentAttention
(counterpart of deeplearning4j_tpu/nn/attention.py; DL4J's
SelfAttentionLayer, LearnedSelfAttentionLayer and RecurrentAttentionLayer).

Sequences are [batch, time, features]. The attention core is
``ops/attention.py``: ``multi_head_dot_product_attention``, which takes the
flash path (the K5 kernel on the card, trained through the
``FlashAttention`` Function) or the exact one by ``resolve_flash``, and
``dot_product_attention``. Params are keyed as the reference keys them, with
(in, out) projection weights, so its params copy across as they are.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from deeplearning4j_tpu_torch.nn import activations as act
from deeplearning4j_tpu_torch.nn import weights as winit
from deeplearning4j_tpu_torch.nn.layers import Layer, register_layer
from deeplearning4j_tpu_torch.ops import attention as attn_ops


@dataclasses.dataclass(frozen=True)
class BaseAttentionLayer(Layer):
    """Fields shared by the attention layers (reference ``:32``)."""

    n_in: int = 0
    n_out: int = 0
    n_heads: int = 1
    head_size: Optional[int] = None  # default n_out // n_heads
    project_input: bool = True
    weight_init: str = "xavier"
    flash: Any = "auto"  # True | False | "auto" (measured-crossover dispatch)
    causal: bool = False

    @property
    def _head_size(self) -> int:
        if self.head_size is not None:
            return self.head_size
        if self.n_out % self.n_heads:
            raise ValueError(
                "n_out must be divisible by n_heads (or set head_size)")
        return self.n_out // self.n_heads

    def _proj_params(self, gen):
        hd = self.n_heads * self._head_size
        wi = self.weight_init
        return {
            "Wq": winit.init(gen, wi, (self.n_in, hd)),
            "Wk": winit.init(gen, wi, (self.n_in, hd)),
            "Wv": winit.init(gen, wi, (self.n_in, hd)),
            "Wo": winit.init(gen, wi, (hd, self.n_out)),
        }

    def _check_unprojected(self):
        if self.n_in != self.n_out:
            raise ValueError("project_input=False requires n_in == n_out")
        if self.n_heads != 1:
            raise ValueError("project_input=False requires n_heads == 1")


def _zero_masked(y, mask):
    return y if mask is None else y * mask[..., None].to(y.dtype)


@register_layer
@dataclasses.dataclass(frozen=True)
class SelfAttentionLayer(BaseAttentionLayer):
    """Self attention over a [B, T, F] sequence -> [B, T, n_out] (reference
    ``:70``). With ``project_input`` the layer learns Wq/Wk/Wv/Wo; without,
    q = k = v = the input (n_in == n_out, one head). ``mask``: a (B, T)
    padding mask; masked keys are never attended to and masked output
    steps are zeroed."""

    def initialize(self, gen, input_shape):
        if not self.project_input:
            self._check_unprojected()
            return {}, {}
        return self._proj_params(gen), {}

    def apply(self, params, state, x, *, training=False, gen=None, mask=None):
        x = self._maybe_dropout(x, training, gen)
        if self.project_input:
            y = attn_ops.multi_head_dot_product_attention(
                x, x, x, params["Wq"], params["Wk"], params["Wv"],
                params["Wo"], n_heads=self.n_heads, mask=mask,
                flash=self.flash, causal=self.causal)
        else:
            q = x[:, None]
            amask = None if mask is None else mask[:, None, None, :]
            y = attn_ops.dot_product_attention(
                q, q, q, mask=amask, causal=self.causal)[:, 0]
        return _zero_masked(y, mask), state

    def output_shape(self, input_shape):
        return (input_shape[0], self.n_out)


@register_layer
@dataclasses.dataclass(frozen=True)
class LearnedSelfAttentionLayer(BaseAttentionLayer):
    """Attention of ``n_queries`` learned query vectors over the sequence ->
    [B, n_queries, n_out] (reference ``:111``): pools a sequence of any
    length into a fixed number of steps."""

    n_queries: int = 1

    def initialize(self, gen, input_shape):
        q = winit.init(gen, self.weight_init, (self.n_queries, self.n_in))
        if not self.project_input:
            self._check_unprojected()
            return {"Q": q}, {}
        return {**self._proj_params(gen), "Q": q}, {}

    def apply(self, params, state, x, *, training=False, gen=None, mask=None):
        x = self._maybe_dropout(x, training, gen)
        queries = params["Q"].expand((x.shape[0],) + params["Q"].shape)
        if self.project_input:
            y = attn_ops.multi_head_dot_product_attention(
                queries, x, x, params["Wq"], params["Wk"], params["Wv"],
                params["Wo"], n_heads=self.n_heads, mask=mask)
        else:
            amask = None if mask is None else mask[:, None, None, :]
            y = attn_ops.dot_product_attention(
                queries[:, None], x[:, None], x[:, None], mask=amask)[:, 0]
        return y, state

    def output_shape(self, input_shape):
        return (self.n_queries, self.n_out)


@register_layer
@dataclasses.dataclass(frozen=True)
class RecurrentAttentionLayer(BaseAttentionLayer):
    """A recurrent cell whose step attends over the whole input with the
    previous hidden state as the query (reference ``:152``):

        a_t = MHA(q = h_{t-1}, k = v = x)
        h_t = activation(x_t Wx + a_t Wr + b)

    The K/V and input projections are taken once for the sequence; the
    reference's ``lax.scan`` step (``:191``) is a loop over time."""

    activation: str = "tanh"

    def initialize(self, gen, input_shape):
        hd = self.n_heads * self._head_size
        wi = self.weight_init
        return {
            "Wx": winit.init(gen, wi, (self.n_in, self.n_out)),
            "Wr": winit.init(gen, wi, (self.n_out, self.n_out)),
            "b": torch.zeros((self.n_out,)),
            "Wq": winit.init(gen, wi, (self.n_out, hd)),
            "Wk": winit.init(gen, wi, (self.n_in, hd)),
            "Wv": winit.init(gen, wi, (self.n_in, hd)),
            "Wo": winit.init(gen, wi, (hd, self.n_out)),
        }, {}

    def apply(self, params, state, x, *, training=False, gen=None, mask=None):
        x = self._maybe_dropout(x, training, gen)
        b, t, _ = x.shape
        nh, dh = self.n_heads, self._head_size
        kproj = attn_ops._split_heads(x @ params["Wk"], nh)
        vproj = attn_ops._split_heads(x @ params["Wv"], nh)
        kmask = None if mask is None else mask[:, None, None, :].to(torch.bool)
        fn = act.resolve(self.activation)
        xw = x @ params["Wx"]
        h = torch.zeros((b, self.n_out), dtype=x.dtype, device=x.device)
        ys = []
        for step in range(t):
            q = (h @ params["Wq"]).reshape(b, nh, 1, dh)
            a = attn_ops.dot_product_attention(q, kproj, vproj, mask=kmask)
            a = a.reshape(b, nh * dh) @ params["Wo"]
            h = fn(xw[:, step] + a @ params["Wr"] + params["b"])
            ys.append(h)
        return _zero_masked(torch.stack(ys, dim=1), mask), state

    def output_shape(self, input_shape):
        return (input_shape[0], self.n_out)
