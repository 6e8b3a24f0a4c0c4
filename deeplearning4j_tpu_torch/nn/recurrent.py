"""Recurrent layers, their wrappers and heads (counterpart of
deeplearning4j_tpu/nn/recurrent.py).

As in the reference:

- data is (B, T, F); the recurrence walks the time axis with the input
  projection ``x @ W + b`` for all T hoisted out of the loop into one
  matrix product;
- ``apply_seq`` takes and returns the carry, for truncated BPTT and
  stateful ``rnn_time_step``; ``init_carry`` is the zero state: ``(h, c)``
  for the LSTMs, one tensor for GRU and SimpleRnn;
- a (B, T) mask passes the previous state through a masked step unchanged
  and zeroes that step's output;
- the LSTMs' gate order is [i, f, o, g], the forget-gate bias starts at
  ``forget_gate_bias_init``; GravesLSTM adds the peepholes ``peep`` =
  [pi, pf, po] (i and f see c_{t-1}, o sees c_t), cast to the step's type;
- GRU is the reset-after form (the reset gate scales ``h @ U``), with the
  separate recurrent bias ``b_rec`` under ``recurrent_bias``.

The LSTM dispatches like every kernel of the port
(``ops/kernels/__init__.py``): on a CUDA tensor under ``auto`` or ``cuda``
each ``apply_seq`` call (a TBPTT segment, one direction of a
Bidirectional, or one ``rnn_time_step``) is one launch of the segment
kernel (``csrc/lstm_seq.cu``, K4 over all T steps, mask included) through
``LSTMSequenceFunction``, or raises when the cell has no kernel
(activations other than sigmoid/tanh, types other than fp32/bf16);
``exact`` and a CPU tensor under ``auto`` take the reference's plain step
in ``_scan``, in the input's type, and autograd differentiates through
that time loop. GravesLSTM, GRU and SimpleRnn have no Pallas kernel in the
reference (each is a jnp scan there), so their plain step is the port's
form. ConvLSTM2D's input convolution (one (B*T)-image batch) and its
recurrent convolution (SAME, stride 1, once a step) go through
``ops.nn.conv2d``: the conv kernel on the card, and in training
``Conv2dFunction``'s dgrad and wgrad kernels.

Wrappers: ``Bidirectional`` runs its layer forward and on the
time-reversed input and mask (a right-padded mask reversed starts with
masked steps, which keep the zero state), with its own input dropout
applied once before both; ``GravesBidirectionalLSTM`` is
Bidirectional(GravesLSTM) with concat. As in the reference, it hands its
dropout rate to the inner GravesLSTM, whose ``apply_seq`` never drops, so
its dropout never applies (ROADMAP.md Queue 3). Params of a wrapper are
nested, ``{"fwd": {...}, "bwd": {...}}``, at every interface.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn import activations as act
from deeplearning4j_tpu_torch.nn import losses as losses_mod
from deeplearning4j_tpu_torch.nn import weights as winit
from deeplearning4j_tpu_torch.nn.layers import Layer, register_layer
from deeplearning4j_tpu_torch.ops import kernels as _kern
from deeplearning4j_tpu_torch.ops import nn as nnops
from deeplearning4j_tpu_torch.ops.kernels import lstm as _klstm
from deeplearning4j_tpu_torch.tree import tree_map


def is_recurrent(layer) -> bool:
    """A layer that carries state along time (``apply_seq`` and
    ``init_carry``): TBPTT and ``rnn_time_step`` hand it its carry."""
    return hasattr(layer, "apply_seq") and hasattr(layer, "init_carry")


def _merge_loss_weights(weights, mask):
    """Per-example loss weights (B,) and a sequence mask (B, T) compose by
    broadcasting the weights over time: both gate the loss."""
    if weights is None:
        return mask
    if mask is None:
        return weights
    return mask * weights.reshape(
        tuple(weights.shape) + (1,) * (mask.dim() - weights.dim()))


@dataclasses.dataclass(frozen=True)
class BaseRecurrentLayer(Layer):
    """Common recurrent config: n_in/n_out, activations, weight inits."""

    n_in: int = 0
    n_out: int = 0
    activation: str = "tanh"
    gate_activation: str = "sigmoid"
    weight_init: str = "xavier"
    weight_init_recurrent: Optional[str] = None  # defaults to weight_init

    def init_carry(self, batch_size: int, dtype=torch.float32, device=None):
        """Zero state (rnnClearPreviousState parity)."""
        raise NotImplementedError

    def apply_seq(self, params, x, carry, *, mask=None, training=False):
        """(B, T, F) + carry -> ((B, T, H), new carry)."""
        raise NotImplementedError

    def apply(self, params, state, x, *, training=False, gen=None,
              mask=None):
        x = self._maybe_dropout(x, training, gen)
        y, _ = self.apply_seq(
            params, x, self.init_carry(x.shape[0], x.dtype, x.device),
            mask=mask, training=training)
        return y, state

    def output_shape(self, input_shape):
        t = input_shape[0] if len(input_shape) == 2 else None
        return (t, self.n_out)

    @staticmethod
    def _scan(step, carry, x, mask):
        """The time loop with the mask-aware state passthrough: a masked
        step keeps the old carry (a tensor or a tuple) and outputs zeros."""
        ys = []
        masks = None if mask is None else mask.unbind(1)
        for t, xt in enumerate(x.unbind(1)):
            new_c, y = step(carry, xt)
            if masks is not None:
                m = masks[t][:, None].to(y.dtype)
                new_c = tree_map(lambda n, o: m * n + (1 - m) * o, new_c,
                                 carry)
                y = m * y
            carry = new_c
            ys.append(y)
        return torch.stack(ys, dim=1), carry


@register_layer
@dataclasses.dataclass(frozen=True)
class LSTM(BaseRecurrentLayer):
    """Standard LSTM, no peepholes (conf/layers/LSTM.java). Gate order
    [i, f, o, g]; the forget-gate bias starts at ``forget_gate_bias_init``
    (reference default 1)."""

    forget_gate_bias_init: float = 1.0

    def initialize(self, gen, input_shape):
        n_in = self.n_in or input_shape[-1]
        h = self.n_out
        rec_init = self.weight_init_recurrent or self.weight_init
        b = torch.zeros((4 * h,))
        b[h:2 * h] = self.forget_gate_bias_init
        return {
            "W": winit.init(gen, self.weight_init, (n_in, 4 * h)),
            "U": winit.init(gen, rec_init, (h, 4 * h)),
            "b": b,
        }, {}

    def init_carry(self, batch_size, dtype=torch.float32, device=None):
        z = torch.zeros((batch_size, self.n_out), dtype=dtype, device=device)
        return (z, z.clone())

    def apply_seq(self, params, x, carry, *, mask=None, training=False):
        # the input projection for all T at once, outside the time loop
        xp = torch.matmul(x, params["W"].to(x.dtype)) + params["b"].to(x.dtype)
        u = params["U"].to(x.dtype)
        xp0 = xp[:, 0] if xp.dim() == 3 else xp
        if _kern.dispatch(
                "lstm_seq_fwd",
                _klstm.supports(xp0, u, self.gate_activation, self.activation),
                xp, lambda: (f"{_klstm._describe(xp0, carry[0], carry[1], u)}"
                             f", activations {self.gate_activation}/"
                             f"{self.activation}"),
                op="lstm_cell",
                sig=lambda: _klstm.shape_signature(xp0.shape[0], self.n_out),
                dtype=xp.dtype):
            return _klstm.lstm_seq(xp, carry[0], carry[1], u,
                                   _klstm.ORDER_IFOG, mask)

        f_act = act.resolve(self.activation)
        g_act = act.resolve(self.gate_activation)

        def step(c, xt):
            h_prev, c_prev = c
            z = xt + torch.matmul(h_prev, u)
            i, f, o, g = z.chunk(4, dim=-1)
            c_new = g_act(f) * c_prev + g_act(i) * f_act(g)
            h_new = g_act(o) * f_act(c_new)
            return (h_new, c_new), h_new

        return self._scan(step, carry, xp, mask)


@register_layer
@dataclasses.dataclass(frozen=True)
class GravesLSTM(BaseRecurrentLayer):
    """LSTM with peephole connections (conf/layers/GravesLSTM.java, after
    Graves 2013; reference ``:186``): i and f peek at c_{t-1}, o at c_t.
    Params W, U, b as the LSTM's and ``peep`` (3, H) = [pi, pf, po]."""

    forget_gate_bias_init: float = 1.0

    def initialize(self, gen, input_shape):
        params, _ = LSTM.initialize(self, gen, input_shape)
        return {"W": params["W"], "U": params["U"],
                "peep": winit.init(gen, "normal", (3, self.n_out)) * 0.1,
                "b": params["b"]}, {}

    def init_carry(self, batch_size, dtype=torch.float32, device=None):
        return LSTM.init_carry(self, batch_size, dtype, device)

    def apply_seq(self, params, x, carry, *, mask=None, training=False):
        f_act = act.resolve(self.activation)
        g_act = act.resolve(self.gate_activation)
        xp = torch.matmul(x, params["W"].to(x.dtype)) + params["b"].to(x.dtype)
        u = params["U"].to(x.dtype)
        pi, pf, po = params["peep"].to(x.dtype).unbind(0)

        def step(c, xt):
            h_prev, c_prev = c
            z = xt + torch.matmul(h_prev, u)
            i, f, o, g = z.chunk(4, dim=-1)
            i = g_act(i + pi * c_prev)
            f = g_act(f + pf * c_prev)
            c_new = f * c_prev + i * f_act(g)
            h_new = g_act(o + po * c_new) * f_act(c_new)
            return (h_new, c_new), h_new

        return self._scan(step, carry, xp, mask)


@register_layer
@dataclasses.dataclass(frozen=True)
class GRU(BaseRecurrentLayer):
    """Gated recurrent unit (reference ``:232``; libnd4j's gruCell), the
    reset-after form: gates [r, z, n], ``n = act(xn + r * (h @ U)_n)``, one
    (H, 3H) product a step; ``recurrent_bias`` adds ``b_rec`` to h @ U.
    The carry is h alone."""

    recurrent_bias: bool = False

    def initialize(self, gen, input_shape):
        n_in = self.n_in or input_shape[-1]
        h = self.n_out
        rec_init = self.weight_init_recurrent or self.weight_init
        params = {
            "W": winit.init(gen, self.weight_init, (n_in, 3 * h)),
            "U": winit.init(gen, rec_init, (h, 3 * h)),
            "b": torch.zeros((3 * h,)),
        }
        if self.recurrent_bias:
            params["b_rec"] = torch.zeros((3 * h,))
        return params, {}

    def init_carry(self, batch_size, dtype=torch.float32, device=None):
        return torch.zeros((batch_size, self.n_out), dtype=dtype,
                           device=device)

    def apply_seq(self, params, x, carry, *, mask=None, training=False):
        f_act = act.resolve(self.activation)
        g_act = act.resolve(self.gate_activation)
        xp = torch.matmul(x, params["W"].to(x.dtype)) + params["b"].to(x.dtype)
        u = params["U"].to(x.dtype)
        b_rec = params.get("b_rec")
        b_rec = None if b_rec is None else b_rec.to(x.dtype)

        def step(h_prev, xt):
            hu = torch.matmul(h_prev, u)
            if b_rec is not None:
                hu = hu + b_rec
            xr, xz, xn = xt.chunk(3, dim=-1)
            hr, hz, hn = hu.chunk(3, dim=-1)
            r = g_act(xr + hr)
            z = g_act(xz + hz)
            n = f_act(xn + r * hn)
            h_new = (1 - z) * n + z * h_prev
            return h_new, h_new

        return self._scan(step, carry, xp, mask)


@register_layer
@dataclasses.dataclass(frozen=True)
class SimpleRnn(BaseRecurrentLayer):
    """Vanilla RNN, ``h_t = act(x W + h U + b)`` (conf/layers/recurrent/
    SimpleRnn.java; reference ``:283``). The carry is h alone."""

    def initialize(self, gen, input_shape):
        n_in = self.n_in or input_shape[-1]
        h = self.n_out
        rec_init = self.weight_init_recurrent or self.weight_init
        return {
            "W": winit.init(gen, self.weight_init, (n_in, h)),
            "U": winit.init(gen, rec_init, (h, h)),
            "b": torch.zeros((h,)),
        }, {}

    def init_carry(self, batch_size, dtype=torch.float32, device=None):
        return torch.zeros((batch_size, self.n_out), dtype=dtype,
                           device=device)

    def apply_seq(self, params, x, carry, *, mask=None, training=False):
        f_act = act.resolve(self.activation)
        xp = torch.matmul(x, params["W"].to(x.dtype)) + params["b"].to(x.dtype)
        u = params["U"].to(x.dtype)

        def step(h_prev, xt):
            h_new = f_act(xt + torch.matmul(h_prev, u))
            return h_new, h_new

        return self._scan(step, carry, xp, mask)


@register_layer
@dataclasses.dataclass(frozen=True)
class Bidirectional(Layer):
    """Bidirectional wrapper (conf/layers/recurrent/Bidirectional.java;
    reference ``:314``): the wrapped recurrent layer runs forward with the
    ``fwd`` params and on the time-reversed input and mask with the ``bwd``
    params, its output reversed back; ``mode`` concat | add | mul | ave
    combines the two. The wrapper's own ``dropout`` applies once, before
    both directions; its ``l1``/``l2`` rate the nested params (the wrapped
    layer's rates are not read, as in the reference: ROADMAP.md Queue 3)."""

    layer: Any = None  # a BaseRecurrentLayer
    mode: str = "concat"

    def initialize(self, gen, input_shape):
        pf, _ = self.layer.initialize(gen, input_shape)
        pb, _ = self.layer.initialize(gen, input_shape)
        return {"fwd": pf, "bwd": pb}, {}

    def apply(self, params, state, x, *, training=False, gen=None,
              mask=None):
        x = self._maybe_dropout(x, training, gen)
        lyr = self.layer
        yf, _ = lyr.apply_seq(
            params["fwd"], x, lyr.init_carry(x.shape[0], x.dtype, x.device),
            mask=mask, training=training)
        yb, _ = lyr.apply_seq(
            params["bwd"], x.flip(1),
            lyr.init_carry(x.shape[0], x.dtype, x.device),
            mask=None if mask is None else mask.flip(1), training=training)
        yb = yb.flip(1)
        m = self.mode.lower()
        if m == "concat":
            return torch.cat([yf, yb], dim=-1), state
        if m == "add":
            return yf + yb, state
        if m == "mul":
            return yf * yb, state
        if m in ("ave", "average"):
            return (yf + yb) / 2, state
        raise ValueError(f"unknown Bidirectional mode {self.mode}")

    def output_shape(self, input_shape):
        t, f = self.layer.output_shape(input_shape)
        return (t, 2 * f) if self.mode.lower() == "concat" else (t, f)

    def to_dict(self):
        d = super().to_dict()
        d["layer"] = self.layer.to_dict()
        return d


@register_layer
@dataclasses.dataclass(frozen=True)
class ConvLSTM2D(Layer):
    """Convolutional LSTM over image sequences (Shi et al. 2015; Keras
    ConvLSTM2D; reference ``:369``): (B, T, H, W, C) -> (B, T, H', W', F),
    or the final h (B, H', W', F) without ``return_sequences``. The input
    convolution runs once over the B*T images; each step adds the
    recurrent convolution of h (stride 1, SAME, so the spatial size stays).
    Gate order [i, f, o, g]; a (B, T) mask passes the state through."""

    n_in: int = 0
    n_out: int = 0  # filters
    kernel_size: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    padding: Any = "SAME"  # the input convolution's; the recurrent is SAME
    activation: str = "tanh"
    gate_activation: str = "sigmoid"
    weight_init: str = "xavier"
    return_sequences: bool = True
    forget_gate_bias_init: float = 1.0

    def initialize(self, gen, input_shape):
        c_in = self.n_in or input_shape[-1]
        kh, kw = self.kernel_size
        f = self.n_out
        b = torch.zeros((4 * f,))
        b[f:2 * f] = self.forget_gate_bias_init
        return {
            "W": winit.init(gen, self.weight_init, (kh, kw, c_in, 4 * f)),
            "U": winit.init(gen, self.weight_init, (kh, kw, f, 4 * f)),
            "b": b,
        }, {}

    def apply(self, params, state, x, *, training=False, gen=None,
              mask=None):
        x = self._maybe_dropout(x, training, gen)
        bsz, steps = x.shape[:2]
        f_act = act.resolve(self.activation)
        g_act = act.resolve(self.gate_activation)
        xp = nnops.conv2d(x.reshape((bsz * steps,) + tuple(x.shape[2:])),
                          params["W"].to(x.dtype), params["b"].to(x.dtype),
                          strides=self.stride, padding=self.padding)
        xp = xp.reshape((bsz, steps) + tuple(xp.shape[1:]))
        u = params["U"].to(x.dtype)
        h = x.new_zeros((bsz,) + tuple(xp.shape[2:4]) + (self.n_out,))
        c = torch.zeros_like(h)
        ys = []
        for t in range(steps):
            z = xp[:, t] + nnops.conv2d(h, u, None, strides=(1, 1),
                                        padding="SAME")
            i, fg, o, g = z.chunk(4, dim=-1)
            c_new = g_act(fg) * c + g_act(i) * f_act(g)
            h_new = g_act(o) * f_act(c_new)
            if mask is None:
                h, c = h_new, c_new
                ys.append(h_new)
                continue
            m = mask[:, t].reshape(bsz, 1, 1, 1).to(h_new.dtype)
            h, c = m * h_new + (1 - m) * h, m * c_new + (1 - m) * c
            ys.append(m * h_new)
        if not self.return_sequences:
            return h, state
        return torch.stack(ys, dim=1), state

    def output_shape(self, input_shape):
        t, h, w, _ = input_shape
        sh, sw = self.stride
        kh, kw = self.kernel_size
        if self.padding == "SAME":
            oh, ow = -(-h // sh), -(-w // sw)
        else:  # VALID
            oh, ow = (h - kh) // sh + 1, (w - kw) // sw + 1
        if not self.return_sequences:
            return (oh, ow, self.n_out)
        return (t, oh, ow, self.n_out)


@register_layer
@dataclasses.dataclass(frozen=True)
class LastTimeStep(Layer):
    """The last real step of (B, T, F) -> (B, F) (conf/layers/recurrent/
    LastTimeStep.java; reference ``:458``): under a (B, T) mask, the step
    at index (number of real steps - 1), at least 0."""

    def apply(self, params, state, x, *, training=False, gen=None,
              mask=None):
        if mask is None:
            return x[:, -1, :], state
        idx = torch.clamp(mask.sum(dim=1).to(torch.int64) - 1, min=0)
        return x[torch.arange(x.shape[0], device=x.device), idx, :], state

    def output_shape(self, input_shape):
        return (input_shape[-1],)


@register_layer
@dataclasses.dataclass(frozen=True)
class RnnOutputLayer(Layer):
    """Per-timestep dense + loss head (conf/layers/RnnOutputLayer.java).
    The loss is averaged over (batch, time), honouring the label mask and
    the per-example weights together."""

    n_in: int = 0
    n_out: int = 0
    loss: str = "mcxent"
    activation: str = "softmax"
    weight_init: str = "xavier"

    def initialize(self, gen, input_shape):
        n_in = self.n_in or input_shape[-1]
        return {
            "W": winit.init(gen, self.weight_init, (n_in, self.n_out)),
            "b": torch.zeros((self.n_out,)),
        }, {}

    def _logits(self, params, x):
        return torch.matmul(x, params["W"].to(x.dtype)) + params["b"].to(
            x.dtype)

    def apply(self, params, state, x, *, training=False, gen=None,
              mask=None):
        return act.resolve(self.activation)(self._logits(params, x)), state

    def compute_loss(self, params, state, x, labels, *, training=True,
                     gen=None, weights=None, mask=None):
        x = self._maybe_dropout(x, training, gen)
        logits = self._logits(params, x)
        logits_fn, act_fn, fused_act = losses_mod.resolve(self.loss)
        w = _merge_loss_weights(weights, mask)
        if logits_fn is not None and fused_act == self.activation.lower():
            return logits_fn(logits, labels, w)
        if act_fn is None:
            raise ValueError(f"loss {self.loss} requires activation "
                             f"{fused_act}")
        return act_fn(act.resolve(self.activation)(logits), labels,
                      weights=w)

    def output_shape(self, input_shape):
        return (input_shape[0], self.n_out)


@register_layer
@dataclasses.dataclass(frozen=True)
class RnnLossLayer(Layer):
    """Loss-only RNN head (conf/layers/RnnLossLayer.java; reference
    ``:520``): the activation of its input, and the loss of it per step,
    under the label mask and the row weights together."""

    loss: str = "mcxent"
    activation: str = "softmax"

    def apply(self, params, state, x, *, training=False, gen=None,
              mask=None):
        return act.resolve(self.activation)(x), state

    def compute_loss(self, params, state, x, labels, *, training=True,
                     gen=None, weights=None, mask=None):
        logits_fn, act_fn, fused_act = losses_mod.resolve(self.loss)
        w = _merge_loss_weights(weights, mask)
        if logits_fn is not None and fused_act == self.activation.lower():
            return logits_fn(x, labels, w)
        if act_fn is None:
            raise ValueError(f"loss {self.loss} requires activation "
                             f"{fused_act}")
        return act_fn(act.resolve(self.activation)(x), labels, weights=w)

    def output_shape(self, input_shape):
        return tuple(input_shape)


@register_layer
@dataclasses.dataclass(frozen=True)
class GravesBidirectionalLSTM(Layer):
    """conf/layers/GravesBidirectionalLSTM.java (reference ``:549``):
    Bidirectional(GravesLSTM) with concat. Its ``dropout`` goes to the
    inner GravesLSTM, whose ``apply_seq`` never applies it, and the
    wrapping Bidirectional keeps 0.0: the reference's behaviour, mirrored
    (ROADMAP.md Queue 3)."""

    n_in: int = 0
    n_out: int = 0
    activation: str = "tanh"
    gate_activation: str = "sigmoid"
    weight_init: str = "xavier"

    def _inner(self):
        cell = GravesLSTM(
            n_in=self.n_in, n_out=self.n_out, activation=self.activation,
            gate_activation=self.gate_activation,
            weight_init=self.weight_init, dropout=self.dropout)
        return Bidirectional(layer=cell, mode="concat")

    def initialize(self, gen, input_shape):
        return self._inner().initialize(gen, input_shape)

    def apply(self, params, state, x, *, training=False, gen=None,
              mask=None):
        return self._inner().apply(params, state, x, training=training,
                                   gen=gen, mask=mask)

    def output_shape(self, input_shape):
        return self._inner().output_shape(input_shape)
