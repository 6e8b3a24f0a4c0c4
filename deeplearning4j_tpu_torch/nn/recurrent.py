"""Recurrent layers: LSTM and the per-timestep output head (counterpart of
deeplearning4j_tpu/nn/recurrent.py).

As in the reference:

- data is (B, T, F); the recurrence walks the time axis with the input
  projection ``x @ W + b`` for all T hoisted out of the loop into one
  matrix product;
- ``apply_seq`` takes and returns the carry, for truncated BPTT and
  stateful ``rnn_time_step``; ``init_carry`` is the zero state;
- a (B, T) mask passes the previous state through a masked step unchanged
  and zeroes that step's output;
- the LSTM's gate order is [i, f, o, g], the forget-gate bias starts at
  ``forget_gate_bias_init``.

The LSTM dispatches like every kernel of the port
(``ops/kernels/__init__.py``): on a CUDA tensor under ``auto`` or ``cuda``
each ``apply_seq`` call (a TBPTT segment, or one ``rnn_time_step``) is one
launch of the segment kernel (``csrc/lstm_seq.cu``, K4 over all T steps,
mask included) through ``LSTMSequenceFunction``, or raises when the cell
has no kernel (activations other than sigmoid/tanh, types other than
fp32/bf16); ``exact`` and a CPU tensor under ``auto`` take the reference's
plain step in ``_scan``, in the input's type, and autograd differentiates
through that time loop.

Not ported yet (ROADMAP.md Queue 1 item 14): GravesLSTM, GRU, SimpleRnn,
Bidirectional, GravesBidirectionalLSTM, ConvLSTM2D, LastTimeStep and
RnnLossLayer.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn import activations as act
from deeplearning4j_tpu_torch.nn import losses as losses_mod
from deeplearning4j_tpu_torch.nn import weights as winit
from deeplearning4j_tpu_torch.nn.layers import Layer, register_layer
from deeplearning4j_tpu_torch.ops import kernels as _kern
from deeplearning4j_tpu_torch.ops.kernels import lstm as _klstm


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
        step keeps the old carry and outputs zeros."""
        ys = []
        masks = None if mask is None else mask.unbind(1)
        for t, xt in enumerate(x.unbind(1)):
            new_c, y = step(carry, xt)
            if masks is not None:
                m = masks[t][:, None].to(y.dtype)
                new_c = tuple(m * n + (1 - m) * o
                              for n, o in zip(new_c, carry))
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
                             f"{self.activation}")):
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
