"""Recurrent ops: whole-layer LSTM/GRU/RNN scans, the sd.rnn namespace
(counterpart of deeplearning4j_tpu/ops/rnn.py).

Parameterization follows ONNX: stacked per-direction weights, ONNX gate
orders (LSTM ``iofc``, GRU ``zrh``), optional initial states, ``layout`` 0 =
seq-major (T,B,C) / 1 = batch-major (B,T,C).

``lstm_layer`` is the op here with a hand-written kernel: each direction is
one launch of the LSTM segment kernel (``ops/kernels/lstm.py``
``lstm_seq_fwd``, gate order ``ORDER_IOFG``) on the hoisted input
projection, as the reference runs its fused Pallas cell under the scan.
On a CUDA tensor it launches the kernel or raises (a cell the kernel does
not take: other activations, another type); on the CPU or under ``exact``
it takes the plain step loop. ``seq_lens`` freezes a finished sequence's
state (``_mask_step``); a reverse direction walks the whole flipped
sequence with the flipped mask, as the reference's scan does.
``conv_lstm_2d`` reaches the conv kernel through ``ops.nn.conv2d``. The
rest are plain torch loops, as they are jnp scans in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops import _compat as C
from deeplearning4j_tpu_torch.ops import kernels as _kern
from deeplearning4j_tpu_torch.ops import nn as nnops
from deeplearning4j_tpu_torch.ops.kernels import lstm as _klstm
from deeplearning4j_tpu_torch.ops.registry import op


def _act(name):
    return {
        "sigmoid": torch.sigmoid, "tanh": torch.tanh, "relu": torch.relu,
        "identity": (lambda x: x), "softsign": F.softsign,
        "softplus": lambda x: torch.logaddexp(x, torch.zeros_like(x)),
        "hardsigmoid": lambda x: F.relu6(x + 3.0) / 6.0,
        "elu": F.elu, "leakyrelu": F.leaky_relu,
    }[name.lower()]


def _split_b(b, n, h, like):
    """ONNX B is (2n*h,): input-bias block then recurrent-bias block."""
    if b is None:
        z = torch.zeros(n * h, dtype=like.dtype, device=like.device)
        return z, z
    return b[: n * h], b[n * h:]


def _mask_step(new, old, t, seq_lens):
    """Freeze the state of finished sequences (ONNX sequence_lens)."""
    if seq_lens is None:
        return new
    return torch.where((t < seq_lens)[:, None], new, old)


def _scan_dir(step, x_tbc, carry, seq_lens, reverse):
    """``step(carry, x_t, t) -> (carry, y_t)`` over time, flipped for a
    reverse direction; ys stacked in original time order."""
    ts = list(range(x_tbc.shape[0]))
    if reverse:
        ts = ts[::-1]
    ys = [None] * len(ts)
    for t in ts:
        carry, ys[t] = step(carry, x_tbc[t], t)
    return carry, torch.stack(ys)


def _directions(direction):
    direction = direction.lower()
    if direction == "forward":
        return [False]
    if direction == "reverse":
        return [True]
    if direction == "bidirectional":
        return [False, True]
    raise ValueError(f"unknown direction {direction!r}")


def _seq_major(x, layout):
    return x if int(layout) == 0 else x.transpose(0, 1)


def _lens(seq_lens, x):
    return None if seq_lens is None else C.t(seq_lens, x).long().to(x.device)


def _lstm_dir_kernel(xp_all, hd, cd, ud, lens, reverse):
    """One direction on the segment kernel: xp_all (T, B, 4H) with the
    bias folded in, batch-major and flipped for reverse; the mask m[b, t] =
    t < seq_lens[b] in the walk's time order. The kernel's h carries are
    the reference's per-step outputs (the frozen h past a sequence's end).
    Differentiable in xp_all, the states and U, through
    ``LSTMSequenceFunction`` with its carries as the output (the reference's
    adjoint). Returns (ys (T, B, H), h, c)."""
    xp = xp_all.transpose(0, 1)
    steps = xp.shape[1]
    mask = None
    if lens is not None:
        mask = (torch.arange(steps, device=xp.device)[None, :]
                < lens[:, None]).to(xp.dtype)
    if reverse:
        xp = xp.flip(1)
        mask = None if mask is None else mask.flip(1)
    hseq, h_fin, c_fin = _klstm.LSTMSequenceFunction.apply(
        xp, hd, cd, ud, mask, _klstm.ORDER_IOFG, True)
    if reverse:
        hseq = hseq.flip(1)
    return hseq.transpose(0, 1), h_fin, c_fin


@op("lstm_layer", "rnn", aliases=("lstmLayer", "lstm"))
def lstm_layer(x, W, R, b=None, seq_lens=None, h0=None, c0=None, *,
               hidden_size, direction="forward", layout=0,
               gate_activation="sigmoid", activation="tanh"):
    """ONNX-semantics LSTM over a full sequence.

    x: (T,B,I) [layout 0] or (B,T,I) [layout 1]; W: (D, 4H, I); R: (D, 4H,
    H); b: (D, 8H); gate order i,o,f,c. Returns (Y, Y_h, Y_c) with Y
    (T,D,B,H) [layout 0] / (B,T,D,H) [layout 1], Y_h/Y_c (D,B,H) [layout 0]
    / (B,D,H) [layout 1]. Each direction is one launch of the LSTM segment
    kernel on a CUDA tensor (see the module docstring)."""
    h = int(hidden_size)
    x = _seq_major(x, layout)
    if int(layout) == 1:  # ONNX layout=1 states are (B,D,H)
        h0 = None if h0 is None else h0.transpose(0, 1)
        c0 = None if c0 is None else c0.transpose(0, 1)
    steps, bsz = x.shape[0], x.shape[1]
    lens = _lens(seq_lens, x)
    f_g, f_c = _act(gate_activation), _act(activation)
    outs, hs, cs = [], [], []
    for d, reverse in enumerate(_directions(direction)):
        bi, br = _split_b(b[d] if b is not None else None, 4, h, x)
        bias = (bi + br).to(x.dtype)
        hd = (torch.zeros((bsz, h), dtype=x.dtype, device=x.device)
              if h0 is None else h0[d].to(x.dtype))
        cd = (torch.zeros((bsz, h), dtype=x.dtype, device=x.device)
              if c0 is None else c0[d].to(x.dtype))
        ud = R[d].t().to(x.dtype).contiguous()          # (H, 4H)
        launch = _kern.dispatch(
            "lstm_seq_fwd",
            _klstm.supports(torch.empty((1, 4 * h), dtype=x.dtype),
                            ud, gate_activation, activation)
            and steps > 0 and bsz > 0, x,
            lambda: (f"x {tuple(x.shape)} {x.dtype}, hidden {h}, gate "
                     f"activation {gate_activation}, activation "
                     f"{activation}"))
        if launch:
            acc = nnops._acc_dtype(x)
            xp_all = (torch.matmul(x.to(acc), W[d].t().to(acc))
                      + bias.to(acc)).to(x.dtype)
            ys, hd, cd = _lstm_dir_kernel(xp_all, hd, cd, ud, lens, reverse)
        else:
            wd = W[d].t().to(x.dtype)

            def step(carry, xt, t, wd=wd, ud=ud, bias=bias):
                hp, cp = carry
                z = xt @ wd + hp @ ud + bias
                i_g, o_g, f_gate, c_in = z.chunk(4, dim=-1)
                i_g, o_g, f_gate = f_g(i_g), f_g(o_g), f_g(f_gate)
                c_new = f_gate * cp + i_g * f_c(c_in)
                h_new = o_g * f_c(c_new)
                c_new = _mask_step(c_new, cp, t, lens)
                h_new = _mask_step(h_new, hp, t, lens)
                return (h_new, c_new), h_new

            (hd, cd), ys = _scan_dir(step, x, (hd, cd), lens, reverse)
        outs.append(ys)
        hs.append(hd)
        cs.append(cd)
    Y = torch.stack(outs, dim=1)                         # (T, D, B, H)
    Yh, Yc = torch.stack(hs), torch.stack(cs)           # (D, B, H)
    if int(layout) == 1:
        Y = Y.permute(2, 0, 1, 3)
        Yh, Yc = Yh.transpose(0, 1), Yc.transpose(0, 1)
    return Y, Yh, Yc


@op("gru_layer", "rnn", aliases=("gruLayer", "gru"))
def gru_layer(x, W, R, b=None, seq_lens=None, h0=None, *, hidden_size,
              direction="forward", layout=0, linear_before_reset=0,
              gate_activation="sigmoid", activation="tanh"):
    """ONNX-semantics GRU. W: (D, 3H, I); R: (D, 3H, H); b: (D, 6H); gate
    order z,r,h."""
    h = int(hidden_size)
    x = _seq_major(x, layout)
    if int(layout) == 1:
        h0 = None if h0 is None else h0.transpose(0, 1)
    bsz = x.shape[1]
    lens = _lens(seq_lens, x)
    f_g, f_c = _act(gate_activation), _act(activation)
    outs, hs = [], []
    for d, reverse in enumerate(_directions(direction)):
        wd, rd = W[d].t(), R[d].t()
        bi, br = _split_b(b[d] if b is not None else None, 3, h, x)
        bi, br = bi.to(x.dtype), br.to(x.dtype)
        hd = (torch.zeros((bsz, h), dtype=x.dtype, device=x.device)
              if h0 is None else h0[d].to(x.dtype))

        def step(hp, xt, t, wd=wd, rd=rd, bi=bi, br=br):
            xz, xr, xh = (xt @ wd + bi).chunk(3, dim=-1)
            if linear_before_reset:
                hz, hr, hh = (hp @ rd + br).chunk(3, dim=-1)
                z, r = f_g(xz + hz), f_g(xr + hr)
                n = f_c(xh + r * hh)
            else:
                rz, rr, rn = rd.chunk(3, dim=-1)
                bz, brr, bn = br.chunk(3, dim=-1)
                z = f_g(xz + hp @ rz + bz)
                r = f_g(xr + hp @ rr + brr)
                n = f_c(xh + (r * hp) @ rn + bn)
            h_new = _mask_step((1.0 - z) * n + z * hp, hp, t, lens)
            return h_new, h_new

        hd, ys = _scan_dir(step, x, hd, lens, reverse)
        outs.append(ys)
        hs.append(hd)
    Y, Yh = torch.stack(outs, dim=1), torch.stack(hs)
    if int(layout) == 1:
        Y, Yh = Y.permute(2, 0, 1, 3), Yh.transpose(0, 1)
    return Y, Yh


@op("rnn_layer", "rnn", aliases=("simple_rnn",))
def rnn_layer(x, W, R, b=None, seq_lens=None, h0=None, *, hidden_size,
              direction="forward", layout=0, activation="tanh"):
    """ONNX-semantics vanilla RNN. W: (D, H, I); R: (D, H, H); b: (D, 2H)."""
    h = int(hidden_size)
    x = _seq_major(x, layout)
    if int(layout) == 1:
        h0 = None if h0 is None else h0.transpose(0, 1)
    bsz = x.shape[1]
    lens = _lens(seq_lens, x)
    f_c = _act(activation)
    outs, hs = [], []
    for d, reverse in enumerate(_directions(direction)):
        wd, rd = W[d].t(), R[d].t()
        bi, br = _split_b(b[d] if b is not None else None, 1, h, x)
        bias = (bi + br).to(x.dtype)
        hd = (torch.zeros((bsz, h), dtype=x.dtype, device=x.device)
              if h0 is None else h0[d].to(x.dtype))

        def step(hp, xt, t, wd=wd, rd=rd, bias=bias):
            h_new = _mask_step(f_c(xt @ wd + hp @ rd + bias), hp, t, lens)
            return h_new, h_new

        hd, ys = _scan_dir(step, x, hd, lens, reverse)
        outs.append(ys)
        hs.append(hd)
    Y, Yh = torch.stack(outs, dim=1), torch.stack(hs)
    if int(layout) == 1:
        Y, Yh = Y.permute(2, 0, 1, 3), Yh.transpose(0, 1)
    return Y, Yh


@op("lstm_cell", "rnn", aliases=("lstmCell",))
def lstm_cell(x, h_prev, c_prev, W, R, b=None, *, gate_activation="sigmoid",
              activation="tanh"):
    """One LSTM step. x: (B,I); W: (4H,I); R: (4H,H); b: (8H,). Gate order
    i,o,f,c. Returns (h, c)."""
    h = h_prev.shape[-1]
    f_g, f_c = _act(gate_activation), _act(activation)
    bi, br = _split_b(b, 4, h, x)
    z = x @ W.t() + h_prev @ R.t() + (bi + br).to(x.dtype)
    i_g, o_g, f_gate, c_in = z.chunk(4, dim=-1)
    c_new = f_g(f_gate) * c_prev + f_g(i_g) * f_c(c_in)
    return f_g(o_g) * f_c(c_new), c_new


@op("gru_cell", "rnn", aliases=("gruCell",))
def gru_cell(x, h_prev, W, R, b=None, *, linear_before_reset=1,
             gate_activation="sigmoid", activation="tanh"):
    """One GRU step. x: (B,I); W: (3H,I); R: (3H,H); b: (6H,). Order z,r,h."""
    h = h_prev.shape[-1]
    f_g, f_c = _act(gate_activation), _act(activation)
    bi, br = _split_b(b, 3, h, x)
    xz, xr, xh = (x @ W.t() + bi.to(x.dtype)).chunk(3, dim=-1)
    if linear_before_reset:
        hz, hr, hh = (h_prev @ R.t() + br.to(x.dtype)).chunk(3, dim=-1)
        z, r = f_g(xz + hz), f_g(xr + hr)
        n = f_c(xh + r * hh)
    else:
        rz, rr, rn = R.chunk(3, dim=0)
        bz, brr, bn = br.to(x.dtype).chunk(3)
        z = f_g(xz + h_prev @ rz.t() + bz)
        r = f_g(xr + h_prev @ rr.t() + brr)
        n = f_c(xh + (r * h_prev) @ rn.t() + bn)
    return (1.0 - z) * n + z * h_prev


@op("sequence_mask", "rnn", differentiable=False)
def sequence_mask(lengths, maxlen=None, dtype="bool"):
    """lengths (B,) -> (B, maxlen) mask; ``maxlen`` defaults to the
    largest length."""
    lengths = C.t(lengths)
    if maxlen is None:
        maxlen = int(lengths.max()) if lengths.numel() else 0
    r = torch.arange(int(maxlen), device=lengths.device)
    return (r[None, :] < lengths[:, None]).to(C.dtype(dtype))


@op("sru_cell", "rnn", aliases=("sruCell",))
def sru_cell(x, c_prev, W, b):
    """One Simple Recurrent Unit step. x, c_prev: (B, I); W: (3I, I);
    b: (2I,). Returns (h, c)."""
    i = x.shape[-1]
    if tuple(W.shape) != (3 * i, i) or tuple(b.shape) != (2 * i,):
        raise ValueError(
            f"sru_cell expects W (3I,I)={3 * i, i} and b (2I,)={2 * i,}; "
            f"got W {tuple(W.shape)}, b {tuple(b.shape)}")
    zt, f_in, r_in = (x @ W.t().to(x.dtype)).chunk(3, dim=-1)
    bf, br = b.to(x.dtype).chunk(2)
    f = torch.sigmoid(f_in + bf)
    r = torch.sigmoid(r_in + br)
    c = f * c_prev + (1.0 - f) * zt
    return r * torch.tanh(c) + (1.0 - r) * x, c


@op("sru", "rnn", aliases=("sru_layer",))
def sru(x, W, b, c0=None, mask=None, layout=1):
    """Whole-sequence SRU; layout 1 = (B, T, I), 0 = (T, B, I). Returns
    (h_seq, c_final)."""
    if layout == 1:
        x = x.transpose(0, 1)
        if mask is not None:
            mask = mask.transpose(0, 1)
    t, bsz, i = x.shape
    z = (x.reshape(t * bsz, i) @ W.t().to(x.dtype)).reshape(t, bsz, 3 * i)
    zt, f_in, r_in = z.chunk(3, dim=-1)
    bf, br = b.to(x.dtype).chunk(2)
    f = torch.sigmoid(f_in + bf)
    r = torch.sigmoid(r_in + br)
    c = (torch.zeros((bsz, i), dtype=x.dtype, device=x.device) if c0 is None
         else c0.to(x.dtype))
    hs = []
    for s in range(t):
        c_new = f[s] * c + (1.0 - f[s]) * zt[s]
        if mask is not None:
            m = mask[s][:, None].to(c.dtype)
            c_new = m * c_new + (1.0 - m) * c
        h = r[s] * torch.tanh(c_new) + (1.0 - r[s]) * x[s]
        if mask is not None:
            h = h * mask[s][:, None].to(h.dtype)
        c = c_new
        hs.append(h)
    h = torch.stack(hs)
    if layout == 1:
        h = h.transpose(0, 1)
    return h, c


@op("conv_lstm_2d", "rnn", aliases=("convLstm2d",))
def conv_lstm_2d(x, W, U, b=None, h0=None, c0=None, *, stride=(1, 1),
                 padding="SAME", gate_activation="sigmoid",
                 activation="tanh"):
    """Convolutional LSTM over (B, T, H, W, C). W: (kh, kw, Cin, 4F); U:
    (kh, kw, F, 4F) (stride 1, SAME). Gate order [i, f, o, g]. Returns
    (y_seq, (h_fin, c_fin)). The input convolution of every step is one
    ``ops.nn.conv2d`` call over B*T images and the recurrent one a call per
    step: the conv kernel on a CUDA tensor."""
    f_act, g_act = _act(activation), _act(gate_activation)
    bsz, steps = x.shape[:2]
    nf = W.shape[-1] // 4
    xp = nnops.conv2d(x.reshape((bsz * steps,) + tuple(x.shape[2:])),
                      W.to(x.dtype), None if b is None else b.to(x.dtype),
                      strides=stride, padding=padding)
    xp = xp.reshape((bsz, steps) + tuple(xp.shape[1:]))
    zeros = torch.zeros((bsz,) + tuple(xp.shape[2:4]) + (nf,),
                        dtype=x.dtype, device=x.device)
    h = zeros if h0 is None else h0.to(x.dtype)
    c = zeros if c0 is None else c0.to(x.dtype)
    u = U.to(x.dtype)
    ys = []
    for t in range(steps):
        z = xp[:, t] + nnops.conv2d(h, u, None, strides=(1, 1),
                                    padding="SAME")
        i_g, f_g, o_g, g_g = z.chunk(4, dim=-1)
        c = g_act(f_g) * c + g_act(i_g) * f_act(g_g)
        h = g_act(o_g) * f_act(c)
        ys.append(h)
    return torch.stack(ys, dim=1), (h, c)


def _lstm_block_step(xt, cs_prev, h_prev, W, b, wci, wcf, wco, *,
                     forget_bias, cell_clip, use_peephole):
    """One TF BlockLSTM step, gate order i, ci(g), f, o; the seven per-step
    tensors."""
    z = torch.cat([xt, h_prev], dim=1) @ W + b
    i, ci, f, o = z.chunk(4, dim=-1)
    if use_peephole:
        i = i + cs_prev * wci
        f = f + cs_prev * wcf
    i = torch.sigmoid(i)
    f = torch.sigmoid(f + forget_bias)
    ci = torch.tanh(ci)
    cs = ci * i + cs_prev * f
    if cell_clip > 0:
        cs = torch.clamp(cs, -cell_clip, cell_clip)
    if use_peephole:
        o = o + cs * wco
    o = torch.sigmoid(o)
    co = torch.tanh(cs)
    return i, cs, f, o, ci, co, co * o


@op("lstm_block_cell", "rnn", aliases=("lstmBlockCell",))
def lstm_block_cell(x, cs_prev, h_prev, W, wci, wcf, wco, b, *,
                    forget_bias=1.0, cell_clip=-1.0, use_peephole=False):
    """TF LSTMBlockCell: x (B,I); W ((I+H),4H), gate order i,c,f,o. Returns
    (i, cs, f, o, ci, co, h)."""
    return _lstm_block_step(x, cs_prev, h_prev, W, b, wci, wcf, wco,
                            forget_bias=forget_bias, cell_clip=cell_clip,
                            use_peephole=use_peephole)


@op("lstm_block", "rnn", aliases=("lstmBlock", "block_lstm"))
def lstm_block(seq_len_max, x, cs_prev, h_prev, W, wci, wcf, wco, b, *,
               forget_bias=1.0, cell_clip=-1.0, use_peephole=False):
    """TF BlockLSTM over x (T,B,I); steps at or past ``seq_len_max`` emit
    zeros and carry the state through. Returns seven (T,B,H) stacks."""
    limit = int(seq_len_max)
    cs_p, h_p = cs_prev, h_prev
    outs = []
    for t in range(x.shape[0]):
        step = _lstm_block_step(x[t], cs_p, h_p, W, b, wci, wcf, wco,
                                forget_bias=forget_bias, cell_clip=cell_clip,
                                use_peephole=use_peephole)
        if t < limit:
            cs_p, h_p = step[1], step[6]
            outs.append(step)
        else:
            outs.append(tuple(torch.zeros_like(v) for v in step))
    return tuple(torch.stack([o[k] for o in outs]) for k in range(7))


def _simple_rnn_scan(x, Wx, Wh, b, h0, seq_lens):
    """x (T,B,I) -> (ys (T,B,H), h_final); tanh cell, zeros past seq_lens
    and the state frozen."""
    steps, bsz = x.shape[0], x.shape[1]
    hdim = Wx.shape[1]
    Wx, Wh = Wx.to(x.dtype), Wh.to(x.dtype)
    bias = (torch.zeros(hdim, dtype=x.dtype, device=x.device) if b is None
            else b.to(x.dtype))
    h = (torch.zeros((bsz, hdim), dtype=x.dtype, device=x.device)
         if h0 is None else h0.to(x.dtype))
    lens = _lens(seq_lens, x)
    ys = []
    for t in range(steps):
        h_new = torch.tanh(x[t] @ Wx + h @ Wh + bias)
        if lens is not None:
            alive = (t < lens)[:, None]
            h_new = torch.where(alive, h_new, h)
            y = torch.where(alive, h_new, torch.zeros_like(h_new))
        else:
            y = h_new
        h = h_new
        ys.append(y)
    return torch.stack(ys), h


@op("static_rnn", "rnn", aliases=("staticRNN",))
def static_rnn(x, Wx, Wh, b=None, h0=None, seq_lens=None):
    """Simple RNN over (T, B, I). Returns (h_seq, h_final)."""
    return _simple_rnn_scan(x, Wx, Wh, b, h0, seq_lens)


@op("dynamic_rnn", "rnn", aliases=("dynamicRNN",))
def dynamic_rnn(x, Wx, Wh, b=None, h0=None, seq_lens=None, time_major=True):
    """``time_major=False`` takes (B, T, I)."""
    if not time_major:
        x = x.transpose(0, 1)
    ys, h = _simple_rnn_scan(x, Wx, Wh, b, h0, seq_lens)
    return (ys if time_major else ys.transpose(0, 1)), h


def _bidir_rnn(x, fw, bw, seq_lens):
    ys_f, h_f = _simple_rnn_scan(x, *fw, seq_lens)
    if seq_lens is None:
        ys_b, h_b = _simple_rnn_scan(x.flip(0), *bw, None)
        ys_b = ys_b.flip(0)
    else:
        steps = x.shape[0]
        idx = torch.arange(steps, device=x.device)[:, None]
        lens = _lens(seq_lens, x)[None, :]
        rev = torch.where(idx < lens, lens - 1 - idx, idx)   # (T, B)
        xr = torch.gather(x, 0, rev[:, :, None].expand(x.shape))
        ys_b, h_b = _simple_rnn_scan(xr, *bw, seq_lens)
        ys_b = torch.gather(ys_b, 0, rev[:, :, None].expand(ys_b.shape))
    return torch.cat([ys_f, ys_b], dim=-1), (h_f, h_b)


@op("static_bidirectional_rnn", "rnn", aliases=("staticBidirectionalRNN",))
def static_bidirectional_rnn(x, Wx_f, Wh_f, b_f, Wx_b, Wh_b, b_b, h0_f=None,
                             h0_b=None, seq_lens=None):
    """(h_seq (T,B,2H), (h_fw, h_bw))."""
    return _bidir_rnn(x, (Wx_f, Wh_f, b_f, h0_f), (Wx_b, Wh_b, b_b, h0_b),
                      seq_lens)


@op("dynamic_bidirectional_rnn", "rnn",
    aliases=("dynamicBidirectionalRNN",))
def dynamic_bidirectional_rnn(x, Wx_f, Wh_f, b_f, Wx_b, Wh_b, b_b, h0_f=None,
                              h0_b=None, seq_lens=None, time_major=True):
    if not time_major:
        x = x.transpose(0, 1)
    ys, hs = _bidir_rnn(x, (Wx_f, Wh_f, b_f, h0_f), (Wx_b, Wh_b, b_b, h0_b),
                        seq_lens)
    return (ys if time_major else ys.transpose(0, 1)), hs


@op("sru_bi", "rnn", aliases=("sruBI",))
def sru_bi(x, W, b, c0=None, mask=None):
    """Bidirectional SRU: x (T, B, 2I), the feature halves feeding the two
    directions; W (2, 3I, I), b (2, 2I), c0 (2, B, I). Returns
    (h (T, B, 2I), c_final (2, B, I))."""
    i = W.shape[-1]
    xf, xb = x[..., :i], x[..., i:]
    hf, cf = sru(xf, W[0], b[0], None if c0 is None else c0[0], mask,
                 layout=0)
    hb_r, cb = sru(xb.flip(0), W[1], b[1], None if c0 is None else c0[1],
                   None if mask is None else mask.flip(0), layout=0)
    return torch.cat([hf, hb_r.flip(0)], dim=-1), torch.stack([cf, cb])

