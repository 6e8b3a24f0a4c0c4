"""Fused LSTM cell on a hand-written CUDA kernel, its plain version and its
autograd Function.

Counterpart of deeplearning4j_tpu/ops/kernels/lstm.py: the TPU kernel
``_cell_kernel`` (launched by ``_cell_pallas``) becomes ``csrc/lstm_cell.cu``
(one block per tile of batch rows x hidden units, all four gate columns of
each unit, the gates and the state update in the block's epilogue; fp32
sums, FMA on the CUDA cores for both types). :func:`lstm_cell_fwd` launches
it on CUDA tensors and takes :func:`lstm_cell_reference` only for tensors
on the CPU.

One step, for xp (B, 4H) (the hoisted input projection plus bias of one
time step), h, c (B, H) and U (H, 4H):

- ``z = xp + h @ U`` in fp32 (float64 stays float64 in the plain version);
- the gate split by a gate order, :data:`ORDER_IFOG` (``nn/recurrent.py``'s
  layers) or :data:`ORDER_IOFG` (the ONNX ``lstm_layer`` op);
- ``c' = sigmoid(f) * c + sigmoid(i) * tanh(g)``,
  ``h' = sigmoid(o) * tanh(c')``, returned in xp's type.

:class:`LSTMCellFunction` is the differentiable step: its forward is the
wrapper (the kernel on the card, the plain version on the CPU); its
backward recomputes the gates with the plain cell and applies the
reference's adjoint ``_cell_vjp_bwd`` in PyTorch. That backward is no
fallback: the reference's is jnp too, outside any Pallas kernel.

Not carried over from the TPU module: the lane rule of ``supports``
(compiled Mosaic wants H a multiple of 128; the CUDA kernel masks any H),
the VMEM guard ``fits_vmem`` (it sizes a TPU program holding the whole
batch block and U in VMEM; the CUDA kernel streams U through shared memory
in chunks, so no cell is too large for it), and the ``b_tile`` knob with
``valid_b_tile``/``valid_b_tiles``/``shape_signature`` (the TPU tuning
database's batch tile; the CUDA kernel's tile is fixed by its launch
geometry).
"""

from __future__ import annotations

from typing import Tuple

import torch

from deeplearning4j_tpu_torch.ops import kernels as _kern
from deeplearning4j_tpu_torch.ops.kernels import _build

ORDER_IFOG: Tuple[str, ...] = ("i", "f", "o", "g")   # DL4J layer order
ORDER_IOFG: Tuple[str, ...] = ("i", "o", "f", "g")   # ONNX lstm_layer order
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def supports(xp, u, gate_activation: str, activation: str) -> bool:
    """Kernel gate: the default sigmoid/tanh cell, xp (B, 4H) and U
    (H, 4H) of one type, fp32 or bf16."""
    if gate_activation.lower() != "sigmoid" or activation.lower() != "tanh":
        return False
    if xp.dtype not in _KERNEL_DTYPES or u.dtype != xp.dtype:
        return False
    if xp.dim() != 2 or u.dim() != 2:
        return False
    h = u.shape[0]
    return u.shape[1] == 4 * h and xp.shape[1] == 4 * h


def _describe(xp, h, c, u):
    return (f"xp {tuple(xp.shape)} {xp.dtype}, h {tuple(h.shape)} {h.dtype}, "
            f"c {tuple(c.shape)} {c.dtype}, U {tuple(u.shape)} {u.dtype}")


def _acc(t):
    """``t`` in its accumulation type: fp32, or float64 for float64."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _gates(z, hidden, order):
    """Slice z (..., 4H) into the i/f/o/g roles by ``order``."""
    blocks = z.split(hidden, dim=-1)
    return tuple(blocks[order.index(r)] for r in ("i", "f", "o", "g"))


def _cell_exact(xp, h, c, u, order):
    """The reference's ``_cell_exact``: the step in fp32 (float64 kept);
    returns (h', c', (i, f, o, g)) unrounded, the backward's recompute."""
    z = _acc(xp) + torch.matmul(_acc(h), _acc(u))
    zi, zf, zo, zg = _gates(z, h.shape[-1], order)
    i, f, o = torch.sigmoid(zi), torch.sigmoid(zf), torch.sigmoid(zo)
    g = torch.tanh(zg)
    c_new = f * _acc(c) + i * g
    return o * torch.tanh(c_new), c_new, (i, f, o, g)


def lstm_cell_reference(xp, h, c, u, order=ORDER_IFOG):
    """Plain PyTorch version of the kernel: (h', c') in xp's type, as the
    reference's ``_cell_fwd_impl`` returns them."""
    h_new, c_new, _ = _cell_exact(xp, h, c, u, order)
    return h_new.to(xp.dtype), c_new.to(xp.dtype)


def _check_cuda(xp, h, c, u):
    devs = {t.device for t in (xp, h, c, u)}
    if len(devs) != 1 or not xp.is_cuda:
        raise ValueError(f"lstm_cell_fwd: tensors on {sorted(map(str, devs))}"
                         "; all must be on one CUDA device")


def lstm_cell_fwd(xp, h, c, u, order=ORDER_IFOG):
    """(h', c') of one LSTM step on the CUDA kernel. ``xp`` may be a strided
    time slice of the (B, T, 4H) projection (its rows contiguous): it is
    read in place, not copied. Tensors on the CPU take
    :func:`lstm_cell_reference`."""
    if all(t.device.type == "cpu" for t in (xp, h, c, u)):
        return lstm_cell_reference(xp, h, c, u, order)
    _check_cuda(xp, h, c, u)
    b, four_h = xp.shape if xp.dim() == 2 else (None, None)
    hidden = u.shape[0]
    if (not supports(xp, u, "sigmoid", "tanh") or h.dtype != xp.dtype
            or c.dtype != xp.dtype or tuple(h.shape) != (b, hidden)
            or tuple(c.shape) != (b, hidden) or sorted(order) != sorted(
                ORDER_IFOG)):
        raise ValueError(f"lstm_cell_fwd: unsupported "
                         f"{_describe(xp, h, c, u)}, order {order}")
    h_out = torch.empty((b, hidden), dtype=xp.dtype, device=xp.device)
    c_out = torch.empty_like(h_out)
    if b == 0 or hidden == 0:
        return h_out, c_out
    if xp.stride(1) != 1:
        xp = xp.contiguous()
    h, c, u = h.contiguous(), c.contiguous(), u.contiguous()
    stride = xp.stride(0) if b > 1 else four_h
    cols = [order.index(r) for r in ("i", "f", "o", "g")]
    lib = _build.load()
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream(xp.device).cuda_stream
        rc = lib.dl4j_lstm_cell_fwd(
            xp.data_ptr(), h.data_ptr(), c.data_ptr(), u.data_ptr(),
            h_out.data_ptr(), c_out.data_ptr(), _KERNEL_DTYPES[xp.dtype], b,
            hidden, stride, *cols, stream)
    _build.check(rc, "lstm_cell_fwd launch")
    _kern.LAUNCHES["lstm_cell_fwd"] += 1
    return h_out, c_out


class LSTMCellFunction(torch.autograd.Function):
    """One differentiable LSTM step (the reference's ``lstm_cell_fused``
    custom VJP): forward through :func:`lstm_cell_fwd`, backward by the
    reference's adjoint from the saved (xp, h, c, U)."""

    @staticmethod
    def forward(ctx, xp, h, c, u, order):
        h_new, c_new = lstm_cell_fwd(xp, h, c, u, order)
        ctx.save_for_backward(xp, h, c, u)
        ctx.order = order
        return h_new, c_new

    @staticmethod
    def backward(ctx, dh, dc):
        """``_cell_vjp_bwd``: dxp in xp's type, dh_prev and dc_prev in the
        state's, dU in U's."""
        xp, h, c, u = ctx.saved_tensors
        order = ctx.order
        dh, dc = _acc(dh), _acc(dc)
        _, c_new, (i, f, o, g) = _cell_exact(xp, h, c, u, order)
        tc = torch.tanh(c_new)
        d_o = dh * tc * o * (1.0 - o)
        dct = dc + dh * o * (1.0 - tc * tc)
        d_f = dct * _acc(c) * f * (1.0 - f)
        d_i = dct * g * i * (1.0 - i)
        d_g = dct * i * (1.0 - g * g)
        parts = {"i": d_i, "f": d_f, "o": d_o, "g": d_g}
        dz = torch.cat([parts[r] for r in order], dim=-1)
        dxp = dz.to(xp.dtype)
        dh_prev = torch.matmul(dz, _acc(u).transpose(0, 1)).to(h.dtype)
        dc_prev = (dct * f).to(c.dtype)
        du = torch.matmul(_acc(h).transpose(0, 1), dz).to(u.dtype)
        return dxp, dh_prev, dc_prev, du, None


def lstm_cell(xp, h, c, u, order=ORDER_IFOG):
    """The differentiable step: (h', c') = :class:`LSTMCellFunction`."""
    return LSTMCellFunction.apply(xp, h, c, u, tuple(order))


def lstm_sequence(xp, h0, c0, u, order=ORDER_IFOG):
    """Whole-sequence path (the reference's ``lstm_sequence_fused``): ``xp``
    (T, B, 4H) time-major, states (B, H); one :func:`lstm_cell` per step.
    Returns (ys (T, B, H), (h_fin, c_fin)). Masks and TBPTT stay with the
    callers, as in the reference."""
    h, c, ys = h0, c0, []
    for xt in xp.unbind(0):
        h, c = lstm_cell(xt, h, c, u, order)
        ys.append(h)
    return torch.stack(ys), (h, c)
