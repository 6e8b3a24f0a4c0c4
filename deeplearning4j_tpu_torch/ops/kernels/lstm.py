"""Fused LSTM cell and LSTM segment on hand-written CUDA kernels, their
plain versions and their autograd Functions.

Counterpart of deeplearning4j_tpu/ops/kernels/lstm.py: the TPU kernel
``_cell_kernel`` (launched by ``_cell_pallas``) becomes two entries.

- One step: ``csrc/lstm_cell.cu`` (one block per tile of batch rows x hidden
  units, all four gate columns of each unit, the gates and the state update
  in the block's epilogue; fp32 sums, FMA on the CUDA cores for both
  types). :func:`lstm_cell_fwd` launches it on CUDA tensors and takes
  :func:`lstm_cell_reference` only for tensors on the CPU.
- A whole TBPTT segment, the cell composed over T steps as the reference's
  ``lstm_sequence_fused`` and layer scan run it, with ``_scan``'s mask rule:
  ``csrc/lstm_seq.cu``, one launch per segment. Its resident body keeps U in
  a 16-block thread-block cluster's shared memory for the whole segment and
  exchanges h through distributed shared memory, bf16 products on the
  tensor cores (mma.sync), fp32 on FMA; where that body does not fit
  (:func:`seq_body`), its step body launches the cell kernel once per step.
  :func:`lstm_seq_fwd` launches it on CUDA tensors and takes
  :func:`lstm_seq_reference` only for tensors on the CPU.

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
:class:`LSTMSequenceFunction` is the differentiable segment: its forward is
:func:`lstm_seq_fwd`, its backward the same adjoint in reverse time with
everything that does not depend on the time chain hoisted out of it (the
gates of every step from one product, dU from one product over T x B).

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

import ctypes
import functools
from typing import Tuple

import torch

from deeplearning4j_tpu_torch.ops import kernels as _kern
from deeplearning4j_tpu_torch.ops.kernels import _build

ORDER_IFOG: Tuple[str, ...] = ("i", "f", "o", "g")   # DL4J layer order
ORDER_IOFG: Tuple[str, ...] = ("i", "o", "f", "g")   # ONNX lstm_layer order
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: why the raw launches refuse inputs that need a gradient: they write
#: their outputs through ctypes, so those would carry no grad_fn and
#: training would silently get no gradient through the LSTM
RAW_LAUNCH_NO_GRAD = (
    "{} is the raw kernel launch and has no backward: call it on inputs "
    "that require grad through its autograd Function ({})")


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
    :func:`lstm_cell_reference`. On the card it raises
    :data:`RAW_LAUNCH_NO_GRAD` when grad is enabled and an input requires
    grad: :class:`LSTMCellFunction` launches it under no-grad."""
    if all(t.device.type == "cpu" for t in (xp, h, c, u)):
        return lstm_cell_reference(xp, h, c, u, order)
    _check_cuda(xp, h, c, u)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (xp, h, c, u)):
        raise NotImplementedError(RAW_LAUNCH_NO_GRAD.format(
            "lstm_cell_fwd", "LSTMCellFunction, or lstm_cell"))
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


# ---------------------------------------------------------------------------
# the segment: K4 over T steps in one launch (csrc/lstm_seq.cu)
# ---------------------------------------------------------------------------

#: csrc/lstm_seq.cu's constants, mirrored for :func:`seq_body` (the CPU
#: tests read them from the source): blocks of a cluster, batch rows a
#: cluster carries at most, hidden units a block owns at most, and the
#: dynamic shared memory of one block on sm_90
SEQ_CLUSTER = 16
SEQ_ROWS = 8
SEQ_MAX_UNITS = 32
SEQ_SMEM_MAX = 232448
SEQ_THREADS = 256
#: the bodies of the segment entry, by the code its plan reports
SEQ_BODIES = ("step", "resident")


def seq_rows(b: int) -> int:
    """Batch rows one cluster of the resident body carries for a batch of
    ``b`` (a power of two from 8 to :data:`SEQ_ROWS`; more rows take more
    clusters: B 32 runs as four clusters)."""
    r = 8
    while r < b and r < SEQ_ROWS:
        r *= 2
    return r


def k_slices(es: int, j: int, r: int) -> int:
    """Slices of K whose fp32 partial sums meet in the resident body's z
    exchange: the bf16 warps' two halves; in fp32 as many as give each of
    :data:`SEQ_THREADS` threads one 4 x 4 tile of the J x R / 4 tiles."""
    return 2 if es == 2 else SEQ_THREADS * 4 // (j * r)


def resident_smem(es: int, h: int, r: int) -> int:
    """Dynamic shared memory of one resident block: U's 4J columns
    (H x 4J), two h buffers (H x R), the z exchange (a buffer of R x
    (4J + 4) fp32 a slice of K) and the block's slice of h (J x R),
    J = H / :data:`SEQ_CLUSTER`."""
    j = h // SEQ_CLUSTER
    return (h * 4 * j * es + 2 * h * r * es
            + k_slices(es, j, r) * r * (4 * j + 4) * 4 + j * r * es)


def seq_body(dtype, b: int, h: int) -> str:
    """The body ``csrc/lstm_seq.cu``'s ``pick_body`` runs for a segment of
    batch ``b`` and ``h`` units: ``resident`` where H is a multiple of
    16 x :data:`SEQ_CLUSTER`, J = H / 16 is at most :data:`SEQ_MAX_UNITS`
    and :func:`resident_smem` is within :data:`SEQ_SMEM_MAX` (H 256 and 512
    in bf16, H 256 in fp32, at any B), else ``step``. T does not enter."""
    if (dtype not in _KERNEL_DTYPES or h % (SEQ_CLUSTER * 16)
            or h // SEQ_CLUSTER > SEQ_MAX_UNITS):
        return "step"
    es = 4 if dtype == torch.float32 else 2
    return ("resident" if resident_smem(es, h, seq_rows(b)) <= SEQ_SMEM_MAX
            else "step")


def lstm_seq_reference(xp, h0, c0, u, order=ORDER_IFOG, mask=None):
    """Plain PyTorch version of the segment entry: :func:`lstm_cell_reference`
    over the T steps of ``xp`` (B, T, 4H) with ``_scan``'s mask rule in xp's
    type (a step with mask m keeps ``m * new + (1 - m) * old`` of each carry
    and outputs ``m * h'``). Returns (y, h carries, c carries) (B, T, H) and
    the final (h, c) (B, H); without a mask the h carries are y itself."""
    m = None if mask is None else mask.to(xp.dtype)
    h, c, ys, hs, cs = h0, c0, [], [], []
    for t in range(xp.shape[1]):
        hn, cn = lstm_cell_reference(xp[:, t], h, c, u, order)
        y = hn
        if m is not None:
            mt = m[:, t, None]
            y = mt * hn
            hn = mt * hn + (1 - mt) * h
            cn = mt * cn + (1 - mt) * c
        h, c = hn, cn
        ys.append(y)
        hs.append(h)
        cs.append(c)
    y = torch.stack(ys, dim=1)
    return y, (y if m is None else torch.stack(hs, dim=1)), \
        torch.stack(cs, dim=1), h, c


@functools.lru_cache(maxsize=None)
def seq_plan(device_index, code, b, h, body_req):
    """The body of one segment launch, as the kernel library's
    ``dl4j_lstm_seq_plan`` reports it on this card; raises where its body is
    not :func:`seq_body`'s (``body_req`` -1) or where no cluster of the
    resident body can be resident on the card. Cached per geometry, so a
    segment's launch makes no plan call."""
    out = [ctypes.c_int(0) for _ in range(5)]
    with torch.cuda.device(device_index):
        rc = _build.load().dl4j_lstm_seq_plan(code, b, h, body_req,
                                              *map(ctypes.byref, out))
    _build.check(rc, "dl4j_lstm_seq_plan")
    body, _, _, smem, active = (v.value for v in out)
    name = SEQ_BODIES[body]
    dtype = torch.float32 if code == 0 else torch.bfloat16
    if body_req < 0 and name != seq_body(dtype, b, h):
        raise RuntimeError(f"csrc/lstm_seq.cu picked {name} where lstm.py's "
                           f"seq_body says {seq_body(dtype, b, h)}")
    if name == "resident" and active < 1:
        raise RuntimeError(
            f"lstm_seq_fwd: a cluster of {SEQ_CLUSTER} blocks with {smem} "
            "bytes of shared memory each cannot be scheduled on "
            f"{torch.cuda.get_device_name(device_index)}")
    return name


def lstm_seq_fwd(xp, h0, c0, u, order=ORDER_IFOG, mask=None, body=None):
    """One LSTM segment on the CUDA kernel: ``xp`` (B, T, 4H) (read in place
    at its strides; each row's 4H contiguous), states (B, H), U (H, 4H), an
    optional (B, T) mask (any float type; cast to xp's, as ``_scan`` casts
    it). ``body`` forces ``"resident"`` or ``"step"`` (the resident body
    must fit); None takes :func:`seq_body`'s. Returns (y, h carries, c
    carries, h_fin, c_fin) as :func:`lstm_seq_reference` does. Tensors on
    the CPU take :func:`lstm_seq_reference`. On the card it raises
    :data:`RAW_LAUNCH_NO_GRAD` when grad is enabled and an input requires
    grad: :class:`LSTMSequenceFunction` launches it under no-grad."""
    tensors = [t for t in (xp, h0, c0, u, mask) if t is not None]
    if all(t.device.type == "cpu" for t in tensors):
        return lstm_seq_reference(xp, h0, c0, u, order, mask)
    devs = {t.device for t in tensors}
    if len(devs) != 1 or not xp.is_cuda:
        raise ValueError(f"lstm_seq_fwd: tensors on {sorted(map(str, devs))}"
                         "; all must be on one CUDA device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(RAW_LAUNCH_NO_GRAD.format(
            "lstm_seq_fwd", "LSTMSequenceFunction, or lstm_seq"))
    hidden = u.shape[0] if u.dim() == 2 else None
    b, steps = xp.shape[:2] if xp.dim() == 3 else (None, None)
    if (xp.dim() != 3 or not supports(xp[:, 0], u, "sigmoid", "tanh")
            or h0.dtype != xp.dtype or c0.dtype != xp.dtype
            or tuple(h0.shape) != (b, hidden)
            or tuple(c0.shape) != (b, hidden)
            or sorted(order) != sorted(ORDER_IFOG) or steps < 1 or b < 1
            or (mask is not None and tuple(mask.shape) != (b, steps))
            or body not in (None, *SEQ_BODIES)):
        raise ValueError(
            f"lstm_seq_fwd: unsupported xp {tuple(xp.shape)} {xp.dtype}, "
            f"{_describe(xp[:, 0] if xp.dim() == 3 else xp, h0, c0, u)}, "
            f"mask {None if mask is None else tuple(mask.shape)}, order "
            f"{order}, body {body}")
    dt, dev = xp.dtype, xp.device
    y = torch.empty((b, steps, hidden), dtype=dt, device=dev)
    cseq = torch.empty_like(y)
    hseq = y if mask is None else torch.empty_like(y)
    h_fin = torch.empty((b, hidden), dtype=dt, device=dev)
    c_fin = torch.empty_like(h_fin)
    if xp.stride(2) != 1:
        xp = xp.contiguous()
    h0, c0, u = h0.contiguous(), c0.contiguous(), u.contiguous()
    if u.data_ptr() % 16:  # the resident body copies U in 16-byte pieces
        u = u.clone()
    if mask is not None:
        mask = mask.to(dt).contiguous()
    code = _KERNEL_DTYPES[dt]
    name = seq_plan(dev.index if dev.index is not None
                             else torch.cuda.current_device(), code, b,
                             hidden, -1 if body is None
                             else SEQ_BODIES.index(body))
    cols = [order.index(r) for r in ("i", "f", "o", "g")]
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dl4j_lstm_seq_fwd(
            xp.data_ptr(), h0.data_ptr(), c0.data_ptr(), u.data_ptr(),
            None if mask is None else mask.data_ptr(), y.data_ptr(),
            None if mask is None else hseq.data_ptr(), cseq.data_ptr(),
            h_fin.data_ptr(), c_fin.data_ptr(), code, b, hidden, steps,
            max(xp.stride(0), 1), max(xp.stride(1), 1), *cols,
            SEQ_BODIES.index(name), stream)
    _build.check(rc, f"lstm_seq_fwd launch ({name} body)")
    _kern.LAUNCHES["lstm_seq_fwd"] += 1
    key = f"lstm_seq_fwd/{name}"
    _kern.BODY_LAUNCHES[key] = _kern.BODY_LAUNCHES.get(key, 0) + 1
    return y, hseq, cseq, h_fin, c_fin


class LSTMSequenceFunction(torch.autograd.Function):
    """One differentiable LSTM segment, mask included (the reference's layer
    scan of ``lstm_cell_fused`` steps): forward through :func:`lstm_seq_fwd`,
    backward by the reference's adjoint ``_cell_vjp_bwd`` in reverse time
    from the saved xp, states, U, carries and mask. Its per-step output is
    y (``m * h'``, the layers' scan), or with ``carries`` the h carries
    (the frozen h past a sequence's end, ``ops/rnn.py::lstm_layer``'s Y)."""

    @staticmethod
    def forward(ctx, xp, h0, c0, u, mask, order, carries=False):
        y, hseq, cseq, h_fin, c_fin = lstm_seq_fwd(xp, h0, c0, u, order, mask)
        ctx.save_for_backward(xp, h0, c0, u, hseq, cseq, mask)
        ctx.order, ctx.carries = order, carries
        return (hseq if carries else y), h_fin, c_fin

    @staticmethod
    def backward(ctx, dy, dh_fin, dc_fin):
        """``_cell_vjp_bwd`` per step, chained in reverse through the carries
        and the mask's passthrough (h_t = m h'_t + (1 - m) h_{t-1}, y_t =
        m h'_t; with ``carries`` the output is h_t itself, so its cotangent
        joins the carry's and passes through with it). Off the chain: the
        gates of every step from one product H_prev (T x B, H) @ U, dU =
        H_prev^T @ dZ, dxp = dZ. On it, per step: dct, the gate adjoints and
        dz_t @ U^T. dxp in xp's type, dh0 and dc0 in the states', dU in
        U's."""
        xp, h0, c0, u, hseq, cseq, mask = ctx.saved_tensors
        order, carries = ctx.order, ctx.carries
        b, steps, hidden = hseq.shape
        hs, cs = _acc(hseq).transpose(0, 1), _acc(cseq).transpose(0, 1)
        h_prev = torch.cat([_acc(h0)[None], hs[:-1]])       # (T, B, H)
        c_prev = torch.cat([_acc(c0)[None], cs[:-1]])
        ua = _acc(u)
        z = _acc(xp).transpose(0, 1) + torch.matmul(h_prev, ua)
        zi, zf, zo, zg = _gates(z, hidden, order)
        i, f, o = torch.sigmoid(zi), torch.sigmoid(zf), torch.sigmoid(zo)
        g = torch.tanh(zg)
        tc = torch.tanh(f * c_prev + i * g)
        a_o = tc * o * (1.0 - o)            # d_o = dh' * a_o
        a_c = o * (1.0 - tc * tc)           # dct = dc' + dh' * a_c
        # dz's blocks by dct (i, f, g) and by dh' (o), at z's column blocks
        k_c = torch.zeros((steps, b, 4, hidden), dtype=z.dtype,
                          device=z.device)
        k_c[:, :, order.index("i")] = g * i * (1.0 - i)
        k_c[:, :, order.index("f")] = c_prev * f * (1.0 - f)
        k_c[:, :, order.index("g")] = i * (1.0 - g * g)
        o_at = order.index("o")
        dz = torch.empty_like(k_c)
        m = (None if mask is None
             else _acc(mask.to(xp.dtype)).transpose(0, 1)[..., None])
        dys = _acc(dy).transpose(0, 1)
        dh, dc, u_t = _acc(dh_fin), _acc(dc_fin), ua.transpose(0, 1)
        for t in range(steps - 1, -1, -1):
            dhp, dcp = dys[t] + dh, dc
            if m is not None:
                keep = 1.0 - m[t]
                pass_h, pass_c = keep * (dhp if carries else dh), keep * dc
                dhp, dcp = m[t] * dhp, m[t] * dcp
            dct = torch.addcmul(dcp, dhp, a_c[t])
            torch.mul(dct[:, None], k_c[t], out=dz[t])
            torch.mul(dhp, a_o[t], out=dz[t, :, o_at])
            dh = torch.matmul(dz[t].view(b, 4 * hidden), u_t)
            dc = dct * f[t]
            if m is not None:
                dh, dc = dh + pass_h, dc + pass_c
        dz = dz.view(steps, b, 4 * hidden)
        du = torch.matmul(h_prev.reshape(steps * b, hidden).transpose(0, 1),
                          dz.reshape(steps * b, 4 * hidden))
        return (dz.transpose(0, 1).to(xp.dtype), dh.to(h0.dtype),
                dc.to(c0.dtype), du.to(u.dtype), None, None, None)


def lstm_seq(xp, h0, c0, u, order=ORDER_IFOG, mask=None):
    """The differentiable segment, batch-major: ``xp`` (B, T, 4H), states
    (B, H), an optional (B, T) mask; returns (y (B, T, H), (h_fin, c_fin))
    through :class:`LSTMSequenceFunction`."""
    y, h, c = LSTMSequenceFunction.apply(xp, h0, c0, u, mask, tuple(order))
    return y, (h, c)


def lstm_sequence(xp, h0, c0, u, order=ORDER_IFOG):
    """Whole-sequence path (the reference's ``lstm_sequence_fused``): ``xp``
    (T, B, 4H) time-major, states (B, H); one :func:`lstm_seq` segment.
    Returns (ys (T, B, H), (h_fin, c_fin)). Masks and TBPTT stay with the
    callers, as in the reference."""
    y, state = lstm_seq(xp.transpose(0, 1), h0, c0, u, order)
    return y.transpose(0, 1), state
