"""Flash-attention forward on a hand-written CUDA kernel, with its plain
version.

Counterpart of the flash forward in deeplearning4j_tpu/ops/attention.py: the
TPU kernel ``_flash_fwd_kernel`` (launched by ``_flash_fwd_pallas``) becomes
``csrc/flash_fwd.cu`` (fp32: FMA on the CUDA cores; bf16: Hopper's TMA
loads into an mbarrier ring and ``wgmma`` tensor-core products, with P
rounded to bf16 before P @ V). :func:`flash_attention_fwd` launches it on
CUDA tensors and takes :func:`flash_attention_fwd_reference` only for
tensors on the CPU.

Both compute, for q (B, H, Sq, D) and k, v (B, H, Sk, D):

- scores ``s = (q . k) * scale`` in fp32;
- an optional causal mask (key position <= query position + Sk - Sq) and an
  optional (B, Sk) key-padding mask (float, > 0 = attend), both setting the
  score to ``_NEG_BIG``;
- the online softmax over key blocks: running max ``m`` (from ``_NEG_BIG``),
  sum ``l`` and fp32 accumulator, with ``p`` zeroed where ``s <= _NEG_BIG/2``
  so a fully-masked row keeps ``l = 0``;
- ``o = acc / safe_l`` in q's type and the fp32 log-sum-exp
  ``lse = m + log(safe_l)`` (B, H, Sq), ``safe_l = 1`` where ``l == 0``: a
  fully-masked row gives ``o = 0`` and ``lse = _NEG_BIG``.

The plain version is ``_flash_fwd_jnp`` / ``online_softmax_update`` of the
reference in PyTorch: the same blocks of ``block_k`` keys (a ragged last
block where Sk does not divide), the same arithmetic. The kernel picks its
own tiles; only the order of the sums differs.

The backward is the reference's ``_flash_bwd`` (jnp there, not Pallas) in
plain PyTorch, :func:`flash_attention_bwd_reference`: it recomputes the
probabilities block by block from the forward's LSE. :class:`FlashAttention`
pairs the two as the reference's ``jax.custom_vjp`` pair ``_flash`` /
``_flash_masked`` does, and :func:`flash` goes through it whenever a
gradient is wanted.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.ops import kernels as _kern
from deeplearning4j_tpu_torch.ops.kernels import _build
from deeplearning4j_tpu_torch.util import cost_model as _cm

_NEG_BIG = -1e30
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel's largest head dimension (a multiple of 8 up to this)
MAX_HEAD_DIM = 128
#: why the raw launch refuses inputs that need a gradient: it writes O
#: through ctypes, so O would carry no grad_fn and training would silently
#: get no gradient through the attention
RAW_LAUNCH_NO_GRAD = (
    "flash_attention_fwd is the raw kernel launch and has no backward: call "
    "it on inputs that require grad through the FlashAttention autograd "
    "Function (ops.kernels.attention.flash, or ops.attention.flash_attention)")


def supports_head_dim(d) -> bool:
    """The head dims the kernel has a body for: a multiple of 8 up to
    :data:`MAX_HEAD_DIM`."""
    return 0 < d <= MAX_HEAD_DIM and d % 8 == 0


def supports(q, k, v, mask=None) -> bool:
    """Type/shape gate of the kernel: 4-D (B, H, S, D) q, k, v of one type
    (fp32 or bf16), head dim a multiple of 8 up to 128, k and v of one
    length, and a (B, Sk) padding mask or none."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        return False
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        return False
    b, h, _, d = q.shape
    if not supports_head_dim(d):
        return False
    if k.shape[:2] != (b, h) or v.shape[:2] != (b, h) \
            or k.shape[3] != d or v.shape[3] != d or v.shape[2] != k.shape[2]:
        return False
    if mask is not None and tuple(mask.shape) != (b, k.shape[2]):
        return False
    return True


def _describe(q, k, v, mask):
    return (f"q {tuple(q.shape)} {q.dtype}, k {tuple(k.shape)} {k.dtype}, "
            f"v {tuple(v.shape)} {v.dtype}, mask "
            f"{None if mask is None else tuple(mask.shape)}")


def flash_attention_fwd_reference(q, k, v, scale, causal, mask=None,
                                  block_k: int = 512):
    """Plain PyTorch version: the reference's blockwise online-softmax
    forward over key blocks of ``min(block_k, Sk)``. Returns (o in q's
    type, lse fp32 (B, H, Sq)). fp64 inputs are computed in fp64 (a
    gradient check's), every other type in fp32."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    bk = max(1, min(int(block_k), sk))
    f32 = torch.promote_types(q.dtype, torch.float32)
    qf = q.to(f32)
    q_pos = torch.arange(sq, device=q.device) + (sk - sq)
    keep = None if mask is None else (mask > 0)
    m = torch.full((b, h, sq), _NEG_BIG, dtype=f32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=f32, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=f32, device=q.device)
    masked = causal or mask is not None
    for j0 in range(0, sk, bk):
        kj = k[:, :, j0:j0 + bk].to(f32)
        vj = v[:, :, j0:j0 + bk].to(f32)
        s = torch.matmul(qf, kj.transpose(-1, -2)) * scale
        if causal:
            k_pos = torch.arange(j0, j0 + kj.shape[2], device=q.device)
            s = torch.where(k_pos[None, :] <= q_pos[:, None], s, _NEG_BIG)
        if keep is not None:
            s = torch.where(keep[:, None, None, j0:j0 + bk], s, _NEG_BIG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        if masked:
            # fully-masked rows: keep p's spurious exp(0) mass out of l/acc
            p = torch.where(s <= _NEG_BIG / 2, 0.0, p)
        l = corr * l + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.matmul(p, vj)
        m = m_new
    safe_l = torch.where(l == 0.0, 1.0, l)
    return (acc / safe_l[..., None]).to(q.dtype), m + torch.log(safe_l)


def _kernel_operand(t):
    """``t`` as the kernel reads it: last dim contiguous, every stride and
    the base 16-byte aligned, no dim of more than one element at stride 0
    (the bf16 body's TMA tensor maps take none of those; a copy only where
    a view breaks that)."""
    align = 16 // t.element_size()
    if t.stride(-1) != 1 or any(s % align for s in t.stride()[:-1]) \
            or any(s == 0 and n > 1 for s, n in zip(t.stride(), t.shape)) \
            or t.data_ptr() % 16:
        t = t.contiguous()
        if t.data_ptr() % 16:
            t = t.clone()
    return t


def _check_cuda(q, k, v, mask):
    devs = {t.device for t in (q, k, v) + (() if mask is None else (mask,))}
    if len(devs) != 1 or not q.is_cuda:
        raise ValueError(f"flash_attention_fwd: tensors on {sorted(map(str, devs))}"
                         "; all must be on one CUDA device")


def flash_attention_fwd(q, k, v, scale, causal, mask=None, block_k: int = 512):
    """(o, lse) of the flash-attention forward on the CUDA kernel. q, k, v
    are (B, H, S, D) views with a contiguous head dim (the projections'
    transposed views are taken as they are); ``mask`` a (B, Sk) padding
    mask, > 0 = attend. o is returned as a (B, H, Sq, D) view of a
    (B, Sq, H, D) buffer, so merging the heads afterwards is free. Tensors
    on the CPU take :func:`flash_attention_fwd_reference` (``block_k``
    sizes its key blocks; the kernel picks its own tiles). On the card it
    raises :data:`RAW_LAUNCH_NO_GRAD` when grad is enabled and q, k or v
    requires grad: :class:`FlashAttention` launches it under no-grad."""
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, scale, causal, mask,
                                             block_k)
    _check_cuda(q, k, v, mask)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(RAW_LAUNCH_NO_GRAD)
    if not supports(q, k, v, mask):
        raise ValueError(f"flash_attention_fwd: unsupported "
                         f"{_describe(q, k, v, mask)}")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    o = torch.empty((b, sq, h, d), dtype=q.dtype,
                    device=q.device).permute(0, 2, 1, 3)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    q, k, v = (_kernel_operand(t) for t in (q, k, v))
    if mask is not None:
        mask = mask.to(torch.float32).contiguous()
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.dl4j_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(),
            o.data_ptr(), lse.data_ptr(), _KERNEL_DTYPES[q.dtype],
            b, h, sq, sk, d, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *o.stride()[:3], float(scale),
            int(bool(causal)), stream)
    _build.check(rc, "flash_attention_fwd launch")
    _kern.LAUNCHES["flash_attention_fwd"] += 1
    return o, lse


def rows_per_block(q) -> int:
    """Query rows per block (fp32) or per work item of the persistent bf16
    body that the kernel takes for q (B, H, Sq, D): 64, or in bf16 128 for
    D > 64. Reported by the smoke beside each timed case."""
    return _build.load().dl4j_flash_fwd_rows(_KERNEL_DTYPES[q.dtype],
                                             q.shape[-1])


def flash_attention_bwd_reference(q, k, v, o, lse, do, scale, causal,
                                  mask=None, block_k: int = 512):
    """The flash backward (the reference's ``_flash_bwd``, ``:268``) in plain
    PyTorch: over key blocks of ``min(block_k, Sk)`` (a ragged last block
    where Sk does not divide), the probabilities are recomputed in fp32 from
    the forward's ``lse`` with the causal and (B, Sk) padding masks
    reapplied, ``p`` zeroed where the score is masked (a fully-masked row
    has ``s == lse == _NEG_BIG``, so ``exp(0) = 1`` would leak gradient),
    and ``delta = sum(dO * O)`` is taken on the saved (rounded) O. Returns
    (dq, dk, dv) in q's, k's and v's types; computed in fp32 (fp64 for
    fp64 inputs)."""
    sq, sk = q.shape[2], k.shape[2]
    bk = max(1, min(int(block_k), sk))
    f32 = torch.promote_types(q.dtype, torch.float32)
    qf, dof = q.to(f32), do.to(f32)
    delta = (dof * o.to(f32)).sum(dim=-1, keepdim=True)
    q_pos = torch.arange(sq, device=q.device) + (sk - sq)
    keep = None if mask is None else (mask > 0)
    masked = causal or mask is not None
    lse = lse[..., None]
    dq = torch.zeros(qf.shape, dtype=f32, device=q.device)
    dks, dvs = [], []
    for j0 in range(0, sk, bk):
        kj = k[:, :, j0:j0 + bk].to(f32)
        vj = v[:, :, j0:j0 + bk].to(f32)
        s = torch.matmul(qf, kj.transpose(-1, -2)) * scale
        if causal:
            k_pos = torch.arange(j0, j0 + kj.shape[2], device=q.device)
            s = torch.where(k_pos[None, :] <= q_pos[:, None], s, _NEG_BIG)
        if keep is not None:
            s = torch.where(keep[:, None, None, j0:j0 + bk], s, _NEG_BIG)
        p = torch.exp(s - lse)
        if masked:
            p = torch.where(s <= _NEG_BIG / 2, 0.0, p)
        dvs.append(torch.matmul(p.transpose(-1, -2), dof))
        ds = p * (torch.matmul(dof, vj.transpose(-1, -2)) - delta) * scale
        dq += torch.matmul(ds, kj)
        dks.append(torch.matmul(ds.transpose(-1, -2), qf))
    dk = dks[0] if len(dks) == 1 else torch.cat(dks, dim=2)
    dv = dvs[0] if len(dvs) == 1 else torch.cat(dvs, dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """The flash forward with its backward (the reference's ``jax.custom_vjp``
    pair ``_flash`` / ``_flash_masked``, ``:314-378``). The forward runs, as
    every ``autograd.Function`` forward does, under no-grad: the kernel
    (``launch``) or the plain forward. It saves q, k, v, O, the fp32 LSE
    and the mask as they are (views included), and the backward is
    :func:`flash_attention_bwd_reference` on them: dq, dk, dv in the inputs'
    types, None for the mask and the settings. Returns (O, LSE); the LSE
    takes no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale, causal, block_k, launch):
        fwd = flash_attention_fwd if launch else \
            flash_attention_fwd_reference
        with _cm.kernel_cost("flash_attention_fwd",
                             flash_cost(q, k, v, causal)):
            o, lse = fwd(q, k, v, scale, causal, mask, block_k)
        ctx.save_for_backward(q, k, v, o, lse, mask)
        ctx.settings = (scale, causal, block_k)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse, mask = ctx.saved_tensors
        scale, causal, block_k = ctx.settings
        dq, dk, dv = flash_attention_bwd_reference(
            q, k, v, o, lse, do, scale, causal, mask, block_k)
        return dq, dk, dv, None, None, None, None, None


def flash(q, k, v, scale, causal, mask=None, block_k: int = 512):
    """The forward as ``ops.attention.flash_attention`` dispatches it: the
    kernel on a CUDA tensor (or raise), the plain version on the CPU or
    under ``exact``; through :class:`FlashAttention` whenever grad is
    enabled and q, k or v requires it. Returns (o, lse)."""
    launch = _kern.dispatch("flash_attention_fwd", supports(q, k, v, mask), q,
                            lambda: _describe(q, k, v, mask))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, mask, scale, causal, block_k,
                                    launch)
    with _cm.kernel_cost("flash_attention_fwd", flash_cost(q, k, v, causal)):
        if launch:
            return flash_attention_fwd(q, k, v, scale, causal, mask, block_k)
        return flash_attention_fwd_reference(q, k, v, scale, causal, mask,
                                             block_k)


def flash_cost(q, k, v, causal):
    """(FLOPs, transcendentals, bytes) of one flash forward for the cost
    model, [B, H, S, D]: 2·D FLOPs a (query, key) pair for each of QKᵀ and
    PV, 3 more for the scale, the running max and the normalisation, one
    exp a pair; a causal call counts the pairs on or below the diagonal.
    Bytes: q, k, v read, O and the fp32 LSE written."""
    def fn():
        b, h, sq, d = (int(n) for n in q.shape)
        sk = int(k.shape[2])
        if causal:
            off = sk - sq
            pairs = sum(min(sk, max(0, i + off + 1)) for i in range(sq))
        else:
            pairs = sq * sk
        pairs *= b * h
        nbytes = (q.numel() + k.numel() + v.numel() + q.numel()) \
            * q.element_size() + 4 * b * h * sq
        return ((4.0 * d + 3.0) * pairs, float(pairs), float(nbytes),
                4.0 * d * pairs)
    return fn
