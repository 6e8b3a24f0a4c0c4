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

The LSE is returned for the flash backward of a later training slice, which
recomputes the probabilities from it (the reference's ``_flash_bwd``).
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.ops import kernels as _kern
from deeplearning4j_tpu_torch.ops.kernels import _build

_NEG_BIG = -1e30
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel's largest head dimension (a multiple of 8 up to this)
MAX_HEAD_DIM = 128
#: why the kernel refuses inputs that need a gradient: it writes O through a
#: ctypes launch with no autograd Function, so O would carry no grad_fn and
#: training would silently get no gradient through the attention
FLASH_BACKWARD = (
    "the flash-attention backward is not ported yet (ROADMAP.md Queue 1 item "
    "7, the reference's _flash_bwd): the forward kernel takes no inputs that "
    "require grad, and transformer layers cannot be trained yet")


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
    type, lse fp32 (B, H, Sq))."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    bk = max(1, min(int(block_k), sk))
    qf = q.to(torch.float32)
    q_pos = torch.arange(sq, device=q.device) + (sk - sq)
    keep = None if mask is None else (mask > 0)
    m = torch.full((b, h, sq), _NEG_BIG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    masked = causal or mask is not None
    for j0 in range(0, sk, bk):
        kj = k[:, :, j0:j0 + bk].to(torch.float32)
        vj = v[:, :, j0:j0 + bk].to(torch.float32)
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
    raises :data:`FLASH_BACKWARD` when grad is enabled and q, k or v
    requires grad."""
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, scale, causal, mask,
                                             block_k)
    _check_cuda(q, k, v, mask)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(FLASH_BACKWARD)
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


def flash(q, k, v, scale, causal, mask=None, block_k: int = 512):
    """The forward as ``ops.attention.flash_attention`` dispatches it: the
    kernel on a CUDA tensor (or raise), the plain version on the CPU or
    under ``exact``."""
    if _kern.dispatch("flash_attention_fwd", supports(q, k, v, mask), q,
                      lambda: _describe(q, k, v, mask)):
        return flash_attention_fwd(q, k, v, scale, causal, mask, block_k)
    return flash_attention_fwd_reference(q, k, v, scale, causal, mask,
                                         block_k)
