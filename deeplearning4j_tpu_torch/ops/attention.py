"""Attention ops (counterpart of deeplearning4j_tpu/ops/attention.py): the
exact dot-product attention, flash attention with its backward, and
multi-head attention.

Layout is the reference's: q, k, v are [batch, heads, seq, head_dim]. Masks
follow ND4J: 1/True = attend, 0/False = blocked. A blocked score is
``_NEG_BIG`` (not -inf), and a row with every key blocked gives zeros on
both paths.

- :func:`dot_product_attention` (reference ``:74``) materialises the
  Sq x Sk matrix: two plain matrix products and a softmax, as the reference
  leaves them to XLA.
- :func:`flash_attention` (reference ``:407``) is the online-softmax
  forward of ``ops/kernels/attention.py``: the hand-written CUDA kernel
  (``csrc/flash_fwd.cu``, replacing ``_flash_fwd_kernel``) on a CUDA tensor,
  its plain blockwise version on the CPU or under ``kernel_impl="exact"``.
  A (B, Sk) padding mask is applied per key inside the kernel. It trains:
  on inputs that require grad it runs through the ``FlashAttention``
  autograd Function, whose backward recomputes the probabilities from the
  forward's LSE (the reference's ``_flash_bwd``, plain PyTorch there too).
- :func:`resolve_flash` (reference ``:389``) is the layers' choice between
  the two: ``"auto"`` takes flash on a CUDA tensor from
  :data:`FLASH_MIN_SEQ` tokens, the crossover measured on the H100
  (``chip_smoke.py``'s ``attention_sweep``); the reference's 1024 is a TPU
  crossover and does not carry over.
- :func:`multi_head_dot_product_attention` (reference ``:465``) projects
  [B, T, F] sequences into heads and takes flash or exact attention by
  :func:`resolve_flash`.

Not ported yet: the paged functions (``paged_kv_gather``,
``paged_attention``), which come with the generate serving slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from deeplearning4j_tpu_torch.ops.kernels import attention as _katt
from deeplearning4j_tpu_torch.ops.registry import op

_NEG_BIG = _katt._NEG_BIG

# flash/exact crossover for CUDA tensors, from chip_smoke.py's attention_sweep
# on one NVIDIA H100 80GB HBM3 at a 700 W power limit (PERF.md): the kernel
# against dot_product_attention at BERT-base head geometry (12 heads of 64),
# tokens per batch held at 8192. The kernel won at every length measured,
# 32 to 2048 tokens: exact/flash time 1.09x at 32 tokens and 1.57-2.14x
# above in fp32, 3.2-16.6x in bf16. 32 is the shortest length measured.
FLASH_MIN_SEQ = 32


@op("dot_product_attention", "attention", aliases=("dotProductAttention",))
def dot_product_attention(q, k, v, mask=None, scale: Optional[float] = None,
                          causal: bool = False, with_weights: bool = False):
    """Scaled dot-product attention, exact (materialises the S x S matrix).

    q: [..., Sq, D], k: [..., Sk, D], v: [..., Sk, Dv]. ``mask``:
    broadcastable to [..., Sq, Sk]; 1/True = attend. ``scale=None`` ->
    1/sqrt(D). The scores are the product in the inputs' type, promoted to
    fp32 for the softmax; a row whose keys are all blocked gets zero
    weights (not the uniform softmax of equal ``_NEG_BIG`` scores)."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    s = torch.matmul(q, k.transpose(-1, -2)).to(
        torch.promote_types(q.dtype, torch.float32))
    s = s * scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        q_pos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        k_pos = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(k_pos <= q_pos, s, _NEG_BIG)
    if mask is not None:
        keep = torch.as_tensor(mask, device=q.device).to(torch.bool)
        s = torch.where(keep, s, _NEG_BIG)
    w = torch.softmax(s, dim=-1)
    if causal or mask is not None:
        valid = (s > _NEG_BIG / 2).any(dim=-1, keepdim=True)
        w = torch.where(valid, w, 0.0)
    out = torch.matmul(w.to(v.dtype), v)
    if with_weights:
        return out, w
    return out


def resolve_flash(flash, seq_q, seq_k, mask=None, device=None,
                  head_dim=None) -> bool:
    """Dispatch rule of the attention layers: ``flash`` True, False or
    "auto". A (B, Tk) padding mask is flash-eligible; any other mask takes
    the exact path. "auto" picks flash for tensors on ``device`` CUDA from
    :data:`FLASH_MIN_SEQ` tokens, and only where the kernel takes
    ``head_dim`` (the reference picks it on a TPU backend from its own
    crossover, where its kernel runs); on the CPU it stays exact, as the
    reference does off the TPU. ``flash=True`` on CUDA with a head dim the
    kernel refuses raises, naming it."""
    if flash not in (True, False, "auto"):
        raise ValueError(
            f"flash must be True, False, or 'auto'; got {flash!r}")
    if mask is not None and mask.dim() != 2:
        return False
    on_cuda = device is not None and torch.device(device).type == "cuda"
    kernel_takes = head_dim is None or _katt.supports_head_dim(head_dim)
    if flash == "auto":
        return on_cuda and kernel_takes and min(seq_q, seq_k) >= FLASH_MIN_SEQ
    if flash and on_cuda and not kernel_takes:
        raise ValueError(
            f"flash=True: the flash kernel has no body for head dim "
            f"{head_dim} (a multiple of 8 up to {_katt.MAX_HEAD_DIM}); "
            "flash='auto' or False takes exact attention")
    return bool(flash)


@op("flash_attention", "attention")
def flash_attention(q, k, v, scale: Optional[float] = None,
                    causal: bool = False, block_q: int = 512,
                    block_k: int = 512, mask=None):
    """Memory-efficient attention: [B,H,S,D] -> [B,H,S,D].

    The CUDA kernel on a CUDA tensor, the plain blockwise forward on the
    CPU (``kernel_impl`` decides, as for every kernel of the port).
    ``mask``: optional (B, Sk) padding mask (1 = attend) applied per key
    inside the kernel. Sequence lengths that do not divide the effective
    blocks ``min(block, S)`` take :func:`dot_product_attention`, the
    reference's rule; the kernel itself tiles any length."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    sq, sk = q.shape[2], k.shape[2]
    bq, bk = min(block_q, sq), min(block_k, sk)
    if mask is not None and mask.dim() != 2:
        raise ValueError(
            "flash_attention mask must be a (B, Sk) padding mask; full "
            f"attention masks take the exact path (got ndim {mask.dim()})")
    if sq % bq or sk % bk:
        amask = None if mask is None else mask[:, None, None, :]
        return dot_product_attention(q, k, v, mask=amask, scale=scale,
                                     causal=causal)
    if mask is not None:
        mask = mask.to(torch.float32)
    o, _lse = _katt.flash(q, k, v, float(scale), bool(causal), mask, bk)
    return o


def _split_heads(x, n_heads):
    """(B, T, F) -> (B, n_heads, T, F / n_heads), a view (reference
    ``:453``)."""
    b, t, f = x.shape
    return x.reshape(b, t, n_heads, f // n_heads).permute(0, 2, 1, 3)


def _merge_heads(x):
    """(B, H, T, Dh) -> (B, T, H * Dh) (reference ``:458``)."""
    b, h, t, dh = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, t, h * dh)


@op("multi_head_dot_product_attention", "attention",
    aliases=("multiHeadDotProductAttention", "mha"))
def multi_head_dot_product_attention(queries, keys, values, Wq, Wk, Wv, Wo,
                                     n_heads: int, mask=None,
                                     scale: Optional[float] = None,
                                     causal: bool = False, flash="auto"):
    """Projected multi-head attention over [B, T, F] sequences (reference
    ``:465``). Wq/Wk/Wv: (F, H*Dh); Wo: (H*Dh, Fout). ``mask`` is a
    (B, Tk) padding mask (1 = valid) or a full [B, 1|H, Tq, Tk] attention
    mask, which takes the exact path. ``flash``: True | False | "auto"
    (:func:`resolve_flash`); the flash path trains through the
    ``FlashAttention`` Function."""
    q = _split_heads(queries @ Wq, n_heads)
    k = _split_heads(keys @ Wk, n_heads)
    v = _split_heads(values @ Wv, n_heads)
    if mask is not None:
        mask = torch.as_tensor(mask, device=q.device)
    if resolve_flash(flash, q.shape[2], k.shape[2], mask, device=q.device,
                     head_dim=q.shape[-1]):
        o = flash_attention(q, k, v, scale=scale, causal=causal, mask=mask)
    else:
        amask = None
        if mask is not None:
            amask = mask[:, None, None, :] if mask.dim() == 2 else mask
        o = dot_product_attention(q, k, v, mask=amask, scale=scale,
                                  causal=causal)
    return _merge_heads(o) @ Wo
