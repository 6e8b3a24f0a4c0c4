"""Kernel dispatch seam of the port (mirrors deeplearning4j_tpu/ops/kernels/__init__.py:37-111).

Every op that has a hand-written CUDA kernel asks :func:`dispatch` whether to
launch it:

- ``kernel_impl``: ``"auto" | "exact" | "cuda"``. ``exact`` always takes
  the plain PyTorch version; ``cuda`` forces the kernel and raises on a
  CPU tensor; ``auto`` takes the plain version for a CPU tensor and the
  kernel for a CUDA tensor. On a CUDA tensor both launch the kernel or
  raise, naming what the op's ``supports`` gate refused: nothing but
  ``exact`` runs the plain version on the card.
- Resolution order: explicit :func:`impl_scope` (the nets stamp their
  conf's ``kernel_impl`` here around every forward) > the
  ``DL4J_TORCH_KERNEL_IMPL`` env knob > ``"auto"``.
- A conf JSON written by the JAX package may say ``"pallas"`` (its forced
  kernel mode); the port reads it as ``"cuda"`` (nn/conf.py).

Counters: :data:`LAUNCHES` counts, per kernel, the launches its wrapper
made; :data:`PLAIN_ON_CUDA` counts calls with a CUDA tensor that took the
plain path (only ``exact`` sends one there); :data:`BODY_LAUNCHES` splits
the conv, wgrad and LSTM segment kernels' launches by the body that ran.
All are plain integers, reset with :func:`reset_counts`. A captured
program (``nn/capture.py``) launches nothing through the wrappers when it
replays: it takes the counts its capture made (:func:`snapshot_counts`,
:func:`counts_since`), puts the tables back as they were
(:func:`restore_counts`), and adds those counts again at each replay
(:func:`add_counts`), so the tables count the launches that ran.

Not carried over from the TPU seam: the VMEM gate (``fits_vmem`` /
``VMEM_BUDGET_BYTES``, conv.py:57-114) sizes a TPU program's whole-image
block, which has no counterpart in a tiled CUDA grid; and the tuning-database
lookup (conv.py:114-125, tuning/database.py) holds TPU measurements and is
not ported.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from typing import Dict, Optional

_VALID = ("auto", "exact", "cuda")

_impl_override: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "dl4j_torch_kernel_impl", default=None)

#: the kernels behind the seam: the conv forward (K1/K2), the input
#: gradient (K1 launched on the transformed dy), the filter gradient (K3),
#: the fused LSTM cell (K4, one step) and its segment entry (K4 over a
#: TBPTT segment, one launch), and the flash-attention forward (K5)
KERNELS = ("conv2d_fwd", "conv2d_dgrad", "conv2d_wgrad", "lstm_cell_fwd",
           "lstm_seq_fwd", "flash_attention_fwd")
#: launches per kernel, bumped by each wrapper where it launches
LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS, 0)
#: CUDA-tensor calls that took the plain path (``exact`` only)
PLAIN_ON_CUDA: Dict[str, int] = dict.fromkeys(KERNELS, 0)
#: launches of a kernel with more than one body, by ``"kernel/body"``
#: (the conv and wgrad kernels' ``fma``, ``mma_sync`` and ``wgmma``; the
#: LSTM segment's ``resident`` and ``step``)
BODY_LAUNCHES: Dict[str, int] = {}


def reset_counts() -> None:
    for table in (LAUNCHES, PLAIN_ON_CUDA):
        for k in table:
            table[k] = 0
    BODY_LAUNCHES.clear()


def snapshot_counts() -> tuple:
    """Copies of (LAUNCHES, PLAIN_ON_CUDA, BODY_LAUNCHES)."""
    return dict(LAUNCHES), dict(PLAIN_ON_CUDA), dict(BODY_LAUNCHES)


def counts_since(snap: tuple) -> tuple:
    """The counts added to each table since ``snap``, nonzero entries
    only."""
    return tuple({k: n - old.get(k, 0) for k, n in table.items()
                  if n != old.get(k, 0)}
                 for table, old in zip((LAUNCHES, PLAIN_ON_CUDA,
                                        BODY_LAUNCHES), snap))


def restore_counts(snap: tuple) -> None:
    """Put every table back to ``snap``."""
    for table, old in zip((LAUNCHES, PLAIN_ON_CUDA, BODY_LAUNCHES), snap):
        table.clear()
        table.update(old)


def add_counts(delta: tuple) -> None:
    """Add :func:`counts_since`'s counts to the tables."""
    for table, add in zip((LAUNCHES, PLAIN_ON_CUDA, BODY_LAUNCHES), delta):
        for k, n in add.items():
            table[k] = table.get(k, 0) + n


def validate_impl(impl: Optional[str]) -> Optional[str]:
    if impl is not None and impl not in _VALID:
        raise ValueError(f"kernel_impl must be one of {_VALID}, got {impl!r}")
    return impl


@contextlib.contextmanager
def impl_scope(impl: Optional[str]):
    """Pin the kernel dispatch for the dynamic extent. ``None`` leaves the
    ambient resolution (env knob / auto) in place."""
    validate_impl(impl)
    tok = _impl_override.set(impl) if impl is not None else None
    try:
        yield
    finally:
        if tok is not None:
            _impl_override.reset(tok)


def resolve_impl() -> str:
    """Effective kernel_impl: scope override > DL4J_TORCH_KERNEL_IMPL > auto."""
    impl = _impl_override.get()
    if impl is None:
        impl = os.environ.get("DL4J_TORCH_KERNEL_IMPL") or "auto"
    if impl not in _VALID:
        raise ValueError(
            f"DL4J_TORCH_KERNEL_IMPL must be one of {_VALID}, got {impl!r}")
    return impl


def dispatch(kernel: str, supported: bool, x, describe) -> bool:
    """The one dispatch rule: True = launch ``kernel`` on ``x``'s device,
    False = take the plain version. ``describe()`` names the call's
    geometry and types for the error when ``supported`` is False."""
    impl = resolve_impl()
    if impl == "exact" or (impl == "auto" and not x.is_cuda):
        if x.is_cuda:
            PLAIN_ON_CUDA[kernel] += 1
        return False
    if not x.is_cuda:
        raise RuntimeError(
            f"kernel_impl='cuda' needs CUDA tensors; {kernel} got one on "
            f"{x.device}")
    if not supported:
        raise ValueError(
            f"kernel_impl={impl!r}: {kernel} has no kernel for "
            f"{describe()} (see its supports()); kernel_impl='exact' runs "
            "the plain version")
    return True


from deeplearning4j_tpu_torch.ops.kernels import (  # noqa: E402,F401
    attention, conv, lstm)
