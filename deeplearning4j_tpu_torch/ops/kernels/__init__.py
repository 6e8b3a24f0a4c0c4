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

Tuned dispatch (the reference's ``:83-125``): a call site that names its
(``op``, shape signature, dtype) has, under
``auto`` on a CUDA tensor with a tuning database armed
(``DL4J_TPU_TUNING_DB``, ``tuning/database.py``), the database's winner
decide: a kernel winner launches with its parameters (the conv's
``row_tile``, K2), an ``exact`` winner runs the plain version on the card.
That is the reference's measured choice, not a fallback, and it is counted
like every plain call on the card. With no database, no entry, a CPU
tensor or an explicit ``exact``/``cuda``, dispatch is as above.

Counters: :data:`LAUNCHES` counts, per kernel, the launches its wrapper
made; :data:`PLAIN_ON_CUDA` counts calls with a CUDA tensor that took the
plain path (``exact``, or an ``exact`` winner under ``auto``);
:data:`BODY_LAUNCHES` splits the conv, wgrad and LSTM segment kernels'
launches by the body that ran; :data:`ROW_TILE_LAUNCHES` counts the conv
forward's launches with a row tile (K2), by tile; :data:`TUNED` counts
every choice a database winner made, by ``"<kernel>/<winner label>"``.
All are plain integers, reset with :func:`reset_counts`. A captured
program (``nn/capture.py``) launches nothing through the wrappers when it
replays: it takes the counts its capture made (:func:`snapshot_counts`,
:func:`counts_since`), puts the tables back as they were
(:func:`restore_counts`), and adds those counts again at each replay
(:func:`add_counts`), so the tables count the launches that ran.

Not carried over from the TPU seam: the VMEM gate (``fits_vmem`` /
``VMEM_BUDGET_BYTES``, conv.py:57-114) sizes a TPU program's whole-image
block, which has no counterpart in a tiled CUDA grid. A TPU database's
records never apply here: the port's keys carry backend ``cuda:sm_90``.
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
#: conv forward launches with a row tile (K2), by ``"conv2d_fwd/rt=<n>"``
ROW_TILE_LAUNCHES: Dict[str, int] = {}
#: choices a tuning-database winner made, by ``"<kernel>/<label>"``
TUNED: Dict[str, int] = {}

_TABLES = (LAUNCHES, PLAIN_ON_CUDA, BODY_LAUNCHES, ROW_TILE_LAUNCHES, TUNED)


def reset_counts() -> None:
    for table in (LAUNCHES, PLAIN_ON_CUDA):
        for k in table:
            table[k] = 0
    for table in (BODY_LAUNCHES, ROW_TILE_LAUNCHES, TUNED):
        table.clear()


def snapshot_counts() -> tuple:
    """Copies of (LAUNCHES, PLAIN_ON_CUDA, BODY_LAUNCHES,
    ROW_TILE_LAUNCHES, TUNED)."""
    return tuple(dict(t) for t in _TABLES)


def counts_since(snap: tuple) -> tuple:
    """The counts added to each table since ``snap``, nonzero entries
    only."""
    return tuple({k: n - old.get(k, 0) for k, n in table.items()
                  if n != old.get(k, 0)}
                 for table, old in zip(_TABLES, snap))


def restore_counts(snap: tuple) -> None:
    """Put every table back to ``snap``."""
    for table, old in zip(_TABLES, snap):
        table.clear()
        table.update(old)


def add_counts(delta: tuple) -> None:
    """Add :func:`counts_since`'s counts to the tables."""
    for table, add in zip(_TABLES, delta):
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


def tuned_winner(kernel: str, x, *, op=None, sig=None, dtype=None):
    """The armed tuning database's winner for a call, or None: consulted
    only under ``auto`` on a CUDA tensor, for a call that names its ``op``
    (the database's op, e.g. ``"conv2d"``), ``sig`` (its shape signature,
    or a callable giving it, built only when a database is armed) and
    ``dtype``. A winner is counted in :data:`TUNED`; an ``exact`` winner,
    which runs the plain version on the card, in :data:`PLAIN_ON_CUDA`
    too. A kernel winner's ``params`` (the conv's ``row_tile``) are the
    caller's to apply."""
    if op is None or not x.is_cuda or resolve_impl() != "auto":
        return None
    winner = _tuned_winner(op, sig, dtype)
    if winner is not None:
        key = f"{kernel}/{winner.get('label', winner.get('impl'))}"
        TUNED[key] = TUNED.get(key, 0) + 1
        if winner.get("impl") == "exact":
            PLAIN_ON_CUDA[kernel] += 1
    return winner


def dispatch(kernel: str, supported: bool, x, describe, *, op=None,
             sig=None, dtype=None) -> bool:
    """The one dispatch rule: True = launch ``kernel`` on ``x``'s device,
    False = take the plain version. ``describe()`` names the call's
    geometry and types for the error when ``supported`` is False. A call
    that names its tuning key (``op``, ``sig``, ``dtype``) follows the
    armed database's winner under ``auto`` (:func:`tuned_winner`): an
    ``exact`` winner takes the plain version, a kernel winner the kernel."""
    winner = tuned_winner(kernel, x, op=op, sig=sig, dtype=dtype)
    if winner is not None and winner.get("impl") == "exact":
        return False
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


def _tuned_winner(op, sig, dtype):
    """The armed tuning database's winner for (op, sig, dtype) on this
    backend, or None: one env/global read when no database is armed, a
    memo probe once one is (reference ``:114-125``)."""
    from deeplearning4j_tpu_torch.tuning import database as _tdb

    if _tdb.database_dir() is None:
        return None
    if callable(sig):
        sig = sig()
    if sig is None:
        return None
    from deeplearning4j_tpu_torch.dtypes import name_of

    return _tdb.resolve(op, sig, name_of(dtype) if dtype is not None
                        else "float32")


from deeplearning4j_tpu_torch.ops.kernels import (  # noqa: E402,F401
    attention, conv, lstm)
