"""numpy-style helpers the op families share (no counterpart in the
reference, where jnp gives these semantics for free).

The reference runs with JAX's 64-bit types off, so its integer results are
int32 (sums of int32 or bool, argmax, sorting indices) and its float
results float32. torch would return int64 for the same calls; the helpers
here bring a result back to the reference's type, so a graph that casts on
it sees what the reference gives. Python scalars become 0-d tensors on the
other operand's device, which torch promotes as JAX promotes its weak
scalars.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

_DTYPES = {
    "float32": torch.float32, "float": torch.float32, "float64": torch.float64,
    "double": torch.float64, "float16": torch.float16, "half": torch.float16,
    "bfloat16": torch.bfloat16, "int8": torch.int8, "int16": torch.int16,
    "int32": torch.int32, "int": torch.int32, "int64": torch.int64,
    "long": torch.int64, "uint8": torch.uint8, "uint16": torch.uint16,
    "uint32": torch.uint32, "uint64": torch.uint64, "bool": torch.bool,
    "bool_": torch.bool, "complex64": torch.complex64,
    "complex128": torch.complex128,
}


def dtype(d) -> Optional[torch.dtype]:
    """A torch dtype from a name, a numpy dtype or type, or a torch dtype;
    None stays None."""
    if d is None or isinstance(d, torch.dtype):
        return d
    if d is bool:
        return torch.bool
    if d is int:
        return torch.int32
    if d is float:
        return torch.float32
    name = d if isinstance(d, str) else np.dtype(d).name
    try:
        return _DTYPES[name]
    except KeyError:
        raise TypeError(f"unknown dtype {d!r}") from None


def t(x, like=None, dt=None) -> torch.Tensor:
    """``x`` as a tensor: a tensor as it is (cast to ``dt`` if given), a
    numpy array or list as a tensor, a Python scalar as a 0-d tensor (int
    -> int64, float -> float32, bool -> bool) on ``like``'s device."""
    if isinstance(x, torch.Tensor):
        return x if dt is None else x.to(dt)
    dev = like.device if isinstance(like, torch.Tensor) else \
        torch.device("cpu")
    if isinstance(x, np.ndarray):
        a = x if x.dtype != np.float64 else x.astype(np.float32)
        out = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return out if dt is None else out.to(dt)
    if isinstance(x, (bool, np.bool_)):
        return torch.tensor(bool(x), device=dev, dtype=dt or torch.bool)
    if isinstance(x, (int, np.integer)):
        return torch.tensor(int(x), device=dev, dtype=dt or torch.int64)
    if isinstance(x, (float, np.floating)):
        return torch.tensor(float(x), device=dev, dtype=dt or torch.float32)
    return torch.as_tensor(np.asarray(x, dtype=None), device=dev) \
        if dt is None else torch.as_tensor(np.asarray(x), device=dev).to(dt)


def pair(x, y):
    """Both operands as tensors on the device of whichever is one."""
    like = x if isinstance(x, torch.Tensor) else y
    return t(x, like), t(y, like)


def axes(axis, ndim: int) -> tuple:
    """Normalized reduction axes; None -> every axis."""
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, (int, np.integer)):
        axis = (int(axis),)
    return tuple(sorted(int(a) % max(ndim, 1) for a in axis))


def acc_int(out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """An integer reduction's result in the reference's type: int32 for
    bool and integer inputs up to 32 bits."""
    if x.dtype == torch.bool or (not x.is_floating_point()
                                 and not x.is_complex()):
        return out.to(torch.int32)
    return out


def reduce(x, axis, keepdims, fn):
    """``fn(x, dims, keepdim)`` over normalized axes; a 0-d input or an
    empty axis tuple returns ``x`` reduced over nothing."""
    x = t(x)
    dims = axes(axis, x.dim())
    if x.dim() == 0 or not dims:
        return fn(x.reshape(1), (0,), False).reshape(()) if x.dim() == 0 \
            else x
    return fn(x, dims, keepdims)


def floatify(x: torch.Tensor) -> torch.Tensor:
    """Integer and bool tensors as float32 (what jnp's float ops do)."""
    return x if (x.is_floating_point() or x.is_complex()) else x.float()


def shape(s) -> tuple:
    if isinstance(s, torch.Tensor):
        return tuple(int(v) for v in s.reshape(-1).tolist())
    if isinstance(s, (int, np.integer)):
        return (int(s),)
    return tuple(int(v) for v in np.asarray(s).reshape(-1))


def norm_index(idx: torch.Tensor, n: int):
    """(wrapped index, in-range mask): negative indices count from the
    end, as JAX's ``.at[]`` does; the mask marks what stays in [0, n)."""
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    return idx, (idx >= 0) & (idx < n)


def as_list(xs: Sequence) -> list:
    return [t(x) for x in xs]
