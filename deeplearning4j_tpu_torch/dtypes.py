"""Dtype system (the port's copy of deeplearning4j_tpu/dtypes.py).

Parity with ND4J's ``DataType`` enum: canonical names map to torch dtypes.
``float32`` is the default parameter/accumulation dtype; ``bfloat16`` is the
default compute dtype for tensor-core-bound work (the Hopper counterpart of
the reference's MXU preference).
"""

from __future__ import annotations

import torch

# Canonical names -> torch dtypes (DataType enum parity).
DOUBLE = torch.float64
FLOAT = torch.float32
HALF = torch.float16
BFLOAT16 = torch.bfloat16
INT64 = torch.int64
INT32 = torch.int32
INT16 = torch.int16
INT8 = torch.int8
UINT64 = torch.uint64
UINT32 = torch.uint32
UINT16 = torch.uint16
UINT8 = torch.uint8
BOOL = torch.bool

_BY_NAME = {
    "double": DOUBLE, "float64": DOUBLE,
    "float": FLOAT, "float32": FLOAT,
    "half": HALF, "float16": HALF,
    "bfloat16": BFLOAT16, "bf16": BFLOAT16,
    "long": INT64, "int64": INT64,
    "int": INT32, "int32": INT32,
    "short": INT16, "int16": INT16,
    "byte": INT8, "int8": INT8,
    "ulong": UINT64, "uint64": UINT64,
    "uint": UINT32, "uint32": UINT32,
    "ushort": UINT16, "uint16": UINT16,
    "ubyte": UINT8, "uint8": UINT8,
    "bool": BOOL,
}

FLOATING_DTYPES = (DOUBLE, FLOAT, HALF, BFLOAT16)
INTEGER_DTYPES = (INT64, INT32, INT16, INT8, UINT64, UINT32, UINT16, UINT8)

# Global defaults (Nd4j.setDefaultDataTypes parity).
_default_floating = FLOAT
_compute_dtype = BFLOAT16  # tensor-core-preferred dtype for matmul/conv


def _as_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        return by_name(dtype)
    name = getattr(dtype, "name", None) or str(dtype)
    return by_name(name)


def by_name(name: str) -> torch.dtype:
    """Resolve a DataType by its ND4J-style name (case-insensitive)."""
    key = name.lower()
    if key.startswith("torch."):
        key = key[len("torch."):]
    if key not in _BY_NAME:
        raise ValueError(f"Unknown dtype name: {name!r}")
    return _BY_NAME[key]


def name_of(dtype) -> str:
    """The canonical name of a dtype ("float32", "bfloat16", ...): the
    string the reference's ``str(jnp.dtype)`` gives, used wherever a dtype
    is written into a key or a file both packages read."""
    return str(_as_dtype(dtype)).replace("torch.", "")


def default_floating_dtype() -> torch.dtype:
    return _default_floating


def set_default_floating_dtype(dtype) -> None:
    global _default_floating
    _default_floating = _as_dtype(dtype)


def compute_dtype() -> torch.dtype:
    """Dtype used for tensor-core-bound compute (matmul/conv) when mixed
    precision is on."""
    return _compute_dtype


def set_compute_dtype(dtype) -> None:
    global _compute_dtype
    _compute_dtype = _as_dtype(dtype)


def is_floating(dtype) -> bool:
    return _as_dtype(dtype).is_floating_point


def is_integer(dtype) -> bool:
    d = _as_dtype(dtype)
    return not d.is_floating_point and not d.is_complex and d != BOOL


def is_bool(dtype) -> bool:
    return _as_dtype(dtype) == BOOL
