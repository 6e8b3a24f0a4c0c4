"""Minimal protobuf wire-format codec (counterpart of
deeplearning4j_tpu/imports/protomini.py; no protobuf runtime).

The ONNX importer reads ONNX's schema with it, and the TF importer reads
TF's (``tf_proto.py``): neither ``onnx``, ``tensorflow`` nor
``google.protobuf`` is needed. ``decode`` takes bytes or a memoryview and
slices length-delimited fields as views of it, so a large model's weights
are not copied on the way to ``np.frombuffer``. The encoder half writes
valid ONNX and TF bytes (``graph_cases.py``, the tests).

Wire format (developers.google.com/protocol-buffers/docs/encoding):
tag = (field_number << 3) | wire_type; wire types used by ONNX:
0 = varint, 1 = 64-bit, 2 = length-delimited, 5 = 32-bit.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple


def read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def decode(buf) -> Dict[int, List[Tuple[int, object]]]:
    """-> {field_number: [(wire_type, raw_value), ...]} preserving order;
    length-delimited values are slices of ``buf`` (views of a
    memoryview)."""
    fields: Dict[int, List[Tuple[int, object]]] = {}
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = read_varint(buf, pos)
        fnum, wt = tag >> 3, tag & 7
        if wt == 0:
            val, pos = read_varint(buf, pos)
        elif wt == 1:
            val = struct.unpack_from("<q", buf, pos)[0]
            pos += 8
        elif wt == 2:
            ln, pos = read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:
            val = struct.unpack_from("<i", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        fields.setdefault(fnum, []).append((wt, val))
    return fields


def get_ints(fields, num) -> List[int]:
    """Repeated int64/int32: both packed (length-delimited) and unpacked."""
    out: List[int] = []
    for wt, v in fields.get(num, []):
        if wt == 0:
            out.append(_signed64(v))
        elif wt == 2:
            pos = 0
            while pos < len(v):
                x, pos = read_varint(v, pos)
                out.append(_signed64(x))
    return out


def get_int(fields, num, default=0) -> int:
    vals = get_ints(fields, num)
    return vals[-1] if vals else default


def get_floats(fields, num) -> List[float]:
    out: List[float] = []
    for wt, v in fields.get(num, []):
        if wt == 5:
            out.append(struct.unpack("<f", struct.pack("<i", v))[0])
        elif wt == 2:
            out.extend(struct.unpack(f"<{len(v) // 4}f", bytes(v)))
    return out


def get_float(fields, num, default=0.0) -> float:
    vals = get_floats(fields, num)
    return vals[-1] if vals else default


def get_doubles(fields, num) -> List[float]:
    out: List[float] = []
    for wt, v in fields.get(num, []):
        if wt == 1:  # unpacked 64-bit
            out.append(struct.unpack("<d", struct.pack("<q", v))[0])
        elif wt == 2:  # packed
            out.extend(struct.unpack(f"<{len(v) // 8}d", bytes(v)))
    return out


def get_bytes(fields, num, default=b"") -> bytes:
    vals = [v for wt, v in fields.get(num, []) if wt == 2]
    return vals[-1] if vals else default


def get_str(fields, num, default="") -> str:
    b = get_bytes(fields, num, None)
    return bytes(b).decode("utf-8") if b is not None else default


def get_strs(fields, num) -> List[str]:
    return [bytes(v).decode("utf-8") for wt, v in fields.get(num, [])
            if wt == 2]


def get_messages(fields, num) -> List[bytes]:
    return [v for wt, v in fields.get(num, []) if wt == 2]


def _signed64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


# ----------------------------------------------------------------- encoding


def _varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def f_varint(num: int, v: int) -> bytes:
    return _varint(num << 3) + _varint(v)


def f_bytes(num: int, v: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(v)) + v


def f_str(num: int, v: str) -> bytes:
    return f_bytes(num, v.encode("utf-8"))


def f_packed_ints(num: int, vals) -> bytes:
    return f_bytes(num, b"".join(_varint(int(v)) for v in vals))


def f_float(num: int, v: float) -> bytes:
    return _varint((num << 3) | 5) + struct.pack("<f", v)

