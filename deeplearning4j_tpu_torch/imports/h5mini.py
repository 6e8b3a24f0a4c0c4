"""Minimal HDF5 reader and writer (no counterpart in the reference, which
reads Keras files with ``h5py``): the machine with the card has neither
``h5py`` nor ``tensorflow``, so the Keras importer reads HDF5 with this.

It covers the subset that h5py writes at its default ``libver='earliest'``,
which is what Keras's legacy ``.h5`` files and the ``model.weights.h5``
member of a ``.keras`` zip hold (HDF5 File Format Specification 3.0,
support.hdfgroup.org/documentation/hdf5/latest/_f_m_t3.html):

- superblock version 0 or 1; versions 2 and 3 (``libver='latest'``) with
  their version-2 object headers, where a group keeps its links in the
  header (compact storage);
- version-1 object headers, continuation messages included;
- symbol-table groups: the version-1 B-tree of any depth, its SNOD
  leaves and the local heap of names; link messages;
- dataspaces, datatypes (little-endian fixed point, IEEE f16/f32/f64,
  fixed-length and variable-length strings), contiguous and compact
  layouts, attribute messages of versions 1-3, variable-length data in
  global heap collections (``GCOL``).

What lies outside the subset raises :class:`H5Unsupported`, naming what it
met (a chunked or filtered dataset, dense link or attribute storage, a
big-endian or compound type): nothing falls back to anything.

:class:`Writer` writes the same subset (superblock 0, version-1 headers,
symbol-table groups, contiguous datasets, version-1 attributes with
variable-length strings in a global heap), in a form h5py reads back; the
Keras test files of ``keras_cases.py`` are written with it.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF


class H5Error(ValueError):
    """A file that is not HDF5, or a structure that does not decode."""


class H5Unsupported(H5Error):
    """A valid HDF5 structure outside the subset this module reads."""


# ------------------------------------------------------------------ reader


class _Type:
    """A decoded datatype: ``kind`` is 'num' (with ``np``), 'str'
    (fixed-length, ``size`` bytes) or 'vlstr'."""

    def __init__(self, kind, size, np_dtype=None, utf8=False):
        self.kind, self.size, self.np, self.utf8 = kind, size, np_dtype, utf8


class _Reader:
    def __init__(self, data):
        self.b = memoryview(data)
        self.gcol: Dict[int, Dict[int, bytes]] = {}
        if bytes(self.b[:8]) != SIGNATURE:
            raise H5Error("not an HDF5 file (no signature at offset 0)")
        ver = self.b[8]
        if ver in (0, 1):
            self.so, self.sl = self.b[13], self.b[14]
            self._check_sizes()
            p = 24 + (4 if ver == 1 else 0)
            self.base = self.u(p, 8)
            # the root group's symbol table entry follows four addresses
            self.root = self.u(p + 32 + 8, 8)
        elif ver in (2, 3):
            self.so, self.sl = self.b[9], self.b[10]
            self._check_sizes()
            self.base = self.u(12, 8)
            self.root = self.u(12 + 24, 8)
        else:
            raise H5Unsupported(f"superblock version {ver}")

    def _check_sizes(self):
        if (self.so, self.sl) != (8, 8):
            raise H5Unsupported(f"offset/length sizes {self.so}/{self.sl} "
                                "(only 8/8)")

    def u(self, pos, n):
        return int.from_bytes(self.b[pos:pos + n], "little")

    def addr(self, a):
        return a + self.base

    # -- object headers ----------------------------------------------------
    def messages(self, addr) -> List[Tuple[int, int, int, int]]:
        """-> [(type, flags, data offset, size)] of the object header at
        ``addr``, continuation blocks followed."""
        p = self.addr(addr)
        if bytes(self.b[p:p + 4]) == b"OHDR":
            return self._messages_v2(p)
        if self.b[p] != 1:
            raise H5Error(f"object header version {self.b[p]} at {addr}")
        nmsgs = self.u(p + 2, 2)
        blocks = [(p + 16, self.u(p + 8, 4))]
        out = []
        while blocks and len(out) < nmsgs:
            start, size = blocks.pop(0)
            q, end = start, start + size
            while q + 8 <= end and len(out) < nmsgs:
                mtype, msize, flags = (self.u(q, 2), self.u(q + 2, 2),
                                       self.b[q + 4])
                if mtype == 0x10:
                    blocks.append((self.addr(self.u(q + 8, 8)),
                                   self.u(q + 16, 8)))
                out.append((mtype, flags, q + 8, msize))
                q += 8 + msize
        return out

    def _messages_v2(self, p):
        flags = self.b[p + 5]
        q = p + 6
        if flags & 0x20:
            q += 16
        if flags & 0x10:
            q += 4
        nsz = 1 << (flags & 3)
        blocks = [(q + nsz, self.u(q, nsz))]
        out = []
        while blocks:
            start, size = blocks.pop(0)
            q, end = start, start + size
            while q + 4 <= end:
                mtype, msize, mflags = (self.b[q], self.u(q + 1, 2),
                                        self.b[q + 3])
                q += 4 + (2 if flags & 0x04 else 0)
                if mtype == 0x10:
                    blocks.append((self.addr(self.u(q, 8)) + 4,
                                   self.u(q + 8, 8) - 8))
                if mtype:
                    out.append((mtype, mflags, q, msize))
                q += msize
        return out

    # -- datatypes and dataspaces -------------------------------------------
    def datatype(self, p) -> _Type:
        cls, ver = self.b[p] & 0x0F, self.b[p] >> 4
        bits = self.u(p + 1, 3)
        size = self.u(p + 4, 4)
        if cls in (0, 1) and bits & 1:
            raise H5Unsupported("big-endian numeric datatype")
        if cls == 0:
            signed = bool(bits & 0x08)
            if size not in (1, 2, 4, 8):
                raise H5Unsupported(f"{size}-byte integer")
            return _Type("num", size, np.dtype(f"<{'i' if signed else 'u'}"
                                               f"{size}"))
        if cls == 1:
            if size not in (2, 4, 8):
                raise H5Unsupported(f"{size}-byte float")
            return _Type("num", size, np.dtype(f"<f{size}"))
        if cls == 3:
            return _Type("str", size, utf8=bool((bits >> 4) & 0x0F))
        if cls == 9:
            if bits & 0x0F != 1:
                raise H5Unsupported("variable-length sequence datatype "
                                    "(only variable-length strings)")
            return _Type("vlstr", size, utf8=bool((bits >> 8) & 0x0F))
        raise H5Unsupported(f"datatype class {cls} (version {ver})")

    def dataspace(self, p) -> Optional[tuple]:
        ver, rank = self.b[p], self.b[p + 1]
        if ver == 1:
            q = p + 8
        elif ver == 2:
            if self.b[p + 3] == 2:
                return None  # null dataspace
            q = p + 4
        else:
            raise H5Unsupported(f"dataspace version {ver}")
        return tuple(self.u(q + 8 * i, 8) for i in range(rank))

    # -- values -------------------------------------------------------------
    def heap_object(self, coll, index) -> bytes:
        objs = self.gcol.get(coll)
        if objs is None:
            p = self.addr(coll)
            if bytes(self.b[p:p + 4]) != b"GCOL":
                raise H5Error(f"no global heap collection at {coll}")
            end = p + self.u(p + 8, 8)
            q, objs = p + 16, {}
            while q + 16 <= end:
                idx, size = self.u(q, 2), self.u(q + 8, 8)
                if idx == 0:
                    break
                objs[idx] = bytes(self.b[q + 16:q + 16 + size])
                q += 16 + ((size + 7) & ~7)
            self.gcol[coll] = objs
        return objs[index]

    def values(self, t: _Type, shape, raw):
        n = int(np.prod(shape)) if shape else 1
        if t.kind == "num":
            a = np.frombuffer(raw, t.np, n).reshape(shape)
            return a.copy() if shape else a[()]
        if t.kind == "str":
            a = np.frombuffer(raw, f"S{t.size}", n).reshape(shape)
            return a.copy() if shape else a[()]
        out = []
        for i in range(n):
            ln, coll, idx = struct.unpack_from("<IQI", raw, 16 * i)
            s = self.heap_object(coll, idx)[:ln] if ln else b""
            out.append(s.decode("utf-8" if t.utf8 else "ascii"))
        if not shape:
            return out[0]
        return np.array(out, dtype=object).reshape(shape)

    def attribute(self, p):
        ver = self.b[p]
        nlen, tlen, slen = self.u(p + 2, 2), self.u(p + 4, 2), self.u(p + 6, 2)
        if ver == 1:
            def pad(v):
                return (v + 7) & ~7
            q = p + 8
        elif ver in (2, 3):
            def pad(v):
                return v
            q = p + 8 + (1 if ver == 3 else 0)
        else:
            raise H5Unsupported(f"attribute message version {ver}")
        if ver > 1 and self.b[p + 1] & 0x03:
            raise H5Unsupported("shared datatype or dataspace in an "
                                "attribute")
        name = bytes(self.b[q:q + nlen]).split(b"\0", 1)[0].decode("utf-8")
        q += pad(nlen)
        t = self.datatype(q)
        q += pad(tlen)
        shape = self.dataspace(q)
        q += pad(slen)
        if shape is None:
            return name, None
        n = int(np.prod(shape)) if shape else 1
        return name, self.values(t, shape, bytes(self.b[q:q + n * t.size]))

    # -- groups --------------------------------------------------------------
    def local_heap(self, addr) -> int:
        p = self.addr(addr)
        if bytes(self.b[p:p + 4]) != b"HEAP":
            raise H5Error(f"no local heap at {addr}")
        return self.addr(self.u(p + 24, 8))

    def heap_name(self, data, off) -> str:
        end = bytes(self.b[data + off:data + off + 65536]).index(b"\0")
        return bytes(self.b[data + off:data + off + end]).decode("utf-8")

    def btree_links(self, node, heap_data, out):
        p = self.addr(node)
        if bytes(self.b[p:p + 4]) != b"TREE":
            raise H5Error(f"no v1 B-tree node at {node}")
        if self.b[p + 4] != 0:
            raise H5Error("v1 B-tree of a group is not of type 0")
        level, used = self.b[p + 5], self.u(p + 6, 2)
        q = p + 24
        for i in range(used):
            child = self.u(q + 8 + 16 * i, 8)
            if level:
                self.btree_links(child, heap_data, out)
                continue
            s = self.addr(child)
            if bytes(self.b[s:s + 4]) != b"SNOD":
                raise H5Error(f"no symbol table node at {child}")
            for j in range(self.u(s + 6, 2)):
                e = s + 8 + 40 * j
                out[self.heap_name(heap_data, self.u(e, 8))] = self.u(e + 8, 8)

    def link(self, p):
        flags = self.b[p + 1]
        q = p + 2
        ltype = 0
        if flags & 0x08:
            ltype = self.b[q]
            q += 1
        if flags & 0x04:
            q += 8
        if flags & 0x10:
            q += 1
        nsz = 1 << (flags & 3)
        nlen = self.u(q, nsz)
        q += nsz
        name = bytes(self.b[q:q + nlen]).decode("utf-8")
        if ltype != 0:
            raise H5Unsupported(f"link type {ltype} ({name!r}): only hard "
                                "links")
        return name, self.u(q + nlen, 8)


class _Node:
    def __init__(self, r: _Reader, addr: int, name: str):
        self._r, self._addr, self.name = r, addr, name
        self.attrs: Dict[str, object] = {}
        self._msgs = r.messages(addr)
        for mtype, flags, p, size in self._msgs:
            if flags & 0x02:
                raise H5Unsupported(f"{name}: shared message type {mtype}")
            if mtype == 0x0C:
                k, v = r.attribute(p)
                self.attrs[k] = v
            elif mtype == 0x15:
                if r.u(p + 2 + (2 if r.b[p + 1] & 1 else 0), 8) != UNDEF:
                    raise H5Unsupported(f"{name}: dense attribute storage")
        # in name order, as h5py lists them
        self.attrs = dict(sorted(self.attrs.items(),
                                 key=lambda kv: kv[0].encode("utf-8")))


class Group(_Node):
    """A group: ``g[name]`` (a '/'-separated path), iteration in name
    order (h5py's), ``get``, ``visititems``, ``attrs``."""

    def __init__(self, r, addr, name="/"):
        super().__init__(r, addr, name)
        links: Dict[str, int] = {}
        for mtype, _flags, p, _size in self._msgs:
            if mtype == 0x11:
                r.btree_links(r.u(p, 8), r.local_heap(r.u(p + 8, 8)), links)
            elif mtype == 0x06:
                k, a = r.link(p)
                links[k] = a
            elif mtype == 0x02:
                q = p + 2 + (8 if r.b[p + 1] & 1 else 0)
                if r.u(q, 8) != UNDEF:
                    raise H5Unsupported(f"{name}: dense link storage "
                                        "(fractal heap)")
        self._links = dict(sorted(links.items(),
                                  key=lambda kv: kv[0].encode("utf-8")))
        self._cache: Dict[str, _Node] = {}

    def _child(self, key):
        obj = self._cache.get(key)
        if obj is None:
            addr = self._links[key]
            path = (self.name.rstrip("/") + "/" + key)
            kinds = {m[0] for m in self._r.messages(addr)}
            obj = (Group(self._r, addr, path) if kinds & {0x11, 0x06, 0x02}
                   or 0x08 not in kinds else Dataset(self._r, addr, path))
            self._cache[key] = obj
        return obj

    def __getitem__(self, path: str):
        node = self
        for part in [s for s in path.split("/") if s]:
            if not isinstance(node, Group) or part not in node._links:
                raise KeyError(f"{path!r} not in {self.name!r}")
            node = node._child(part)
        return node

    def get(self, path, default=None):
        try:
            return self[path]
        except KeyError:
            return default

    def __contains__(self, path):
        return self.get(path) is not None

    def __iter__(self):
        return iter(self._links)

    def __len__(self):
        return len(self._links)

    def visititems(self, fn):
        """``fn(relative path, obj)`` for every object below, depth first
        in name order, as h5py's ``visititems``; stops at a non-None
        return."""
        def walk(g, prefix):
            for k in g:
                obj = g._child(k)
                rel = prefix + k
                got = fn(rel, obj)
                if got is not None:
                    return got
                if isinstance(obj, Group):
                    got = walk(obj, rel + "/")
                    if got is not None:
                        return got
            return None
        return walk(self, "")


class Dataset(_Node):
    """A dataset: ``shape``, ``dtype``, ``attrs``; ``np.asarray(ds)`` or
    ``ds[()]`` reads it."""

    def __init__(self, r, addr, name):
        super().__init__(r, addr, name)
        self._type = self._layout = None
        self.shape = ()
        for mtype, _flags, p, size in self._msgs:
            if mtype == 0x01:
                self.shape = r.dataspace(p)
            elif mtype == 0x03:
                self._type = r.datatype(p)
            elif mtype == 0x08:
                self._layout = (p, size)
            elif mtype == 0x0B:
                raise H5Unsupported(f"{name}: filtered dataset (filter "
                                    "pipeline message)")
        if self._type is None or self._layout is None:
            raise H5Error(f"{name}: dataset without datatype or layout")
        p, _ = self._layout
        ver = r.b[p]
        if ver < 3:
            raise H5Unsupported(f"{name}: data layout message version {ver}")
        self._class = r.b[p + 1]
        if self._class == 2:
            raise H5Unsupported(f"{name}: chunked dataset (only contiguous "
                                "and compact layouts)")
        if self._class not in (0, 1):
            raise H5Unsupported(f"{name}: layout class {self._class}")
        self.dtype = (self._type.np if self._type.kind == "num"
                      else np.dtype(object) if self._type.kind == "vlstr"
                      else np.dtype(f"S{self._type.size}"))

    def read(self):
        r, (p, _) = self._r, self._layout
        shape = self.shape or ()
        n = (int(np.prod(shape)) if shape else 1) * self._type.size
        if self._class == 0:
            raw = bytes(r.b[p + 4:p + 4 + r.u(p + 2, 2)])
        else:
            addr = r.u(p + 2, 8)
            raw = (bytes(n) if addr == UNDEF
                   else bytes(r.b[r.addr(addr):r.addr(addr) + n]))
        if len(raw) < n:
            raise H5Error(f"{self.name}: data runs past the end of the file")
        return r.values(self._type, shape, raw)

    def __getitem__(self, key):
        return self.read()[key]

    def __array__(self, dtype=None, copy=None):
        a = np.asarray(self.read())
        return a.astype(dtype) if dtype is not None else a


class File(Group):
    """An HDF5 file read whole into memory, from a path, bytes or a binary
    file object; its root group."""

    def __init__(self, src, mode="r"):
        if mode != "r":
            raise ValueError("h5mini.File reads only (use Writer)")
        if isinstance(src, (bytes, bytearray, memoryview)):
            data = bytes(src)
        elif hasattr(src, "read"):
            data = src.read()
        else:
            with open(src, "rb") as f:
                data = f.read()
        r = _Reader(data)
        super().__init__(r, r.root, "/")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def close(self):
        pass


# ------------------------------------------------------------------ writer


def _pad8(b: bytes) -> bytes:
    return b + bytes(-len(b) % 8)


def _u(v, n):
    return int(v).to_bytes(n, "little")


_FLOAT_PROPS = {2: (16, 10, 5, 0, 10, 15), 4: (32, 23, 8, 0, 23, 127),
                8: (64, 52, 11, 0, 52, 1023)}


def _enc_datatype(kind, dt=None, size=0) -> bytes:
    if kind == "vlstr":
        # variable-length string, null-terminated, UTF-8; its base type is
        # a 1-byte UTF-8 string, as h5py writes it
        base = bytes([0x13, 0x10, 0, 0]) + _u(1, 4)
        return bytes([0x19, 0x01, 0x01, 0x00]) + _u(16, 4) + base
    if kind == "str":
        return bytes([0x13, 0x00, 0, 0]) + _u(size, 4)
    dt = np.dtype(dt)
    if dt.kind == "f":
        prec, eloc, esz, mloc, msz, bias = _FLOAT_PROPS[dt.itemsize]
        return (bytes([0x11, 0x20, prec - 1, 0]) + _u(dt.itemsize, 4)
                + _u(0, 2) + _u(prec, 2)
                + bytes([eloc, esz, mloc, msz]) + _u(bias, 4))
    if dt.kind in "iub":
        signed = 0x08 if dt.kind == "i" else 0
        return (bytes([0x10, signed, 0, 0]) + _u(dt.itemsize, 4)
                + _u(0, 2) + _u(8 * dt.itemsize, 2))
    raise H5Unsupported(f"cannot write dtype {dt}")


def _enc_dataspace(shape) -> bytes:
    return (bytes([1, len(shape), 0, 0]) + bytes(4)
            + b"".join(_u(d, 8) for d in shape))


class WGroup:
    """A group to write: ``attrs`` (str -> str, a list of str, or an array),
    ``create_group``, ``create_dataset``."""

    def __init__(self):
        self.attrs: Dict[str, object] = {}
        self.children: Dict[str, object] = {}

    def create_group(self, path: str) -> "WGroup":
        g = self
        for part in [s for s in path.split("/") if s]:
            g = g.children.setdefault(part, WGroup())
        return g

    def create_dataset(self, path: str, data) -> "WDataset":
        *head, last = [s for s in path.split("/") if s]
        g = self.create_group("/".join(head)) if head else self
        ds = WDataset(np.ascontiguousarray(data))
        g.children[last] = ds
        return ds


class WDataset:
    def __init__(self, data: np.ndarray):
        if data.dtype.byteorder == ">":
            data = data.astype(data.dtype.newbyteorder("<"))
        self.data = data
        self.attrs: Dict[str, object] = {}


class Writer(WGroup):
    """The root group of a file to write; :meth:`tobytes` and
    :meth:`save` serialize it (superblock 0, group leaf K 4, internal K
    16, as the HDF5 library writes by default)."""

    LEAF_K, NODE_K = 4, 16

    def tobytes(self) -> bytes:
        self._out = bytearray(96)
        strings: Dict[bytes, None] = {}
        self._collect(self, strings)
        self._vl = self._write_global_heap(list(strings))
        root, btree, heap = self._write_group(self)
        sb = (SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
              + _u(self.LEAF_K, 2) + _u(self.NODE_K, 2) + _u(0, 4)
              + _u(0, 8) + _u(UNDEF, 8) + _u(len(self._out), 8)
              + _u(UNDEF, 8)
              + _u(0, 8) + _u(root, 8) + _u(1, 4) + bytes(4)
              + _u(btree, 8) + _u(heap, 8))
        self._out[:96] = sb
        return bytes(self._out)

    def save(self, path):
        with open(path, "wb") as f:
            f.write(self.tobytes())

    # -- layout --------------------------------------------------------------
    def _put(self, b: bytes) -> int:
        addr = len(self._out)
        self._out += _pad8(bytes(b))
        return addr

    @staticmethod
    def _vl_items(v):
        if isinstance(v, str):
            return [v]
        if isinstance(v, (list, tuple)) or (isinstance(v, np.ndarray)
                                            and v.dtype == object):
            return [str(s) for s in np.asarray(v, dtype=object).ravel()]
        return []

    def _collect(self, node, strings):
        for v in node.attrs.values():
            for s in self._vl_items(v):
                strings[s.encode("utf-8")] = None
        for child in getattr(node, "children", {}).values():
            self._collect(child, strings)

    def _write_global_heap(self, strings) -> Dict[bytes, Tuple[int, int]]:
        """Every distinct variable-length string, in global heap
        collections of at most 65,000 objects and at least 4,096 bytes
        (the library's minimum), the rest of each one free space."""
        refs = {}
        for start in range(0, len(strings), 65000):
            chunk = strings[start:start + 65000]
            body = bytearray()
            for i, s in enumerate(chunk, 1):
                body += _u(i, 2) + _u(1, 2) + bytes(4) + _u(len(s), 8)
                body += _pad8(s)
            size = max(4096, 16 + len(body) + 16)
            free = size - 16 - len(body)
            body += _u(0, 2) + _u(0, 2) + bytes(4) + _u(free, 8)
            body += bytes(free - 16)
            addr = self._put(b"GCOL" + bytes([1, 0, 0, 0]) + _u(size, 8)
                             + bytes(body))
            refs.update((s, (addr, i)) for i, s in enumerate(chunk, 1))
        return refs

    def _attr_message(self, name, v) -> bytes:
        vl = self._vl_items(v)
        if vl:
            shape = () if isinstance(v, str) else (len(vl),)
            dtype = _enc_datatype("vlstr")
            data = b""
            for s in vl:
                b = s.encode("utf-8")
                addr, idx = self._vl[b]
                data += _u(len(b), 4) + _u(addr, 8) + _u(idx, 4)
        else:
            a = np.asarray(v)
            if a.dtype.kind == "S":
                dtype = _enc_datatype("str", size=a.dtype.itemsize)
            else:
                a = a.astype(a.dtype.newbyteorder("<"))
                dtype = _enc_datatype("num", a.dtype)
            shape, data = a.shape, a.tobytes()
        nm = name.encode("utf-8") + b"\0"
        space = _enc_dataspace(shape)
        return (bytes([1, 0]) + _u(len(nm), 2) + _u(len(dtype), 2)
                + _u(len(space), 2) + _pad8(nm) + _pad8(dtype)
                + _pad8(space) + data)

    def _header(self, msgs: List[Tuple[int, bytes]]) -> int:
        body = b"".join(_u(t, 2) + _u(len(_pad8(m)), 2) + bytes(4)
                        + _pad8(m) for t, m in msgs)
        return self._put(bytes([1, 0]) + _u(len(msgs), 2) + _u(1, 4)
                         + _u(len(body), 4) + bytes(4) + body)

    def _write_dataset(self, ds: WDataset) -> int:
        a = ds.data
        raw = a.tobytes()
        data_addr = self._put(raw) if raw else UNDEF
        msgs = [(0x01, _enc_dataspace(a.shape)),
                (0x03, _enc_datatype("num", a.dtype)),
                (0x05, bytes([2, 2, 2, 1]) + _u(0, 4)),
                (0x08, bytes([3, 1]) + _u(data_addr, 8) + _u(len(raw), 8))]
        msgs += [(0x0C, self._attr_message(k, v)) for k, v in ds.attrs.items()]
        return self._header(msgs)

    def _write_group(self, g: WGroup) -> Tuple[int, int, int]:
        entries = []
        for name in sorted(g.children, key=lambda s: s.encode("utf-8")):
            child = g.children[name]
            addr = (self._write_group(child)[0] if isinstance(child, WGroup)
                    else self._write_dataset(child))
            entries.append((name.encode("utf-8"), addr))
        # local heap: "" at offset 0, then each name, 8-byte aligned; no
        # free block (H5HL_FREE_NULL = 1)
        names, offsets = bytearray(8), []
        for nm, _ in entries:
            offsets.append(len(names))
            names += _pad8(nm + b"\0")
        heap = len(self._out)
        self._put(b"HEAP" + bytes(4) + _u(len(names), 8) + _u(1, 8)
                  + _u(heap + 32, 8) + bytes(names))
        # symbol table nodes of at most 2 * LEAF_K entries (allocated
        # whole), keyed by their last name, under B-tree nodes of at most
        # 2 * NODE_K children
        cap = 2 * self.LEAF_K
        nodes = []
        for i in range(0, len(entries), cap):
            chunk = entries[i:i + cap]
            body = b"SNOD" + bytes([1, 0]) + _u(len(chunk), 2)
            for (nm, addr), off in zip(chunk, offsets[i:i + cap]):
                body += _u(off, 8) + _u(addr, 8) + bytes(24)
            body += bytes(8 + 40 * cap - len(body))
            nodes.append((self._put(body), offsets[i + len(chunk) - 1]))
        level = 0
        while True:
            parents = []
            for i in range(0, max(len(nodes), 1), 2 * self.NODE_K):
                kids = nodes[i:i + 2 * self.NODE_K]
                body = (b"TREE" + bytes([0, level]) + _u(len(kids), 2)
                        + _u(UNDEF, 8) + _u(UNDEF, 8) + _u(0, 8))
                for addr, key in kids:
                    body += _u(addr, 8) + _u(key, 8)
                body += bytes(24 + 2 * self.NODE_K * 16 + 8 - len(body))
                parents.append((self._put(body), kids[-1][1] if kids else 0))
            if len(parents) == 1:
                btree = parents[0][0]
                break
            nodes, level = parents, level + 1
        msgs = [(0x11, _u(btree, 8) + _u(heap, 8))]
        msgs += [(0x0C, self._attr_message(k, v)) for k, v in g.attrs.items()]
        return self._header(msgs), btree, heap


__all__ = ["File", "Group", "Dataset", "Writer", "WGroup", "WDataset",
           "H5Error", "H5Unsupported"]
