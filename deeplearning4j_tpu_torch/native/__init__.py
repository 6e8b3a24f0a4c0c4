"""Native runtime bindings: host arena, CSV parse and pipeline, image
decode and pipeline (counterpart of deeplearning4j_tpu/native/__init__.py).

The flat C ABI of ``csrc/dl4jtpu_native.cpp`` and ``csrc/dl4jtpu_image.cpp``
(the port's copies of the reference's sources, with the CSV pipeline's
wake-ups repaired) is bound through ctypes, as the reference binds it. The
library is built with the system ``g++`` on first use into
``build/native/`` at the root of the checkout, named by a hash of the
sources and the flags, as ``ops/kernels/_build.py`` names the CUDA
library: an edited source gets a new library on its next load, an
unchanged one is reused, and nothing is written inside the package.

As in the reference, when the image libraries (``libjpeg``, ``libpng``)
do not link, a CSV-only library is built instead: :func:`image_available`
is then False and :func:`image_build_error` holds the compiler's error.
:func:`build_info` says which library loaded and how long the build took.

:class:`AsyncImagePipeline` decodes each batch into a page-locked host
buffer from a small ring when a CUDA device is present (the reference
allocates a fresh ``np.empty`` per batch). A slot is reused only once the
host-to-device copy that read it has finished: :meth:`AsyncImagePipeline.
next_batch` returns, with the batch, the slot's ``release_after``, to which
the copier hands its CUDA event (``data/prefetch.py`` does this); a slot
handed out without one gets a fresh buffer, so a batch the caller keeps is
never overwritten.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "csrc" / "dl4jtpu_native.cpp"
_SRC_IMG = _HERE / "csrc" / "dl4jtpu_image.cpp"
BUILD_DIR = _HERE.parents[1] / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
IMAGE_LIBS = ("-ljpeg", "-lpng")

_lib = None
_lock = threading.Lock()
_build_error: Optional[str] = None
_image_build_error: Optional[str] = None
_image_supported = False
_build_seconds: Optional[float] = None
_library: Optional[Path] = None


def library_path(image: bool = True) -> Path:
    """The hashed library for the CSV core (``image=False``) or the CSV
    core with the image decoder."""
    srcs = [_SRC, _SRC_IMG] if image else [_SRC]
    flags = CXX_FLAGS + (IMAGE_LIBS if image else ())
    h = hashlib.sha256(" ".join(flags).encode())
    for src in srcs:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    stem = "libdl4jtpu_native" if image else "libdl4jtpu_native_csv"
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def _compile(image: bool) -> Tuple[Path, Optional[str]]:
    """g++ the library unless it exists. → (path, error or None)."""
    lib = library_path(image)
    if lib.exists():
        return lib, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    srcs = [_SRC, _SRC_IMG] if image else [_SRC]
    cmd = ["g++", *CXX_FLAGS, *map(str, srcs), "-o", str(tmp),
           *(IMAGE_LIBS if image else ())]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:  # no compiler, ...
        return lib, repr(e)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return lib, (proc.stderr or proc.stdout)[-2000:]
    os.replace(tmp, lib)
    return lib, None


def _build() -> Optional[str]:
    """Build (or find) the library; the CSV-only core when the image
    libraries do not link. → error message or None."""
    global _image_supported, _image_build_error, _build_seconds, _library
    t0 = time.perf_counter()
    lib, err = _compile(image=True)
    if err is None:
        _image_supported = True
    else:
        _image_build_error = err
        lib, err2 = _compile(image=False)
        if err2 is not None:
            _build_seconds = time.perf_counter() - t0
            return err
    _build_seconds = time.perf_counter() - t0
    _library = lib
    return None


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        err = _build()
        if err is not None:
            _build_error = err
            return None
        lib = ctypes.CDLL(str(_library))
        lib.arena_create.restype = ctypes.c_void_p
        lib.arena_create.argtypes = [ctypes.c_size_t]
        lib.arena_alloc.restype = ctypes.c_void_p
        lib.arena_alloc.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t]
        lib.arena_reset.argtypes = [ctypes.c_void_p]
        lib.arena_used.restype = ctypes.c_size_t
        lib.arena_used.argtypes = [ctypes.c_void_p]
        lib.arena_capacity.restype = ctypes.c_size_t
        lib.arena_capacity.argtypes = [ctypes.c_void_p]
        lib.arena_destroy.argtypes = [ctypes.c_void_p]
        lib.csv_count_rows.restype = ctypes.c_long
        lib.csv_count_rows.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        lib.csv_parse.restype = ctypes.c_long
        lib.csv_parse.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char,
                                  ctypes.POINTER(ctypes.c_float), ctypes.c_long,
                                  ctypes.c_long]
        lib.pipe_create.restype = ctypes.c_void_p
        lib.pipe_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                    ctypes.c_int, ctypes.c_char, ctypes.c_int,
                                    ctypes.c_int]
        lib.pipe_next.restype = ctypes.c_long
        lib.pipe_next.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                                  ctypes.POINTER(ctypes.c_int)]
        lib.pipe_free_batch.argtypes = [ctypes.POINTER(ctypes.c_float)]
        lib.pipe_destroy.argtypes = [ctypes.c_void_p]
        if hasattr(lib, "image_decode_file"):
            lib.image_decode_file.restype = ctypes.c_int
            lib.image_decode_file.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float)]
            lib.img_pipe_create.restype = ctypes.c_void_p
            lib.img_pipe_create.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int),
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int]
            lib.img_pipe_next_batch.restype = ctypes.c_long
            lib.img_pipe_next_batch.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.c_long, ctypes.POINTER(ctypes.c_int)]
            lib.img_pipe_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def is_available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    _load()
    return _build_error


def image_build_error() -> Optional[str]:
    """The compiler's error when the image decoder did not build (the
    CSV-only core loaded instead), else None."""
    _load()
    return _image_build_error


def build_info() -> dict:
    """Which library loaded, whether the image decoder is in it, and the
    seconds the build took (near 0 when a built library was reused)."""
    _load()
    return {"library": None if _library is None else str(_library),
            "image": _image_supported, "seconds": _build_seconds,
            "error": _build_error, "image_error": _image_build_error}


# ---------------------------------------------------------------------------
# Host arena (workspace parity)
# ---------------------------------------------------------------------------


class HostArena:
    """Page-aligned bump allocator for staging buffers (MemoryWorkspace
    parity — scoped use: allocate per step, reset after the copy to the
    device)."""

    def __init__(self, capacity_bytes: int):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {_build_error}")
        self._lib = lib
        self._ptr = lib.arena_create(capacity_bytes)
        if not self._ptr:
            raise MemoryError("arena_create failed")

    def alloc_array(self, shape, dtype=np.float32, align: int = 64) -> np.ndarray:
        """A numpy view over arena memory (no copy on reset — reuse)."""
        dtype = np.dtype(dtype)
        nbytes = int(np.prod(shape)) * dtype.itemsize
        p = self._lib.arena_alloc(self._ptr, nbytes, align)
        if not p:
            raise MemoryError("arena exhausted")
        buf = (ctypes.c_char * nbytes).from_address(p)
        return np.frombuffer(buf, dtype=dtype).reshape(shape)

    def used(self) -> int:
        return self._lib.arena_used(self._ptr)

    def capacity(self) -> int:
        return self._lib.arena_capacity(self._ptr)

    def reset(self):
        """Invalidates previously returned views — scope discipline is the
        caller's (the reference throws on workspace scope violations)."""
        self._lib.arena_reset(self._ptr)

    def close(self):
        if self._ptr:
            self._lib.arena_destroy(self._ptr)
            self._ptr = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# CSV
# ---------------------------------------------------------------------------


def parse_csv(text: bytes, cols: int, delimiter: str = ",") -> np.ndarray:
    """Parse CSV bytes → (rows, cols) float32. Non-numeric cells → NaN."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_build_error}")
    if isinstance(text, str):
        text = text.encode()
    rows = lib.csv_count_rows(text, len(text))
    out = np.empty((rows, cols), np.float32)
    parsed = lib.csv_parse(
        text, len(text), delimiter.encode()[0:1],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), rows, cols)
    if parsed < 0:
        raise ValueError("malformed CSV (inconsistent column count)")
    return out[:parsed]


class AsyncCSVPipeline:
    """Threaded read+parse of many CSV files, delivered in order
    (AsyncDataSetIterator parity: bounded prefetch off the training thread).

    Iterate → (file_index, float32 array (rows, cols))."""

    def __init__(self, paths: List[str], cols: int, delimiter: str = ",",
                 n_threads: int = 2, prefetch: int = 4):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {_build_error}")
        self._lib = lib
        self.paths = [os.fspath(p) for p in paths]
        self.cols = cols
        arr = (ctypes.c_char_p * len(self.paths))(
            *[p.encode() for p in self.paths])
        self._keepalive = arr
        self._ptr = lib.pipe_create(arr, len(self.paths), cols,
                                    delimiter.encode()[0:1], n_threads, prefetch)

    def __iter__(self):
        return self

    def __next__(self) -> Tuple[int, np.ndarray]:
        data = ctypes.POINTER(ctypes.c_float)()
        idx = ctypes.c_int()
        rows = self._lib.pipe_next(self._ptr, ctypes.byref(data),
                                   ctypes.byref(idx))
        if rows == -3:
            raise StopIteration
        if rows == -1:
            raise ValueError(f"malformed CSV: {self.paths[idx.value]}")
        if rows == -2:
            raise IOError(f"unreadable file: {self.paths[idx.value]}")
        try:
            arr = np.ctypeslib.as_array(data, shape=(rows, self.cols)).copy()
        finally:
            self._lib.pipe_free_batch(data)
        return idx.value, arr

    def close(self):
        if getattr(self, "_ptr", None):
            self._lib.pipe_destroy(self._ptr)
            self._ptr = None

    def __del__(self):
        self.close()


# ---------------------------------------------------------------------------
# Image pipeline (NativeImageLoader parity)
# ---------------------------------------------------------------------------


def image_available() -> bool:
    """True when the native image decode path (libjpeg/libpng) compiled in."""
    return _load() is not None and hasattr(_lib, "image_decode_file")


def decode_image_file(path: str, height: int, width: int,
                      channels: int = 3) -> np.ndarray:
    """Decode JPEG/PNG + bilinear resize → float32 (H, W, C) in [0, 255]."""
    lib = _load()
    if lib is None or not hasattr(lib, "image_decode_file"):
        raise RuntimeError(
            f"native image decode unavailable: "
            f"{_image_build_error or _build_error}")
    out = np.empty((height, width, channels), np.float32)
    rc = lib.image_decode_file(
        os.fspath(path).encode(), height, width, channels,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc == -2:
        raise IOError(f"unreadable image: {path}")
    if rc != 0:
        raise ValueError(f"undecodable image (JPEG/PNG only): {path}")
    return out


class _Slot:
    """One batch buffer of a :class:`_PinnedRing` and the CUDA event of the
    copy that read it last (None until one is handed back)."""

    __slots__ = ("buf", "event", "handed_out", "_lock")

    def __init__(self, buf, lock):
        self.buf = buf
        self.event = None
        self.handed_out = False
        self._lock = lock

    def release_after(self, event) -> None:
        """Hand back the CUDA ``event`` of the copy that read this slot:
        the ring reuses the slot once the event has completed."""
        with self._lock:
            self.event = event


class _PinnedRing:
    """A few page-locked (B, H, W, C) float32 buffers, handed out in turn.
    :meth:`acquire` waits for the event of the copy that last read the slot;
    a slot handed out with no event back gets a fresh buffer instead, since
    its reader is unknown. ``fresh`` counts those."""

    def __init__(self, shape, size: int):
        import torch

        self._torch = torch
        self.shape = tuple(shape)
        self._lock = threading.Lock()
        self.slots = [_Slot(self._alloc(), self._lock) for _ in range(size)]
        self._next = 0
        self.fresh = 0
        self.waits = 0

    def _alloc(self):
        return self._torch.empty(self.shape, dtype=self._torch.float32,
                                 pin_memory=True)

    def acquire(self) -> "_Slot":
        slot = self.slots[self._next]
        self._next = (self._next + 1) % len(self.slots)
        with self._lock:
            event, slot.event = slot.event, None
            if event is None and slot.handed_out:
                slot.buf = self._alloc()
                self.fresh += 1
        if event is not None:
            if not event.query():
                self.waits += 1
            event.synchronize()
        slot.handed_out = True
        return slot


#: batch buffers a pipeline's pinned ring holds: one being filled, one
#: being copied, and the prefetch queue's two
RING_SLOTS = 4


class AsyncImagePipeline:
    """Threaded decode+resize of many images into float32 NHWC batches
    (NativeImageLoader + AsyncDataSetIterator parity: the ETL hot path the
    reference keeps native so the accelerator is never input-bound).

    Iterate → (x (n, H, W, C) float32, labels (n,) int32, indices (n,) int32);
    undecodable files are skipped (counted in .failed). Images come in the
    order they finish decoding; ``indices`` names each one's file.

    ``pin_memory`` (default: whether CUDA is available) decodes into a ring
    of RING_SLOTS page-locked buffers, so ``x`` is a view of one of them;
    see :meth:`next_batch`. Without it each batch is a fresh array, as in
    the reference."""

    def __init__(self, paths, labels=None, height=224, width=224, channels=3,
                 batch=32, n_threads: int = 4, prefetch: int = 64,
                 pin_memory: Optional[bool] = None):
        lib = _load()
        if lib is None or not hasattr(lib, "img_pipe_create"):
            raise RuntimeError(
                f"native image pipeline unavailable: "
                f"{_image_build_error or _build_error}")
        self._lib = lib
        self.paths = [os.fspath(p) for p in paths]
        self.height, self.width, self.channels = height, width, channels
        self.batch = batch
        self.failed = 0
        self.decoded = 0
        if pin_memory is None:
            import torch

            pin_memory = torch.cuda.is_available()
        self._ring = (_PinnedRing((batch, height, width, channels),
                                  RING_SLOTS) if pin_memory else None)
        arr = (ctypes.c_char_p * len(self.paths))(
            *[p.encode() for p in self.paths])
        labs = (ctypes.c_int * len(self.paths))(
            *([int(l) for l in labels] if labels is not None
              else [-1] * len(self.paths)))
        self._keepalive = (arr, labs)
        self._ptr = lib.img_pipe_create(arr, labs, len(self.paths),
                                        height, width, channels,
                                        n_threads, prefetch)

    @property
    def ring(self) -> Optional[_PinnedRing]:
        return self._ring

    def __iter__(self):
        return self

    def __next__(self):
        x, labels, indices, _ = self.next_batch()
        return x, labels, indices

    def next_batch(self):
        """→ (x, labels, indices, release): ``release`` is the pinned
        slot's ``release_after`` (hand it the event of the copy that reads
        ``x``), or None when ``x`` is a fresh array. Raises StopIteration
        at the end."""
        slot = self._ring.acquire() if self._ring is not None else None
        if slot is not None:
            x = slot.buf.numpy()
        else:
            x = np.empty((self.batch, self.height, self.width,
                          self.channels), np.float32)
        labels = np.empty((self.batch,), np.int32)
        indices = np.empty((self.batch,), np.int32)
        n_failed = ctypes.c_int()
        n = self._lib.img_pipe_next_batch(
            self._ptr, x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            self.batch, ctypes.byref(n_failed))
        self.failed += n_failed.value
        self.decoded += n
        if n == 0:
            raise StopIteration
        return (x[:n], labels[:n], indices[:n],
                None if slot is None else slot.release_after)

    def close(self):
        if getattr(self, "_ptr", None):
            self._lib.img_pipe_destroy(self._ptr)
            self._ptr = None

    def __del__(self):
        self.close()
