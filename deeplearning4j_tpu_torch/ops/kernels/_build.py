"""Builds the port's CUDA sources into one shared library and loads it
(no counterpart in the JAX package, whose Pallas kernels compile inside
XLA).

The kernels under ``deeplearning4j_tpu_torch/csrc/*.cu`` have a plain C
interface (pointers and the stream as ``void*``), so they compile with
``nvcc`` alone, in seconds, without PyTorch's headers, and are bound with
``ctypes``. Each source compiles to an object in its own ``nvcc`` process,
all started together; one more ``nvcc`` links the objects into a library
in ``build/kernels/`` at the root of the checkout, named by a hash of the
sources, the headers they share (``csrc/*.cuh``) and the flags: an edited
source or header gets a new library on its next load,
an unchanged one is reused. Nothing here runs at import time; the first
kernel launch calls :func:`load`. A build that fails raises with nvcc's
output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: seconds the last build took (0.0 when an existing library was reused)
build_seconds: Optional[float] = None


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelBuildError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
        "build only where the CUDA toolkit is installed")


def sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def headers():
    return sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdl4j_torch_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Start every command at once and wait for all; returns a
    (command, return code, stdout + stderr) triple for each."""
    procs = [(c, subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True))
             for c in cmds]
    done = []
    for c, p in procs:
        out, err = p.communicate()
        done.append((c, p.returncode, out + err))
    return done


def build() -> Path:
    """Compile every source into the hashed library unless it exists."""
    global build_seconds
    lib = library_path()
    if lib.exists():
        build_seconds = 0.0
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{lib.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    t0 = time.perf_counter()
    results = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                        for src, o in zip(sources(), objs)])
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    if all(rc == 0 for _, rc, _ in results):
        results += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                              *map(str, objs)]])
    build_seconds = time.perf_counter() - t0
    (BUILD_DIR / "build.log").write_text("".join(
        " ".join(c) + "\n" + log for c, _, log in results))
    for o in objs:
        o.unlink(missing_ok=True)
    failed = [(c, rc, log) for c, rc, log in results if rc != 0]
    if failed:
        tmp.unlink(missing_ok=True)
        c, rc, log = failed[0]
        raise KernelBuildError(
            f"nvcc failed ({rc}): {' '.join(c)}\n{log[-8000:]}")
    os.replace(tmp, lib)
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.dl4j_conv2d.argtypes = [vp, vp, vp, i, vp, i, vp, vp]
    lib.dl4j_conv2d.restype = i
    lib.dl4j_conv2d_plan.argtypes = [i, vp, ctypes.POINTER(i),
                                     ctypes.POINTER(i)]
    lib.dl4j_conv2d_plan.restype = i
    lib.dl4j_conv2d_spec_bytes.argtypes = []
    lib.dl4j_conv2d_spec_bytes.restype = i
    lib.dl4j_conv2d_wgrad.argtypes = [vp, vp, vp] + [i] * 18 + [vp, vp]
    lib.dl4j_conv2d_wgrad.restype = i
    lib.dl4j_conv2d_wgrad_plan.argtypes = [i] * 17 + [ctypes.POINTER(i)] * 2
    lib.dl4j_conv2d_wgrad_plan.restype = i
    ll = ctypes.c_longlong
    lib.dl4j_flash_fwd.argtypes = ([vp] * 6 + [i] * 6 + [ll] * 12
                                   + [ctypes.c_float, i, vp])
    lib.dl4j_flash_fwd.restype = i
    lib.dl4j_flash_fwd_rows.argtypes = [i] * 2
    lib.dl4j_flash_fwd_rows.restype = i
    lib.dl4j_lstm_cell_fwd.argtypes = [vp] * 6 + [i] * 3 + [ll] + [i] * 4 + [vp]
    lib.dl4j_lstm_cell_fwd.restype = i
    lib.dl4j_lstm_seq_fwd.argtypes = ([vp] * 10 + [i] * 4 + [ll] * 2 + [i] * 5
                                      + [vp])
    lib.dl4j_lstm_seq_fwd.restype = i
    lib.dl4j_lstm_seq_plan.argtypes = [i] * 4 + [ctypes.POINTER(i)] * 5
    lib.dl4j_lstm_seq_plan.restype = i
    lib.dl4j_cuda_error_string.argtypes = [i]
    lib.dl4j_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
        return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t``."""
    if rc != 0:
        msg = load().dl4j_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
