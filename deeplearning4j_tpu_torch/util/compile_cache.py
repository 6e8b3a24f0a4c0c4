"""The persistent compile cache (counterpart of
deeplearning4j_tpu/util/compile_cache.py).

A fresh process pays for every program it builds even when an identical
one was built seconds earlier by the run before it: the cold-start cost
of a restarted server. The reference points JAX's content-addressed
on-disk executable cache at a directory. The port's compiled artefact is
the kernel library (``ops/kernels/_build.py``): every ``csrc/*.cu``
compiled by ``nvcc`` for ``sm_90a`` and linked into one shared object,
named by a hash of the sources, the headers and the flags. Without a
cache it lives in the checkout's ``build/kernels/``; with one, a process
builds it into the cache directory once and every later process (a fresh
checkout's too) loads it from there and runs no ``nvcc``. An edited
source misses cleanly (a new hash); :func:`clear_persistent_cache` prunes.

- ``DL4J_TPU_COMPILE_CACHE=<dir>``: enabled once when the environment is
  first read (``config.py``).
- :func:`enable_persistent_cache`: the programmatic form; returns the dir.

A CUDA graph holds one process's device addresses, so what a warm process
still builds is its graphs: ``util/aot_store.py`` keeps what they need.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

from deeplearning4j_tpu_torch.ops.kernels import _build

_enabled_dir: Optional[str] = None

#: what a cache entry's file name starts with (``_build.library_path``)
_ENTRY_PREFIX = "libdl4j_torch_kernels_"


def enable_persistent_cache(cache_dir: Optional[str] = None) -> str:
    """Build and load the kernel library in ``cache_dir`` (created if
    missing; default ``DL4J_TPU_COMPILE_CACHE``, else the checkout's
    ``build/kernels/``). Idempotent; returns the dir. A library already
    loaded by this process stays loaded."""
    global _enabled_dir
    from deeplearning4j_tpu_torch.util import telemetry as tm

    cache_dir = os.path.abspath(
        cache_dir or os.environ.get("DL4J_TPU_COMPILE_CACHE")
        or str(_build.BUILD_DIR))
    os.makedirs(cache_dir, exist_ok=True)
    _build.set_build_dir(cache_dir)
    tm.counter("compile_cache.enables_total")
    _enabled_dir = cache_dir
    return cache_dir


def disable_persistent_cache() -> None:
    """Back to the checkout's ``build/kernels/``."""
    global _enabled_dir
    _build.set_build_dir(None)
    _enabled_dir = None


def cache_dir() -> Optional[str]:
    """The active cache dir, or None when the persistent cache is off."""
    return _enabled_dir


def cache_entries(path: Optional[str] = None) -> int:
    """Number of kernel libraries in the cache dir (0 if absent)."""
    path = path or _enabled_dir
    if not path or not os.path.isdir(path):
        return 0
    return sum(1 for f in os.listdir(path)
               if f.startswith(_ENTRY_PREFIX) and f.endswith(".so"))


def clear_persistent_cache(path: Optional[str] = None) -> None:
    """Remove every entry under the cache dir (the dir itself stays)."""
    path = path or _enabled_dir
    if not path or not os.path.isdir(path):
        return
    for name in os.listdir(path):
        full = os.path.join(path, name)
        if os.path.isdir(full):
            shutil.rmtree(full, ignore_errors=True)
        else:
            try:
                os.remove(full)
            except OSError:
                pass
