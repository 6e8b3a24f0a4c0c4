"""The on-disk AOT store (counterpart of deeplearning4j_tpu/util/aot_store.py):
what a warm process needs to build a network's programs without being
told their shapes.

The reference serializes each warmed program's lowered module
(``jax.export``), so a warm process skips the Python trace. The port's
programs are CUDA graphs (``nn/capture.py``), and a CUDA graph holds one
process's device addresses: it cannot be stored. So an entry holds what a
later process can reuse:

- the program's tag (``mln_train_step``, ``mln_forward``, ``cg_...``) and
  the shapes and dtypes of its arguments, from which the warm process
  makes its example inputs and builds the same program;
- the kernel plans its build computed (``ops/kernels/conv.py``: each conv
  forward and dgrad launch plan, the dgrad phase plan and a tuned
  ``row_tile`` among its inputs, and each wgrad plan), which the warm
  process makes again before it builds anything.

Together with the persistent kernel-library cache
(``util/compile_cache.py``: no ``nvcc`` in the warm process) a restarted
server's ``warmup(export_dir=...)`` reads its store and captures its
graphs, nothing more.

Key: ``<conf prefix>-<program hash>``. The prefix is a sha256 of the conf
JSON, the torch and CUDA versions, a content digest of every source of
the ``deeplearning4j_tpu_torch`` package (``csrc/`` and the native sources
included) and the environment bits that change a program; the program
hash is one of the tag and the signature. Any change to any of them
misses. An entry is one JSON file written atomically (a temporary file
per process and thread, then ``os.replace``): two processes saving the
same entry at once both leave a readable one. A truncated or unreadable
entry counts as a miss, never an error. ``aot_store.hits_total``,
``misses_total`` and ``saves_total`` count in the telemetry registry.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import Callable, List, Optional

_pkg_digest_cache: Optional[str] = None
_SOURCE_SUFFIXES = (".py", ".cu", ".cuh", ".cpp", ".cc", ".h", ".hpp")
_SUFFIX = ".aot.json"


def _tm():
    from deeplearning4j_tpu_torch.util import telemetry

    return telemetry


def package_digest() -> str:
    """Content digest of every source file of the port's package (Python,
    CUDA and C++), computed once per process: any code change misses."""
    global _pkg_digest_cache
    if _pkg_digest_cache is None:
        import deeplearning4j_tpu_torch

        root = os.path.dirname(os.path.abspath(
            deeplearning4j_tpu_torch.__file__))
        h = hashlib.sha256()
        for dirpath, dirnames, filenames in sorted(os.walk(root)):
            dirnames.sort()
            for fn in sorted(filenames):
                if not fn.endswith(_SOURCE_SUFFIXES):
                    continue
                path = os.path.join(dirpath, fn)
                h.update(os.path.relpath(path, root).encode())
                with open(path, "rb") as fh:
                    h.update(fh.read())
        _pkg_digest_cache = h.hexdigest()
    return _pkg_digest_cache


def encode_args(tree):
    """An argument tree (tensors, None, dicts, lists, tuples) as JSON:
    each tensor as its shape and dtype."""
    import torch

    if tree is None:
        return None
    if isinstance(tree, dict):
        return {"dict": {k: encode_args(v) for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return {"list" if isinstance(tree, list) else "tuple":
                [encode_args(v) for v in tree]}
    if isinstance(tree, torch.Tensor):
        return {"shape": list(tree.shape),
                "dtype": str(tree.dtype).replace("torch.", "")}
    raise TypeError(f"cannot store argument of type {type(tree).__name__}")


def decode_args(enc, device):
    """:func:`encode_args`' inverse: zeros of each shape and dtype on
    ``device``."""
    import torch

    if enc is None:
        return None
    if "dict" in enc:
        return {k: decode_args(v, device) for k, v in enc["dict"].items()}
    if "list" in enc:
        return [decode_args(v, device) for v in enc["list"]]
    if "tuple" in enc:
        return tuple(decode_args(v, device) for v in enc["tuple"])
    return torch.zeros(tuple(enc["shape"]),
                       dtype=getattr(torch, enc["dtype"]), device=device)


class AotStore:
    """A directory of program entries, loaded by exact key (see the module
    doc)."""

    def __init__(self, directory: str):
        self.dir = os.path.abspath(directory)
        os.makedirs(self.dir, exist_ok=True)

    @staticmethod
    def _env_bits() -> str:
        """Environment flags that change a program."""
        from deeplearning4j_tpu_torch.config import get_environment

        env = get_environment()
        return repr((env.debug, env.profiling, env.nan_panic,
                     env.default_compute_dtype,
                     os.environ.get("DL4J_TORCH_KERNEL_IMPL"),
                     os.environ.get("DL4J_TPU_TUNING_DB")))

    def conf_prefix(self, conf_json: str) -> str:
        """The part of every key that the conf, the versions, the package
        sources and the environment decide."""
        import torch

        h = hashlib.sha256()
        for part in (conf_json, torch.__version__, torch.version.cuda,
                     package_digest(), self._env_bits()):
            h.update(repr(part).encode())
        return h.hexdigest()[:32]

    def key(self, tag: str, conf_json: str, sig) -> str:
        h = hashlib.sha256()
        for part in (tag, repr(sig)):
            h.update(repr(part).encode())
        return f"{self.conf_prefix(conf_json)}-{h.hexdigest()[:32]}"

    def _path(self, key: str) -> str:
        return os.path.join(self.dir, key + _SUFFIX)

    def _read(self, path: str) -> Optional[dict]:
        try:
            with open(path, "r") as fh:
                entry = json.load(fh)
            if not isinstance(entry, dict) or "tag" not in entry \
                    or "args" not in entry:
                return None
            return entry
        except (OSError, ValueError):
            return None  # truncated or unreadable: a miss

    def load(self, key: str) -> Optional[dict]:
        """The entry for ``key``, or None (a miss). Hits and misses feed
        ``aot_store.hits_total`` / ``aot_store.misses_total``."""
        entry = self._read(self._path(key))
        _tm().counter("aot_store.hits_total" if entry is not None
                      else "aot_store.misses_total")
        return entry

    def find(self, conf_json: str) -> List[dict]:
        """Every readable entry of this conf (by key), each counted a hit;
        an unreadable one is counted a miss and skipped."""
        prefix = self.conf_prefix(conf_json) + "-"
        out = []
        for fn in sorted(os.listdir(self.dir)):
            if fn.startswith(prefix) and fn.endswith(_SUFFIX):
                entry = self._read(os.path.join(self.dir, fn))
                _tm().counter("aot_store.hits_total" if entry is not None
                              else "aot_store.misses_total")
                if entry is not None:
                    out.append(entry)
        return out

    def save(self, key: str, entry: dict) -> str:
        """Write ``entry`` under ``key`` atomically."""
        path = self._path(key)
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "w") as fh:
            json.dump(entry, fh)
        os.replace(tmp, path)
        _tm().counter("aot_store.saves_total")
        return path

    def entries(self) -> int:
        return sum(1 for f in os.listdir(self.dir) if f.endswith(_SUFFIX))


def aot_build(store: Optional[AotStore], tag: str, conf_json: str, sig,
              args, build: Callable[[], object]):
    """One program of a warmup, shared by both networks: ``build()``
    makes it; with a store, the entry for (tag, conf, signature) is looked
    up first (its kernel plans made again before the build) and, on a
    miss, saved after the build with the plans the build made."""
    from deeplearning4j_tpu_torch.ops.kernels import conv as _kconv

    if store is None:
        return build()
    key = store.key(tag, conf_json, sig)
    entry = store.load(key)
    if entry is not None:
        _kconv.replan(entry.get("plans", []))
        return build()
    before = _kconv.plans_made()
    prog = build()
    store.save(key, {"tag": tag, "sig": repr(sig),
                     "args": encode_args(args),
                     "plans": _kconv.plans_made()[len(before):]})
    return prog
