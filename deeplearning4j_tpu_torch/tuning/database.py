"""Persistent tuning database: measured winners keyed by (op, shape
signature, dtype, backend, topology), consulted by ``auto`` dispatch
(counterpart of deeplearning4j_tpu/tuning/database.py, the same schema).

Every entry is the committed outcome of one equivalence-gated sweep by
``tuning/measure.py``: the winning candidate (impl + params), its measured
per-call milliseconds, the full per-candidate table, and a digest of the
candidate set so a warm reader can prove the search space has not drifted.

Storage (as the reference's, so either package reads the other's files):

- One JSON file per key under the database directory, named
  ``<op>--<sha16>.json``, the hash over ``op|sig|dtype|backend|topology``.
- Atomic commits (``.tmp`` then ``os.replace``).
- Corrupt or truncated entries are skipped with a warning and a
  ``tuning.corrupt_skipped_total`` counter, never believed.
- The key's backend is ``cuda:sm_<major><minor>`` on a card (``cpu`` on
  the host), its topology ``cuda:<n>:<device name>``; the reference keys
  ``cpu``/``tpu`` and ``<platform>:<n>[:<kind>]``. So a TPU database's
  records never answer for the card, and the card's never for the TPU.

``resolve`` is what ``ops/kernels`` ``auto`` dispatch calls: one memoised
lookup per (op, sig, dtype), with ``tuning.lookups_total`` /
``tuning.hits_total`` counters. ``DL4J_TPU_TUNING_DB`` arms the
process-global database; ``set_database`` re-points it at runtime.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

SCHEMA_VERSION = 1


def _tm():
    from deeplearning4j_tpu_torch.util import telemetry

    return telemetry


def current_backend() -> str:
    """The backend the measurements ran on: ``cuda:sm_<major><minor>``
    when a card is visible (``cuda:sm_90`` on an H100), else ``cpu``."""
    import torch

    if torch.cuda.is_available():
        major, minor = torch.cuda.get_device_capability(0)
        return f"cuda:sm_{major}{minor}"
    return "cpu"


def current_topology() -> str:
    """Device-topology component of the key: ``cuda:<n>:<device name>``
    on cards (an H100 entry must not answer for another card), ``cpu:1``
    on the host."""
    import torch

    if torch.cuda.is_available():
        name = torch.cuda.get_device_name(0).replace(" ", "_")
        return f"cuda:{torch.cuda.device_count()}:{name}"
    return "cpu:1"


@dataclasses.dataclass(frozen=True)
class TuningKey:
    """One measurement context. ``sig`` is the space's canonical shape
    signature (e.g. ``x=8x32x32x4;w=3x3x4x8;s=1x1;...``); conf-scope
    knobs use the reserved ``conf-default`` signature."""

    op: str
    sig: str
    dtype: str
    backend: str
    topology: str

    @staticmethod
    def for_op(op: str, sig: str, dtype: str) -> "TuningKey":
        return TuningKey(op=op, sig=sig, dtype=str(dtype),
                         backend=current_backend(),
                         topology=current_topology())

    def digest(self) -> str:
        payload = "|".join((self.op, self.sig, self.dtype, self.backend,
                            self.topology))
        return hashlib.sha256(payload.encode()).hexdigest()

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def candidates_digest(candidates: List[dict]) -> str:
    """Stable digest of a candidate set (labels + params), so a warm
    lookup can prove the registered search space hasn't changed since the
    entry was measured — a drifted space re-measures instead of trusting
    a stale winner."""
    payload = json.dumps(
        sorted((c.get("label", ""), json.dumps(c.get("params") or {},
                                               sort_keys=True))
               for c in candidates))
    return hashlib.sha256(payload.encode()).hexdigest()


class TuningDatabase:
    """Directory of per-key JSON entries with atomic commits and an
    in-memory read cache (thread-safe; shared by dispatch)."""

    def __init__(self, directory: str):
        # no makedirs here: consultation (get_database/resolve) must be
        # read-only — a typo'd DL4J_TPU_TUNING_DB or a read-only mount
        # degrades to "unmeasured", never a crash mid-trace. The write
        # path (commit) creates the directory.
        self.dir = os.path.abspath(directory)
        self._cache: Dict[str, Optional[dict]] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------- paths
    def _path(self, key: TuningKey) -> str:
        safe_op = "".join(c if c.isalnum() or c in "-_" else "_"
                          for c in key.op)
        return os.path.join(self.dir, f"{safe_op}--{key.digest()[:16]}.json")

    # ----------------------------------------------------------- lookups
    def lookup(self, key: TuningKey) -> Optional[dict]:
        """The committed entry for ``key`` (or None). Counts
        ``tuning.lookups_total`` / ``tuning.hits_total``; both outcomes
        are cached in memory, so consultation from dispatch costs one dict
        probe after the first call."""
        _tm().counter("tuning.lookups_total")
        kd = key.digest()
        with self._lock:
            if kd in self._cache:
                entry = self._cache[kd]
                if entry is not None:
                    _tm().counter("tuning.hits_total")
                return entry
        entry = self._read(key)
        with self._lock:
            self._cache[kd] = entry
        if entry is not None:
            _tm().counter("tuning.hits_total")
        return entry

    def _read(self, key: TuningKey) -> Optional[dict]:
        path = self._path(key)
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                entry = json.load(f)
            if not isinstance(entry, dict) or "winner" not in entry \
                    or entry.get("schema") != SCHEMA_VERSION \
                    or not isinstance(entry.get("key"), dict):
                raise ValueError("not a tuning entry")
        except Exception as e:
            # the restore_latest_good convention: a truncated/corrupt
            # entry (incl. a hand-written one missing "key") is a loud
            # warning and a skip, never a crash — and never silently
            # believed
            logger.warning(
                "tuning database: skipping corrupt entry %s (%s: %s)",
                path, type(e).__name__, e)
            _tm().counter("tuning.corrupt_skipped_total")
            _tm().instant("tuning.corrupt_skipped", path=path)
            return None
        if entry["key"].get("op") != key.op:
            # 16-hex-digit prefix collision across ops is practically
            # impossible, but verify rather than assume
            logger.warning("tuning database: key mismatch in %s", path)
            return None
        return entry

    # ------------------------------------------------------------ writes
    def commit(self, key: TuningKey, entry: dict) -> str:
        """Atomically persist ``entry`` for ``key`` (checkpoint-style
        tmp+rename) and refresh the in-memory cache."""
        entry = dict(entry)
        entry.setdefault("schema", SCHEMA_VERSION)
        entry["key"] = key.as_dict()
        entry.setdefault("created_unix", time.time())
        os.makedirs(self.dir, exist_ok=True)
        path = self._path(key)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(entry, f, indent=2, sort_keys=True)
        os.replace(tmp, path)
        with self._lock:
            self._cache[key.digest()] = entry
        _resolve_cache.clear()   # a fresh winner must reach live dispatch
        _tm().counter("tuning.commits_total")
        return path

    def invalidate_cache(self):
        """Drop the in-memory cache (tests; a sweep writing through a
        SECOND database object pointed at the same directory)."""
        with self._lock:
            self._cache.clear()

    # ------------------------------------------------------------- stats
    def entry_paths(self) -> List[str]:
        try:
            return sorted(
                os.path.join(self.dir, f) for f in os.listdir(self.dir)
                if f.endswith(".json"))
        except OSError:
            return []

    def entries(self) -> int:
        return len(self.entry_paths())

    def all_records(self) -> List[dict]:
        """Every loadable entry (corrupt ones skipped with the warning
        counter) — the sweep report and the stats surface."""
        out = []
        for path in self.entry_paths():
            try:
                with open(path) as f:
                    entry = json.load(f)
                if not isinstance(entry, dict) or "winner" not in entry:
                    raise ValueError("not a tuning entry")
            except Exception as e:
                logger.warning(
                    "tuning database: skipping corrupt entry %s (%s: %s)",
                    path, type(e).__name__, e)
                _tm().counter("tuning.corrupt_skipped_total")
                continue
            out.append(entry)
        return out

    def stats(self) -> dict:
        """Per-op entry counts from the ``<op>--<sha16>.json`` filenames
        alone — /healthz probes this every few seconds, so it must not
        open and parse every entry (``all_records`` is for the sweep
        report, which wants the payloads anyway)."""
        by_op: Dict[str, int] = {}
        paths = self.entry_paths()
        for path in paths:
            stem = os.path.basename(path)[:-len(".json")]
            op = stem.rsplit("--", 1)[0] if "--" in stem else "?"
            by_op[op] = by_op.get(op, 0) + 1
        return {"dir": self.dir, "entries": len(paths),
                "entries_by_op": by_op}


# ------------------------------------------------------- process singleton
_UNSET = object()   # "no explicit set_database call": defer to the env knob
_db: Optional[TuningDatabase] = None
_db_dir: Any = _UNSET
_db_lock = threading.Lock()
# resolve() memo: (db identity, op, sig, dtype) -> winner|None. Building a
# TuningKey costs a sha256 and a device query: fine per sweep, too much per
# eager dispatch. Backend and topology cannot change under a live process,
# so the memo is sound; commits and set_database() clear it.
_resolve_cache: Dict[tuple, Optional[dict]] = {}


def database_dir() -> Optional[str]:
    """The armed database directory (explicit set_database wins over the
    DL4J_TPU_TUNING_DB env knob — including ``set_database(None)``, which
    is explicit OFF, not "defer to env"), or None when tuning is off."""
    if _db_dir is not _UNSET:
        return _db_dir
    return os.environ.get("DL4J_TPU_TUNING_DB") or None


def set_database(directory: Optional[str]) -> Optional[TuningDatabase]:
    """Arm (or, with None, disarm) the process-global tuning database.
    ``None`` disarms even when DL4J_TPU_TUNING_DB is exported — test
    fixtures and benches rely on teardown actually turning tuning off."""
    global _db, _db_dir
    with _db_lock:
        _db_dir = directory
        _db = TuningDatabase(directory) if directory else None
        _resolve_cache.clear()
        return _db


def get_database() -> Optional[TuningDatabase]:
    """The process-global database per :func:`database_dir`, or None."""
    global _db
    d = database_dir()
    if not d:
        return None
    with _db_lock:
        if _db is None or _db.dir != os.path.abspath(d):
            _db = TuningDatabase(d)
            # the memo keys include id(db): clear on re-point so a
            # recycled object address can never alias stale winners
            _resolve_cache.clear()
        return _db


def resolve(op: str, sig: str, dtype) -> Optional[dict]:
    """The winner record (``{"label", "impl", "params", "ms", ...}``) for
    the current backend/topology, or None when no database is armed or no
    entry exists: the one call ``ops/kernels`` ``auto`` dispatch and
    conf-time defaulting make. Memoised per (op, sig, dtype); the lookup
    counters count database lookups, not memo probes."""
    db = get_database()
    if db is None:
        return None
    ck = (id(db), op, sig, str(dtype))
    try:
        return _resolve_cache[ck]
    except KeyError:
        pass
    entry = db.lookup(TuningKey.for_op(op, sig, str(dtype)))
    winner = entry.get("winner") if entry is not None else None
    _resolve_cache[ck] = winner
    return winner


def conf_default(knob: str, dtype: str = "any") -> Optional[Any]:
    """Tuned default for a conf-scope knob (``remat_policy``,
    ``batch_buckets``, ``prefill_chunk``, ``affinity_head``): the winner's
    param value under the reserved ``conf-default`` signature, or None.
    Callers apply it only when the user and the environment left the knob
    unset: tuned evidence fills a deferred default, it never overrides an
    explicit choice."""
    winner = resolve(knob, "conf-default", dtype)
    if winner is None:
        return None
    params = winner.get("params") or {}
    return params.get(knob)


def current_status() -> dict:
    """The /healthz tuning section (sys.modules-guarded in ui_server.py):
    database dir, entry count, lookup/hit/measurement counters; an empty
    dict when no database is armed."""
    db = get_database()
    if db is None:
        return {}
    snap = _tm().get_telemetry().snapshot()
    body = dict(db.stats())
    body["counters"] = {n: v for n, v in snap["counters"].items()
                        if n.startswith("tuning.")}
    return body


def collect_tuning_gauges() -> list:
    """Scrape-time collector for /metrics (``util/telemetry.py``
    ``_collect_tuning``, behind a sys.modules guard)."""
    db = get_database()
    if db is None:
        return [("tuning.db_enabled", {}, 0)]
    return [("tuning.db_enabled", {}, 1),
            ("tuning.db_entries", {}, db.entries())]
