"""Equivalence-gated measurement driver, the search half of the tuner
(counterpart of deeplearning4j_tpu/tuning/measure.py).

A candidate is admitted only after its outputs (value, and gradients where
the space gates them) match the exact path within the space's tolerance;
only admitted candidates are timed; the winner is the fastest admitted
candidate, committed to the tuning database with the whole measurement
table as evidence.

Timing: a two-point fit (time ``n`` calls and ``2n`` calls; per-call cost
(t2 − t1)/n cancels fixed overheads) in a median of ``runs``, each window
sized to at least ``min_window_s``. Each window is closed by the case's
``sync`` (``torch.cuda.synchronize()`` on a card): without it, host wall
time would measure launches, not kernels.

Search: ``grid`` measures every valid candidate; ``random`` samples
``samples`` with a seeded RNG (the registered default always included)
and then walks ``space.neighbors`` of the incumbent until none improves.

Self-test hooks: ``handicap`` adds a per-call sleep to a labelled candidate
(a planted-slow candidate must lose), ``corrupt`` perturbs a labelled
candidate's outputs (a planted wrong candidate must be rejected).
"""

from __future__ import annotations

import math
import random
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.tuning import database as tdb
from deeplearning4j_tpu_torch.tuning.space import Candidate, SearchSpace


def _tm():
    from deeplearning4j_tpu_torch.util import telemetry

    return telemetry


def _host(x) -> np.ndarray:
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, np.float64)


def _max_abs_diff(a, b) -> float:
    """Worst elementwise |a-b| over a pair of trees of tensors, normalised
    per leaf by max(1, |ref|_inf): the tolerance is absolute for O(1)
    magnitudes and relative for large ones."""
    from deeplearning4j_tpu_torch.tree import tree_leaves

    worst = 0.0
    la = tree_leaves(list(a) if isinstance(a, tuple) else a)
    lb = tree_leaves(list(b) if isinstance(b, tuple) else b)
    if len(la) != len(lb):
        return float("inf")
    for xa, xb in zip(la, lb):
        xa = _host(xa)
        xb = _host(xb)
        if xa.shape != xb.shape:
            return float("inf")
        if not (np.all(np.isfinite(xa)) and np.all(np.isfinite(xb))):
            return float("inf")
        scale = max(1.0, float(np.max(np.abs(xa))) if xa.size else 0.0)
        d = float(np.max(np.abs(xa - xb))) / scale if xa.size else 0.0
        worst = max(worst, d)
    return worst


class MeasurementDriver:
    """Sweeps one :class:`SearchSpace` context and commits the winner.

    Parameters: ``db`` (a :class:`tuning.database.TuningDatabase`),
    ``search`` ("grid" | "random"), ``samples`` (random-mode candidate
    budget), ``seed`` (deterministic candidate sampling), ``runs``
    (median-of-N), ``min_window_s`` (minimum timed window)."""

    def __init__(self, db: tdb.TuningDatabase, *, search: str = "grid",
                 samples: int = 6, seed: int = 0, runs: int = 3,
                 min_window_s: float = 0.05):
        if search not in ("grid", "random"):
            raise ValueError(
                f"search must be grid|random, got {search!r}")
        self.db = db
        self.search = search
        self.samples = int(samples)
        self.seed = int(seed)
        self.runs = int(runs)
        self.min_window_s = float(min_window_s)

    # ------------------------------------------------------------ timing
    def _time_candidate(self, run_once: Callable[[], None],
                        handicap_s: float = 0.0,
                        sync: Callable[[], None] = lambda: None):
        """(per_call_ms, noise_str): two-point-fit median-of-N, each
        window closed by ``sync``."""
        def call():
            run_once()
            if handicap_s:
                time.sleep(handicap_s)

        call()  # warm: builds and plans outside the timed window
        sync()
        t0 = time.perf_counter()
        call()
        sync()
        once = max(time.perf_counter() - t0, 1e-7)
        n1 = max(1, int(math.ceil(self.min_window_s / once)))

        def window(n):
            sync()
            t0 = time.perf_counter()
            for _ in range(n):
                call()
            sync()
            return time.perf_counter() - t0

        slopes = []
        for _ in range(self.runs):
            t1 = window(n1)
            t2 = window(2 * n1)
            slopes.append(max((t2 - t1) / n1, 1e-9))
        slopes.sort()
        med = slopes[len(slopes) // 2]
        noise = (slopes[-1] - slopes[0]) / 2.0 / med if med else 0.0
        return med * 1e3, f"±{round(100 * noise, 1)}% ({self.runs}-sample spread/2)"

    # ------------------------------------------------------------ search
    def _select(self, space: SearchSpace, candidates: List[Candidate]):
        if self.search == "grid" or len(candidates) <= self.samples:
            return list(candidates)
        rng = random.Random(self.seed)
        defaults = [c for c in candidates if c.is_default]
        pool = [c for c in candidates if not c.is_default]
        picked = rng.sample(pool, max(0, self.samples - len(defaults)))
        return defaults + picked

    # ------------------------------------------------------------- sweep
    def sweep(self, space: SearchSpace, ctx: dict, *,
              force: bool = False,
              handicap: Optional[Dict[str, float]] = None,
              corrupt: Optional[Dict[str, Callable]] = None) -> dict:
        """Measure one (space, context): returns the committed entry plus
        a ``status`` field — ``"warm"`` (database already holds a winner
        for this key and an UNCHANGED candidate set: nothing measured,
        nothing re-proven — the cross-process contract) or
        ``"measured"``. Raises RuntimeError when no candidate survives
        the equivalence gate (a space whose every candidate is wrong is a
        bug, not a tuning result)."""
        if not space.measurable:
            raise RuntimeError(
                f"space {space.name!r} is declared, not measurable here "
                f"(requires {space.requires})")
        key = space.key(ctx)
        candidates = space.enumerate(ctx)
        digest = tdb.candidates_digest([c.as_dict() for c in candidates])
        if not force:
            entry = self.db.lookup(key)
            if entry is not None \
                    and entry.get("candidates_digest") == digest:
                out = dict(entry)
                out["status"] = "warm"
                return out

        handicap = handicap or {}
        corrupt = corrupt or {}
        case = space.build(ctx)
        reference = case.reference()
        selected = self._select(space, candidates)
        measured: List[dict] = []
        admitted: List[dict] = []
        seen_labels = set()

        def consider(cand: Candidate):
            if cand.label in seen_labels:
                return None
            seen_labels.add(cand.label)
            row = cand.as_dict()
            ok, reason = space.validate(cand, ctx)
            if not ok:
                row.update(admitted=False, reason=f"invalid: {reason}")
                measured.append(row)
                return None
            # the equivalence gate runs BEFORE the stopwatch: a candidate
            # that computes the wrong thing is never even timed
            outputs = case.outputs(cand)
            if cand.label in corrupt:
                outputs = corrupt[cand.label](outputs)
            err = _max_abs_diff(reference, outputs)
            if err > case.tolerance:
                row.update(admitted=False,
                           reason=(f"equivalence: max diff {err:.3e} > "
                                   f"tol {case.tolerance:.0e}"))
                measured.append(row)
                _tm().counter("tuning.equivalence_rejects_total")
                return None
            ms, noise = self._time_candidate(
                case.timer(cand), handicap.get(cand.label, 0.0), case.sync)
            _tm().counter("tuning.measurements_total")
            row.update(admitted=True, ms=round(ms, 6), noise=noise,
                       max_diff=err)
            measured.append(row)
            admitted.append(row)
            return row

        for cand in selected:
            consider(cand)

        # greedy refinement (random mode): walk neighbors of the
        # incumbent until no neighbor improves — deterministic because
        # the incumbent choice and the neighbor order both are
        if self.search == "random" and admitted:
            improved = True
            while improved:
                improved = False
                best = min(admitted, key=lambda r: r["ms"])
                best_cand = next(c for c in candidates
                                 if c.label == best["label"])
                for nb in space.neighbors(best_cand, ctx):
                    row = consider(nb)
                    if row is not None and row["ms"] < best["ms"]:
                        improved = True

        if not admitted:
            raise RuntimeError(
                f"tuning sweep for {space.name} {key.sig}: no candidate "
                "passed the equivalence gate — refusing to commit a "
                f"winner ({len(measured)} candidates rejected)")

        winner_row = min(admitted, key=lambda r: r["ms"])
        default_rows = [r for r in admitted
                        if r.get("is_default")] or admitted
        default_ms = default_rows[0]["ms"]
        winner = {"label": winner_row["label"],
                  "impl": winner_row["impl"],
                  "params": winner_row["params"],
                  "ms": winner_row["ms"], "noise": winner_row["noise"]}
        entry = {
            "schema": tdb.SCHEMA_VERSION,
            "winner": winner,
            "default_ms": default_ms,
            "speedup_vs_default": round(default_ms / winner_row["ms"], 4)
            if winner_row["ms"] else None,
            "tolerance": case.tolerance,
            "candidates_digest": digest,
            "search": {"mode": self.search, "seed": self.seed,
                       "runs": self.runs,
                       "selected": len(seen_labels),
                       "enumerated": len(candidates)},
            "measured": measured,
        }
        self.db.commit(key, entry)
        out = dict(entry)
        out["status"] = "measured"
        out["key"] = key.as_dict()
        return out
