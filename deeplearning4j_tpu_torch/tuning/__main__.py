"""Sweep the registered search spaces into a tuning database.

    python -m deeplearning4j_tpu_torch.tuning --db build/tuning_db \\
        --spaces conv2d_tiles,lstm_tiles [--json]

Each measurable space is swept at its default contexts (on a card: the
ResNet-50 3x3 stage geometries at batch 32 and the char-RNN's LSTM; on the
CPU, tiny machinery-proof shapes whose winners rank nothing): candidates
gated against ``exact``, timed, the winner committed. A second run over
the same database measures nothing (status ``warm``). Declared spaces are
listed with what measuring them requires. Arm the database for ``auto``
dispatch with ``DL4J_TPU_TUNING_DB=<dir>`` or ``tuning.set_database(dir)``.
Exit status 1 when a sweep found no candidate that passes the gate.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--db", default=None,
                    help="database directory (default: DL4J_TPU_TUNING_DB, "
                         "else ./tuning_db)")
    ap.add_argument("--spaces", default=None,
                    help="comma-separated space names (default: every "
                         "measurable space)")
    ap.add_argument("--search", choices=("grid", "random"), default="grid")
    ap.add_argument("--samples", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--min-window", type=float, default=0.05)
    ap.add_argument("--force", action="store_true",
                    help="re-measure even where a warm entry exists")
    ap.add_argument("--json", action="store_true",
                    help="print one JSON report line")
    args = ap.parse_args(argv)

    from deeplearning4j_tpu_torch import tuning
    from deeplearning4j_tpu_torch.util import telemetry as tm

    db = tuning.set_database(args.db or tuning.database_dir() or "tuning_db")
    driver = tuning.MeasurementDriver(
        db, search=args.search, samples=args.samples, seed=args.seed,
        runs=args.runs, min_window_s=args.min_window)
    names = ([s.strip() for s in args.spaces.split(",") if s.strip()]
             if args.spaces else tuning.measurable_spaces())
    report = {"db": db.dir, "backend": tuning.TuningKey.for_op(
        "", "", "").backend, "spaces": [], "declared": []}
    failures = 0
    t_start = time.time()
    for name in names:
        space = tuning.get_space(name)
        if not space.measurable:
            report["declared"].append(
                {"space": name, "requires": space.requires,
                 "candidates": [c.label for c in space.enumerate({})]})
            continue
        for ctx in space.default_contexts():
            t0 = time.time()
            try:
                entry = driver.sweep(space, ctx, force=args.force)
            except RuntimeError as e:
                failures += 1
                report["spaces"].append(
                    {"space": name, "ctx": ctx, "error": str(e)})
                continue
            rows = entry.get("measured", [])
            report["spaces"].append({
                "space": name, "sig": space.key(ctx).sig,
                "dtype": space.dtype(ctx), "status": entry["status"],
                "winner": entry["winner"],
                "speedup_vs_default": entry.get("speedup_vs_default"),
                "admitted": sum(1 for r in rows if r.get("admitted")),
                "rejected": sum(1 for r in rows
                                if r.get("admitted") is False),
                "sweep_seconds": round(time.time() - t0, 2)})
    snap = tm.get_telemetry().snapshot()
    report["counters"] = {n: v for n, v in snap["counters"].items()
                          if n.startswith("tuning.")}
    report["db_stats"] = db.stats()
    report["wall_seconds"] = round(time.time() - t_start, 2)
    if args.json:
        print(json.dumps(report))
    else:
        print(f"tuning: backend={report['backend']} db={db.dir}")
        for row in report["spaces"]:
            if "error" in row:
                print(f"  FAIL  {row['space']}: {row['error']}")
                continue
            w = row["winner"]
            print(f"  {row['status']:<9} {row['space']:<14} "
                  f"{row['sig']:<48} {row['dtype']:<9} -> {w['label']} "
                  f"({w['ms']:.4g} ms, x{row['speedup_vs_default']:g} vs "
                  f"default)")
        for row in report["declared"]:
            print(f"  declared  {row['space']:<14} requires "
                  f"{row['requires']}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
