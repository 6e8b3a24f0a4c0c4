"""Fleet worker entry point (counterpart of
deeplearning4j_tpu/serving/fleet_worker.py, whole; ``serving/fleet.py``
spawns it):

    python -m deeplearning4j_tpu_torch.serving.fleet_worker \\
        --spec spec.json --worker-id w0 --ready-file w0.ready.json

Replays the fleet spec (:func:`~deeplearning4j_tpu_torch.serving.fleet.
fleet_spec`): restores each model's ModelSerializer archive on the spec's
``device`` (the card unless the spec says "cpu"; with no card the restore
raises and the process exits non-zero, which the supervisor reports),
registers it on a fresh :class:`ModelRouter`, starts a warmed
:class:`ModelServer` on an ephemeral port (warmup captures the serving
programs in this process's own CUDA context), and publishes
``{"port", "pid", "worker_id", "host"}`` to the ready file (tmp + rename:
the supervisor never reads a torn handshake). It then serves until
SIGTERM, which runs the server's graceful drain (finish queued work, 503
new admissions) before exiting 0.

The supervisor puts the spec's ``env`` into the worker's environment at
spawn, so ``CUDA_VISIBLE_DEVICES``, ``DL4J_TORCH_KERNEL_IMPL`` and the
``DL4J_TPU_*`` knobs are in place before the worker imports torch; the
worker applies them again (an operator's own setting wins) before it
restores anything, so a hand-run with the same spec behaves the same. A
``model_kw`` ``export_dir`` (the reference's AOT store) raises: it comes
with ROADMAP Queue 1 item 12.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def build_router(spec: dict):
    """A ModelRouter loaded per the fleet spec (imported here, after the
    environment is in place)."""
    from deeplearning4j_tpu_torch.data.bucketing import BucketingPolicy
    from deeplearning4j_tpu_torch.serving.model import ServingModel
    from deeplearning4j_tpu_torch.serving.router import ModelRouter
    from deeplearning4j_tpu_torch.util.model_serializer import \
        ModelSerializer

    device = spec.get("device")
    router = ModelRouter(name=spec.get("name", "fleet-worker"),
                         device=device)
    for m in spec.get("models", []):
        kw = dict(m.get("model_kw") or {})
        if kw.get("export_dir") is not None:
            raise NotImplementedError(
                f"model {m['id']!r}: model_kw export_dir is not ported: "
                "the AOT store (util/aot_store.py, util/compile_cache.py) "
                "comes with ROADMAP Queue 1 item 12")
        net = ModelSerializer.restore_model(m["path"], load_updater=False,
                                            device=device)
        b = kw.get("bucketing")
        if isinstance(b, dict):
            kw["bucketing"] = BucketingPolicy(
                batch_buckets=tuple(b["batch_buckets"])
                if b.get("batch_buckets") else None,
                seq_buckets=tuple(b["seq_buckets"])
                if b.get("seq_buckets") else None)
        elif isinstance(b, str):
            kw["bucketing"] = BucketingPolicy.from_spec(b)
        if m.get("draft_path"):
            kw["draft_net"] = ModelSerializer.restore_model(
                m["draft_path"], load_updater=False, device=device)
        model = ServingModel(net, m["id"], kind=m.get("kind", "classify"),
                             quantize=m.get("quantize"), **kw)
        router.register(model, **(m.get("register") or {}))
    return router


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spec", required=True, help="fleet spec JSON path")
    ap.add_argument("--worker-id", required=True)
    ap.add_argument("--ready-file", required=True,
                    help="where to publish {port,pid} once warmed")
    args = ap.parse_args(argv)
    with open(args.spec) as f:
        spec = json.load(f)
    for k, v in (spec.get("env") or {}).items():
        os.environ.setdefault(str(k), str(v))
    router = build_router(spec)
    from deeplearning4j_tpu_torch.serving.server import ModelServer

    server = ModelServer(router, port=int(spec.get("port", 0)),
                         worker_id=args.worker_id).start(warmup=True)
    tmp = args.ready_file + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"port": server.port, "pid": os.getpid(),
                   "worker_id": args.worker_id, "host": server.host}, f)
    os.replace(tmp, args.ready_file)
    try:
        # serve until SIGTERM starts the drain (ModelServer installed the
        # handler: this is the main thread) or the server dies
        while server._thread is not None and server._thread.is_alive():
            if server.draining:
                server.wait_drained(timeout=60.0)
                break
            time.sleep(0.2)
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
