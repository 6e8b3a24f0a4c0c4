#!/usr/bin/env python3
"""Does a tuned row tile change ResNet-50's arithmetic, and what does one
Adam step make of that? On one CUDA card, fp32, batch 32:

    python3 tools/row_tile_splits.py

1. For each of ResNet-50's four 3x3 stage geometries (the ConvTileSpace
   contexts) and each of its kernel candidates: the K slices
   (``dl4j_conv2d_plan``'s split-K count) against the whole kernel's, and
   whether the forward's output is bit-equal to the whole kernel's. A row
   tile changes the number of M tiles, so it can change the split count,
   and with it the order of the fp32 sums.
2. Full-width ResNet-50 (224x224, random weights from a seed, the
   residual branches calmed as ``chip_smoke.py`` does) under a tuning
   database whose winner at every geometry is the tile whose split count
   differs most from the whole kernel's (none where no tile differs),
   against the same net with no database: the output, the loss and the
   gradients of one training step, then the params after one step of the
   zoo's Adam(1e-3), with the tensor that moved most and its gradient in
   both runs. Two runs with no database are compared the same way. The
   armed run's gradients also go through ``chip_smoke.py``'s step gate
   (``_grad_parity``) against the same step in fp64, with the unarmed run
   in the place of the plain path.

Prints one JSON line per geometry and per comparison, and writes them to
``chiprun_out/row_tile_splits.json``. It needs a card.
"""

import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _global_rel_l2(a, b):
    num = sum(float((x.double() - y.double()).pow(2).sum())
              for x, y in zip(a, b))
    den = sum(float(y.double().pow(2).sum()) for y in b)
    return (num / den) ** 0.5 if den else 0.0


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("row_tile_splits: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    os.environ["DL4J_TORCH_KERNEL_IMPL"] = "auto"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke
    from deeplearning4j_tpu_torch import tuning
    from deeplearning4j_tpu_torch.nn import capture
    from deeplearning4j_tpu_torch.ops.kernels import conv as kconv
    from deeplearning4j_tpu_torch.tree import tree_items
    from deeplearning4j_tpu_torch.tuning.database import TuningKey
    from deeplearning4j_tpu_torch.zoo.models import ResNet50

    card = os.popen("nvidia-smi --query-gpu=name,power.limit "
                    "--format=csv,noheader").read().strip()
    lines = []

    def emit(**rec):
        rec["card"] = card
        lines.append(rec)
        print(json.dumps(rec), flush=True)

    space = tuning.get_space("conv2d_tiles")
    gen = torch.Generator(device="cuda").manual_seed(0)
    picks = {}
    for ctx in tuning.space.resnet50_conv_contexts(32, ("float32",)):
        x = torch.randn(ctx["x_shape"], device="cuda", generator=gen)
        w = torch.randn(ctx["w_shape"], device="cuda", generator=gen) * 0.05
        pads = ((1, 1), (1, 1))
        whole = kconv.conv2d_fwd(x, w, (1, 1), pads, (1, 1), 1)
        _, whole_splits, body = kconv.fwd_plan(x, w, (1, 1), pads, (1, 1), 1)
        tiles = []
        for cand in space.enumerate(ctx):
            rt = cand.params.get("row_tile")
            if cand.impl != "cuda" or rt is None:
                continue
            _, splits, _ = kconv.fwd_plan(x, w, (1, 1), pads, (1, 1), 1, rt)
            out = kconv.conv2d_fwd(x, w, (1, 1), pads, (1, 1), 1,
                                   row_tile=rt)
            tiles.append({"label": cand.label, "row_tile": rt,
                          "splits": splits,
                          "bit_equal": bool(torch.equal(out, whole)),
                          "max_abs_diff": float((out - whole).abs().max())})
        oh = ctx["x_shape"][1]
        differ = [t for t in tiles if t["splits"] != whole_splits]
        if differ:
            picks[oh] = (ctx, max(differ, key=lambda t: abs(
                t["splits"] - whole_splits)))
        emit(what="geometry", oh=oh, channels=ctx["x_shape"][3], body=body,
             whole_splits=whole_splits, tiles=tiles)

    rng = np.random.default_rng(12345)
    xb = rng.normal(size=(32, 224, 224, 3)).astype(np.float32)
    yb = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, 32)]
    net = ResNet50().init(device="cuda")
    chip_smoke._calm_residual_branches(net)

    def run(db_dir):
        tuning.set_database(db_dir)
        try:
            with capture.disabled():
                twin = net._cost_shadow()
                out = twin.output(xb).detach().clone()
                grads, loss = twin.compute_gradient_and_score(xb, yb)
                grads = dict(tree_items(grads))
                twin.fit(xb, yb)
                params = dict(tree_items(twin.params))
            return out, float(loss), grads, params
        finally:
            tuning.set_database(None)

    def compare(what, a, b, winners):
        names = list(b[2])
        moved = {k: float((a[3][k] - b[3][k]).abs().max())
                 / max(1.0, float(b[3][k].abs().max())) for k in b[3]}
        worst = max(moved, key=moved.get)
        emit(what=what, winners=winners,
             output_max_abs_diff=float((a[0] - b[0]).abs().max()),
             loss_diff=abs(a[1] - b[1]),
             grad_rel_l2=_global_rel_l2([a[2][k] for k in names],
                                        [b[2][k] for k in names]),
             param_diff=moved[worst], param_diff_tensor=str(worst),
             tensors_moved_over_1e_4=sum(v > 1e-4 for v in moved.values()),
             worst_grad_max_abs=[float(a[2][worst].abs().max())
                                 if worst in a[2] else None,
                                 float(b[2][worst].abs().max())
                                 if worst in b[2] else None])

    with tempfile.TemporaryDirectory() as db_dir:
        db = tuning.TuningDatabase(db_dir)
        for oh, (ctx, tile) in picks.items():
            db.commit(TuningKey.for_op(space.op, space.signature(ctx),
                                       "float32"),
                      {"winner": {"label": tile["label"], "impl": "cuda",
                                  "params": {"row_tile": tile["row_tile"]}}})
        plain = run(None)
        compare("unarmed_repeat", run(None), plain, {})
        armed = run(db_dir)
        compare("armed", armed, plain,
                {oh: t["label"] for oh, (_, t) in picks.items()})
    from deeplearning4j_tpu_torch.ops import kernels as kern

    def nested(flat):
        out = {}
        for (node, key), t in flat.items():
            out.setdefault(node, {})[key] = t
        return out

    with capture.disabled(), kern.impl_scope("exact"):
        x64 = torch.from_numpy(xb).cuda().double()
        l_64, g_64, _, _ = net._cost_shadow()._gradients(
            {net.conf.inputs[0]: x64},
            {net.conf.outputs[0]: torch.from_numpy(yb).cuda()},
            torch.ones(32, dtype=torch.float64, device="cuda"))
    (name, worst), rows, failures = chip_smoke._grad_parity(
        nested(armed[2]), nested(plain[2]), g_64, top=None)
    emit(what="step_gate_armed", loss_fp64=float(l_64),
         worst_vs_unarmed=[name, worst],
         max_gate_use=max(r["gate_use"] for r in rows),
         worst_gate_use=sorted(rows, key=lambda r: -r["gate_use"])[:3],
         failures=len(failures))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "row_tile_splits.json"),
              "w") as f:
        json.dump(lines, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
