"""Eager, host-bound rates of one checkout on the card: LeNet ``fit``
images/s (batch 64, 3 windows of 200 steps) and ResNet-50's bf16 forward
images/s (batch 32, 3 windows of 20), under ``capture.disabled()``, each
sorted. Compare two checkouts in one call, in turns:

    for t in build/parent . . build/parent; do
        python tools/eager_rates.py $t; done

(unpack the parent with ``git archive`` into the git-ignored ``build/``).
Each run prints one JSON line; each checkout builds its own kernels.
"""

import json
import os
import sys
import time


def _rates(torch, step, rows, calls, windows=3):
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    out = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(calls):
            step()
        torch.cuda.synchronize()
        out.append(rows * calls / (time.perf_counter() - t0))
    return sorted(out)


def main(tree: str) -> None:
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.nn import capture
    from deeplearning4j_tpu_torch.ops.kernels import _build
    from deeplearning4j_tpu_torch.zoo.models import LeNet, ResNet50

    os.environ["DL4J_TORCH_KERNEL_IMPL"] = "auto"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load()
    rng = np.random.default_rng(0)
    out = {"tree": tree}
    with capture.disabled():
        net = LeNet().init(device="cuda")
        x = torch.from_numpy(rng.normal(size=(64, 28, 28, 1)).astype(
            np.float32)).cuda()
        y = torch.from_numpy(np.eye(10, dtype=np.float32)[
            rng.integers(0, 10, 64)]).cuda()
        out["lenet_fit_images_per_sec"] = _rates(
            torch, lambda: net._fit_batch(x, y), 64, 200)
        r50 = ResNet50(compute_dtype="bfloat16").init(device="cuda")
        xb = torch.randn((32, 224, 224, 3), device="cuda")
        out["resnet50_bf16_forward_images_per_sec"] = _rates(
            torch, lambda: r50.output(xb), 32, 20)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
