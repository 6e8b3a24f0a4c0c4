#!/usr/bin/env python3
"""Time the conv kernels of a checkout on one CUDA card: chip_smoke.py's
kernel and kernel_grad phases, and their sums over one ResNet-50 pass; or,
with ``--forward``, ResNet-50's ``net.output`` rate end to end.

    python3 tools/conv_compare.py [--forward] [ROOT ...]

Each ROOT (default: this checkout) is a checkout of the repository, for
example the parent commit unpacked with ``git archive`` into a git-ignored
directory. Each runs in a process of its own, in the order given, so two
versions compared in one call share the card: give them in turns (parent,
change, change, parent). A ROOT builds its kernels into its own
``build/kernels/``. For each ROOT the script prints the per-geometry JSON
lines of the two phases (the ``kernel`` and ``kernel_grad`` lines of
``chip_smoke.py``), then one line ``{"root": ..., "sums": ...}``: the
forward's, dgrad's and wgrad's times summed over one 224x224 ResNet-50
forward or train step at batch 8, each as [kernel ms, cuDNN ms], fp32 and
bf16. With ``--forward`` each ROOT prints one line ``{"root": ...,
"forward": ...}`` instead: 224x224 images/sec of ``net.output`` (five
windows of 1 s, as ``chip_smoke.forward_images_per_sec``) in fp32 and bf16
at batch 32, and in bf16 at batch 1, where the host's time per forward
(some 53 conv launches and the layers' Python) sets the rate. It needs a
card, as ``chip_smoke.py`` does.
"""

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PHASES = """
import os, sys
sys.path.insert(0, os.getcwd())
os.environ["DL4J_TORCH_KERNEL_IMPL"] = "auto"
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke
from deeplearning4j_tpu_torch.ops.kernels import _build
from deeplearning4j_tpu_torch.zoo.models import ResNet50
if not torch.cuda.is_available():
    sys.exit("conv_compare: torch.cuda.is_available() is False")
_build.load()
conf = ResNet50().conf()
chip_smoke.kernel_phase(torch, conf)
chip_smoke.kernel_grad_phase(torch, conf)
"""


_FORWARD = """
import json, os, sys
sys.path.insert(0, os.getcwd())
os.environ["DL4J_TORCH_KERNEL_IMPL"] = "auto"
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke
from deeplearning4j_tpu_torch.ops.kernels import _build
from deeplearning4j_tpu_torch.zoo.models import ResNet50
if not torch.cuda.is_available():
    sys.exit("conv_compare: torch.cuda.is_available() is False")
_build.load()
net = ResNet50().init(device="cuda")
net16 = ResNet50(compute_dtype="bfloat16").init(device="cuda")
net16.params, net16.states = net.params, net.states
rate = chip_smoke.forward_images_per_sec
print(json.dumps({
    "fp32_b32": rate(torch, net, batch=32, window_s=1.0),
    "bf16_b32": rate(torch, net16, batch=32, window_s=1.0),
    "bf16_b1": rate(torch, net16, batch=1, window_s=1.0)}))
"""


def sums(lines):
    """[kernel ms, cuDNN ms] summed over a pass, by kernel and type."""
    fwd = [r for r in lines if r.get("phase") == "kernel"]
    grad = [r for r in lines if r.get("phase") == "kernel_grad"]

    def total(recs, key, per):
        return [sum(r[key][f] * r[per] for r in recs)
                for f in ("ms", "library_ms")]

    out = {}
    for tag in ("fp32", "bf16"):
        out[f"fwd_{tag}"] = total(fwd, tag, "launches_per_forward")
        for k in ("dgrad", "wgrad"):
            out[f"{k}_{tag}"] = total(grad, f"{k}_{tag}", f"{k}_per_step")
    return out


def main() -> int:
    args = sys.argv[1:]
    forward = "--forward" in args
    roots = [os.path.abspath(r) for r in args if r != "--forward"] or [HERE]
    for root in roots:
        run = subprocess.run([sys.executable, "-c",
                              _FORWARD if forward else _PHASES], cwd=root,
                             capture_output=True, text=True)
        if run.returncode:
            print(run.stderr[-3000:], file=sys.stderr)
            return run.returncode
        lines = [json.loads(s) for s in run.stdout.splitlines()
                 if s.startswith("{")]
        if forward:
            print(json.dumps({"root": root, "forward": lines[-1]}),
                  flush=True)
            continue
        for rec in lines:
            print(json.dumps(rec))
        print(json.dumps({"root": root, "sums": sums(lines)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
