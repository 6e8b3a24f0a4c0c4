#!/usr/bin/env python3
"""Where the bf16 flash-attention kernel's time goes, on one CUDA card.

    python3 tools/flash_ablation.py        # from the root of a checkout

Builds variants of ``deeplearning4j_tpu_torch/csrc/flash_fwd.cu``, each made
by cutting or changing one part of the source (the source itself is not
touched; the variants go to ``build/flash_ablation/``, one ``nvcc`` each, all
started together), and times each with CUDA-graph replay, as
``chip_smoke.py`` times the kernel, on the bf16 BERT-base head geometry (12
heads of 64) at batch 1, 8 and 32, S 512, and batch 8, S 128, with
``scaled_dot_product_attention`` beside them. The variants:

- ``built``: the source as it is;
- ``rows128``: 128 query rows per work item at D 64 (two consumer
  warpgroups sharing each K/V tile, one block an SM) instead of 64;
- ``stages3``, ``stages4``: a deeper K/V ring;
- ``rows128_stages3``, ``rows128_stages4``: both;
- ``no_softmax``: S scaled and rounded straight into P: the products and
  the data pipeline without the softmax;
- ``pipeline``: no product and no softmax: TMA loads, mbarriers and the
  epilogue only;
- ``masked_body``: the source as it is, launched with a padding mask of all
  ones, so the masked instantiation runs on the unmasked case's data.

The variants compute wrong answers (all but ``built``, ``rows128*``,
``stages*`` and ``masked_body``); only their times mean anything. Every
variant is timed ROUNDS times, all of them in turn; prints one JSON line per
geometry (``ms``: the least of the rounds, ``ms_max``: the most), then the
card's name and power limit. Exits 1 without CUDA.
"""

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "deeplearning4j_tpu_torch", "csrc", "flash_fwd.cu")
OUT = os.path.join(ROOT, "build", "flash_ablation")
GEOMETRIES = ((1, 512), (8, 512), (32, 512), (8, 128))
ROUNDS = 2


def _cut(src, start, end, repl):
    i = src.index(start)
    j = src.index(end, i)
    return src[:i] + repl + src[j:]


def _replace(old, new):
    def edit(src):
        if old not in src:
            raise ValueError(f"anchor not in the source: {old[:60]!r}")
        return src.replace(old, new)
    return edit


def _no_softmax(src):
    return _cut(src, "        // online softmax per row half h",
                "        // P in bf16 as the A fragments", "")


def _no_products(src):
    src = _cut(src, "        wgmma_fence();\n#pragma unroll\n        for (int kk = 0;",
               "        // the masks, while the product runs",
               "#pragma unroll\n        for (int x = 0; x < BK / 2; ++x) s[x] = (float)(x + t);\n")
    return _cut(src, "        // O += P V over the tile's keys", "        __syncwarp();",
                "#pragma unroll\n        for (int c = 0; c < BK / 16; ++c)\n"
                "          oacc[c] += __int_as_float(pa[c][0] ^ pa[c][3]);\n")


# D <= 64 on the body of 128 query rows an item (two consumer warpgroups)
_ROWS128 = _replace("? launch_bf16<1, 64, MASKED>(", "? launch_bf16<2, 64, MASKED>(")

VARIANTS = {
    "built": [],
    "rows128": [_ROWS128],
    "stages3": [_replace("constexpr int STAGES = 2;", "constexpr int STAGES = 3;")],
    "stages4": [_replace("constexpr int STAGES = 2;", "constexpr int STAGES = 4;")],
    "rows128_stages3": [_ROWS128,
                        _replace("constexpr int STAGES = 2;", "constexpr int STAGES = 3;")],
    "rows128_stages4": [_ROWS128,
                        _replace("constexpr int STAGES = 2;", "constexpr int STAGES = 4;")],
    "no_softmax": [_no_softmax],
    "pipeline": [_no_softmax, _no_products],
}


def variant_sources(src):
    """{name: source} of every variant; raises if an anchor went missing."""
    out = {}
    for name, edits in VARIANTS.items():
        text = src
        for edit in edits:
            changed = edit(text)
            if changed == text:
                raise ValueError(f"variant {name}: an edit changed nothing")
            text = changed
        out[name] = text
    return out


def build(sources):
    from deeplearning4j_tpu_torch.ops.kernels import _build

    os.makedirs(OUT, exist_ok=True)
    cmds = {}
    for name, text in sources.items():
        path = os.path.join(OUT, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        cmds[name] = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                      os.path.join(OUT, f"{name}.so"), path]
    procs = {n: subprocess.Popen(c, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for n, c in cmds.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log[-4000:]}")
        lib = ctypes.CDLL(os.path.join(OUT, f"{name}.so"))
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.dl4j_flash_fwd.argtypes = ([vp] * 6 + [i] * 6 + [ll] * 12
                                       + [ctypes.c_float, i, vp])
        lib.dl4j_flash_fwd.restype = i
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_ablation: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import torch.nn.functional as F

    from chip_smoke import time_ms

    with open(SOURCE) as f:
        libs = build(variant_sources(f.read()))

    def launch(lib, q, k, v, mask, o, lse):
        b, h, sq, d = q.shape
        rc = lib.dl4j_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), o.data_ptr(),
            lse.data_ptr(), 1, b, h, sq, k.shape[2], d, *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], *o.stride()[:3], d ** -0.5, 0,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")

    for b, s in GEOMETRIES:
        gen = torch.Generator(device="cuda").manual_seed(b * 10000 + s)
        q, k, v = (torch.randn((b, s, 12, 64), device="cuda", generator=gen)
                   .bfloat16().permute(0, 2, 1, 3) for _ in range(3))
        o = torch.empty((b, s, 12, 64), device="cuda",
                        dtype=torch.bfloat16).permute(0, 2, 1, 3)
        lse = torch.empty((b, 12, s), device="cuda")
        ones = torch.ones((b, s), device="cuda")
        runs = {"sdpa": lambda: F.scaled_dot_product_attention(
            q, k, v, scale=0.125)}
        for name, lib in libs.items():
            runs[name] = (lambda lib=lib:
                          launch(lib, q, k, v, None, o, lse))
        runs["masked_body"] = lambda: launch(libs["built"], q, k, v, ones, o,
                                             lse)
        times = {name: [] for name in runs}
        for _ in range(ROUNDS):  # in turns, so a slow spell hits all alike
            for name, fn in runs.items():
                times[name].append(time_ms(torch, fn))
        row = {"b": b, "s": s, "heads": 12, "head_dim": 64, "dtype": "bf16",
               "ms": {name: min(t) for name, t in times.items()},
               "ms_max": {name: max(t) for name, t in times.items()}}
        print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
