#!/usr/bin/env python3
"""Where the bf16 wgrad kernel's time goes, on one CUDA card.

    python3 tools/wgrad_ablation.py        # from the root of a checkout

Builds variants of ``deeplearning4j_tpu_torch/csrc/conv2d_wgrad.cu``, each
made by cutting or changing one part of the wgmma body (the source itself is
not touched; the variants go to ``build/wgrad_ablation/``, one ``nvcc``
each, all started together), and times each with CUDA-graph replay, as
``chip_smoke.py`` times the kernel, on ResNet-50 wgrad geometries at batch
1, 8 and 32, with cuDNN's ``conv2d_weight`` (TF32 off) beside them. The
variants:

- ``built``: the source as it is;
- ``no_a``: the producer issues no load of x's patch rows (A);
- ``no_b``: no load of dy's rows (B);
- ``no_loads``: neither: the ring's barriers, the products and the
  epilogue only;
- ``no_products``: the loads and the epilogue, no wgmma;
- ``no_epilogue``: no store of dW or of the split slices;
- ``empty``: the kernel returns at once (the launch, and the second
  launch that sums the slices);
- ``one_lane``: that second launch with one thread an element;
- ``barriers_only``: neither loads nor products;
- ``chunks2``, ``chunks8``, ``chunks16``: at least 2, 8 or 16 chunks of 64
  positions a split, not 4;
- ``smem_epilogue``: each warp stages 8 rows of its fp32 tile in shared
  memory at a time and writes them back whole, 16 bytes a lane;
- ``stages2``: a ring of two stages.

The variants compute wrong answers (all but ``built``, ``one_lane``,
``chunks*``, ``smem_epilogue`` and ``stages2``); only their times mean anything. Every variant
is timed ROUNDS times, all of them in turn; prints one JSON line per
geometry (``ms``: the least of the rounds, ``ms_max``: the most;
``splits`` as each variant's plan sizes them), then the card's name and
power limit. Exits 1 without CUDA.
"""

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "deeplearning4j_tpu_torch", "csrc")
SOURCE = os.path.join(CSRC, "conv2d_wgrad.cu")
OUT = os.path.join(ROOT, "build", "wgrad_ablation")
# (N, H = W, Cin, k, stride, Cout): ResNet-50 wgrad geometries
GEOMETRIES = ((1, 28, 128, 1, 1, 512), (8, 28, 128, 1, 1, 512),
              (8, 56, 64, 1, 1, 256), (8, 14, 256, 3, 1, 256),
              (8, 7, 512, 1, 1, 2048), (8, 56, 256, 1, 2, 512),
              (32, 56, 64, 1, 1, 256), (32, 14, 256, 3, 1, 256))
ROUNDS = 2


def _replace(old, new):
    def edit(src):
        if old not in src:
            raise ValueError(f"anchor not in the source: {old[:60]!r}")
        return src.replace(old, new)
    return edit


_NO_A = _replace("const int count = w < 2 ? (w < a_atoms ? 1 : 0) :",
                 "const int count = w < 2 ? 0 :")
_NO_B = _replace(": max(0, min(2, b_atoms - first));", ": 0;")
_NO_PRODUCTS = _replace(
    "          if constexpr (CN == 64)\n            wgmma_n64<1, 1>(acc, da, db);\n"
    "          else\n            wgmma_n128<1, 1>(acc, da, db);\n",
    "          acc[kk] += (float)(da ^ db);\n")

_EMPTY = _replace("  const int tid = threadIdx.x;\n  const int wg = tid >> 7;  // 0: producer",
                  "  if (g.rows > 0) return;\n"
                  "  const int tid = threadIdx.x;\n  const int wg = tid >> 7;  // 0: producer")
_NO_EPILOGUE = _replace("        float* dst = g.splits > 1 ?",
                        "        if (g.rows > 0) continue;\n"
                        "        float* dst = g.splits > 1 ?")


# the epilogue through shared memory: each warp stages 8 of its rows at a time (rows padded by 16
# bytes) and writes them back whole, 16 bytes a lane
_SMEM_EPILOGUE = [
    _replace("  static constexpr int BYTES = RING + 16 * STAGES + 1024;",
             "  static constexpr int OUT_ROW = CN * 4 + 16;\n"
             "  static constexpr int BYTES = RING + 8 * 8 * OUT_ROW + 16 * STAGES + 1024;"),
    _replace("  const uint32_t bar_full = base + T::RING;",
             "  const uint32_t bar_full = base + T::RING + 8 * 8 * T::OUT_ROW;"),
    _replace(
        "#pragma unroll\n        for (int h = 0; h < 2; ++h) {\n"
        "          float* drow = dst + (long long)(row0 + 8 * h) * g.cout + col0;\n"
        "#pragma unroll\n          for (int n = 0; n < CN / 8; ++n)\n"
        "            *reinterpret_cast<float2*>(drow + 8 * n) =\n"
        "                make_float2(acc[4 * n + 2 * h], acc[4 * n + 2 * h + 1]);\n"
        "        }\n",
        "        uint8_t* stg = smem_raw + (base - smem_u32(smem_raw)) + T::RING +\n"
        "                       (4 * cw + warp) * 8 * T::OUT_ROW;\n"
        "#pragma unroll\n        for (int h = 0; h < 2; ++h) {\n"
        "          __syncwarp();\n"
        "#pragma unroll\n          for (int n = 0; n < CN / 8; ++n)\n"
        "            *reinterpret_cast<float2*>(stg + (lane >> 2) * T::OUT_ROW +\n"
        "                                       (8 * n + 2 * (lane & 3)) * 4) =\n"
        "                make_float2(acc[4 * n + 2 * h], acc[4 * n + 2 * h + 1]);\n"
        "          __syncwarp();\n"
        "          constexpr int PER_ROW = CN / 4;  // 16-byte pieces of a row\n"
        "          for (int q = lane; q < 8 * PER_ROW; q += 32) {\n"
        "            const int r = q / PER_ROW, c = q - r * PER_ROW;\n"
        "            *reinterpret_cast<float4*>(dst + (long long)(r0 + 64 * a_atom + 16 * warp +\n"
        "                                                         8 * h + r) * g.cout +\n"
        "                                       n0 + 64 * b_atom0 + 4 * c) =\n"
        "                *reinterpret_cast<const float4*>(stg + r * T::OUT_ROW + 16 * c);\n"
        "          }\n"
        "        }\n"),
]


def _chunks(n):
    return _replace("constexpr int MIN_CHUNKS_PER_SPLIT = 4;",
                    f"constexpr int MIN_CHUNKS_PER_SPLIT = {n};")


VARIANTS = {
    "built": [],
    "no_a": [_NO_A],
    "no_b": [_NO_B],
    "no_loads": [_NO_A, _NO_B],
    "no_products": [_NO_PRODUCTS],
    "no_epilogue": [_NO_EPILOGUE],
    "empty": [_EMPTY],
    "one_lane": [_replace("  while (lanes < 32 && 16 * lanes <= splits",
                          "  while (lanes < 1 && 16 * lanes <= splits")],
    "barriers_only": [_NO_A, _NO_B, _NO_PRODUCTS],
    "chunks2": [_chunks(2)],
    "chunks8": [_chunks(8)],
    "chunks16": [_chunks(16)],
    "smem_epilogue": _SMEM_EPILOGUE,
    "stages2": [_replace(
        "static constexpr int STAGES = 192 * 1024 / STAGE < 8 ? 192 * 1024 / STAGE : 8;",
        "static constexpr int STAGES = 2;")],
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
        cmds[name] = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", CSRC,
                      "-shared", "-o", os.path.join(OUT, f"{name}.so"), path]
    procs = {n: subprocess.Popen(c, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for n, c in cmds.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log[-4000:]}")
        lib = ctypes.CDLL(os.path.join(OUT, f"{name}.so"))
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.dl4j_conv2d_wgrad.argtypes = [vp, vp, vp] + [i] * 18 + [vp, vp]
        lib.dl4j_conv2d_wgrad.restype = i
        lib.dl4j_conv2d_wgrad_plan.argtypes = ([i] * 17
                                               + [ctypes.POINTER(i)] * 2)
        lib.dl4j_conv2d_wgrad_plan.restype = i
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("wgrad_ablation: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import torch.nn.functional as F
    from torch.nn import grad as tgrad

    from chip_smoke import time_ms
    from deeplearning4j_tpu_torch.ops.kernels import conv as kconv

    torch.backends.cudnn.allow_tf32 = False
    with open(SOURCE) as f:
        libs = build(variant_sources(f.read()))

    for n, hw, cin, k, s, cout in GEOMETRIES:
        gen = torch.Generator(device="cuda").manual_seed(n * hw * cin + cout)
        oh = -(-hw // s)
        x = torch.randn((n, hw, hw, cin), device="cuda",
                        generator=gen).bfloat16()
        dy = torch.randn((n, oh, oh, cout), device="cuda",
                         generator=gen).bfloat16()
        pads = kconv.resolve_padding("SAME", (hw, hw), (k, k), (s, s), (1, 1))
        out = torch.empty((k, k, cin, cout), device="cuda")
        plans = {}
        for name, lib in libs.items():
            splits, body = ctypes.c_int(1), ctypes.c_int(0)
            rc = lib.dl4j_conv2d_wgrad_plan(
                1, n, hw, hw, cin, k, k, cout, 1, oh, oh, s, s, 1, 1,
                pads[0][0], pads[1][0], ctypes.byref(splits),
                ctypes.byref(body))
            if rc or body.value != 2:
                raise RuntimeError(f"plan: error {rc}, body {body.value}")
            plans[name] = splits.value
        ws = torch.empty((max(plans.values()), k * k * cin, cout),
                         device="cuda")

        def launch(lib, splits):
            rc = lib.dl4j_conv2d_wgrad(
                x.data_ptr(), dy.data_ptr(), out.data_ptr(), 1, n, hw, hw,
                cin, k, k, cout, 1, oh, oh, s, s, 1, 1, pads[0][0],
                pads[1][0], splits, ws.data_ptr(),
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
            if rc:
                raise RuntimeError(f"launch failed: CUDA error {rc}")

        xl = F.pad(x.permute(0, 3, 1, 2), (pads[1][0], pads[1][1],
                                           pads[0][0], pads[0][1]))
        xl = xl.contiguous()
        dyl = dy.permute(0, 3, 1, 2).contiguous()
        runs = {"cudnn": lambda: tgrad.conv2d_weight(
            xl, (cout, cin, k, k), dyl, (s, s), 0)}
        for name, lib in libs.items():
            runs[name] = lambda lib=lib, sp=plans[name]: launch(lib, sp)
        times = {name: [] for name in runs}
        for _ in range(ROUNDS):  # in turns, so a slow spell hits all alike
            for name, fn in runs.items():
                times[name].append(time_ms(torch, fn))
        row = {"n": n, "hw": hw, "cin": cin, "k": k, "stride": s,
               "cout": cout, "splits": plans,
               "ms": {name: min(t) for name, t in times.items()},
               "ms_max": {name: max(t) for name, t in times.items()}}
        print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
