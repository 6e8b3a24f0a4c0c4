#!/usr/bin/env python3
"""Where the LSTM segment kernel's time goes, on one CUDA card.

    python3 tools/lstm_ablation.py        # from the root of a checkout

Builds variants of ``deeplearning4j_tpu_torch/csrc/lstm_seq.cu``, each made
by cutting or changing one part of the resident body (the source itself is
not touched; the variants go to ``build/lstm_ablation/``, one ``nvcc`` each
with ``csrc/lstm_cell.cu`` for the step body, all started together), and
times each with CUDA-graph replay, as ``chip_smoke.py`` times the kernels,
at the char-RNN's geometries: a training segment (B 32, H 256, T 50) and a
sampling step (B 4, H 256, T 1), fp32 and bf16, no mask. The variants:

- ``built``: the source as it is;
- ``step_body``: the same library with the step body forced (the cell
  kernel once per step);
- ``no_products``: no h @ U (no loads of U or h, no mma.sync or FMA);
- ``no_gates``: the epilogue takes z itself for the four gates (no
  sigmoid or tanh);
- ``no_stores``: no store of y or of the c carries to device memory;
- ``no_exchange``: no store of a block's h slice into its peers (no
  distributed shared memory);
- ``no_barrier``: no cluster barrier between steps (a block barrier in its
  place; the results are wrong by design);
- ``barrier_only``: neither products, gates, stores nor exchange: the
  step's barriers and the xp loads;
- ``empty``: the kernel returns at once (the launch of a 16-block
  cluster);
- ``u_streamed``: U copied from device memory (L2) into shared memory again
  at every step, as a kernel without the resident U would read it;
- ``u_registers``: fp32 only (bf16 is built as it is): each thread's part
  of U (32 float4 at H 256) loaded into registers once and read from
  there at every step, persistent-RNN style; right at H 256 only;
- ``cluster8``: a cluster of 8 blocks, each owning 32 units;
- ``rows16``, ``rows32``: a cluster carries up to 16 or 32 batch rows, not
  8, so B 32 runs on 2 clusters or 1, not 4.

The variants but ``built``, ``step_body``, ``u_streamed``, ``u_registers``,
``cluster8`` and ``rows*`` compute wrong answers; only their times mean
anything. Every
variant is timed ROUNDS times, all of them in turn; prints one JSON line
per geometry (``ms``: the least of the rounds, ``ms_max``: the most;
``us_per_step``: ``ms`` over T), then the card's name and power limit.
Exits 1 without CUDA.
"""

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "deeplearning4j_tpu_torch", "csrc")
SOURCE = os.path.join(CSRC, "lstm_seq.cu")
STEP_SOURCE = os.path.join(CSRC, "lstm_cell.cu")
OUT = os.path.join(ROOT, "build", "lstm_ablation")
# (B, H, T): the char-RNN's training segment and sampling step
GEOMETRIES = ((32, 256, 50), (4, 256, 1))
ROUNDS = 2


def _replace(old, new):
    def edit(src):
        if old not in src:
            raise ValueError(f"anchor not in the source: {old[:60]!r}")
        return src.replace(old, new)
    return edit


_NO_PRODUCTS = [
    _replace("      for (int s = 0; s < ks_n; ++s) {",
             "      for (int s = 0; s < 0 * ks_n; ++s) {"),
    _replace("      for (int o = 0; o < klen / 8; ++o, up += 8 * UROW, hp += 8 * HROW) {",
             "      for (int o = 0; o < 0 * klen; ++o, up += 8 * UROW, hp += 8 * HROW) {"),
]
_NO_GATES = _replace(
    "      const float ig = sigmoid_acc(pick(z, a.col_i));\n"
    "      const float fg = sigmoid_acc(pick(z, a.col_f));\n"
    "      const float og = sigmoid_acc(pick(z, a.col_o));\n"
    "      const float gg = tanhf(pick(z, a.col_g));\n"
    "      const float c_new = __fadd_rn(__fmul_rn(fg, creg[i]), __fmul_rn(ig, gg));\n"
    "      float h_car = rt<T>(og * tanhf(c_new))",
    "      const float ig = z[0], fg = z[1], og = z[2], gg = z[3];\n"
    "      const float c_new = fg * creg[i] + ig * gg;\n"
    "      float h_car = rt<T>(og * c_new)")
_NO_STORES = _replace(
    "      static_cast<T*>(a.y)[at] = from_f<T>(y);\n"
    "      static_cast<T*>(a.cseq)[at] = from_f<T>(c_car);\n",
    "      (void)y;\n")
_NO_EXCHANGE = _replace(
    "    for (int e = tid; e < chunks * CLUSTER; e += SEQ_THREADS) {",
    "    for (int e = tid; e < 0 * chunks; e += SEQ_THREADS) {")
_NO_BARRIER = _replace("    cluster_barrier();\n  }\n  cluster_barrier();",
                       "    __syncthreads();\n  }\n  cluster_barrier();")
_EMPTY = _replace("  constexpr int ES = sizeof(T);\n",
                  "  if (a.b > 0) return;\n  constexpr int ES = sizeof(T);\n")
_U_STREAMED = _replace(
    "    const int cur = t & 1;\n",
    "    const int cur = t & 1;\n"
    "    __syncthreads();\n"
    "    stage_u<T>(us, static_cast<const T*>(a.u), H, J, j0, UROW);\n"
    "    cp_async_wait_all();\n"
    "    __syncthreads();\n")


# fp32 at H 256 and 8 rows a cluster (8 slices of 32 rows of K): each
# thread's 32 float4 of U loaded into registers once, after U is staged,
# and read from there at every step (persistent-RNN style)
_U_REGISTERS = [
    _replace("  for (int t = 0; t < steps; ++t) {\n",
             "  float4 ureg[32];\n"
             "  if constexpr (ES == 4) {\n"
             "    const int tiles = J * (R / 4), tile = tid % tiles;\n"
             "    const int ks = tid / tiles, mg = tile % J;\n"
             "#pragma unroll\n"
             "    for (int kk = 0; kk < 32; ++kk) {\n"
             "      const int k = ks * (H / slices) + kk;\n"
             "      ureg[kk] = *reinterpret_cast<const float4*>(\n"
             "          us_p + k * UROW + ((mg ^ (k & 7)) << 4));\n"
             "    }\n"
             "  }\n"
             "  for (int t = 0; t < steps; ++t) {\n"),
    _replace("      for (int o = 0; o < klen / 8; ++o, up += 8 * UROW, hp += 8 * HROW) {",
             "#pragma unroll\n"
             "      for (int o = 0; o < 4; ++o, up += 8 * UROW, hp += 8 * HROW) {"),
    _replace("          const float4 uv = *reinterpret_cast<const float4*>(up + uoff[kk]);",
             "          const float4 uv = ureg[o * 8 + kk];"),
]


def _const(name, old, new):
    return _replace(f"constexpr int {name} = {old};",
                    f"constexpr int {name} = {new};")


VARIANTS = {
    "built": [],
    "no_products": _NO_PRODUCTS,
    "no_gates": [_NO_GATES],
    "no_stores": [_NO_STORES],
    "no_exchange": [_NO_EXCHANGE],
    "no_barrier": [_NO_BARRIER],
    "barrier_only": _NO_PRODUCTS + [_NO_GATES, _NO_STORES, _NO_EXCHANGE],
    "empty": [_EMPTY],
    "u_streamed": [_U_STREAMED],
    "u_registers": _U_REGISTERS,
    "cluster8": [_const("CLUSTER", 16, 8)],
    "rows16": [_const("ROWS", 8, 16)],
    "rows32": [_const("ROWS", 8, 32)],
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
                      "-shared", "-o", os.path.join(OUT, f"{name}.so"), path,
                      STEP_SOURCE]
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
        lib.dl4j_lstm_seq_fwd.argtypes = ([vp] * 10 + [i] * 4 + [ll] * 2
                                          + [i] * 5 + [vp])
        lib.dl4j_lstm_seq_fwd.restype = i
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("lstm_ablation: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from chip_smoke import time_ms

    with open(SOURCE) as f:
        libs = build(variant_sources(f.read()))

    for b, h, t in GEOMETRIES:
        for dt, code in ((torch.float32, 0), (torch.bfloat16, 1)):
            gen = torch.Generator(device="cuda").manual_seed(b * h + t)
            xp = torch.randn((b, t, 4 * h), device="cuda",
                             generator=gen).to(dt)
            h0 = (0.5 * torch.randn((b, h), device="cuda",
                                    generator=gen)).to(dt)
            c0 = torch.randn((b, h), device="cuda", generator=gen).to(dt)
            u = (torch.randn((h, 4 * h), device="cuda", generator=gen)
                 / h ** 0.5).to(dt)
            y, cseq = (torch.empty((b, t, h), device="cuda", dtype=dt)
                       for _ in range(2))
            h_fin, c_fin = (torch.empty((b, h), device="cuda", dtype=dt)
                            for _ in range(2))

            def launch(lib, body):
                rc = lib.dl4j_lstm_seq_fwd(
                    xp.data_ptr(), h0.data_ptr(), c0.data_ptr(),
                    u.data_ptr(), None, y.data_ptr(), None,
                    cseq.data_ptr(), h_fin.data_ptr(), c_fin.data_ptr(),
                    code, b, h, t, t * 4 * h, 4 * h, 0, 1, 2, 3, body,
                    ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
                if rc:
                    raise RuntimeError(f"launch failed: CUDA error {rc}")

            runs = {"step_body": lambda: launch(libs["built"], 0)}
            for name, lib in libs.items():
                runs[name] = lambda lib=lib: launch(lib, 1)
            times = {name: [] for name in runs}
            for _ in range(ROUNDS):  # in turns: a slow spell hits all alike
                for name, fn in runs.items():
                    times[name].append(time_ms(torch, fn, reps=10))
            row = {"b": b, "h": h, "t": t,
                   "dtype": "fp32" if code == 0 else "bf16",
                   "ms": {n: min(v) for n, v in times.items()},
                   "ms_max": {n: max(v) for n, v in times.items()},
                   "us_per_step": {n: 1e3 * min(v) / t
                                   for n, v in times.items()}}
            print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
