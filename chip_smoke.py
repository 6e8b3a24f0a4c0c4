#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py          # from the root of a checkout

Drives the port (``deeplearning4j_tpu_torch``) only, and imports nothing
of the JAX package. Phases, each printing one JSON line:

1. device: the card's name and power limit; TF32 off for matmuls and convs.
2. build: the CUDA kernels from ``deeplearning4j_tpu_torch/csrc`` with nvcc.
3. kernel: the conv kernel against its plain PyTorch version on every
   distinct conv geometry of the 224x224 ResNet-50 forward (enumerated from
   the port's own conf) at batch 8, plus dilated + grouped, odd-channel
   and row-tiled cases, in fp32 (rtol 1e-4, atol 1e-4) and bf16 (rtol 8e-3,
   atol 1e-4: two bf16 ulps on the same bf16 inputs), with the kernel's,
   the plain version's and ``F.conv2d``'s times and the card's bound.
4. serve: full-width ResNet-50 (224x224x3, 1000 classes, random weights
   from seed 12345) behind ModelServer -> ModelRouter -> BatchScheduler ->
   ServingModel; 8 HTTP requests of 1-16 rows, some concurrent. Every
   response must hold probabilities that sum to 1 and match ``net.output``
   on the plain path within 1e-4; the conv kernel must have launched 53
   times per executed chunk and the plain path never on a CUDA tensor.
   Then ``net.output`` forward images/sec at batch 32 in fp32 and bf16
   (five windows of 2 s each: median, min, max), and one profiled
   batch-32 forward of each: device time by kernel, idle share.
5. kernels: one JSON line per the kernel table in PERF.md.

The last line is ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero; with no CUDA device it exits 1 before doing anything.
"""

import json
import math
import os
import subprocess
import sys
import time
import urllib.request
import zlib
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))

H100_FP32_FLOPS = 67e12       # fp32 outside the tensor cores, dense
H100_BF16_FLOPS = 989e12      # bf16 tensor cores, dense
H100_BYTES_PER_S = 3.35e12    # HBM3
CONV_SOURCE = "deeplearning4j_tpu_torch/csrc/conv2d_fwd.cu"
CONV_REPLACES = "deeplearning4j_tpu/ops/kernels/conv.py:174"
CONV_REPLACES_TILED = "deeplearning4j_tpu/ops/kernels/conv.py:198"
SERVE_ROWS = (1, 3, 16, 2, 5, 8, 4, 7)
BUCKETS = (1, 2, 4, 8, 16, 32)


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(torch, fn, reps=20):
    """Device milliseconds per ``fn()``: ``reps`` calls captured in one CUDA
    graph, replayed between CUDA events, so the host's launch overhead is
    not in the number (it is in :func:`eager_ms`)."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    graph.reset()
    return start.elapsed_time(end) / (3 * reps)


def eager_ms(torch, fn, reps=20):
    """Milliseconds per ``fn()`` called from Python in a loop: device time
    plus whatever the host's launch path adds."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ------------------------------------------------------------- geometries


def conv_geometries(conf, batch):
    """{(n, h, w, cin, kh, kw, cout, stride, padding, dilation, groups):
    launches per forward} for every ConvolutionLayer of a graph conf,
    walking its topological order with the layers' own shape rules."""
    from deeplearning4j_tpu_torch.nn import layers as L

    shape_of = {name: tuple(s) for name, s in zip(conf.inputs,
                                                   conf.input_shapes)}
    geoms = {}
    for n in conf.topological_order():
        ins = [shape_of[i] for i in n.inputs]
        if not n.is_layer:
            shape_of[n.name] = tuple(n.node.output_shape(*ins))
            continue
        ishape = ins[0]
        if len(ins) > 1:
            ishape = ins[0][:-1] + (sum(s[-1] for s in ins),)
        lyr = n.node
        if isinstance(lyr, L.ConvolutionLayer):
            h, w, c = ishape
            key = (batch, h, w, c, *lyr.kernel_size, lyr.n_out,
                   tuple(lyr.stride), lyr.padding, tuple(lyr.dilation), 1)
            geoms[key] = geoms.get(key, 0) + 1
        shape_of[n.name] = tuple(lyr.output_shape(ishape))
    return geoms


def read_extent(size, out, k, stride, dil, lo):
    """Input positions along one axis that some output's window reads: the
    union of the windows, clipped to the input (a 1x1/s2 window reads
    every other position; padding reads nothing)."""
    return sum(1 for i in {o * stride - lo + t * dil
                           for o in range(out) for t in range(k)}
               if 0 <= i < size)


def bound(flops, nbytes, peak_flops):
    """The least time the card could take: operations over the peak rate
    for the type, against bytes (each input element the function needs
    read once, the output written once) over the memory rate; the larger,
    and which one it is."""
    ops_ms, bytes_ms = flops / peak_flops * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms), "ops_ms": ops_ms,
            "bytes_ms": bytes_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def check_geometry(torch, key, count):
    """The kernel against its plain version (and F.conv2d's time) at one
    geometry in fp32 and bf16; returns the per-geometry record."""
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.ops.kernels import conv as kconv

    n, h, w, cin, kh, kw, cout, stride, padding, dil, groups, *rt = key
    row_tile = rt[0] if rt else None
    strides = (stride, stride) if isinstance(stride, int) else stride
    pads = kconv.resolve_padding(padding, (h, w), (kh, kw), strides, dil)
    gen = torch.Generator(device="cuda").manual_seed(
        zlib.crc32(repr(key).encode()))
    x32 = torch.randn((n, h, w, cin), generator=gen, device="cuda")
    w32 = torch.randn((kh, kw, cin // groups, cout), generator=gen,
                      device="cuda") * math.sqrt(2.0 / (kh * kw * cin))
    rec = {"geometry": {"n": n, "hw": [h, w], "cin": cin, "k": [kh, kw],
                        "cout": cout, "stride": list(strides),
                        "padding": padding, "pads": pads,
                        "dilation": list(dil), "groups": groups,
                        "row_tile": row_tile},
           "launches_per_forward": count}
    for tag, dt, peak, tol in (
            ("fp32", torch.float32, H100_FP32_FLOPS, (1e-4, 1e-4)),
            ("bf16", torch.bfloat16, H100_BF16_FLOPS, (8e-3, 1e-4))):
        x, wt = x32.to(dt), w32.to(dt)

        def kernel():
            return kconv.conv2d_fwd(x, wt, strides, pads, dil, groups,
                                    row_tile=row_tile)

        def plain():
            return kconv.conv2d_fwd_reference(x, wt, strides, pads, dil,
                                              groups)

        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        if out.shape != ref.shape or out.dtype != dt:
            raise AssertionError(f"{key} {tag}: kernel gave {out.shape} "
                                 f"{out.dtype}, plain {ref.shape}")
        diff = (out.float() - ref.float()).abs()
        err = float(diff.max())
        if not torch.isfinite(out.float()).all() or not torch.allclose(
                out.float(), ref.float(), rtol=tol[0], atol=tol[1]):
            raise AssertionError(f"{key} {tag}: kernel disagrees with the "
                                 f"plain version (max abs err {err})")
        # F.conv2d yardstick on NCHW tensors, padded once outside the timing
        # (its padding is symmetric only; SAME on the ResNet strides is not)
        xl = F.pad(x.permute(0, 3, 1, 2),
                   (pads[1][0], pads[1][1], pads[0][0], pads[0][1]))
        xl = xl.contiguous()
        wl = wt.permute(3, 2, 0, 1).contiguous()
        oh, ow = out.shape[1], out.shape[2]
        flops = 2.0 * n * oh * ow * cout * kh * kw * (cin // groups)
        x_read = n * cin * read_extent(h, oh, kh, strides[0], dil[0],
                                       pads[0][0]) * read_extent(
            w, ow, kw, strides[1], dil[1], pads[1][0])
        nbytes = (x_read + wt.numel() + out.numel()) * x.element_size()
        rec[tag] = {
            "max_abs_err": err,
            "ms": time_ms(torch, kernel),
            "eager_ms": eager_ms(torch, kernel),
            "plain_ms": time_ms(torch, plain),
            "library_ms": time_ms(torch, lambda: F.conv2d(
                xl, wl, None, strides, 0, dil, groups)),
            **bound(flops, nbytes, peak),
        }
    return rec


def kernel_phase(torch, conf):
    from deeplearning4j_tpu_torch.ops import kernels as kern

    geoms = conv_geometries(conf, batch=8)
    if sum(geoms.values()) != 53:
        raise AssertionError(f"ResNet-50 conf has {sum(geoms.values())} "
                             "convolutions, expected 53")
    # off the ResNet path: dilation + groups; odd channel counts with
    # anisotropic stride/dilation (the kernel's unvectorised gathers); and
    # the row-tiled program (the TPU kernel's row_tile, K2)
    extra = {(8, 29, 29, 64, 3, 3, 64, (1, 1), "SAME", (2, 2), 2): 0,
             (8, 13, 11, 6, 3, 3, 10, (2, 1), "SAME", (1, 2), 2): 0,
             (8, 56, 56, 64, 3, 3, 64, (1, 1), "SAME", (1, 1), 1, 7): 0}
    records = []
    for key, count in list(geoms.items()) + list(extra.items()):
        rec = check_geometry(torch, key, count)
        records.append(rec)
        emit("kernel", name="conv2d_fwd", **rec)
    kern.reset_counts()
    return records


# ------------------------------------------------------------------ serve


def _post(url, body):
    data = json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        out = json.loads(r.read())
    return out, time.perf_counter() - t0


def _calm_residual_branches(net, scale=0.25):
    """Scale the last batchnorm gamma of every residual branch: with random
    weights and identity running statistics each block would double the
    activations' variance and saturate the softmax; at 0.25 the 16-block
    stack stays near unit scale and the probabilities are well
    conditioned for the comparison."""
    for name, p in net.params.items():
        if name.endswith("_c_bn"):
            p["gamma"].mul_(scale)


def forward_images_per_sec(torch, net, batch=32, window_s=2.0, windows=5):
    """``net.output`` forward images/sec at ``batch`` rows (no HTTP,
    scheduler or bucketing): ``windows`` windows of at least ``window_s``
    seconds of back-to-back forwards, each closed by a device sync."""
    x = torch.randn((batch, 224, 224, 3), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1))
    for _ in range(3):
        net.output(x)
    torch.cuda.synchronize()
    rates = []
    for _ in range(windows):
        n, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < window_s:
            y = net.output(x)
            n += 1
        torch.cuda.synchronize()
        rates.append(batch * n / (time.perf_counter() - t0))
    if not torch.isfinite(y.float()).all():
        raise AssertionError(f"non-finite batch-{batch} output")
    rates.sort()
    return {"median": rates[len(rates) // 2], "min": rates[0],
            "max": rates[-1], "windows": rates}


def profile_forward(torch, net, batch=32, top=8):
    """One batch-``batch`` forward under torch.profiler: device time by
    kernel (the conv kernel and its split-K reduction apart from the
    rest), the wall time and the device's idle share of it."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn((batch, 224, 224, 3), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(2))
    net.output(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        net.output(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels.append((us / 1e3, e.count, e.key))
    kernels.sort(reverse=True)
    busy = sum(k[0] for k in kernels)
    conv = sum(k[0] for k in kernels if "conv2d_fwd" in k[2])
    split = sum(k[0] for k in kernels if "reduce_splits" in k[2])
    return {"batch": batch, "wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall_ms if wall_ms else None,
            "conv_kernel_ms": conv, "split_reduce_ms": split,
            "other_device_ms": busy - conv - split,
            "top": [{"ms": ms, "calls": n, "kernel": name[:90]}
                    for ms, n, name in kernels[:top]]}


def serve_phase(torch, np, card):
    from deeplearning4j_tpu_torch.data.bucketing import BucketingPolicy
    from deeplearning4j_tpu_torch.ops import kernels as kern
    from deeplearning4j_tpu_torch.serving import (ModelRouter, ModelServer,
                                                  ServingModel)
    from deeplearning4j_tpu_torch.zoo.models import ResNet50

    t0 = time.perf_counter()
    net = ResNet50().init(device="cuda")
    _calm_residual_branches(net)
    n_params = net.num_params()
    model = ServingModel(net, "resnet50",
                         bucketing=BucketingPolicy(batch_buckets=BUCKETS))
    router = ModelRouter()
    router.register(model, max_wait_ms=100.0, queue_limit=64)
    server = ModelServer(router, port=0).start()  # warms every bucket
    warm_s = time.perf_counter() - t0
    rng = np.random.default_rng(12345)
    # inputs on a quarter grid in [-2, 2]: short JSON, exact in fp32
    xs = [rng.integers(-8, 9, size=(r, 224, 224, 3)).astype(np.float32) / 4
          for r in SERVE_ROWS]
    bodies = [{"inputs": x.tolist()} for x in xs]
    url = f"{server.url}/v1/models/resnet50/infer"
    try:
        kern.reset_counts()
        chunks0 = model.chunks_executed
        t1 = time.perf_counter()
        with ThreadPoolExecutor(4) as pool:  # two waves of 4 concurrent
            answers = list(pool.map(lambda b: _post(url, b), bodies[:4]))
            answers += list(pool.map(lambda b: _post(url, b), bodies[4:]))
        serve_s = time.perf_counter() - t1
        launches = kern.LAUNCHES["conv2d_fwd"]
        plain_on_cuda = kern.PLAIN_ON_CUDA["conv2d_fwd"]
        chunks = model.chunks_executed - chunks0
        _, sched = router.get("resnet50")
        batches = sched.counts["batches"]
    finally:
        server.stop()
    if chunks < 1 or launches != 53 * chunks:
        raise AssertionError(f"conv kernel launched {launches} times for "
                             f"{chunks} chunks, expected 53 per chunk")
    if plain_on_cuda:
        raise AssertionError(f"{plain_on_cuda} conv calls on CUDA tensors "
                             "took the plain path")
    max_err, max_sum_err = 0.0, 0.0
    for x, (body, _lat) in zip(xs, answers):
        got = np.asarray(body["outputs"], np.float64)
        if got.shape != (x.shape[0], 1000) or not np.isfinite(got).all():
            raise AssertionError(f"response shape {got.shape}")
        max_sum_err = max(max_sum_err, float(np.abs(got.sum(1) - 1).max()))
        with kern.impl_scope("exact"):
            ref = net.output(x).double().cpu().numpy()
        max_err = max(max_err, float(np.abs(got - ref).max()))
    if max_sum_err > 1e-5 or max_err > 1e-4:
        raise AssertionError(f"served probabilities off: sum err "
                             f"{max_sum_err}, vs exact {max_err}")
    emit("serve", model="ResNet50", input=[224, 224, 3], classes=1000,
         params=n_params, requests=len(SERVE_ROWS), rows=list(SERVE_ROWS),
         batches=batches, chunks=chunks, conv_launches=launches,
         plain_on_cuda=plain_on_cuda, max_abs_err_vs_exact=max_err,
         max_row_sum_err=max_sum_err, warmup_s=warm_s,
         serve_wall_s=serve_s, served_rows_per_s=sum(SERVE_ROWS) / serve_s,
         request_latency_s=[lat for _, lat in answers], card=card)

    net16 = ResNet50(compute_dtype="bfloat16").init(device="cuda")
    net16.params, net16.states = net.params, net.states  # cast per forward
    emit("throughput", model="ResNet50", batch=32, path="net.output",
         window_s=2.0, forward_images_per_sec_fp32=forward_images_per_sec(
             torch, net),
         forward_images_per_sec_bf16=forward_images_per_sec(torch, net16),
         card=card)
    for tag, n in (("fp32", net), ("bf16", net16)):
        emit("profile", model="ResNet50", dtype=tag, card=card,
             **profile_forward(torch, n))
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs only on a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    from deeplearning4j_tpu_torch.ops.kernels import _build
    from deeplearning4j_tpu_torch.zoo.models import ResNet50

    os.environ["DL4J_TORCH_KERNEL_IMPL"] = "auto"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", name=kind, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count(),
         tf32=False)

    t0 = time.perf_counter()
    _build.load()
    log = (_build.BUILD_DIR / "build.log").read_text().splitlines()
    emit("build", seconds=time.perf_counter() - t0,
         nvcc_seconds=_build.build_seconds, library=str(_build.build()),
         ptxas=[ln.split("ptxas info    : ", 1)[-1] for ln in log
                if "Compiling entry" in ln or "registers" in ln])

    records = kernel_phase(torch, ResNet50().conf())
    launches = serve_phase(torch, np, smi)

    per_fwd = [r for r in records if r["launches_per_forward"]]

    def total(tag, field):
        return sum(r[tag][field] * r["launches_per_forward"] for r in per_fwd)

    print(json.dumps({"kernels": [{
        "name": "conv2d_fwd", "route": "cuda", "source": CONV_SOURCE,
        "replaces": CONV_REPLACES, "replaces_also": CONV_REPLACES_TILED,
        "replaces_ids": ["K1", "K2"], "launches": launches,
        "max_abs_err": max(r["fp32"]["max_abs_err"] for r in records),
        "max_err_fp32": max(r["fp32"]["max_abs_err"] for r in records),
        "max_err_bf16": max(r["bf16"]["max_abs_err"] for r in records),
        "ms": total("fp32", "ms"), "eager_ms": total("fp32", "eager_ms"),
        "plain_ms": total("fp32", "plain_ms"),
        "bound_ms": total("fp32", "bound_ms"),
        "bound_by": ("operations" if total("fp32", "ops_ms")
                     >= total("fp32", "bytes_ms") else "bytes"),
        "library_ms": total("fp32", "library_ms"),
        "ms_bf16": total("bf16", "ms"),
        "eager_ms_bf16": total("bf16", "eager_ms"),
        "bound_ms_bf16": total("bf16", "bound_ms"),
        "library_ms_bf16": total("bf16", "library_ms"),
        "per": "one 224x224 ResNet-50 forward at batch 8 (its 53 launches "
               "summed), fp32 unless suffixed _bf16; ms by CUDA graph "
               "replay, eager_ms by a Python loop",
        "card": smi}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
