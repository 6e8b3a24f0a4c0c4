"""Cost attribution: per-layer FLOPs, bytes and device time of one training
step, and MFU (counterpart of deeplearning4j_tpu/util/cost_model.py).

The reference reads its static costs from the compiled XLA executable (HLO
cost analysis, ``layer:<tag>`` named scopes in the op metadata). PyTorch
runs eagerly and has no compiled program to analyse, so the port COUNTS
one step as it runs, on copies of the net's state:

- Every layer apply runs under :func:`layer_scope` (the nets' forward and
  loss bodies), the updaters under :func:`optimizer_scope`. The scopes cost
  one check of a global when nothing records.
- A ``TorchDispatchMode`` sees every aten op of the step, forward and
  backward, and charges it to the open scope by the reference's
  conventions (XLA HloCostAnalysis's): a product 2·M·N·K, a convolution
  2 FLOPs per multiply-add over its valid tap positions, 1 FLOP an output
  element for elementwise ops, (in − out) for a reduction; exp, log, tanh,
  sigmoid, sqrt, rsqrt, pow... count as transcendentals, not FLOPs. Bytes
  are each op's operands and results (every eager op is its own kernel).
- The hand kernels launch through ctypes, where no aten op sees them: each
  wrapper reports its own FLOPs and bytes through :func:`kernel_cost` (the
  formulas of PERF.md §6's bound column), on the card and, for the same
  call, on the CPU, where its plain version runs and the ops inside it are
  not counted again.
- Backward ops belong to the scope whose forward made their autograd node:
  scope boundaries are recorded as autograd sequence numbers, and just
  before ``torch.autograd.grad`` runs, every node of the graph gets a
  pre-hook that opens its layer's backward row.
- An op no rule knows counts 0 FLOPs and is listed by name in the
  report's ``uncounted_ops``: nothing is estimated silently.

Rows say where their numbers came from: ``counted`` (above), or
``analytic`` (closed-form formulas from the layer confs, the reference's
``analytic_layer_flops``) when a step cannot be counted.

Device time (``cost_report(profile=True)``): a profiled eager step on
copies of the state records a CUDA event where a layer scope opens, where
a backward node of another layer runs, and around the optimizer (on the
CPU, the host clock). A spacer kernel (``torch.cuda._sleep``) sized from a
warm-up run's host time runs before each region, so each region's kernels
are queued before it starts and its events time device work, not the
host's launch gaps; the spacers lie outside every region. The regions tile
the step, so their sum is the step's device time: its kernels and the
launch gaps between back-to-back kernels, which an eager step cannot
avoid. It is cross-checked against the same regions' span in a
``torch.profiler`` trace of the step (:func:`region_span_s`); the trace's
kernel-busy time (gaps excluded) is reported beside it.

Reported by ``net.cost_report()``, the ``/costs`` route
(util/ui_server.py), the ``cost`` group of StatsListener records and the
``train.examples_per_sec`` / ``train.model_flops_utilization`` gauges. MFU
= achieved FLOP/s over ``DL4J_TPU_PEAK_FLOPS`` (config.py); no peak is
assumed when it is unset.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import math
import os
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

# ---------------------------------------------------------------------------
# scope helpers (the contract between the nets and the recorder)
# ---------------------------------------------------------------------------

_TAG_BAD = re.compile(r"[^A-Za-z0-9_.\-]")

OPTIMIZER_ROW = "(optimizer)"
UNTAGGED_ROW = "(untagged)"

_NULL = contextlib.nullcontext()
_tls = threading.local()
#: the active step recorder (one at a time; None = scopes cost nothing)
_REC: Optional["_StepRecorder"] = None


def sanitize_tag(tag: str) -> str:
    """Layer tags hold no '/', no spaces: nothing a trace name or a
    Prometheus label could mangle."""
    return _TAG_BAD.sub("_", str(tag))


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


class _LayerScope:
    __slots__ = ("tag",)

    def __init__(self, tag):
        self.tag = tag

    def __enter__(self):
        st = _stack()
        st.append(self.tag)
        rec = _REC
        if rec is not None and len(st) == 1 and not getattr(_tls, "opt", 0):
            rec.boundary((self.tag, "fwd"))
        return self

    def __exit__(self, *exc):
        st = _stack()
        st.pop()
        rec = _REC
        if rec is not None and not st and not getattr(_tls, "opt", 0):
            # the device-time region stays open until the next scope: the
            # few ops between two layers go to the one before
            rec.boundary((UNTAGGED_ROW, "fwd"), timeline=False)
        return False


class _OptimizerScope:
    __slots__ = ()

    def __enter__(self):
        _tls.opt = getattr(_tls, "opt", 0) + 1
        rec = _REC
        if rec is not None and _tls.opt == 1:
            rec.boundary((OPTIMIZER_ROW, "fwd"))
        return self

    def __exit__(self, *exc):
        _tls.opt -= 1
        rec = _REC
        if rec is not None and _tls.opt == 0:
            st = _stack()
            rec.boundary((st[0], "fwd") if st else (UNTAGGED_ROW, "fwd"))
        return False


def layer_scope(tag: str):
    """The scope every layer apply runs under. With no recorder active it
    is a shared null context (one global read)."""
    if _REC is None:
        return _NULL
    return _LayerScope(sanitize_tag(tag))


def optimizer_scope():
    """The updaters' scope: optimizer FLOPs get their own row."""
    if _REC is None:
        return _NULL
    return _OptimizerScope()


def _current_key() -> Tuple[str, str]:
    bk = getattr(_tls, "bwd", None)
    if bk is not None:
        return bk
    if getattr(_tls, "opt", 0):
        return (OPTIMIZER_ROW, "fwd")
    st = _stack()
    if st:
        return (st[0], "fwd")
    rec = _REC
    return (UNTAGGED_ROW, "bwd" if rec is not None and rec.in_backward
            else "fwd")


# ---------------------------------------------------------------------------
# per-op cost rules (XLA HloCostAnalysis conventions)
# ---------------------------------------------------------------------------

_ZERO = {
    "view", "_unsafe_view", "reshape", "_reshape_alias", "expand",
    "expand_as", "permute", "transpose", "t", "squeeze", "unsqueeze",
    "slice", "select", "as_strided", "alias", "detach", "unbind", "split",
    "split_with_sizes", "chunk", "narrow", "diagonal", "view_as",
    "lift_fresh", "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "zeros", "zeros_like", "ones", "ones_like", "full",
    "full_like", "fill", "new_zeros", "new_ones", "new_full",
    "scalar_tensor", "arange", "_local_scalar_dense", "is_nonzero", "clone",
    "cat", "stack", "constant_pad_nd", "index", "index_select", "gather",
    "embedding", "repeat", "flip", "roll", "contiguous", "resize",
    "set", "bernoulli", "uniform", "normal", "random", "rand", "randn",
    "randint", "rand_like", "randn_like", "sort", "topk", "argsort",
    "_to_dtype", "unfold", "tril", "triu", "masked_select", "nonzero",
    "copy", "_copy_from", "_copy_from_and_resize", "record_stream",
    "linspace", "eye", "pad", "index_put", "slice_scatter",
    "select_scatter", "as_strided_scatter", "unsqueeze_copy", "view_copy",
    "_foreach_copy", "_foreach_zero", "zero", "split_copy", "detach_copy",
    "select_backward", "slice_backward", "as_strided_backward",
    "promote_types", "result_type", "sym_size", "sym_stride", "size",
    "stride", "dim", "numel", "is_same_size",
    "_has_compatible_shallow_copy_type",
}
_VIEWS = {
    "view", "_unsafe_view", "reshape", "_reshape_alias", "expand",
    "expand_as", "permute", "transpose", "t", "squeeze", "unsqueeze",
    "slice", "select", "as_strided", "alias", "detach", "unbind", "split",
    "split_with_sizes", "chunk", "narrow", "diagonal", "view_as",
    "lift_fresh", "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "_local_scalar_dense", "is_nonzero",
    "record_stream", "set", "resize",
}
#: FLOPs per output element
_ELEMENTWISE = {
    "add": 1, "sub": 1, "mul": 1, "div": 1, "neg": 1, "abs": 1,
    "maximum": 1, "minimum": 1, "clamp": 1, "clamp_min": 1, "clamp_max": 1,
    "eq": 1, "ne": 1, "lt": 1, "le": 1, "gt": 1, "ge": 1, "where": 1,
    "sign": 1, "floor": 1, "ceil": 1, "round": 1, "trunc": 1, "relu": 1,
    "logical_and": 1, "logical_or": 1, "logical_not": 1, "logical_xor": 1,
    "bitwise_and": 1, "bitwise_or": 1, "bitwise_not": 1, "bitwise_xor": 1,
    "rsub": 1, "reciprocal": 1, "square": 1, "masked_fill": 1, "fmod": 1,
    "remainder": 1, "sgn": 1, "floor_divide": 1, "isnan": 1, "isinf": 1,
    "isfinite": 1, "heaviside": 1, "hardtanh": 2, "leaky_relu": 2,
    "threshold_backward": 2, "threshold": 2, "lerp": 3, "addcmul": 3,
    "addcdiv": 3, "sigmoid_backward": 3, "tanh_backward": 3, "relu6": 2,
    "hardtanh_backward": 2, "leaky_relu_backward": 2, "elu": 3,
    "elu_backward": 3, "hardsigmoid": 3, "hardswish": 4, "xlogy": 2,
    "native_dropout_backward": 1, "softshrink": 2, "hardshrink": 2,
    "silu_backward": 4,
}
#: transcendentals per output element (and FLOPs beside them)
_TRANSCENDENTAL = {
    "exp": (1, 0), "exp2": (1, 0), "expm1": (1, 0), "log": (1, 0),
    "log1p": (1, 0), "log2": (1, 0), "log10": (1, 0), "sqrt": (1, 0),
    "rsqrt": (1, 0), "tanh": (1, 0), "sigmoid": (1, 0), "erf": (1, 0),
    "erfc": (1, 0), "erfinv": (1, 0), "sin": (1, 0), "cos": (1, 0),
    "tan": (1, 0), "atan": (1, 0), "asin": (1, 0), "acos": (1, 0),
    "sinh": (1, 0), "cosh": (1, 0), "asinh": (1, 0), "acosh": (1, 0),
    "atanh": (1, 0), "atan2": (1, 0), "pow": (1, 0), "lgamma": (1, 0),
    "digamma": (1, 0), "gelu": (2, 6), "gelu_backward": (2, 10),
    "softplus": (2, 2), "softplus_backward": (1, 3), "silu": (1, 2),
    "mish": (3, 3), "log_sigmoid_forward": (2, 2), "logit": (1, 2),
}
#: reductions: (in - out) FLOPs, plus extra FLOPs per output element
_REDUCE = {
    "sum": 0, "mean": 1, "amax": 0, "amin": 0, "prod": 0, "any": 0,
    "all": 0, "argmax": 0, "argmin": 0, "nansum": 0, "cumsum": 0,
    "cumprod": 0, "logsumexp": 0, "count_nonzero": 0, "max_dim": 0,
}


def _elems(t) -> int:
    return t.numel() if isinstance(t, torch.Tensor) else 0


def _tensors(obj) -> list:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _tensors(o)]
    return []


def _nbytes(obj) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(obj))


def valid_taps(in_size: int, out_size: int, k: int, stride: int,
               dilation: int, pad_lo: int, base_dilation: int = 1) -> int:
    """(output position, tap) pairs of one spatial axis that read a real
    input element: XLA's convolution count walks exactly these, so padding
    taps cost nothing."""
    dilated_in = (in_size - 1) * base_dilation + 1
    cnt = 0
    for ki in range(k):
        kidx = ki * dilation
        for o in range(out_size):
            ri = o * stride + kidx - pad_lo
            if 0 <= ri < dilated_in and (base_dilation == 1
                                         or ri % base_dilation == 0):
                cnt += 1
    return cnt


def conv_flops(x_shape, w_shape, strides, pads, dilation, groups) -> float:
    """FLOPs of one NHWC x HWIO convolution (and of each of its two
    gradients, which touch the same (position, tap) pairs): 2 x batch x
    Cin/groups x Cout x the valid (position, tap) pairs of both axes."""
    n, h, w, _ = (int(d) for d in x_shape)
    kh, kw, cg, cout = (int(d) for d in w_shape)
    out = []
    for ins, k, s, d, p in zip((h, w), (kh, kw), strides, dilation, pads):
        eff = (k - 1) * d + 1
        out.append((ins + p[0] + p[1] - eff) // s + 1)
    taps = (valid_taps(h, out[0], kh, strides[0], dilation[0], pads[0][0])
            * valid_taps(w, out[1], kw, strides[1], dilation[1], pads[1][0]))
    return 2.0 * n * cg * cout * taps


def _conv_op_flops(args, out) -> float:
    """aten.convolution (NCHW, the ops outside the hand kernels)."""
    x, w = args[0], args[1]
    stride, padding, dilation = args[3], args[4], args[5]
    groups = int(args[8]) if len(args) > 8 else 1
    nsp = x.dim() - 2
    taps = 1
    for d in range(nsp):
        taps *= valid_taps(int(x.shape[2 + d]), int(out.shape[2 + d]),
                           int(w.shape[2 + d]), int(stride[d % len(stride)]),
                           int(dilation[d % len(dilation)]),
                           int(padding[d % len(padding)]))
    return 2.0 * int(x.shape[0]) * int(x.shape[1]) // max(1, groups) \
        * int(w.shape[0]) * taps


def product_flops(name: str, args, out) -> Optional[float]:
    """The product FLOPs (2·M·N·K, the convolutions' 2 a multiply-add) of
    a product op, or None for any other op: the part of a layer's count
    that the analytic formulas model."""
    if name == "mm":
        m, k = args[0].shape
        return 2.0 * m * k * args[1].shape[1]
    if name == "addmm":
        m, k = args[1].shape
        return 2.0 * m * k * args[2].shape[1]
    if name == "bmm":
        b, m, k = args[0].shape
        return 2.0 * b * m * k * args[1].shape[2]
    if name == "baddbmm":
        b, m, k = args[1].shape
        return 2.0 * b * m * k * args[2].shape[2]
    if name in ("dot", "vdot"):
        return 2.0 * _elems(args[0])
    if name in ("mv", "addmv"):
        return 2.0 * _elems(args[0] if name == "mv" else args[1])
    if name == "convolution":
        return _conv_op_flops(args, _tensors(out)[0])
    if name == "convolution_backward":
        grad_out, x, w = args[0], args[1], args[2]
        fwd = _conv_op_flops((x, w, None) + tuple(args[4:8])
                             + (args[9],), grad_out)
        mask = args[10] if len(args) > 10 else (True, True, True)
        return fwd * (int(bool(mask[0])) + int(bool(mask[1])))
    return None


def op_cost(name: str, args, kwargs, out) -> Optional[Tuple[float, float]]:
    """(FLOPs, transcendentals) of one aten op by its overload packet's
    name (in-place variants included), or None when no rule knows it."""
    if name.endswith("_") and not name.endswith("__"):
        name = name[:-1]
    foreach = name.startswith("_foreach_")
    if foreach:
        name = name[len("_foreach_"):]
        n_out = sum(_elems(t) for t in _tensors(args[0] if args else ()))
    else:
        outs = _tensors(out)
        n_out = _elems(outs[0]) if outs else _elems(
            args[0] if args else None)
    if name in _ZERO or name in _VIEWS:
        return 0.0, 0.0
    if name in ("_to_copy", "to", "_to_dtype_layout"):
        src = args[0] if args else None
        dst = _tensors(out)
        if src is not None and dst and dst[0].dtype != src.dtype:
            return float(n_out), 0.0  # convert: one FLOP an element
        return 0.0, 0.0
    if name in ("max", "min"):
        if len(args) > 1 and isinstance(args[1], torch.Tensor):
            return float(n_out), 0.0  # elementwise maximum/minimum
        return float(max(0, _elems(args[0]) - n_out)), 0.0
    if name in _ELEMENTWISE:
        return float(_ELEMENTWISE[name] * n_out), 0.0
    if name == "pow" and len(args) > 1 and isinstance(args[1], (int, float)) \
            and float(args[1]).is_integer() and 1 <= args[1] <= 4:
        return float((int(args[1]) - 1) * n_out), 0.0  # x**n: products
    if name in _TRANSCENDENTAL:
        t, f = _TRANSCENDENTAL[name]
        return float(f * n_out), float(t * n_out)
    prod = product_flops(name, args, out)
    if prod is not None:
        extra = 0.0
        if name == "addmm":
            extra = float(args[1].shape[0] * args[2].shape[1])
        elif name == "baddbmm":
            extra = float(args[1].shape[0] * args[1].shape[1]
                          * args[2].shape[2])
        elif name == "convolution_backward":
            mask = args[10] if len(args) > 10 else (True, True, True)
            extra = float(_elems(args[0])) if mask[2] else 0.0
        return prod + extra, 0.0
    if name in _REDUCE:
        n_in = _elems(args[0])
        extra = _REDUCE.get(name, 0)
        return float(max(0, n_in - n_out) + extra * n_out), 0.0
    if name in ("var", "std", "var_mean", "std_mean"):
        n_in = _elems(args[0])
        tr = float(n_out) if name.startswith("std") else 0.0
        return float(3 * n_in + n_out), tr
    if name == "linalg_vector_norm":
        n_in = _elems(args[0])
        return float(2 * n_in - n_out), float(n_out)
    if name in ("_softmax", "softmax"):
        return 4.0 * n_out, float(n_out)
    if name in ("_log_softmax", "log_softmax"):
        m = n_out // max(1, int(args[0].shape[args[1]])) if args[0].dim() \
            else 1
        return 4.0 * n_out, float(n_out + m)
    if name == "_softmax_backward_data":
        return 4.0 * n_out, 0.0
    if name == "_log_softmax_backward_data":
        return 3.0 * n_out, float(n_out)
    if name in ("native_batch_norm", "_native_batch_norm_legit",
                "_native_batch_norm_legit_no_training",
                "native_layer_norm", "native_group_norm"):
        x = args[0]
        n = _elems(x)
        training = name == "native_layer_norm" or name == \
            "native_group_norm" or (len(args) > 5 and bool(args[5])) \
            or name == "_native_batch_norm_legit"
        c = int(x.shape[1]) if x.dim() > 1 else 1
        return (8.0 if training else 4.0) * n, float(c)
    if name in ("native_batch_norm_backward", "native_layer_norm_backward",
                "native_group_norm_backward"):
        return 8.0 * _elems(args[0]), 0.0
    if name in ("max_pool2d_with_indices", "max_pool3d_with_indices",
                "avg_pool2d", "avg_pool3d"):
        win = 1
        for k in args[1]:
            win *= int(k)
        extra = n_out if name.startswith("avg") else 0
        return float(n_out * max(1, win - 1) + extra), 0.0
    if name in ("max_pool2d_with_indices_backward",
                "max_pool3d_with_indices_backward", "avg_pool2d_backward",
                "avg_pool3d_backward", "embedding_dense_backward",
                "index_add", "scatter_add", "index_put_", "scatter",
                "scatter_reduce"):
        return float(_elems(args[0])), 0.0
    if name in ("nll_loss_forward", "nll_loss2d_forward"):
        return float(_elems(args[0]) // max(1, int(args[0].shape[-1]))), 0.0
    if name in ("nll_loss_backward", "nll_loss2d_backward"):
        return float(_elems(args[1]) // max(1, int(args[1].shape[-1]))), 0.0
    if name == "native_dropout":
        return 2.0 * _elems(args[0]), 0.0
    return None


# ---------------------------------------------------------------------------
# the step recorder: scopes, counting, device-time regions
# ---------------------------------------------------------------------------


class _Timeline:
    """Regions of a step between scope boundaries, timed by CUDA events
    (host clock on the CPU). ``spacers`` (seconds a region, by index) come
    from a warm-up run's host times: a spacer kernel that long runs before
    each region, so the region's work is queued when it starts."""

    def __init__(self, device: torch.device,
                 spacers: Optional[List[float]] = None,
                 cycles_per_s: float = 0.0):
        self.cuda = device.type == "cuda"
        self.device = device
        self.spacers = spacers
        self.cycles_per_s = cycles_per_s
        self.regions: list = []   # (key, start, end, host_s)
        self._open = None        # (key, start mark, host t0)

    def _mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self.device))
            return ev
        return time.perf_counter()

    def switch(self, key) -> None:
        now = time.perf_counter()
        if self._open is not None:
            k, start, t0 = self._open
            self.regions.append((k, start, self._mark(), now - t0))
            self._open = None
        if key is None:
            return
        i = len(self.regions)
        if self.cuda and self.spacers is not None and self.cycles_per_s:
            s = self.spacers[i] if i < len(self.spacers) else 2e-3
            torch.cuda._sleep(max(1000, int(s * self.cycles_per_s)))
        self._open = (key, self._mark(), time.perf_counter())

    def close(self) -> None:
        self.switch(None)

    def seconds(self) -> List[Tuple[Tuple[str, str], float]]:
        out = []
        for key, a, b, _ in self.regions:
            if self.cuda:
                b.synchronize()
                out.append((key, a.elapsed_time(b) / 1e3))
            else:
                out.append((key, b - a))
        return out

    def host_seconds(self) -> List[float]:
        return [h for _, _, _, h in self.regions]


class _KernelCost:
    __slots__ = ("rec",)

    def __init__(self, rec):
        self.rec = rec

    def __enter__(self):
        _tls.suppress = getattr(_tls, "suppress", 0) + 1
        return self

    def __exit__(self, *exc):
        _tls.suppress -= 1
        return False


def kernel_cost(kernel: str, cost: Callable[[], Tuple[float, float, float]]):
    """What a hand kernel's wrapper does around its launch and around its
    plain version: when a step is being counted, ``cost()`` gives the
    call's (FLOPs, transcendentals, bytes[, product FLOPs]; the products
    default to all the FLOPs), charged to the open scope,
    and the aten ops inside the block are not counted again. Otherwise a
    shared null context."""
    rec = _REC
    if rec is None or not rec.count:
        return _NULL
    if not getattr(_tls, "suppress", 0):
        c = cost()
        flops, transc, nbytes = c[:3]
        rec.add(_current_key(), flops, transc, nbytes,
                c[3] if len(c) > 3 else flops)
        k = rec.kernels.setdefault(kernel, {"calls": 0, "flops": 0.0,
                                            "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
    return _KernelCost(rec)


def _count_mode_class():
    from torch.utils._python_dispatch import TorchDispatchMode

    class _CountMode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            rec = _REC
            if rec is not None and not getattr(_tls, "suppress", 0):
                rec.add_op(func, args, kwargs, out)
            return out

    return _CountMode


def _walk_nodes(roots) -> list:
    seen, out, stack = set(), [], [r for r in roots if r is not None]
    while stack:
        n = stack.pop()
        if n is None or id(n) in seen:
            continue
        seen.add(id(n))
        out.append(n)
        for nxt, _ in getattr(n, "next_functions", ()):
            if nxt is not None and id(nxt) not in seen:
                stack.append(nxt)
    return out


class _StepRecorder:
    """One recorded step: scope boundaries (autograd sequence numbers),
    optionally the per-op counts, optionally a device-time timeline."""

    def __init__(self, count: bool, timeline: Optional[_Timeline] = None):
        self.count = count
        self.timeline = timeline
        self.by_key: Dict[Tuple[str, str], Dict[str, float]] = {}
        self.uncounted: Dict[str, int] = {}
        self.kernels: Dict[str, dict] = {}
        self.in_backward = False
        self._seqs: List[int] = []
        self._keys: List[Tuple[str, str]] = []
        self._probe_leaf = torch.zeros((), requires_grad=True)

    # -- boundaries ---------------------------------------------------------
    def _seq_now(self) -> Optional[int]:
        if torch.is_inference_mode_enabled():
            return None
        _tls.suppress = getattr(_tls, "suppress", 0) + 1
        try:
            with torch.enable_grad():
                node = (self._probe_leaf * 1).grad_fn
            return node._sequence_nr() if node is not None else None
        finally:
            _tls.suppress -= 1

    def boundary(self, key, timeline: bool = True) -> None:
        if not self.in_backward:
            seq = self._seq_now()
            if seq is not None:
                self._seqs.append(seq)
                self._keys.append(key)
        if timeline and self.timeline is not None:
            self.timeline.switch(key)

    def key_of_node(self, node) -> Tuple[str, str]:
        i = bisect.bisect_right(self._seqs, node._sequence_nr()) - 1
        tag, d = self._keys[i] if i >= 0 else (UNTAGGED_ROW, "fwd")
        return (tag, "bwd" if d == "fwd" and tag != OPTIMIZER_ROW else d)

    # -- counting -----------------------------------------------------------
    def add(self, key, flops, transc, nbytes, products=0.0) -> None:
        r = self.by_key.get(key)
        if r is None:
            r = self.by_key[key] = {"flops": 0.0, "transcendentals": 0.0,
                                    "bytes": 0.0, "product_flops": 0.0}
        r["flops"] += flops
        r["transcendentals"] += transc
        r["bytes"] += nbytes
        r["product_flops"] += products

    def add_op(self, func, args, kwargs, out) -> None:
        name = func._overloadpacket.__name__
        try:
            cost = op_cost(name, args, kwargs, out)
        except Exception:  # noqa: BLE001 - an odd signature: listed below
            cost = None
        if cost is None:
            self.uncounted[name] = self.uncounted.get(name, 0) + 1
            cost = (0.0, 0.0)
        base = name.rstrip("_")
        nbytes = 0 if base in _VIEWS else _nbytes(args) + (
            0 if name.endswith("_") else _nbytes(out))
        try:
            prod = product_flops(base, args, out) or 0.0
        except Exception:  # noqa: BLE001 - counted above as uncounted
            prod = 0.0
        self.add(_current_key(), cost[0], cost[1], float(nbytes), prod)

    # -- backward -----------------------------------------------------------
    def grad(self, orig, outputs, inputs, *a, **k):
        roots = [t.grad_fn for t in _tensors(outputs)]
        handles = []
        tl = self.timeline
        for node in _walk_nodes(roots):
            if type(node).__name__ == "AccumulateGrad":
                continue
            key = self.key_of_node(node)

            def pre(grad_outputs, key=key):
                _tls.bwd = key
                # untagged nodes stay in the open region, as between scopes
                if tl is not None and tl._open is not None \
                        and tl._open[0] != key and key[0] != UNTAGGED_ROW:
                    tl.switch(key)
                return None

            def post(grad_inputs, grad_outputs):
                _tls.bwd = None
                return None

            handles.append(node.register_prehook(pre))
            handles.append(node.register_hook(post))
        self.in_backward = True
        try:
            return orig(outputs, inputs, *a, **k)
        finally:
            self.in_backward = False
            _tls.bwd = None
            for h in handles:
                h.remove()


@contextlib.contextmanager
def record_step(count: bool = True, timeline: Optional[_Timeline] = None):
    """Record one step run inside the block: the recorder's ``by_key``
    holds {(tag, "fwd"|"bwd"): {"flops", "transcendentals", "bytes"}} and
    ``uncounted`` the ops no rule knows; the timeline (when given) the
    step's regions; each by_key entry also has ``product_flops``, the part
    of its FLOPs in products (the analytic formulas' part).
    ``torch.autograd.grad`` is wrapped for the block so backward nodes
    open their layer's backward row."""
    global _REC
    if _REC is not None:
        raise RuntimeError("cost_model: a step is already being recorded")
    rec = _StepRecorder(count, timeline)
    orig_grad = torch.autograd.grad

    def grad(outputs, inputs, *a, **k):
        return rec.grad(orig_grad, outputs, inputs, *a, **k)

    mode = _count_mode_class()() if count else None
    _REC = rec
    torch.autograd.grad = grad
    try:
        if timeline is not None:
            timeline.switch((UNTAGGED_ROW, "fwd"))
        if mode is not None:
            with mode:
                yield rec
        else:
            yield rec
        if timeline is not None:
            timeline.close()
    finally:
        torch.autograd.grad = orig_grad
        _REC = None
        _tls.stack = []
        _tls.opt = 0
        _tls.bwd = None


class CostAnalysisUnavailable(RuntimeError):
    """A step could not be counted: callers fall back to the analytic
    formulas (source: analytic)."""


def count_step(run: Callable[[], Any]) -> _StepRecorder:
    """Count one step: ``run()`` inside :func:`record_step`. Raises
    :class:`CostAnalysisUnavailable` when this torch has no dispatch modes."""
    try:
        from torch.utils._python_dispatch import \
            TorchDispatchMode  # noqa: F401
    except ImportError as e:
        raise CostAnalysisUnavailable(repr(e)) from None
    with record_step(count=True) as rec:
        run()
    return rec


def _cycles_per_second(device) -> float:
    """The spacer kernel's clock: cycles of ``torch.cuda._sleep`` a second,
    timed once by CUDA events."""
    s = torch.cuda.current_stream(device)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    cycles = 20_000_000
    torch.cuda._sleep(1000)
    a.record(s)
    torch.cuda._sleep(cycles)
    b.record(s)
    b.synchronize()
    return cycles / max(a.elapsed_time(b) / 1e3, 1e-9)


def _is_spacer(name: str) -> bool:
    return "sleep" in name.lower() or "spin" in name.lower()


def region_span_s(path: str) -> float:
    """The device time a traced step's regions occupy, from the trace: the
    device events in time order, cut into regions at the spacer kernels,
    each region's span from its first event's start to its last's end (its
    kernels and the launch gaps between back-to-back kernels; the spacers
    and the gaps around them left out). The quantity the regions' CUDA
    events measure, read from the trace instead."""
    from deeplearning4j_tpu_torch.util import profiler as _prof

    evs = sorted((e for e in _prof.parse_chrome_trace(path)
                  if e["cat"] in _prof.DEVICE_CATEGORIES),
                 key=lambda e: e["ts"])
    total, lo, hi = 0.0, None, None
    for e in evs:
        if _is_spacer(e["name"]):
            if lo is not None:
                total += hi - lo
            lo = hi = None
            continue
        end = e["ts"] + e["dur"]
        lo = e["ts"] if lo is None else lo
        hi = end if hi is None else max(hi, end)
    if lo is not None:
        total += hi - lo
    return total / 1e6


def profile_step(run: Callable[[], Any], device, trace_dir: Optional[str]
                 = None, around=None) -> Tuple[Dict[Tuple[str, str], float],
                                              float, Optional[dict]]:
    """Device time of one step by region: ``run()`` once on a plain
    timeline (warm-up; each region's host time), then once with a spacer
    before each region (sized 2x that host time plus 100 µs), optionally
    under ``torch.profiler`` (``trace_dir``) and inside ``around()`` when
    given. Returns ({(tag, dir): seconds}, the regions' total seconds, and,
    with a trace, {"busy_s": the trace's kernel-busy time (the union of its
    device events, spacers excluded), "span_s": :func:`region_span_s`,
    "kernels": kernel event counts by name, "regions": the number of
    regions})."""
    device = torch.device(device)
    with record_step(count=False, timeline=_Timeline(device)) as rec:
        run()
    host = rec.timeline.host_seconds()
    cps = 0.0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        cps = _cycles_per_second(device)
    tl = _Timeline(device, [2.0 * h + 1e-4 for h in host], cps)
    trace = None
    if trace_dir is not None:
        from deeplearning4j_tpu_torch.util import profiler as _prof

        with _prof.device_trace(trace_dir, cuda=device.type == "cuda"):
            with (around() if around else _NULL):
                with record_step(count=False, timeline=tl):
                    run()
        path = os.path.join(trace_dir, "trace.json")
        busy = _prof.trace_device_ms(path, exclude=_is_spacer) / 1e3
        counts = {k: v for k, v in _prof.trace_event_counts(path).items()
                  if not _is_spacer(k)}
        trace = {"busy_s": busy, "span_s": region_span_s(path),
                 "kernels": counts, "regions": len(tl.regions)}
    else:
        with (around() if around else _NULL):
            with record_step(count=False, timeline=tl):
                run()
    times: Dict[Tuple[str, str], float] = {}
    for key, sec in tl.seconds():
        times[key] = times.get(key, 0.0) + sec
    return times, sum(times.values()), trace


# ---------------------------------------------------------------------------
# analytic formulas (source: analytic)
# ---------------------------------------------------------------------------


def _prod(dims) -> int:
    n = 1
    for d in dims:
        n *= int(d)
    return n


def analytic_layer_flops(lyr, in_shape, params: int) -> float:
    """Forward FLOPs per example of one layer conf: closed forms for the
    product-shaped layers (dense, conv, recurrent, attention), a
    positions·params estimate for the rest (the reference's ``:585``).
    ``in_shape`` excludes the batch. Backward is 2x forward."""
    cls = type(lyr).__name__
    out_shape = tuple(lyr.output_shape(tuple(in_shape)))
    in_elems = _prod(in_shape)
    out_elems = _prod(out_shape)
    if cls in ("DenseLayer", "OutputLayer"):
        return 2.0 * in_elems * lyr.n_out
    if cls == "ConvolutionLayer":
        kh, kw = lyr.kernel_size
        c_in = lyr.n_in or in_shape[-1]
        return 2.0 * out_elems * kh * kw * c_in
    if cls == "SeparableConvolution2D":
        kh, kw = lyr.kernel_size
        c_in = lyr.n_in or in_shape[-1]
        pos = out_elems // max(1, out_shape[-1])
        depth = 2.0 * pos * c_in * lyr.depth_multiplier * kh * kw
        point = 2.0 * pos * c_in * lyr.depth_multiplier * lyr.n_out
        return depth + point
    if cls == "Deconvolution2D":
        kh, kw = lyr.kernel_size
        c_in = lyr.n_in or in_shape[-1]
        pos = in_elems // max(1, c_in)
        return 2.0 * pos * kh * kw * c_in * lyr.n_out
    if cls in ("LSTM", "GravesLSTM", "GRU", "SimpleRnn"):
        T = in_shape[0] if len(in_shape) >= 2 else 1
        F = in_shape[-1]
        H = lyr.n_out
        gates = {"LSTM": 4, "GravesLSTM": 4, "GRU": 3, "SimpleRnn": 1}[cls]
        return T * (2.0 * gates * H * (F + H) + 10.0 * H)
    if cls in ("RnnOutputLayer",):
        T = in_shape[0] if len(in_shape) >= 2 else 1
        return 2.0 * T * in_shape[-1] * lyr.n_out
    if "Attention" in cls and hasattr(lyr, "n_heads"):
        S = in_shape[0] if len(in_shape) >= 2 else 1
        D = lyr.n_in or in_shape[-1]
        hd = getattr(lyr, "n_heads", 1) * (getattr(lyr, "head_size", None)
                                           or max(1, lyr.n_out // max(
                                               1, lyr.n_heads)))
        proj = 2.0 * S * D * hd * 3 + 2.0 * S * hd * lyr.n_out
        attn = 4.0 * S * S * hd
        return proj + attn
    if cls == "EmbeddingLayer":
        return 0.0
    if params:
        positions = max(1, out_elems // max(1, out_shape[-1]))
        return 2.0 * params * positions
    return float(out_elems)  # paramless elementwise/pool layers


def analytic_rows(entries, batch: int) -> List["CostRow"]:
    """``entries``: [(tag, layer conf, in_shape excl. batch, param count)]
    -> the source=analytic table."""
    rows = []
    for tag, lyr, in_shape, params in entries:
        fwd = analytic_layer_flops(lyr, in_shape, params) * batch
        out_shape = tuple(lyr.output_shape(tuple(in_shape)))
        byt = 4.0 * (batch * _prod(in_shape) + batch * _prod(out_shape)
                     + params)
        rows.append(CostRow(
            layer=sanitize_tag(tag), params=params, flops_fwd=fwd,
            flops_bwd=2.0 * fwd, bytes_accessed=3.0 * byt,
            source="analytic"))
    return rows


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CostRow:
    layer: str
    params: int = 0
    flops_fwd: float = 0.0
    flops_bwd: float = 0.0
    transcendentals: float = 0.0
    bytes_accessed: float = 0.0
    device_time_fwd_s: Optional[float] = None
    device_time_bwd_s: Optional[float] = None
    source: str = "counted"

    @property
    def flops(self) -> float:
        return self.flops_fwd + self.flops_bwd

    @property
    def device_time_s(self) -> Optional[float]:
        if self.device_time_fwd_s is None and self.device_time_bwd_s is None:
            return None
        return (self.device_time_fwd_s or 0.0) + (self.device_time_bwd_s
                                                  or 0.0)

    def to_dict(self) -> dict:
        return {
            "layer": self.layer, "params": self.params,
            "flops_fwd": self.flops_fwd, "flops_bwd": self.flops_bwd,
            "flops": self.flops, "transcendentals": self.transcendentals,
            "bytes_accessed": self.bytes_accessed,
            "device_time_fwd_s": self.device_time_fwd_s,
            "device_time_bwd_s": self.device_time_bwd_s,
            "device_time_s": self.device_time_s,
            "source": self.source,
        }


_PEAK_DTYPE_ALIASES = {
    "bf16": "bf16", "bfloat16": "bf16",
    "fp32": "fp32", "f32": "fp32", "float32": "fp32",
    "fp16": "fp16", "f16": "fp16", "float16": "fp16",
    "int8": "int8", "i8": "int8",
    "fp64": "fp64", "f64": "fp64", "float64": "fp64",
}


def _canon_peak_dtype(dtype) -> Optional[str]:
    if dtype is None:
        return None
    return _PEAK_DTYPE_ALIASES.get(
        str(dtype).strip().lower().replace("torch.", ""))


def peak_flops_from_env(dtype=None) -> Optional[float]:
    """DL4J_TPU_PEAK_FLOPS (config.py): the card's peak FLOP/s, a bare
    number or a per-dtype table (``bf16=9.89e14,fp32=6.7e13``). ``dtype``
    is the run's compute dtype (aliases normalise); with a table and no
    matching entry, or no dtype and more than one entry but no fp32,
    nothing is guessed. Unset or unparsable -> None: there is no default
    peak."""
    v = os.environ.get("DL4J_TPU_PEAK_FLOPS")
    if not v or not v.strip():
        return None
    v = v.strip()
    if "=" in v:
        table = {}
        for part in v.split(","):
            part = part.strip()
            if not part:
                continue
            key, _, val = part.partition("=")
            ck = _canon_peak_dtype(key)
            try:
                f = float(val)
            except ValueError:
                continue
            if ck is not None and f > 0:
                table[ck] = f
        if dtype is None:
            if len(table) == 1:
                return next(iter(table.values()))
            return table.get("fp32")
        ck = _canon_peak_dtype(dtype)
        return None if ck is None else table.get(ck)
    try:
        f = float(v)
    except ValueError:
        return None
    return f if f > 0 else None


@dataclasses.dataclass
class CostReport:
    """Per-layer cost table + whole-step totals + utilization. ``launches``
    holds the hand kernels' launches of the counted step and of the
    profiled step (``{"counted": {...}, "profiled": {...}}``);
    ``trace_busy_s`` the profiled step's kernel-busy time from its
    torch.profiler trace and ``trace_span_s`` the time its regions occupy
    the device by the same trace (:func:`region_span_s`), the quantity
    ``device_time_s`` measures by CUDA events; ``uncounted_ops`` the aten
    ops no rule knew."""

    rows: List[CostRow]
    totals: Dict[str, float]
    batch: int
    params_total: int
    source: str                           # 'counted' | 'analytic'
    model: str = ""
    step_time_s: Optional[float] = None   # measured wall per step
    device_time_s: Optional[float] = None  # attributed device time a step
    peak_flops: Optional[float] = None
    launches: Optional[dict] = None
    trace_busy_s: Optional[float] = None
    trace_span_s: Optional[float] = None
    trace_kernels: Optional[dict] = None
    uncounted_ops: Optional[dict] = None
    kernels: Optional[dict] = None
    #: devices the step spans (a one-device mesh's lane step: 1)
    devices: int = 1

    @property
    def flops_per_step(self) -> float:
        return float(self.totals.get("flops", 0.0)) or sum(
            r.flops for r in self.rows)

    @property
    def examples_per_sec(self) -> Optional[float]:
        if not self.step_time_s:
            return None
        return self.batch / self.step_time_s

    @property
    def achieved_flops_per_sec(self) -> Optional[float]:
        if not self.step_time_s:
            return None
        return self.flops_per_step / self.step_time_s

    @property
    def mfu(self) -> Optional[float]:
        """Model FLOPs utilization: achieved FLOP/s over the configured
        peak; None unless both are known."""
        a = self.achieved_flops_per_sec
        if a is None or not self.peak_flops:
            return None
        return a / self.peak_flops

    @property
    def optimizer_update_share(self) -> Optional[float]:
        """Share of the attributed device time of a step spent in the
        optimizer update (the ``(optimizer)`` row); None without a
        profiled run."""
        total = 0.0
        opt = 0.0
        seen = False
        for r in self.rows:
            t = r.device_time_s
            if t is None:
                continue
            seen = True
            total += t
            if r.layer == OPTIMIZER_ROW:
                opt += t
        if not seen or total <= 0.0:
            return None
        return opt / total

    def top_layers(self, n: int = 5, by: str = "device_time_s") -> List[dict]:
        """The ``n`` costliest rows by ``by`` (a CostRow field)."""
        rows = sorted(self.rows, key=lambda r: -(getattr(r, by) or 0.0))
        return [r.to_dict() for r in rows[:n]]

    def to_dict(self) -> dict:
        return {
            "model": self.model,
            "batch": self.batch,
            "params_total": self.params_total,
            "source": self.source,
            "totals": dict(self.totals),
            "flops_per_step": self.flops_per_step,
            "step_time_s": self.step_time_s,
            "device_time_s": self.device_time_s,
            "examples_per_sec": self.examples_per_sec,
            "achieved_flops_per_sec": self.achieved_flops_per_sec,
            "peak_flops": self.peak_flops,
            "model_flops_utilization": self.mfu,
            "optimizer_update_share": self.optimizer_update_share,
            "launches": self.launches,
            "trace_busy_s": self.trace_busy_s,
            "trace_span_s": self.trace_span_s,
            "trace_kernels": self.trace_kernels,
            "uncounted_ops": self.uncounted_ops,
            "kernels": self.kernels,
            "devices": self.devices,
            "layers": [r.to_dict() for r in self.rows],
        }

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def summary(self) -> str:
        """Human table: one row per layer, totals + MFU footer."""
        def fmt(v, unit=""):
            if v is None:
                return "-"
            if v == 0:
                return "0"
            mag = int(math.floor(math.log10(abs(v)) / 3)) if abs(v) >= 1 \
                else 0
            mag = max(0, min(mag, 5))
            suffix = ["", "K", "M", "G", "T", "P"][mag]
            return f"{v / 1000 ** mag:.2f}{suffix}{unit}"

        lines = [f"{'layer':<34}{'params':>10}{'fwd FLOPs':>12}"
                 f"{'bwd FLOPs':>12}{'bytes':>10}{'t_fwd ms':>10}"
                 f"{'t_bwd ms':>10}  source"]
        for r in self.rows:
            tf = "-" if r.device_time_fwd_s is None \
                else f"{r.device_time_fwd_s * 1e3:.3f}"
            tb = "-" if r.device_time_bwd_s is None \
                else f"{r.device_time_bwd_s * 1e3:.3f}"
            lines.append(
                f"{r.layer:<34}{fmt(r.params):>10}{fmt(r.flops_fwd):>12}"
                f"{fmt(r.flops_bwd):>12}{fmt(r.bytes_accessed):>10}"
                f"{tf:>10}{tb:>10}  {r.source}")
        lines.append(
            f"TOTAL: {fmt(self.flops_per_step)}FLOP/step over B={self.batch}"
            f" ({fmt(float(self.params_total))} params, source={self.source})")
        if self.step_time_s:
            lines.append(
                f"  step {self.step_time_s * 1e3:.2f} ms wall -> "
                f"{fmt(self.examples_per_sec)} ex/s, "
                f"{fmt(self.achieved_flops_per_sec)}FLOP/s achieved")
        if self.mfu is not None:
            lines.append(f"  MFU {100.0 * self.mfu:.2f}% of peak "
                         f"{fmt(self.peak_flops)}FLOP/s "
                         "(DL4J_TPU_PEAK_FLOPS)")
        share = self.optimizer_update_share
        if share is not None:
            lines.append(
                f"  optimizer update phase: {100.0 * share:.2f}% of "
                "attributed device time")
        if self.uncounted_ops:
            lines.append("  uncounted ops (0 FLOPs): " + ", ".join(
                f"{k} x{v}" for k, v in sorted(self.uncounted_ops.items())))
        return "\n".join(lines)


def rows_from_counts(by_key: Dict[Tuple[str, str], Dict[str, float]],
                     params_by_tag: Dict[str, int],
                     layer_times: Optional[Dict[Tuple[str, str], float]]
                     = None) -> List[CostRow]:
    """Merge the counted step with the net's params-per-tag map (a tag
    with no op still gets a zero row) and the optional per-(layer, dir)
    device seconds."""
    tags: List[str] = list(params_by_tag)
    for (tag, _d) in by_key:
        if tag not in tags:
            tags.append(tag)
    if layer_times:
        for (tag, _d) in layer_times:
            if tag not in tags:
                tags.append(tag)
    tail = [t for t in (OPTIMIZER_ROW, UNTAGGED_ROW) if t in tags]
    tags = [t for t in tags if t not in tail] + tail
    rows = []
    for tag in tags:
        fwd = by_key.get((tag, "fwd"), {})
        bwd = by_key.get((tag, "bwd"), {})
        row = CostRow(
            layer=tag, params=params_by_tag.get(tag, 0),
            flops_fwd=fwd.get("flops", 0.0), flops_bwd=bwd.get("flops", 0.0),
            transcendentals=(fwd.get("transcendentals", 0.0)
                             + bwd.get("transcendentals", 0.0)),
            bytes_accessed=fwd.get("bytes", 0.0) + bwd.get("bytes", 0.0),
            source="counted")
        if layer_times is not None:
            row.device_time_fwd_s = layer_times.get((tag, "fwd"), 0.0)
            row.device_time_bwd_s = layer_times.get((tag, "bwd"), 0.0)
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# the nets' cost_report
# ---------------------------------------------------------------------------


def random_batch(device, x_shapes, y_shapes, dtype=torch.float32):
    """Seed-0 normal inputs of ``x_shapes`` (zeros for an integer dtype)
    and zero labels of ``y_shapes``, on ``device``: the batch a cost report
    counts and times (the reference's ``cost_report`` inputs)."""
    import numpy as np

    rng = np.random.default_rng(0)
    xs = []
    for s in x_shapes:
        if dtype.is_floating_point:
            xs.append(torch.as_tensor(rng.normal(size=s), dtype=dtype,
                                      device=device))
        else:
            xs.append(torch.zeros(s, dtype=dtype, device=device))
    ys = [torch.zeros(s, dtype=torch.float32, device=device)
          for s in y_shapes]
    return xs, ys


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed_steps(net, fit_args, steps: int) -> float:
    """Wall seconds per step of ``net._fit_batch(*fit_args)`` as ``fit``
    runs it (a captured program on CUDA), after two warm steps."""
    for _ in range(2):
        net._fit_batch(*fit_args)
    _sync(net.device)
    t0 = time.perf_counter()
    for _ in range(max(1, steps)):
        net._fit_batch(*fit_args)
    _sync(net.device)
    return (time.perf_counter() - t0) / max(1, steps)


def net_cost_report(net, args_of, params_by_tag, entries, batch, *,
                    profile=False, steps=3, peak_flops=None, name="",
                    publish=True, trace_dir=None, count_guard=None,
                    fit_args=None) -> CostReport:
    """The body of ``MultiLayerNetwork.cost_report`` and
    ``ComputationGraph.cost_report``: count one eager train step
    (``net._train_body(*args_of(copy))``) on a copy of the net, optionally
    time ``steps`` steps of ``net._fit_batch(*fit_args)`` on a second copy
    and one profiled eager step by region on the first, and build the
    report. ``entries()`` gives the analytic table's rows."""
    from deeplearning4j_tpu_torch.nn import capture
    from deeplearning4j_tpu_torch.ops import kernels as _kern

    shadow = net._cost_shadow()
    args = args_of(shadow)

    def run():
        shadow._step_sizes()
        shadow._train_body(*args)

    source, rec, launches = "counted", None, {}
    try:
        with capture.disabled():
            guard = count_guard() if callable(count_guard) else count_guard
            with guard if guard is not None else _NULL:
                snap = _kern.snapshot_counts()
                rec = count_step(run)
                launches["counted"] = _kern.counts_since(snap)[0]
    except CostAnalysisUnavailable:
        source = "analytic"
    step_time = layer_times = device_time = trace = None
    if profile:
        if fit_args is not None:
            step_time = timed_steps(net._cost_shadow(), fit_args, steps)
        measured = {}

        @contextlib.contextmanager
        def around():
            snap = _kern.snapshot_counts()
            yield
            measured["launches"] = _kern.counts_since(snap)[0]

        with capture.disabled():
            layer_times, device_time, trace = profile_step(
                run, net.device, trace_dir, around=around)
        launches["profiled"] = measured.get("launches", {})
        if step_time is None:
            step_time = device_time
    if rec is not None:
        rows = rows_from_counts(rec.by_key, params_by_tag, layer_times)
        totals = {
            "flops": sum(r.flops for r in rows),
            "transcendentals": sum(r.transcendentals for r in rows),
            "bytes_accessed": sum(r.bytes_accessed for r in rows)}
    else:
        rows = analytic_rows(entries(), batch)
        totals = {"flops": sum(r.flops for r in rows)}
    conf = getattr(net, "conf", None)
    report = CostReport(
        rows=rows, totals=totals, batch=batch,
        params_total=net.num_params(), source=source, model=str(name),
        step_time_s=step_time, device_time_s=device_time,
        peak_flops=(peak_flops if peak_flops is not None
                    else peak_flops_from_env(
                        getattr(conf, "compute_dtype", None))),
        launches=launches or None,
        trace_busy_s=None if trace is None else trace["busy_s"],
        trace_span_s=None if trace is None else trace["span_s"],
        trace_kernels=None if trace is None else trace["kernels"],
        uncounted_ops=None if rec is None else dict(rec.uncounted),
        kernels=None if rec is None else dict(rec.kernels))
    net._cost_flops_per_example = report.flops_per_step / batch
    net._peak_flops = report.peak_flops
    if publish:
        publish_report(str(name), report)
    return report


# ---------------------------------------------------------------------------
# publish registry (the /costs route + StatsListener `cost` group)
# ---------------------------------------------------------------------------

_published: Dict[str, dict] = {}
_published_lock = threading.Lock()


def publish_report(name: str, report: CostReport) -> CostReport:
    """Register a report under ``name`` for the UI server's ``/costs``
    route and the StatsListener ``cost`` group, and set the utilization
    gauges so /metrics shows them without a fit loop running."""
    with _published_lock:
        _published[str(name)] = report.to_dict()
    from deeplearning4j_tpu_torch.util import telemetry as tm

    if tm.enabled():
        if report.examples_per_sec is not None:
            tm.gauge("train.examples_per_sec", report.examples_per_sec,
                     model=str(name))
        if report.mfu is not None:
            tm.gauge("train.model_flops_utilization", report.mfu,
                     model=str(name))
    return report


def published_reports() -> Dict[str, dict]:
    with _published_lock:
        return {k: dict(v) for k, v in _published.items()}


def clear_published() -> None:
    with _published_lock:
        _published.clear()


def cost_stats_group() -> Optional[dict]:
    """Compact per-report summary for StatsListener records: totals and
    utilization only; the per-layer table stays on /costs."""
    reps = published_reports()
    if not reps:
        return None
    return {
        name: {
            "flops_per_step": r.get("flops_per_step"),
            "batch": r.get("batch"),
            "params_total": r.get("params_total"),
            "source": r.get("source"),
            "step_time_s": r.get("step_time_s"),
            "examples_per_sec": r.get("examples_per_sec"),
            "model_flops_utilization": r.get("model_flops_utilization"),
            "layers": len(r.get("layers", ())),
        }
        for name, r in reps.items()
    }
