"""Conv2d on hand-written CUDA kernels: forward, input gradient (dgrad) and
filter gradient (wgrad), each with its plain version.

Counterpart of deeplearning4j_tpu/ops/kernels/conv.py. The TPU forward
kernels ``_fwd_kernel`` / ``_fwd_kernel_tiled`` become one implicit-GEMM
CUDA kernel (``csrc/conv2d_fwd.cu``) with three bodies: FMA on the CUDA
cores for fp32; for bf16, ``wgmma`` with TMA and an mbarrier ring where
the group's input and output channels are multiples of 64 (every
ResNet-50 conv but the stem), ``mma.sync`` elsewhere. The kernel library
picks the body from the type and geometry (``dl4j_conv2d_plan``) and the
wrappers report it (:func:`fwd_plan`, :func:`dgrad_plan`,
``kernels.BODY_LAUNCHES``). The TPU ``row_tile`` knob is that kernel's
``row_tile`` (output rows per M segment), not a second body.
:func:`conv2d_fwd` launches it on a CUDA tensor and takes
:func:`conv2d_fwd_reference` only for a tensor on the CPU. A geometry with
too few output tiles to fill the card splits its K sum into an fp32
workspace: the plan sizes the split, the wrapper allocates it.

The kernel reads a phase plan per spatial axis (:class:`_Spec`): which
outputs form each phase, and for each tap of a phase its input offset and
weight index. The forward is one phase per axis.

The backward is the reference's ``custom_vjp`` (``_conv_vjp_bwd``) as
:class:`Conv2dFunction`:

- dx (:func:`conv2d_dgrad`) is the same kernel launched on dy with the
  flipped, I/O-transposed weights (indexed in place, no copy), as the
  reference reuses ``_fwd_kernel``, but split by stride phase
  (:func:`dgrad_phase_plan`):
  the dx rows with (ih + lo) mod s = r take only the taps with
  ki*d = r (mod s), each a stride-1 gather of the undilated dy. No
  zero-dilated dy is made and no product with its zeros computed; all
  phases run in one launch, and a phase with no taps writes zeros.
- dW (:func:`conv2d_wgrad`) is the wgrad kernel (``csrc/conv2d_wgrad.cu``,
  replacing ``_wgrad_kernel``), fp32 out, cast to w's type by the caller.
  Its bodies are the conv kernel's three, picked by its own gate
  (:func:`wgrad_body`: bf16 ``wgmma`` needs one group as well) and
  reported by :func:`wgrad_plan`.

Each of the three kernels goes through ``kernels.dispatch`` on its own and
counts its own launches (``conv2d_fwd``, ``conv2d_dgrad``,
``conv2d_wgrad``), though dgrad shares the forward kernel.

The plain versions are the TPU kernels' own arithmetic in PyTorch:
:func:`conv2d_fwd_reference` pads, then for each (ki, kj) tap multiplies
one strided window reshaped to (N*OH*OW, Cg) by the (Cg, Og) weight slice
per group (all groups in one batched product; a depthwise conv's Cg = 1
products are element-wise), summed in fp32; :func:`conv2d_wgrad_reference` sums
patch(ki, kj)^T @ dY per tap; :func:`conv2d_dgrad_reference` dilates,
pads (or trims) dy as ``_dy_for_input_grad`` does and runs the plain
forward, a construction independent of the phase plan. They are the exact
path of ``ops.nn.conv2d`` and what the kernels are held to.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops import kernels as _kern
from deeplearning4j_tpu_torch.ops.kernels import _build
from deeplearning4j_tpu_torch.util import cost_model as _cm

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def resolve_padding(padding, in_hw, k_hw, strides, dilation):
    """'SAME'/'VALID'/int/(ph, pw) -> explicit ((lo, hi), (lo, hi)) pixels
    (the ND4J symmetric convention for numeric pads; SAME computes the
    XLA-compatible asymmetric split)."""
    if padding == "VALID":
        return ((0, 0), (0, 0))
    out = []
    for i in range(2):
        k_eff = (k_hw[i] - 1) * dilation[i] + 1
        if padding == "SAME":
            o = -(-in_hw[i] // strides[i])
            pad = max((o - 1) * strides[i] + k_eff - in_hw[i], 0)
            out.append((pad // 2, pad - pad // 2))
        else:
            p = _pair(padding)[i]
            out.append((p, p))
    return tuple(out)


def _out_size(in_size, pad, k, stride, dil):
    eff = (k - 1) * dil + 1
    return (in_size + pad[0] + pad[1] - eff) // stride + 1


def valid_row_tile(oh: int, row_tile) -> bool:
    """A positive divisor of the output height, or None (whole OH)."""
    if row_tile is None:
        return True
    return isinstance(row_tile, int) and 0 < row_tile <= oh \
        and oh % row_tile == 0


def valid_row_tiles(oh: int, limit: int = 8):
    """The candidate row tiles of an output height: ``None`` (whole OH,
    the default) and every divisor of ``oh`` below it, up to ``limit``
    of them, smallest first (the reference's ``:144``)."""
    divs = [d for d in range(1, oh + 1) if oh % d == 0 and d < oh]
    return [None] + divs[:limit]


def shape_signature(x_shape, w_shape, strides, padding, dilation,
                    groups) -> str:
    """The tuning-database signature of one conv geometry, the same
    string the reference builds (``:128``): one builder for the search
    space (``tuning/space.py``) and the dispatch site (``ops/nn.py``)."""
    def part(v):
        if isinstance(v, (tuple, list)):
            return "x".join(str(int(x)) for x in v)
        return str(v)

    pad = padding if isinstance(padding, str) else part(_pair(padding))
    return (f"x={part(x_shape)};w={part(w_shape)};s={part(strides)};"
            f"p={pad};d={part(dilation)};g={int(groups)}")


def supports(x, w, data_format, feature_group_count,
             preferred_element_type) -> bool:
    """Geometry/dtype gate for the kernel (mirrors the reference's). The
    kernel sums in fp32 and writes x's type, which is what a
    ``preferred_element_type`` of None or float32 asks for; any other
    request, layout or type is refused."""
    if data_format != "NHWC" or preferred_element_type not in (
            None, torch.float32):
        return False
    if x.dim() != 4 or w.dim() != 4:
        return False
    if x.dtype not in _KERNEL_DTYPES or w.dtype != x.dtype:
        return False
    cin = x.shape[-1]
    if cin % feature_group_count or w.shape[3] % feature_group_count:
        return False
    if w.shape[2] * feature_group_count != cin:
        return False
    return max(w.shape[0], w.shape[1]) <= MAX_AXIS_TAPS


def _geometry(x, w, strides, pads, dilation):
    n, h, wd, _ = x.shape
    kh, kw, _, cout = w.shape
    oh = _out_size(h, pads[0], kh, strides[0], dilation[0])
    ow = _out_size(wd, pads[1], kw, strides[1], dilation[1])
    return n, oh, ow, cout


# ---------------------------------------------------------------------------
# the phase plan and the launch (csrc/conv2d_fwd.cu)
# ---------------------------------------------------------------------------

#: the kernel's limits per spatial axis: phases (the stride, for dgrad) and
#: taps (the kernel extent)
MAX_AXIS_PHASES = 8
MAX_AXIS_TAPS = 32
#: the bodies of csrc/conv2d_fwd.cu and csrc/conv2d_wgrad.cu, by the code
#: ``dl4j_conv2d_plan`` and ``dl4j_conv2d_wgrad_plan`` report
BODIES = ("fma", "mma_sync", "wgmma")


class _Axis(ctypes.Structure):
    """csrc/conv2d_fwd.cu's ConvAxis: one spatial axis of a phase plan."""
    _fields_ = [("phases", ctypes.c_int), ("in_size", ctypes.c_int),
                ("out_size", ctypes.c_int), ("in_step", ctypes.c_int),
                ("out_step", ctypes.c_int),
                ("n_out", ctypes.c_int * MAX_AXIS_PHASES),
                ("out0", ctypes.c_int * MAX_AXIS_PHASES),
                ("tap0", ctypes.c_int * (MAX_AXIS_PHASES + 1)),
                ("off", ctypes.c_int * MAX_AXIS_TAPS),
                ("wk", ctypes.c_int * MAX_AXIS_TAPS)]


class _Spec(ctypes.Structure):
    """csrc/conv2d_fwd.cu's ConvSpec: one launch."""
    _fields_ = [("n", ctypes.c_int), ("cin", ctypes.c_int),
                ("cout", ctypes.c_int), ("groups", ctypes.c_int),
                ("kh", ctypes.c_int), ("kw", ctypes.c_int),
                ("row_tile", ctypes.c_int), ("b_trans", ctypes.c_int),
                ("ax", _Axis * 2)]


def fwd_axis_plan(k, stride, dilation, pad_lo, out_size):
    """The forward along one axis as a phase plan: ``(in_step, out_step,
    phases)``, one phase ``(out0, n_out, taps)`` of every output, tap ki
    reading input ``o * stride + ki * dilation - pad_lo``."""
    taps = tuple((ki, ki * dilation - pad_lo) for ki in range(k))
    return (stride, 1, ((0, out_size, taps),))


def dgrad_axis_plan(x_size, k, stride, dilation, pad_lo):
    """dx along one axis of a conv (stride s, dilation d, low pad lo) as a
    phase plan ``(1, s, phases)``. dy row oh reaches dx row ih through tap
    ki exactly when ``oh*s - lo + ki*d = ih``, so the rows with
    ``(ih + lo) mod s = r`` form phase r: ``n_out`` rows from ``out0`` at
    stride s, and its taps are the ki with ``ki*d = r (mod s)``, tap
    ``(ki, off)`` adding ``dy[o + off] @ w[ki]^T`` to ``dx[out0 + o*s]``
    (a dy row outside dy reads as zero). A phase may have no tap; phases
    with no row are left out."""
    phases = []
    for r in range(stride):
        j0 = -((r - pad_lo) // stride)  # first j with j*s + r - lo >= 0
        n_out = (x_size - 1 + pad_lo - r) // stride - j0 + 1
        if n_out <= 0:
            continue
        taps = tuple((ki, j0 + (r - ki * dilation) // stride)
                     for ki in range(k) if (ki * dilation - r) % stride == 0)
        phases.append((j0 * stride + r - pad_lo, n_out, taps))
    return (1, stride, tuple(phases))


def dgrad_phase_plan(x_hw, k_hw, strides, pads, dilation, dy_hw):
    """The phase plan of dx, one :func:`dgrad_axis_plan` per axis: a 2-D
    phase is a pair of axis phases, its taps the pairs of their taps. Each
    dx position lies in exactly one 2-D phase; ``dy_hw`` bounds the dy
    rows and columns a tap may read (the rest are zeros)."""
    for i in range(2):
        eff = (k_hw[i] - 1) * dilation[i] + 1
        want = (x_hw[i] + sum(pads[i]) - eff) // strides[i] + 1
        if dy_hw[i] != want:
            raise ValueError(f"dgrad_phase_plan: dy extent {dy_hw[i]} along "
                             f"axis {i}, expected {want}")
    return tuple(dgrad_axis_plan(x_hw[i], k_hw[i], strides[i], dilation[i],
                                 pads[i][0]) for i in range(2))


def _spec(n, cin, cout, groups, k_hw, in_hw, out_hw, plans, row_tile,
          b_trans):
    """The launch's ConvSpec. ``b_trans``: the weights are the forward's of
    the conv whose input gradient this is, (kh, kw, Cout/groups, Cin) here,
    read transposed in place (no flipped, transposed copy: tap ki reads
    weight index ki)."""
    s = _Spec(n=n, cin=cin, cout=cout, groups=groups, kh=k_hw[0],
              kw=k_hw[1], row_tile=row_tile or 0, b_trans=int(b_trans))
    for i, (in_step, out_step, phases) in enumerate(plans):
        a = s.ax[i]
        a.phases, a.in_size, a.out_size = len(phases), in_hw[i], out_hw[i]
        a.in_step, a.out_step = in_step, out_step
        t = 0
        for r, (out0, n_out, taps) in enumerate(phases):
            a.n_out[r], a.out0[r], a.tap0[r] = n_out, out0, t
            for k, off in taps:
                a.off[t], a.wk[t] = off, k
                t += 1
        a.tap0[len(phases)] = t
    return s


#: the geometry of each plan this process made, in order, as
#: ("fwd" | "wgrad", args): what ``util/aot_store.py`` stores so that a
#: warm process makes them again before building (:func:`replan`)
_PLANNED: list = []


def plans_made() -> list:
    """The plans made so far (see ``_PLANNED``), JSON-ready."""
    return [list(p) for p in _PLANNED]


def _tupled(v):
    return tuple(_tupled(x) for x in v) if isinstance(v, list) else v


def replan(plans) -> None:
    """Make again the plans :func:`plans_made` listed (a stored warm-up's;
    each a cached call into the kernel library), on the card only."""
    if not torch.cuda.is_available():
        return
    for kind, args in plans:
        args = _tupled(args)
        if kind == "fwd":
            _launch_plan(*args)
        else:
            _wgrad_plan(*args)


@functools.lru_cache(maxsize=None)
def _launch_plan(device_index, code, n, cin, cout, groups, k_hw, in_hw,
                 out_hw, plans, row_tile, b_trans):
    """(ConvSpec, K slices, body name) of one launch, as the kernel
    library plans it for this card (``dl4j_conv2d_plan``); cached per
    geometry, so a step's launches build no struct and make no plan call."""
    _PLANNED.append(("fwd", [device_index, code, n, cin, cout, groups,
                             k_hw, in_hw, out_hw, plans, row_tile,
                             b_trans]))
    lib = _build.load()
    if lib.dl4j_conv2d_spec_bytes() != ctypes.sizeof(_Spec):
        raise RuntimeError("csrc/conv2d_fwd.cu's ConvSpec and conv.py's "
                           "_Spec differ")
    spec = _spec(n, cin, cout, groups, k_hw, in_hw, out_hw, plans, row_tile,
                 b_trans)
    splits, body = ctypes.c_int(1), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = lib.dl4j_conv2d_plan(code, ctypes.addressof(spec),
                                  ctypes.byref(splits), ctypes.byref(body))
    _build.check(rc, "dl4j_conv2d_plan")
    return spec, splits.value, BODIES[body.value]


def _aligned(t):
    """t, or a copy of it where its data is not 16-byte aligned (TMA and the
    16-byte loads of the bf16 wgmma body need it)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(kernel, x, w, out, plan):
    """One launch of the conv kernel into ``out`` on the plan from
    :func:`_launch_plan`; counts it under ``kernel`` and its body."""
    spec, splits, body = plan
    if body == "wgmma":
        x, w = _aligned(x), _aligned(w)
    ws = (torch.empty((splits, out.numel()), dtype=torch.float32,
                      device=x.device) if splits > 1 else None)
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.dl4j_conv2d(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                             _KERNEL_DTYPES[x.dtype], ctypes.addressof(spec),
                             splits, None if ws is None else ws.data_ptr(),
                             stream)
    _build.check(rc, f"{kernel} launch")
    _kern.LAUNCHES[kernel] += 1
    key = f"{kernel}/{body}"
    _kern.BODY_LAUNCHES[key] = _kern.BODY_LAUNCHES.get(key, 0) + 1
    if spec.row_tile:
        key = f"{kernel}/rt={spec.row_tile}"
        _kern.ROW_TILE_LAUNCHES[key] = _kern.ROW_TILE_LAUNCHES.get(key, 0) + 1


def fwd_plan(x, w, strides, pads, dilation, groups, row_tile=None):
    """(ConvSpec, K slices, body) of :func:`conv2d_fwd` on these CUDA
    tensors."""
    strides, dilation = _pair(strides), _pair(dilation)
    n, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    _, oh, ow, _ = _geometry(x, w, strides, pads, dilation)
    plans = tuple(fwd_axis_plan(k, s, d, p[0], o) for k, s, d, p, o in zip(
        (kh, kw), strides, dilation, pads, (oh, ow)))
    return _launch_plan(x.device.index, _KERNEL_DTYPES[x.dtype], n, cin,
                        cout, groups, (kh, kw), (h, wd), (oh, ow), plans,
                        row_tile or 0, False)


def dgrad_plan(dy, w, x_hw, strides, pads, dilation, groups):
    """(ConvSpec, K slices, body) of :func:`conv2d_dgrad` on these CUDA
    tensors (``w`` as the forward's, HWIO)."""
    strides, dilation = _pair(strides), _pair(dilation)
    n, oh, ow, cout = dy.shape
    kh, kw, cg, _ = w.shape
    plans = dgrad_phase_plan(x_hw, (kh, kw), strides, pads, dilation,
                             (oh, ow))
    return _launch_plan(dy.device.index, _KERNEL_DTYPES[dy.dtype], n, cout,
                        cg * groups, groups, (kh, kw), (oh, ow),
                        tuple(x_hw), plans, 0, True)


def conv2d_fwd_reference(x, w, strides, pads, dilation, groups):
    """Plain PyTorch version: the tap-sum of the TPU kernel, fp32 sums."""
    n, oh, ow, cout = _geometry(x, w, strides, pads, dilation)
    kh, kw, cg, _ = w.shape
    og = cout // groups
    sh, sw = strides
    dh, dw = dilation
    acc_t = torch.promote_types(x.dtype, torch.float32)
    xp = F.pad(x.to(acc_t), (0, 0, pads[1][0], pads[1][1],
                             pads[0][0], pads[0][1]))
    wf = w.to(acc_t)
    m = n * oh * ow
    if groups == 1:
        acc = torch.zeros((m, cout), dtype=acc_t, device=x.device)
    else:  # every group at once: (M, groups, Og)
        acc = torch.zeros((m, groups, og), dtype=acc_t, device=x.device)
        wf = wf.reshape(kh, kw, cg, groups, og)
    for ki in range(kh):
        for kj in range(kw):
            r0, c0 = ki * dh, kj * dw
            patch = xp[:, r0:r0 + (oh - 1) * sh + 1:sh,
                       c0:c0 + (ow - 1) * sw + 1:sw, :]
            if groups == 1:
                acc.addmm_(patch.reshape(m, cg), wf[ki, kj])
            elif cg == 1:  # depthwise: one product a tap and output
                acc.addcmul_(patch.reshape(m, groups, 1), wf[ki, kj, 0])
            else:
                acc.add_(torch.einsum("mgc,cgo->mgo",
                                      patch.reshape(m, groups, cg),
                                      wf[ki, kj]))
    return acc.reshape(n, oh, ow, cout).to(x.dtype)


def _check_cuda_pair(name, a, b):
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError(f"{name}: tensors on {a.device} and {b.device}; "
                         "both must be on one CUDA device")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")


def conv2d_fwd(x, w, strides, pads, dilation, groups,
               row_tile: Optional[int] = None):
    """NHWC x HWIO convolution on the CUDA kernel. ``pads`` is the explicit
    ((lo, hi), (lo, hi)) form from :func:`resolve_padding`; ``row_tile``
    is the number of output rows an M segment spans (None = whole OH).
    A CPU tensor takes :func:`conv2d_fwd_reference`."""
    strides, dilation = _pair(strides), _pair(dilation)
    n, oh, ow, cout = _geometry(x, w, strides, pads, dilation)
    if not valid_row_tile(oh, row_tile):
        raise ValueError(
            f"row_tile {row_tile!r} invalid for output height {oh} "
            "(must be a positive divisor)")
    if x.device.type == "cpu" and w.device.type == "cpu":
        return conv2d_fwd_reference(x, w, strides, pads, dilation, groups)
    _check_cuda_pair("conv2d_fwd", x, w)
    if not supports(x, w, "NHWC", groups, None):
        raise ValueError(
            f"conv2d_fwd: unsupported x {tuple(x.shape)} {x.dtype}, "
            f"w {tuple(w.shape)} {w.dtype}, groups {groups}")
    if min(min(p) for p in pads) < 0 or min(strides + dilation) < 1:
        raise ValueError(f"conv2d_fwd: bad pads {pads} / strides {strides} "
                         f"/ dilation {dilation}")
    if oh < 1 or ow < 1:
        raise ValueError(f"conv2d_fwd: empty output {oh}x{ow}")
    out = torch.empty((n, oh, ow, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    _launch("conv2d_fwd", x, w, out,
            fwd_plan(x, w, strides, pads, dilation, groups, row_tile))
    return out


def _cost(x, w, strides, pads, dilation, groups):
    """(FLOPs, transcendentals, bytes) of one conv launch for the cost
    model: the forward, dgrad and wgrad launches of a conv multiply over
    the same valid (position, tap) pairs and each moves x (or dx), w (or
    dW) and y (or dy) once."""
    def fn():
        strides_p, dil_p = _pair(strides), _pair(dilation)
        flops = _cm.conv_flops(tuple(x.shape), tuple(w.shape), strides_p,
                               pads, dil_p, groups)
        y = 1
        for d in _geometry(x, w, strides_p, pads, dil_p):
            y *= int(d)
        return flops, 0.0, float((x.numel() + w.numel() + y)
                                 * x.element_size())
    return fn


def conv2d(x, w, strides, pads, dilation, groups, supported, describe,
           sig=None):
    """The forward as ``ops.nn.conv2d`` dispatches it: the kernel on a CUDA
    tensor (or raise), the plain version on the CPU or under ``exact``.
    ``sig``: the call's tuning signature (:func:`shape_signature`, or a
    callable giving it); under ``auto`` with a tuning database armed, the
    winner for it decides, and a kernel winner's ``row_tile`` (K2) is
    launched when it divides the output height (a stale tile launches the
    whole kernel)."""
    winner = _kern.tuned_winner("conv2d_fwd", x, op="conv2d", sig=sig,
                                dtype=x.dtype)
    launch = (winner is None or winner.get("impl") != "exact") and \
        _kern.dispatch("conv2d_fwd", supported, x, describe)
    with _cm.kernel_cost("conv2d_fwd", _cost(x, w, strides, pads, dilation,
                                             groups)):
        if launch:
            row_tile = ((winner or {}).get("params") or {}).get("row_tile")
            if row_tile is not None and not valid_row_tile(
                    _geometry(x, w, _pair(strides), pads,
                              _pair(dilation))[1], row_tile):
                row_tile = None
            return conv2d_fwd(x.contiguous(), w.contiguous(), strides, pads,
                              dilation, groups, row_tile=row_tile)
        return conv2d_fwd_reference(x, w, strides, pads, dilation, groups)


# ---------------------------------------------------------------------------
# filter gradient (wgrad): K3
# ---------------------------------------------------------------------------


def supports_wgrad(x, dy, groups) -> bool:
    """Type/layout gate of the wgrad kernel: 4-D NHWC x and dy of one
    kernel type, channels divisible by ``groups``."""
    return (x.dim() == 4 and dy.dim() == 4 and x.dtype in _KERNEL_DTYPES
            and dy.dtype == x.dtype and x.shape[-1] % groups == 0
            and dy.shape[-1] % groups == 0)


def wgrad_body(dtype, x_shape, dy_shape, k_hw, strides, pads, dilation,
               groups) -> str:
    """The body of ``csrc/conv2d_wgrad.cu`` a launch runs, as its
    ``pick_body`` decides (``dl4j_conv2d_wgrad_plan`` reports it on the
    card): fp32 ``fma``; bf16 ``wgmma`` for one group whose Cin and Cout
    are multiples of 64 and whose window fits x's im2col tensor map
    (strides up to 8, window extents and bounding-box corners within
    127: every ResNet-50 wgrad but the stem's), ``mma_sync`` elsewhere.
    Shapes are NHWC; ``pads`` the explicit ((top, bottom), (left, right))."""
    if dtype == torch.float32:
        return "fma"
    cin, cout = x_shape[-1], dy_shape[-1]
    fits = True
    for i in range(2):
        k, s, d, lo = k_hw[i], strides[i], dilation[i], pads[i][0]
        upper = -lo + (dy_shape[1 + i] - 1) * s + 1 - x_shape[1 + i]
        fits &= (s <= 8 and (k - 1) * d <= 127 and -128 <= -lo <= 127
                 and -128 <= upper <= 127)
    return ("wgmma" if groups == 1 and cin % 64 == 0 and cout % 64 == 0
            and fits else "mma_sync")


@functools.lru_cache(maxsize=None)
def _wgrad_plan(device_index, code, *geometry):
    """(position slices, body) of one wgrad launch, as the kernel library's
    ``dl4j_conv2d_wgrad_plan`` sizes them for this card (the body's block
    tile, one wave of resident blocks from the occupancy calculator);
    raises where its body is not :func:`wgrad_body`'s. Cached per
    geometry, so a step's launches make no plan call."""
    _PLANNED.append(("wgrad", [device_index, code, *geometry]))
    splits, body = ctypes.c_int(1), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = _build.load().dl4j_conv2d_wgrad_plan(
            code, *geometry, ctypes.byref(splits), ctypes.byref(body))
    _build.check(rc, "dl4j_conv2d_wgrad_plan")
    n, h, wd, cin, kh, kw, cout, groups, oh, ow, sh, sw, dh, dw, pt, pl = \
        geometry
    want = wgrad_body(torch.float32 if code == 0 else torch.bfloat16,
                      (n, h, wd, cin), (n, oh, ow, cout), (kh, kw), (sh, sw),
                      ((pt, 0), (pl, 0)), (dh, dw), groups)
    if BODIES[body.value] != want:
        raise RuntimeError(f"csrc/conv2d_wgrad.cu picked "
                           f"{BODIES[body.value]} where conv.py's "
                           f"wgrad_body says {want}")
    return splits.value, want


def _wgrad_geometry(x, dy, kh, kw, strides, pads, dilation, groups):
    """The geometry ints of ``dl4j_conv2d_wgrad_plan`` and
    ``dl4j_conv2d_wgrad``."""
    n, h, wd, cin = x.shape
    _, oh, ow, cout = dy.shape
    return (n, h, wd, cin, kh, kw, cout, groups, oh, ow, strides[0],
            strides[1], dilation[0], dilation[1], pads[0][0], pads[1][0])


def wgrad_plan(x, dy, kh, kw, strides, pads, dilation, groups):
    """(position slices, body) of :func:`conv2d_wgrad` on these CUDA
    tensors."""
    return _wgrad_plan(x.device.index, _KERNEL_DTYPES[x.dtype],
                       *_wgrad_geometry(x, dy, kh, kw, _pair(strides), pads,
                                        _pair(dilation), groups))


def conv2d_wgrad_reference(x, dy, kh, kw, strides, pads, dilation, groups):
    """Plain PyTorch version of ``_wgrad_kernel``: for each group and tap,
    patch(ki, kj)^T @ dY over all N*OH*OW positions, fp32 sums and an fp32
    (kh, kw, Cg, Cout) result (fp64 stays fp64)."""
    n, oh, ow, cout = dy.shape
    cg = x.shape[-1] // groups
    og = cout // groups
    sh, sw = strides
    dh, dw = dilation
    acc_t = torch.promote_types(x.dtype, torch.float32)
    xp = F.pad(x.to(acc_t), (0, 0, pads[1][0], pads[1][1],
                             pads[0][0], pads[0][1]))
    m = n * oh * ow
    dyf = dy.to(acc_t).reshape(m, groups, og)
    out = torch.empty((kh, kw, cg, cout), dtype=acc_t, device=x.device)
    for ki in range(kh):
        for kj in range(kw):
            r0, c0 = ki * dh, kj * dw
            patch = xp[:, r0:r0 + (oh - 1) * sh + 1:sh,
                       c0:c0 + (ow - 1) * sw + 1:sw, :].reshape(m, groups, cg)
            if groups == 1:
                out[ki, kj] = patch[:, 0].t() @ dyf[:, 0]
            elif cg == og == 1:  # depthwise: one dot product a group
                out[ki, kj] = (patch[:, :, 0] * dyf[:, :, 0]).sum(0)
            else:  # every group at once: (Cg, groups, Og)
                out[ki, kj] = torch.einsum("mgc,mgo->cgo", patch,
                                           dyf).reshape(cg, cout)
    return out


def conv2d_wgrad(x, dy, kh, kw, strides, pads, dilation, groups):
    """dW (kh, kw, Cin/groups, Cout) in fp32 on the wgrad kernel, from the
    forward's x and the output gradient dy (both NHWC, one type). A CPU
    tensor takes :func:`conv2d_wgrad_reference`."""
    strides, dilation = _pair(strides), _pair(dilation)
    if x.device.type == "cpu" and dy.device.type == "cpu":
        return conv2d_wgrad_reference(x, dy, kh, kw, strides, pads, dilation,
                                      groups)
    _check_cuda_pair("conv2d_wgrad", x, dy)
    if not supports_wgrad(x, dy, groups):
        raise ValueError(
            f"conv2d_wgrad: unsupported x {tuple(x.shape)} {x.dtype}, "
            f"dy {tuple(dy.shape)} {dy.dtype}, groups {groups}")
    n, h, wd, cin = x.shape
    _, oh, ow, cout = dy.shape
    want = (_out_size(h, pads[0], kh, strides[0], dilation[0]),
            _out_size(wd, pads[1], kw, strides[1], dilation[1]))
    if (oh, ow) != want or dy.shape[0] != n:
        raise ValueError(f"conv2d_wgrad: dy {tuple(dy.shape)} does not match "
                         f"x {tuple(x.shape)} (expected {want} outputs)")
    cg = cin // groups
    out = torch.empty((kh, kw, cg, cout), dtype=torch.float32,
                      device=x.device)
    if dy.numel() == 0:
        return out.zero_()
    geometry = _wgrad_geometry(x, dy, kh, kw, strides, pads, dilation, groups)
    code = _KERNEL_DTYPES[x.dtype]
    splits, body = _wgrad_plan(x.device.index, code, *geometry)
    if body == "wgmma":
        x, dy = _aligned(x), _aligned(dy)
    ws = (torch.empty((splits, kh * kw * cg, cout), dtype=torch.float32,
                      device=x.device) if splits > 1 else None)
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.dl4j_conv2d_wgrad(
            x.data_ptr(), dy.data_ptr(), out.data_ptr(), code, *geometry,
            splits, None if ws is None else ws.data_ptr(), stream)
    _build.check(rc, "conv2d_wgrad launch")
    _kern.LAUNCHES["conv2d_wgrad"] += 1
    key = f"conv2d_wgrad/{body}"
    _kern.BODY_LAUNCHES[key] = _kern.BODY_LAUNCHES.get(key, 0) + 1
    return out


# ---------------------------------------------------------------------------
# input gradient (dgrad): K1 on the transformed dy and w
# ---------------------------------------------------------------------------


def flip_transpose_w(w, groups):
    """w (kh, kw, Cg, g*Og) -> (kh, kw, Og, g*Cg): spatial flip + per-group
    I/O transpose (the reference's ``_flip_transpose_w``)."""
    kh, kw, cg, cout = w.shape
    og = cout // groups
    wg = w.reshape(kh, kw, cg, groups, og).flip(0, 1)
    return wg.permute(0, 1, 4, 3, 2).reshape(kh, kw, og, groups * cg)


def dilate_dy(dy, strides):
    """dy with sh-1 / sw-1 zero rows / columns between its rows / columns,
    (N, (OH-1)*sh+1, (OW-1)*sw+1, C); dy itself at stride 1."""
    sh, sw = strides
    if (sh, sw) == (1, 1):
        return dy
    n, oh, ow, c = dy.shape
    out = dy.new_zeros((n, (oh - 1) * sh + 1, (ow - 1) * sw + 1, c))
    out[:, ::sh, ::sw] = dy
    return out


def dgrad_pads(x_hw, k_hw, strides, pads, dilation, dy_hw):
    """(lo', hi') per axis of the stride-dilated dy for the forward conv
    that computes dx: ``lo' = eff-1-lo``, ``hi' = H+lo-len(dilated dy)``
    (negative = trim), as ``_dy_for_input_grad`` derives them."""
    spec = []
    for i in range(2):
        eff = (k_hw[i] - 1) * dilation[i] + 1
        odl = (dy_hw[i] - 1) * strides[i] + 1
        spec.append((eff - 1 - pads[i][0], x_hw[i] + pads[i][0] - odl))
    return tuple(spec)


def supports_dgrad(dy, w, groups, strides=(1, 1)) -> bool:
    """The kernel's gate on dy and the forward's weights: 4-D, one kernel
    type, dy's channels the weights' outputs, and a phase plan within the
    kernel's limits (strides up to MAX_AXIS_PHASES, kernel extents up to
    MAX_AXIS_TAPS)."""
    return (dy.dim() == 4 and w.dim() == 4 and dy.dtype in _KERNEL_DTYPES
            and w.dtype == dy.dtype and dy.shape[-1] == w.shape[3]
            and w.shape[3] % groups == 0
            and max(_pair(strides)) <= MAX_AXIS_PHASES
            and max(w.shape[0], w.shape[1]) <= MAX_AXIS_TAPS)


def conv2d_dgrad_reference(dy, w, x_hw, strides, pads, dilation, groups):
    """Plain PyTorch version: dilate dy, pad (or trim) it by
    :func:`dgrad_pads`, and run :func:`conv2d_fwd_reference` with the
    flipped, transposed weights at stride 1. Result in dy's type."""
    dyd = dilate_dy(dy, strides)
    spec = dgrad_pads(x_hw, w.shape[:2], strides, pads, dilation,
                      dy.shape[1:3])
    (tlo, thi), (llo, lhi) = ((max(0, -lo), max(0, -hi)) for lo, hi in spec)
    dyd = dyd[:, tlo:dyd.shape[1] - thi, llo:dyd.shape[2] - lhi]
    fpads = tuple((max(0, lo), max(0, hi)) for lo, hi in spec)
    return conv2d_fwd_reference(dyd, flip_transpose_w(w, groups), (1, 1),
                                fpads, dilation, groups)


def conv2d_dgrad(dy, w, x_hw, strides, pads, dilation, groups):
    """dx (N, H, W, Cin) on the conv kernel, split by stride phase: one
    launch over every phase of :func:`dgrad_phase_plan`, reading the
    undilated dy and the forward's weights as they are (the kernel indexes
    them transposed, tap ki at weight ki: no flipped copy); a phase with no
    taps writes zeros. A CPU tensor takes :func:`conv2d_dgrad_reference`."""
    strides, dilation = _pair(strides), _pair(dilation)
    if dy.device.type == "cpu" and w.device.type == "cpu":
        return conv2d_dgrad_reference(dy, w, x_hw, strides, pads, dilation,
                                      groups)
    _check_cuda_pair("conv2d_dgrad", dy, w)
    if not supports_dgrad(dy, w, groups, strides):
        raise ValueError(
            f"conv2d_dgrad: unsupported dy {tuple(dy.shape)} {dy.dtype}, "
            f"w {tuple(w.shape)} {w.dtype}, groups {groups}, strides "
            f"{strides}")
    n = dy.shape[0]
    cin = w.shape[2] * groups
    out = torch.empty((n, x_hw[0], x_hw[1], cin), dtype=dy.dtype,
                      device=dy.device)
    if out.numel() == 0:
        return out
    plan = dgrad_plan(dy, w, x_hw, strides, pads, dilation, groups)
    _launch("conv2d_dgrad", dy, w, out, plan)
    return out


# ---------------------------------------------------------------------------
# the differentiable op
# ---------------------------------------------------------------------------


def conv2d_bwd(dy, x, w, strides, pads, dilation, groups, need_dx=True,
               need_dw=True):
    """(dx, dW) of the NHWC conv, each through its own dispatch: the dgrad
    or wgrad kernel on a CUDA tensor (or raise), the plain version on the
    CPU or under ``exact``. dW comes back in w's type, dx in x's; an input
    that needs no gradient gets None and costs no launch."""
    dx = dw = None
    if need_dx:
        with _cm.kernel_cost("conv2d_dgrad", _cost(x, w, strides, pads,
                                                   dilation, groups)):
            if _kern.dispatch("conv2d_dgrad",
                              supports_dgrad(dy, w, groups, strides), dy,
                              lambda: f"dy {tuple(dy.shape)} {dy.dtype}, w "
                                      f"{tuple(w.shape)} {w.dtype}, groups "
                                      f"{groups}"):
                dx = conv2d_dgrad(dy.contiguous(), w.contiguous(),
                                  tuple(x.shape[1:3]), strides, pads,
                                  dilation, groups)
            else:
                dx = conv2d_dgrad_reference(dy, w, tuple(x.shape[1:3]),
                                            strides, pads, dilation, groups)
            dx = dx.to(x.dtype)
    if need_dw:
        kh, kw = w.shape[0], w.shape[1]
        with _cm.kernel_cost("conv2d_wgrad", _cost(x, w, strides, pads,
                                                   dilation, groups)):
            if _kern.dispatch("conv2d_wgrad", supports_wgrad(x, dy, groups),
                              x, lambda: f"x {tuple(x.shape)} {x.dtype}, dy "
                                         f"{tuple(dy.shape)} {dy.dtype}, "
                                         f"groups {groups}"):
                dw = conv2d_wgrad(x.contiguous(), dy.contiguous(), kh, kw,
                                  strides, pads, dilation, groups)
            else:
                dw = conv2d_wgrad_reference(x, dy, kh, kw, strides, pads,
                                            dilation, groups)
            dw = dw.to(w.dtype)
    return dx, dw


class Conv2dFunction(torch.autograd.Function):
    """The reference's ``conv2d_pallas`` custom VJP: the forward through
    :func:`conv2d`, the backward through :func:`conv2d_bwd` (dgrad skipped
    when x needs no gradient, e.g. a network's input). The dispatch mode is
    read when the forward runs and pinned for the backward, which autograd
    may run on another thread. ``kept``: the output a remat stage's
    forward kept (``util/xla_tuning.py``), returned instead of launching;
    x and w are saved either way, so the stage's recompute saves what its
    forward saved."""

    @staticmethod
    def forward(ctx, x, w, strides, pads, dilation, groups, supported,
                describe, sig=None, kept=None):
        ctx.impl = _kern.resolve_impl()
        ctx.geometry = (strides, pads, dilation, groups)
        ctx.save_for_backward(x, w)
        if kept is not None:
            return kept.view_as(kept)
        return conv2d(x, w, strides, pads, dilation, groups, supported,
                      describe, sig)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        with _kern.impl_scope(ctx.impl):
            dx, dw = conv2d_bwd(dy, x, w, *ctx.geometry,
                                need_dx=ctx.needs_input_grad[0],
                                need_dw=ctx.needs_input_grad[1])
        return dx, dw, None, None, None, None, None, None, None, None
