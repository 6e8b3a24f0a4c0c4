"""Elementwise op families: transform / pairwise / scalar (counterpart of
deeplearning4j_tpu/ops/elementwise.py).

One torch expression per op, as the reference has one jnp expression per
op; none of them is a Pallas kernel there, so all are plain PyTorch here.
Integer semantics follow jnp: floor division and ``mod`` round toward
minus infinity, ``fmod`` and ``truncatediv`` toward zero, ``round`` rounds
half to even, and shifts of negative integers are arithmetic. The bit
operations (rotations, popcounts) work on the unsigned pattern of the
integer's width. Special functions torch lacks (``betainc``, ``expint``)
are evaluated in float64 by their series and continued fractions.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops import _compat as C
from deeplearning4j_tpu_torch.ops.registry import op


def _u(fn):
    """A unary op on tensors or scalars."""
    return lambda x: fn(C.t(x))


def _b(fn):
    """A binary op with numpy broadcasting and weak Python scalars."""
    return lambda x, y: fn(*C.pair(x, y))


# ---------------------------------------------------------------------------
# transform_float
# ---------------------------------------------------------------------------

for _name, _fn in (("exp", torch.exp), ("log", torch.log),
                   ("log2", torch.log2), ("log10", torch.log10),
                   ("log1p", torch.log1p), ("expm1", torch.expm1),
                   ("sqrt", torch.sqrt), ("rsqrt", torch.rsqrt),
                   ("sin", torch.sin), ("cos", torch.cos), ("tan", torch.tan),
                   ("asin", torch.asin), ("acos", torch.acos),
                   ("atan", torch.atan), ("sinh", torch.sinh),
                   ("cosh", torch.cosh), ("tanh", torch.tanh),
                   ("asinh", torch.asinh), ("acosh", torch.acosh),
                   ("atanh", torch.atanh), ("erf", torch.special.erf),
                   ("erfc", torch.special.erfc), ("sigmoid", torch.sigmoid),
                   ("log_sigmoid", F.logsigmoid),
                   ("softsign", F.softsign)):
    op(_name, "transform_float")(_u(_fn))


@op("softplus", "transform_float")
def softplus(x):
    """log(1 + exp(x)) as jax.nn.softplus computes it (logaddexp(x, 0)),
    with no linear cut-off."""
    x = C.floatify(C.t(x))
    return torch.logaddexp(x, torch.zeros_like(x))


op("gelu", "transform_float", aliases=("gelu_erf",))(
    lambda x: F.gelu(C.t(x), approximate="none"))
op("gelu_tanh", "transform_float", aliases=("precise_gelu",))(
    lambda x: F.gelu(C.t(x), approximate="tanh"))
op("gelu_sigmoid", "transform_float", aliases=("fast_gelu",))(
    lambda x: C.t(x) * torch.sigmoid(1.702 * C.t(x)))
op("elu", "transform_float")(_u(F.elu))
op("selu", "transform_float")(_u(F.selu))
op("swish", "transform_float", aliases=("silu",))(_u(F.silu))
op("mish", "transform_float")(_u(F.mish))
# ND4J HardSigmoid: clip(0.2x + 0.5, 0, 1), not jax.nn.hard_sigmoid
op("hard_sigmoid", "transform_float")(
    lambda x: torch.clamp(0.2 * C.t(x) + 0.5, 0.0, 1.0))
op("hardswish", "transform_float", aliases=("hard_swish",))(_u(F.hardswish))
op("celu", "transform_float")(
    lambda x, alpha=1.0: F.celu(C.t(x), alpha))
op("thresholded_relu", "transform_float")(
    lambda x, alpha=1.0: torch.where(C.t(x) > alpha, C.t(x), 0.0))
op("shrink", "transform_float")(
    lambda x, lambd=0.5, bias=0.0: torch.where(
        C.t(x) < -lambd, C.t(x) + bias,
        torch.where(C.t(x) > lambd, C.t(x) - bias, 0.0)))
op("hard_tanh", "transform_float", aliases=("hardtanh",))(
    lambda x: torch.clamp(C.t(x), -1.0, 1.0))
op("rationaltanh", "transform_float")(
    lambda x: 1.7159 * torch.tanh(2.0 * C.t(x) / 3.0))
op("rectifiedtanh", "transform_float")(
    lambda x: torch.clamp_min(torch.tanh(C.t(x)), 0.0))


@op("sigmoid_derivative", "transform_float")
def sigmoid_derivative(x):
    s = torch.sigmoid(C.t(x))
    return s * (1.0 - s)


@op("tanh_derivative", "transform_float")
def tanh_derivative(x):
    th = torch.tanh(C.t(x))
    return 1.0 - th * th


# ---------------------------------------------------------------------------
# transform_same
# ---------------------------------------------------------------------------

op("abs", "transform_same")(_u(torch.abs))
op("neg", "transform_same", aliases=("negative",))(_u(torch.neg))
op("sign", "transform_same")(_u(torch.sign))
op("square", "transform_same")(_u(torch.square))
op("cube", "transform_same")(lambda x: C.t(x) * C.t(x) * C.t(x))
op("reciprocal", "transform_same")(lambda x: 1.0 / C.t(x))
op("floor", "transform_same")(_u(torch.floor))
op("ceil", "transform_same")(_u(torch.ceil))
op("round", "transform_same")(_u(torch.round))  # half to even, as jnp
op("rint", "transform_same")(_u(torch.round))
op("trunc", "transform_same")(_u(torch.trunc))
op("relu", "transform_same")(_u(torch.relu))
op("relu6", "transform_same")(_u(F.relu6))
op("identity", "transform_same", aliases=("linear", "old_identity"))(
    lambda x: x)
op("stop_gradient", "transform_same")(lambda x: C.t(x).detach())
op("oneslike", "transform_same", aliases=("ones_as", "ones_like"))(
    lambda x, dtype=None: torch.ones_like(C.t(x), dtype=C.dtype(dtype)))
op("zeroslike", "transform_same", aliases=("zeros_as", "zeros_like"))(
    lambda x, dtype=None: torch.zeros_like(C.t(x), dtype=C.dtype(dtype)))


@op("leakyrelu", "transform_same", aliases=("leaky_relu",))
def leaky_relu(x, alpha=0.01):
    return F.leaky_relu(C.t(x), negative_slope=alpha)


@op("prelu", "transform_same")
def prelu(x, alpha):
    x = C.t(x)
    return torch.where(x >= 0, x, C.t(alpha, x) * x)


@op("thresholdrelu", "transform_same")
def threshold_relu(x, theta=1.0):
    x = C.t(x)
    return torch.where(x > theta, x, 0.0)


@op("clipbyvalue", "transform_same", aliases=("clip_by_value",))
def clip_by_value(x, clip_min, clip_max):
    x = C.t(x)
    lo = C.t(clip_min, x) if not isinstance(clip_min, (int, float)) \
        else clip_min
    hi = C.t(clip_max, x) if not isinstance(clip_max, (int, float)) \
        else clip_max
    return torch.clamp(x, lo, hi)


@op("clipbynorm", "transform_same", aliases=("clip_by_norm",))
def clip_by_norm(x, clip_norm, axes=None):
    x = C.t(x)
    if axes is None:
        norm = torch.sqrt(torch.sum(torch.square(x)))
    else:
        norm = torch.sqrt(torch.sum(torch.square(x),
                                    dim=C.axes(axes, x.dim()), keepdim=True))
    scale = torch.where(norm > clip_norm,
                        clip_norm / torch.clamp_min(norm, 1e-12), 1.0)
    return x * scale


# ---------------------------------------------------------------------------
# transform_bool
# ---------------------------------------------------------------------------

op("isnan", "transform_bool", differentiable=False)(_u(torch.isnan))
op("isinf", "transform_bool", differentiable=False)(_u(torch.isinf))
op("isfinite", "transform_bool", differentiable=False)(_u(torch.isfinite))
op("not", "transform_bool", aliases=("boolean_not",),
   differentiable=False)(_u(torch.logical_not))


# ---------------------------------------------------------------------------
# pairwise
# ---------------------------------------------------------------------------

op("add", "pairwise")(_b(torch.add))
op("subtract", "pairwise", aliases=("sub",))(_b(torch.sub))
op("multiply", "pairwise", aliases=("mul", "old_mul"))(_b(torch.mul))
op("divide", "pairwise", aliases=("div",))(_b(torch.true_divide))
op("rsub", "pairwise", aliases=("reversesubtract",))(
    _b(lambda x, y: y - x))
op("rdiv", "pairwise", aliases=("reversedivide",))(
    _b(lambda x, y: torch.true_divide(y, x)))
op("pow", "pairwise", aliases=("power",))(_b(torch.pow))
def _integers(x, y) -> bool:
    return not (x.is_floating_point() or y.is_floating_point()
                or x.is_complex() or y.is_complex())


def _int_trunc_div(x, y):
    """XLA's integer division: toward zero, and -1 for a zero divisor
    (torch would raise on the CPU and give garbage on the card)."""
    zero = y == 0
    q = torch.div(x, torch.where(zero, torch.ones_like(y), y),
                  rounding_mode="trunc")
    return torch.where(zero, torch.full_like(q, -1), q)


@op("floordiv", "pairwise", aliases=("floor_div",))
def floordiv(x, y):
    """jnp.floor_divide: for integers, XLA's truncating quotient stepped
    down where the signs differ and the remainder is not 0 (the
    remainder by 0 is x), so x // 0 is -1 or -2, as the reference gives."""
    x, y = C.pair(x, y)
    if not _integers(x, y):
        return torch.floor_divide(x, y)
    q = _int_trunc_div(x, y)
    rem = torch.where(y == 0, x, x - q * y)
    step = (torch.sign(x) != torch.sign(y)) & (rem != 0)
    return torch.where(step, q - 1, q)


def _int_zero_safe(fn):
    """An integer remainder with 0 where the divisor is 0 (jnp's)."""
    def run(x, y):
        x, y = C.pair(x, y)
        if not _integers(x, y):
            return fn(x, y)
        zero = y == 0
        out = fn(x, torch.where(zero, torch.ones_like(y), y))
        return torch.where(zero, torch.zeros_like(out), out)
    return run


op("mod", "pairwise", aliases=("floormod",))(_int_zero_safe(torch.remainder))
op("fmod", "pairwise")(_int_zero_safe(torch.fmod))


@op("truncatediv", "pairwise")
def truncatediv(x, y):
    """Division truncating toward zero; integer inputs keep their type
    (and give -1 for a zero divisor, as lax.div does)."""
    x, y = C.pair(x, y)
    if _integers(x, y):
        return _int_trunc_div(x, y)
    return torch.trunc(x / y)


op("maximum", "pairwise", aliases=("max_pairwise",))(_b(torch.maximum))
op("minimum", "pairwise", aliases=("min_pairwise",))(_b(torch.minimum))
op("atan2", "pairwise")(_b(lambda x, y: torch.atan2(C.floatify(x),
                                                    C.floatify(y))))
op("squareddifference", "pairwise",
   aliases=("squared_difference", "squared_subtract"))(
    _b(lambda x, y: torch.square(x - y)))
op("hypot", "pairwise")(_b(lambda x, y: torch.hypot(C.floatify(x),
                                                    C.floatify(y))))
op("copysign", "pairwise")(_b(torch.copysign))

op("equals", "pairwise_bool", aliases=("eq",), differentiable=False)(
    _b(torch.eq))
op("notequals", "pairwise_bool", aliases=("neq",), differentiable=False)(
    _b(torch.ne))
op("greater", "pairwise_bool", aliases=("gt",), differentiable=False)(
    _b(torch.gt))
op("greaterequal", "pairwise_bool", aliases=("gte",), differentiable=False)(
    _b(torch.ge))
op("less", "pairwise_bool", aliases=("lt",), differentiable=False)(
    _b(torch.lt))
op("lessequal", "pairwise_bool", aliases=("lte",), differentiable=False)(
    _b(torch.le))
op("and", "pairwise_bool", aliases=("boolean_and",), differentiable=False)(
    _b(torch.logical_and))
op("or", "pairwise_bool", aliases=("boolean_or",), differentiable=False)(
    _b(torch.logical_or))
op("xor", "pairwise_bool", aliases=("boolean_xor",), differentiable=False)(
    _b(torch.logical_xor))


@op("where", "pairwise", aliases=("select",))
def where(condition, x, y):
    cond = C.t(condition)
    x, y = C.pair(x, y)
    return torch.where(cond.to(x.device).bool(), x, y)


@op("axpy", "pairwise")
def axpy(x, y, alpha=1.0):
    """y + alpha*x."""
    return alpha * C.t(x) + C.t(y)


# ---------------------------------------------------------------------------
# scalar
# ---------------------------------------------------------------------------

op("scalar_add", "scalar")(lambda x, s: C.t(x) + s)
op("scalar_sub", "scalar")(lambda x, s: C.t(x) - s)
op("scalar_mul", "scalar")(lambda x, s: C.t(x) * s)
op("scalar_div", "scalar")(lambda x, s: C.t(x) / s)
op("scalar_rsub", "scalar")(lambda x, s: s - C.t(x))
op("scalar_rdiv", "scalar")(lambda x, s: s / C.t(x))
op("scalar_max", "scalar")(lambda x, s: torch.clamp_min(C.t(x), s))
op("scalar_min", "scalar")(lambda x, s: torch.clamp_max(C.t(x), s))
op("scalar_pow", "scalar")(lambda x, s: torch.pow(C.t(x), s))
op("scalar_set", "scalar", differentiable=False)(
    lambda x, s: torch.full_like(C.t(x), s))
op("step", "scalar", differentiable=False)(
    lambda x, s=0.0: (C.t(x) > s).to(C.t(x).dtype))

op("shift_left", "pairwise_bool", aliases=("left_shift", "shift_bits"),
   differentiable=False)(_b(torch.bitwise_left_shift))
op("shift_right", "pairwise_bool", aliases=("right_shift", "rshift_bits"),
   differentiable=False)(_b(torch.bitwise_right_shift))


# ---------------------------------------------------------------------------
# Special functions
# ---------------------------------------------------------------------------

op("igamma", "pairwise")(
    _b(lambda a, x: torch.special.gammainc(C.floatify(a), C.floatify(x))))
op("igammac", "pairwise")(
    _b(lambda a, x: torch.special.gammaincc(C.floatify(a), C.floatify(x))))


@op("polygamma", "pairwise")
def polygamma(n, x):
    """polygamma of integer order ``n`` (a scalar or a tensor of orders,
    broadcast against x)."""
    x = C.floatify(C.t(x))
    if not isinstance(n, torch.Tensor):
        return torch.special.polygamma(int(n), x)
    n, xb = torch.broadcast_tensors(n.to(x.device).long(), x)
    out = torch.empty_like(xb)
    for k in torch.unique(n).tolist():
        sel = n == k
        out[sel] = torch.special.polygamma(int(k), xb[sel])
    return out


op("zeta", "pairwise")(
    _b(lambda x, q: torch.special.zeta(C.floatify(x), C.floatify(q))))


def _betainc(a, b, x):
    """Regularized incomplete beta I_x(a, b) by the continued fraction
    (modified Lentz), on the side of x where it converges fast, in
    float64."""
    a, b, x = torch.broadcast_tensors(a.double(), b.double(), x.double())
    swap = x > (a + 1.0) / (a + b + 2.0)
    aa, bb = torch.where(swap, b, a), torch.where(swap, a, b)
    xx = torch.where(swap, 1.0 - x, x)
    tiny = 1e-300
    lbeta = torch.lgamma(aa + bb) - torch.lgamma(aa) - torch.lgamma(bb)
    front = torch.exp(lbeta + aa * torch.log(xx.clamp_min(tiny))
                      + bb * torch.log1p(-xx).clamp_min(-1e300)) / aa
    cc = torch.ones_like(xx)
    d = 1.0 - (aa + bb) * xx / (aa + 1.0)
    d = torch.where(d.abs() < tiny, torch.full_like(d, tiny), d)
    d = 1.0 / d
    f = d
    for m in range(1, 300):
        m2 = 2 * m
        num = m * (bb - m) * xx / ((aa + m2 - 1) * (aa + m2))
        for step in (num, -(aa + m) * (aa + bb + m) * xx
                     / ((aa + m2) * (aa + m2 + 1))):
            d = 1.0 + step * d
            d = torch.where(d.abs() < tiny, torch.full_like(d, tiny), d)
            cc = 1.0 + step / cc
            cc = torch.where(cc.abs() < tiny, torch.full_like(cc, tiny), cc)
            d = 1.0 / d
            f = f * d * cc
    val = front * f
    out = torch.where(swap, 1.0 - val, val)
    out = torch.where(x <= 0, torch.zeros_like(out), out)
    return torch.where(x >= 1, torch.ones_like(out), out)


@op("betainc", "transform_float")
def betainc(a, b, x):
    like = x if isinstance(x, torch.Tensor) else a
    a, b, x = (C.floatify(C.t(v, like)) for v in (a, b, x))
    dt = torch.promote_types(torch.promote_types(a.dtype, b.dtype), x.dtype)
    return _betainc(a, b, x).to(dt)


op("lgamma", "transform_float", aliases=("gammaln",))(
    lambda x: torch.lgamma(C.floatify(C.t(x))))
op("digamma", "transform_float")(
    lambda x: torch.digamma(C.floatify(C.t(x))))
op("erfinv", "transform_float")(lambda x: torch.erfinv(C.floatify(C.t(x))))
op("i0", "transform_float")(lambda x: torch.special.i0(C.floatify(C.t(x))))
op("i1", "transform_float")(lambda x: torch.special.i1(C.floatify(C.t(x))))
op("logit", "transform_float")(
    lambda x: torch.special.logit(C.floatify(C.t(x))))
op("expit", "transform_float")(lambda x: torch.sigmoid(C.floatify(C.t(x))))

op("divide_no_nan", "pairwise")(
    _b(lambda x, y: torch.where(y == 0, torch.zeros_like(x * 0.0),
                                x / torch.where(y == 0, torch.ones_like(y),
                                                y))))
op("toggle_bits", "transform_same", differentiable=False)(
    _u(torch.bitwise_not))


def _bits(x: torch.Tensor) -> int:
    return x.element_size() * 8


def _unsigned(x: torch.Tensor):
    """The bit pattern of x as a non-negative int64 (widths up to 32)."""
    bits = _bits(x)
    if bits > 32:
        raise TypeError(f"bit ops cover integers up to 32 bits, got {x.dtype}")
    return x.to(torch.int64) & ((1 << bits) - 1), bits


def _signed_back(u: torch.Tensor, dt: torch.dtype, bits: int):
    if dt in (torch.uint8, torch.uint16, torch.uint32):
        return u.to(dt)
    return torch.where(u >= (1 << (bits - 1)), u - (1 << bits), u).to(dt)


@op("cyclic_shift_bits", "pairwise_bool",
    aliases=("rotl", "cyclic_rshift_bits_inv"), differentiable=False)
def cyclic_shift_bits(x, n):
    """Rotate-left of integer bits on the unsigned pattern."""
    x = C.t(x)
    ux, bits = _unsigned(x)
    n = C.t(n, x).to(torch.int64) % bits
    rot = ((ux << n) | (ux >> ((bits - n) % bits))) & ((1 << bits) - 1)
    return _signed_back(torch.where(n == 0, ux, rot), x.dtype, bits)


@op("cumlogsumexp", "transform_same")
def cumlogsumexp(x, axis=0, exclusive=False, reverse=False):
    x = C.t(x)
    if reverse:
        x = torch.flip(x, (axis,))
    out = torch.logcumsumexp(x, dim=axis)
    if exclusive:
        pad = torch.full_like(out.narrow(axis, 0, 1), float("-inf"))
        out = torch.cat([pad, out.narrow(axis, 0, x.shape[axis] - 1)],
                        dim=axis)
    if reverse:
        out = torch.flip(out, (axis,))
    return out


@op("clip_by_global_norm", "transform_same")
def clip_by_global_norm(arrays, clip_norm):
    """Scale a list of arrays so their joint L2 norm is <= clip_norm.
    Returns (clipped_list, global_norm)."""
    arrays = [C.t(a) for a in arrays]
    gnorm = torch.sqrt(sum(torch.sum(torch.square(a.float()))
                           for a in arrays))
    scale = clip_norm / torch.clamp_min(gnorm, clip_norm)
    return [a * scale.to(a.dtype) for a in arrays], gnorm


@op("clipbyavgnorm", "transform_same", aliases=("clip_by_avg_norm",))
def clip_by_avg_norm(x, clip_value, axes=None):
    x = C.t(x)
    dims = C.axes(axes, x.dim())
    n = torch.sqrt(torch.sum(torch.square(x), dim=dims, keepdim=True))
    count = x.numel() if axes is None else math.prod(x.shape[a]
                                                     for a in dims)
    avg = n / count
    scale = torch.where(avg > clip_value,
                        clip_value / torch.clamp_min(avg, 1e-12), 1.0)
    return x * scale


def _expint(x: torch.Tensor) -> torch.Tensor:
    """The exponential integral Ei(x) in float64: its power series
    gamma + ln|x| + sum x^k / (k k!) for x > -1, and -E1(-x) by E1's
    continued fraction below."""
    xd = x.double()
    euler = 0.5772156649015329
    term = torch.ones_like(xd)
    series = torch.zeros_like(xd)
    xs = torch.where(xd > -1.0, xd, torch.zeros_like(xd))
    for k in range(1, 400):
        term = term * xs / k
        series = series + term / k
    small = euler + torch.log(xs.abs().clamp_min(1e-300)) + series
    z = torch.where(xd <= -1.0, -xd, torch.full_like(xd, 2.0))
    # E1(z) = exp(-z) / (z + 1 - 1/(z + 3 - 4/(z + 5 - ...))), Lentz
    tiny = 1e-300
    b = z + 1.0
    c = torch.full_like(z, 1.0 / tiny)
    d = 1.0 / b
    h = d
    for i in range(1, 300):
        an = -float(i * i)
        b = b + 2.0
        d = 1.0 / torch.where((an * d + b).abs() < tiny,
                              torch.full_like(b, tiny), an * d + b)
        c = b + an / c
        c = torch.where(c.abs() < tiny, torch.full_like(c, tiny), c)
        h = h * d * c
    e1 = h * torch.exp(-z)
    out = torch.where(xd > -1.0, small, -e1)
    return torch.where(xd == 0, torch.full_like(out, float("-inf")), out)


op("expint", "transform_float")(
    lambda x: _expint(C.t(x)).to(C.floatify(C.t(x)).dtype))
op("pow_derivative", "scalar")(
    lambda x, p=2.0: p * torch.pow(C.t(x), p - 1.0))
op("fill_like", "transform_same", aliases=("full_like",))(
    lambda x, value=0.0: torch.full_like(C.t(x), value))


@op("cyclic_rshift_bits", "pairwise_bool", aliases=("rotr",),
    differentiable=False)
def cyclic_rshift_bits(x, n):
    """Rotate-right: rotate-left by the complementary count."""
    x = C.t(x)
    bits = _bits(x)
    n = C.t(n, x).to(torch.int64) % bits
    return cyclic_shift_bits(x, (bits - n) % bits)


def _popcount(u: torch.Tensor, bits: int) -> torch.Tensor:
    count = torch.zeros_like(u)
    for i in range(bits):
        count += (u >> i) & 1
    return count.to(torch.int32)


@op("bits_hamming_distance", "reduce_long", differentiable=False)
def bits_hamming_distance(x, y):
    """Total popcount of x XOR y over all elements, a 0-d int32."""
    x = C.t(x)
    v = torch.bitwise_xor(x, C.t(y, x).to(x.dtype))
    u, bits = _unsigned(v)
    return torch.sum(_popcount(u, bits), dtype=torch.int32)


class _FakeQuant(torch.autograd.Function):
    """Quantize-dequantize through the nudged range; straight-through
    gradient inside it, zero outside (TF's FakeQuant gradient)."""

    @staticmethod
    def forward(ctx, x, nmin, nmax, scale):
        ctx.save_for_backward(x, nmin, nmax)
        clamped = torch.minimum(torch.maximum(x, nmin), nmax)
        return torch.floor((clamped - nmin) / scale + 0.5) * scale + nmin

    @staticmethod
    def backward(ctx, g):
        x, nmin, nmax = ctx.saved_tensors
        return (torch.where((x >= nmin) & (x <= nmax), g,
                            torch.zeros_like(g)), None, None, None)


def _fake_quant(x, qmin, qmax, minv, maxv):
    """TF's nudged fake quantization: the zero point snapped onto the
    integer grid in fp32, x clamped to the nudged range, rounded by
    floor(v + 0.5)."""
    scale = (maxv - minv) / (qmax - qmin)
    scale = torch.where(scale == 0, torch.full_like(scale, 1e-8), scale)
    zero_f = qmin - minv / scale
    nudged_zero = torch.clamp(torch.floor(zero_f + 0.5), qmin, qmax)
    nmin = (qmin - nudged_zero) * scale
    nmax = (qmax - nudged_zero) * scale
    return _FakeQuant.apply(x, nmin, nmax, scale)


@op("fake_quant_with_min_max_vars", "transform_float",
    aliases=("fake_quant_with_min_max_args",))
def fake_quant_with_min_max_vars(x, min=-6.0, max=6.0, num_bits=8,
                                 narrow_range=False):
    x = C.t(x)
    qmin = 1.0 if narrow_range else 0.0
    qmax = float(2 ** int(num_bits) - 1)
    return _fake_quant(x, qmin, qmax, C.t(min, x, x.dtype),
                       C.t(max, x, x.dtype))


@op("fake_quant_with_min_max_vars_per_channel", "transform_float")
def fake_quant_with_min_max_vars_per_channel(x, min, max, num_bits=8,
                                             narrow_range=False):
    """Per-channel variant: min/max are vectors over the last axis."""
    x = C.t(x)
    qmin = 1.0 if narrow_range else 0.0
    qmax = float(2 ** int(num_bits) - 1)
    return _fake_quant(x, qmin, qmax, C.t(min, x, x.dtype),
                       C.t(max, x, x.dtype))


@op("compare_and_bitpack", "transform_bool", differentiable=False)
def compare_and_bitpack(x, threshold):
    """Pack (x > threshold) into uint8, 8 lanes per byte, MSB first."""
    x = C.t(x)
    if x.shape[-1] % 8:
        raise ValueError("compare_and_bitpack: last dim must be divisible "
                         f"by 8, got {x.shape[-1]}")
    bits = (x > C.t(threshold, x, x.dtype)).to(torch.int32)
    b = bits.reshape(tuple(x.shape[:-1]) + (x.shape[-1] // 8, 8))
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32,
                           device=x.device)
    return torch.sum(b * weights, dim=-1).to(torch.uint8)


@op("zero_fraction", "summarystats", differentiable=False)
def zero_fraction(x):
    return torch.mean((C.t(x) == 0).to(torch.float32))


@op("check_numerics", "transform_same", differentiable=False)
def check_numerics(x, message="check_numerics failed"):
    """Identity that raises FloatingPointError on NaN or Inf."""
    x = C.t(x)
    if not bool(torch.all(torch.isfinite(x))):
        raise FloatingPointError(message)
    return x


@op("popcount", "transform_same", aliases=("population_count",),
    differentiable=False)
def popcount(x):
    """Per-element set-bit count, int32."""
    u, bits = _unsigned(C.t(x))
    return _popcount(u, bits)
