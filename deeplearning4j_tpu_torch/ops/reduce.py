"""Reduction op families: reduce / indexreduce / summarystats / reduce3
(counterpart of deeplearning4j_tpu/ops/reduce.py).

Every reduction takes numpy's ``axis`` (None, an int or a tuple) and
``keepdims``. Integer and bool sums and counts come back int32 and index
reductions int32, the reference's types; ``median`` and the percentiles
interpolate linearly between the two middle values as jnp does.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.ops import _compat as C
from deeplearning4j_tpu_torch.ops.registry import op


def _sum(x, axis=None, keepdims=False, dtype=None):
    x = C.t(x)
    out = C.reduce(x, axis, keepdims,
                   lambda v, d, k: torch.sum(v, dim=d, keepdim=k))
    return out.to(C.dtype(dtype)) if dtype is not None else C.acc_int(out, x)


def _prod(x, axis=None, keepdims=False, dtype=None):
    x = C.t(x)
    dims = C.axes(axis, x.dim())
    out = x
    for d in sorted(dims, reverse=True):
        out = torch.prod(out, dim=d, keepdim=keepdims)
    if x.dim() == 0:
        out = x * 1
    return out.to(C.dtype(dtype)) if dtype is not None else C.acc_int(out, x)


def _mean(x, axis=None, keepdims=False, dtype=None):
    x = C.floatify(C.t(x))
    out = C.reduce(x, axis, keepdims,
                   lambda v, d, k: torch.mean(v, dim=d, keepdim=k))
    return out if dtype is None else out.to(C.dtype(dtype))


def _max(x, axis=None, keepdims=False):
    return C.reduce(x, axis, keepdims,
                    lambda v, d, k: torch.amax(v, dim=d, keepdim=k))


def _min(x, axis=None, keepdims=False):
    return C.reduce(x, axis, keepdims,
                    lambda v, d, k: torch.amin(v, dim=d, keepdim=k))


op("sum", "reduce")(_sum)
op("prod", "reduce")(_prod)
op("mean", "reduce")(_mean)
op("max", "reduce", aliases=("reduce_max",))(_max)
op("min", "reduce", aliases=("reduce_min",))(_min)
op("amax", "reduce", aliases=("absmax",))(
    lambda x, axis=None, keepdims=False: _max(torch.abs(C.t(x)), axis,
                                              keepdims))
op("amin", "reduce", aliases=("absmin",))(
    lambda x, axis=None, keepdims=False: _min(torch.abs(C.t(x)), axis,
                                              keepdims))
op("asum", "reduce", aliases=("abssum",))(
    lambda x, axis=None, keepdims=False: _sum(torch.abs(C.t(x)), axis,
                                              keepdims))
op("amean", "reduce")(
    lambda x, axis=None, keepdims=False: _mean(torch.abs(C.t(x)), axis,
                                               keepdims))
op("norm1", "reduce")(
    lambda x, axis=None, keepdims=False: _sum(torch.abs(C.t(x)), axis,
                                              keepdims))
op("norm2", "reduce")(
    lambda x, axis=None, keepdims=False: torch.sqrt(
        _sum(torch.square(C.t(x)), axis, keepdims)))
op("squarednorm", "reduce", aliases=("sqnorm",))(
    lambda x, axis=None, keepdims=False: _sum(torch.square(C.t(x)), axis,
                                              keepdims))
op("normmax", "reduce")(
    lambda x, axis=None, keepdims=False: _max(torch.abs(C.t(x)), axis,
                                              keepdims))
op("logsumexp", "reduce")(
    lambda x, axis=None, keepdims=False: C.reduce(
        C.floatify(C.t(x)), axis, keepdims,
        lambda v, d, k: torch.logsumexp(v, dim=d, keepdim=k)))
op("countnonzero", "reduce_long", differentiable=False)(
    lambda x, axis=None, keepdims=False: _sum(C.t(x) != 0, axis, keepdims))
op("countzero", "reduce_long", differentiable=False)(
    lambda x, axis=None, keepdims=False: _sum(C.t(x) == 0, axis, keepdims))
op("all", "reduce_bool", differentiable=False)(
    lambda x, axis=None, keepdims=False: C.reduce(
        C.t(x).bool(), axis, keepdims,
        lambda v, d, k: torch.all(v, dim=d, keepdim=k)))
op("any", "reduce_bool", differentiable=False)(
    lambda x, axis=None, keepdims=False: C.reduce(
        C.t(x).bool(), axis, keepdims,
        lambda v, d, k: torch.any(v, dim=d, keepdim=k)))


def _cum(fn):
    def run(x, axis=None, dtype=None):
        x = C.t(x)
        if axis is None:
            x, axis = x.reshape(-1), 0
        out = fn(x, dim=axis)
        return out.to(C.dtype(dtype)) if dtype is not None \
            else C.acc_int(out, x)
    return run


op("cumsum", "reduce", aliases=("cumulative_sum",))(_cum(torch.cumsum))
op("cumprod", "reduce")(_cum(torch.cumprod))


# --- indexreduce -----------------------------------------------------------


def _arg(fn):
    def run(x, axis=None, keepdims=False):
        x = C.t(x)
        if axis is None:
            out = fn(x.reshape(-1), dim=0)
            if keepdims:
                out = out.reshape((1,) * x.dim())
        else:
            out = fn(x, dim=int(axis), keepdim=keepdims)
        return out.to(torch.int32)
    return run


argmax = _arg(torch.argmax)
argmin = _arg(torch.argmin)
op("argmax", "indexreduce", aliases=("imax",), differentiable=False)(argmax)
op("argmin", "indexreduce", aliases=("imin",), differentiable=False)(argmin)


@op("argamax", "indexreduce", aliases=("iamax",), differentiable=False)
def argamax(x, axis=None):
    return argmax(torch.abs(C.t(x)), axis=axis)


@op("argamin", "indexreduce", aliases=("iamin",), differentiable=False)
def argamin(x, axis=None):
    return argmin(torch.abs(C.t(x)), axis=axis)


# --- summarystats ----------------------------------------------------------


@op("var", "summarystats", aliases=("variance",))
def variance(x, axis=None, keepdims=False, bias_corrected=True):
    """Variance; ND4J defaults to the bias-corrected (N-1) estimator."""
    return C.reduce(C.floatify(C.t(x)), axis, keepdims,
                    lambda v, d, k: torch.var(
                        v, dim=d, keepdim=k,
                        correction=1 if bias_corrected else 0))


@op("std", "summarystats", aliases=("standarddeviation",))
def std(x, axis=None, keepdims=False, bias_corrected=True):
    return C.reduce(C.floatify(C.t(x)), axis, keepdims,
                    lambda v, d, k: torch.std(
                        v, dim=d, keepdim=k,
                        correction=1 if bias_corrected else 0))


# --- reduce3 ---------------------------------------------------------------


@op("cosinesimilarity", "reduce3", aliases=("cosine_similarity",))
def cosine_similarity(x, y, axis=None, keepdims=False, eps=1e-12):
    x, y = C.pair(x, y)
    num = _sum(x * y, axis, keepdims)
    nx = torch.sqrt(_sum(torch.square(x), axis, keepdims))
    ny = torch.sqrt(_sum(torch.square(y), axis, keepdims))
    return num / torch.clamp_min(nx * ny, eps)


@op("cosinedistance", "reduce3", aliases=("cosine_distance",))
def cosine_distance(x, y, axis=None, keepdims=False):
    return 1.0 - cosine_similarity(x, y, axis=axis, keepdims=keepdims)


@op("euclidean", "reduce3", aliases=("euclideandistance",))
def euclidean_distance(x, y, axis=None, keepdims=False):
    x, y = C.pair(x, y)
    return torch.sqrt(_sum(torch.square(x - y), axis, keepdims))


@op("manhattan", "reduce3", aliases=("manhattandistance",))
def manhattan_distance(x, y, axis=None, keepdims=False):
    x, y = C.pair(x, y)
    return _sum(torch.abs(x - y), axis, keepdims)


@op("jaccarddistance", "reduce3")
def jaccard_distance(x, y, axis=None, keepdims=False, eps=1e-12):
    x, y = C.pair(x, y)
    num = _sum(torch.minimum(x, y), axis, keepdims)
    den = _sum(torch.maximum(x, y), axis, keepdims)
    return 1.0 - num / torch.clamp_min(den, eps)


@op("hammingdistance", "reduce3", aliases=("hamming",),
    differentiable=False)
def hamming_distance(x, y, axis=None, keepdims=False):
    x, y = C.pair(x, y)
    return _sum((x != y).to(torch.float32), axis, keepdims)


@op("dot", "reduce3")
def dot(x, y, axis=None, keepdims=False):
    x, y = C.pair(x, y)
    return _sum(x * y, axis, keepdims)


# ---------------------------------------------------------------------------
# Histogram / order statistics
# ---------------------------------------------------------------------------


@op("histogram", "reduce", differentiable=False)
def histogram(x, nbins=10, range=None):
    """Counts per bin over min..max (or the given range), int32."""
    xf = C.t(x).reshape(-1).to(torch.float32)
    if range is not None:
        lo = torch.tensor(float(range[0]), device=xf.device)
        hi = torch.tensor(float(range[1]), device=xf.device)
    else:
        lo, hi = torch.min(xf), torch.max(xf)
    width = (hi - lo) / nbins
    idx = torch.clamp(((xf - lo) / torch.where(width == 0,
                                              torch.ones_like(width), width))
                      .to(torch.int32), 0, nbins - 1)
    return torch.zeros(nbins, dtype=torch.int32, device=xf.device).index_add_(
        0, idx.long(), torch.ones_like(idx))


@op("histogram_fixed_width", "reduce", differentiable=False)
def histogram_fixed_width(x, value_range, nbins=100):
    """Out-of-range values clamp to the edge bins."""
    vr = [float(v) for v in (value_range.tolist()
                             if isinstance(value_range, torch.Tensor)
                             else value_range)]
    return histogram(x, nbins=int(nbins), range=(vr[0], vr[1]))


@op("bincount", "reduce", differentiable=False)
def bincount(x, weights=None, minlength=0, maxlength=None):
    """Counts of each integer value over a static length (max of
    minlength and maxlength, as the reference sizes it)."""
    length = int(maxlength or minlength)
    if length <= 0:
        raise ValueError("bincount needs a static minlength/maxlength")
    idx = torch.clamp(C.t(x).reshape(-1).to(torch.int64), 0, length - 1)
    if weights is not None:
        w = C.t(weights).reshape(-1)
        return torch.zeros(length, dtype=w.dtype,
                           device=w.device).index_add_(0, idx, w)
    return torch.zeros(length, dtype=torch.int32, device=idx.device) \
        .index_add_(0, idx, torch.ones(idx.shape, dtype=torch.int32,
                                       device=idx.device))


def _quantile(x, q, axis, keepdims, method="linear"):
    """numpy's quantile over ``axis`` (None, int or tuple), with ``q`` a
    scalar or a 1-D list (then leading in the result, as numpy puts it)."""
    x = C.floatify(C.t(x))
    dims = C.axes(axis, x.dim())
    rest = [d for d in range(x.dim()) if d not in dims]
    moved = x.permute(*rest, *dims).reshape(
        tuple(x.shape[d] for d in rest) + (-1,))
    qt = C.t(q, x).to(x.dtype)
    out = torch.quantile(moved, qt, dim=-1, interpolation=method)
    if keepdims:
        shape = [1 if d in dims else x.shape[d] for d in range(x.dim())]
        out = out.reshape(tuple(qt.shape) + tuple(shape))
    return out


@op("median", "reduce")
def median(x, axis=None, keepdims=False):
    return _quantile(x, 0.5, axis, keepdims)


@op("percentile", "reduce")
def percentile(x, q, axis=None, keepdims=False, interpolation="linear"):
    qv = (C.t(q).to(torch.float32) if not isinstance(q, (int, float))
          else float(q))
    return _quantile(x, qv / 100.0, axis, keepdims, interpolation)


@op("quantile", "reduce")
def quantile(x, q, axis=None, keepdims=False):
    return _quantile(x, q, axis, keepdims)


@op("entropy", "reduce_float")
def entropy(x, axis=None, keepdims=False):
    """-sum(p ln p); zero-probability terms contribute 0."""
    x = C.t(x)
    tt = torch.where(x > 0, x * torch.log(torch.clamp_min(x, 1e-38)), 0.0)
    return -_sum(tt, axis, keepdims)


@op("shannon_entropy", "reduce_float", aliases=("shannonentropy",))
def shannon_entropy(x, axis=None, keepdims=False):
    """-sum(p log2 p)."""
    x = C.t(x)
    tt = torch.where(x > 0, x * torch.log2(torch.clamp_min(x, 1e-38)), 0.0)
    return -_sum(tt, axis, keepdims)


@op("log_entropy", "reduce_float", aliases=("logentropy",))
def log_entropy(x, axis=None, keepdims=False):
    return torch.log(entropy(x, axis=axis, keepdims=keepdims))

