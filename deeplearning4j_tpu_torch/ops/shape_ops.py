"""Shape / indexing / gather-scatter ops (counterpart of
deeplearning4j_tpu/ops/shape_ops.py).

Index semantics are JAX's, not torch's: a gather by ``take`` or
``take_along_axis`` reads NaN (the fill) at an out-of-range index, a
gather by indexing (``gather_nd``) clamps it, a scatter drops an update at
an out-of-range index, and negative indices count from the end everywhere
but in the segment ops, which drop them. A scatter-add sums duplicate
indices; a scatter-update with duplicates keeps one of them (which one is
not defined, in either package). Sorting is stable; index results are
int32.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops import _compat as C
from deeplearning4j_tpu_torch.ops.registry import op

op("reshape", "shape")(lambda x, shape: torch.reshape(C.t(x), C.shape(shape)))
op("ravel", "shape", aliases=("flatten",))(lambda x: C.t(x).reshape(-1))
op("transpose", "shape")(
    lambda x, axes=None: C.t(x).permute(
        *(tuple(axes) if axes is not None
          else tuple(range(C.t(x).dim()))[::-1])))
op("permute", "shape")(lambda x, axes: C.t(x).permute(*tuple(axes)))
op("swapaxes", "shape")(lambda x, axis1, axis2: torch.swapaxes(C.t(x), axis1,
                                                               axis2))
op("moveaxis", "shape")(lambda x, source, destination: torch.movedim(
    C.t(x), source, destination))


@op("expand_dims", "shape")
def expand_dims(x, axis):
    x = C.t(x)
    nd = x.dim() + (len(axis) if isinstance(axis, (tuple, list)) else 1)
    for a in sorted(a % nd for a in (axis if isinstance(axis, (tuple, list))
                                     else (axis,))):
        x = x.unsqueeze(a)
    return x


@op("squeeze", "shape")
def squeeze(x, axis=None):
    x = C.t(x)
    if axis is None:
        return x.squeeze()
    return x.squeeze(C.axes(axis, x.dim()))


op("broadcast_to", "shape")(
    lambda x, shape: torch.broadcast_to(C.t(x), C.shape(shape)))
op("tile", "shape")(lambda x, reps: torch.tile(C.t(x), C.shape(reps)))


@op("repeat", "shape")
def repeat(x, repeats, axis=None):
    x = C.t(x)
    reps = repeats if isinstance(repeats, int) else C.t(repeats, x).long()
    return torch.repeat_interleave(x, reps, dim=axis)


op("concat", "shape", aliases=("concatenate",))(
    lambda arrays, axis=0: torch.cat(C.as_list(arrays), dim=axis))
op("concat_n", "shape")(
    lambda *arrays, axis=0: torch.cat(C.as_list(arrays), dim=axis))
op("stack_n", "shape")(
    lambda *arrays, axis=0: torch.stack(C.as_list(arrays), dim=axis))
op("stack", "shape", aliases=("parallel_stack",))(
    lambda arrays, axis=0: torch.stack(C.as_list(arrays), dim=axis))
op("unstack", "shape", aliases=("unbind",))(
    lambda x, axis=0: list(torch.unbind(C.t(x), dim=axis)))


@op("split", "shape")
def split(x, num_or_sections, axis=0):
    """numpy's split: an int is a count of equal sections, a list the
    split points."""
    x = C.t(x)
    if isinstance(num_or_sections, int):
        if x.shape[axis] % num_or_sections:
            raise ValueError("array split does not result in an equal "
                             "division")
        return list(torch.tensor_split(x, num_or_sections, dim=axis))
    return list(torch.tensor_split(x, [int(v) for v in num_or_sections],
                                   dim=axis))


op("split_v", "shape")(
    lambda x, sizes, axis=0: list(torch.split(C.t(x), [int(s) for s in sizes],
                                              dim=axis)))


@op("flip", "shape", aliases=("reverse",))
def flip(x, axis=None):
    x = C.t(x)
    return torch.flip(x, C.axes(axis, x.dim()))


op("roll", "shape")(
    lambda x, shift, axis=None: torch.roll(
        C.t(x), shift if isinstance(shift, int) else tuple(shift),
        axis if axis is None or isinstance(axis, int) else tuple(axis)))
op("rot90", "shape")(
    lambda x, k=1, axes=(0, 1): torch.rot90(C.t(x), k, tuple(axes)))
op("slice", "shape")(
    lambda x, begin, sizes: C.t(x)[tuple(
        slice(int(b), int(b) + int(s)) for b, s in zip(begin, sizes))])


@op("strided_slice", "shape")
def strided_slice(x, begin, end, strides=None):
    """lax.slice: in-range begin/end per axis, positive strides."""
    strides = strides or [1] * len(begin)
    return C.t(x)[tuple(slice(int(b), int(e), int(s))
                        for b, e, s in zip(begin, end, strides))]


op("cast", "shape", differentiable=False)(
    lambda x, dtype: C.t(x).to(C.dtype(dtype)))
op("size", "shape", differentiable=False)(lambda x: C.t(x).numel())
op("rank", "shape", differentiable=False)(lambda x: C.t(x).dim())
op("shape_of", "shape", differentiable=False)(
    lambda x: torch.tensor(tuple(C.t(x).shape), dtype=torch.int32,
                           device=C.t(x).device))


@op("invert_permutation", "sorting", differentiable=False)
def invert_permutation(p):
    """inv[p[i]] = i."""
    p = C.t(p)
    out = torch.zeros_like(p)
    out[p.long()] = torch.arange(p.shape[0], dtype=p.dtype, device=p.device)
    return out


@op("pad", "shape")
def pad(x, paddings, mode="constant", constant_value=0.0):
    """numpy's pad with [(lo, hi), ...] per dim. The non-constant modes
    gather by the index pattern numpy's own pad makes of an arange."""
    x = C.t(x)
    pads = [(int(a), int(b)) for a, b in paddings]
    if mode == "constant":
        flat = [v for lo_hi in reversed(pads) for v in lo_hi]
        return F.pad(x, flat, value=constant_value)
    for d, (lo, hi) in enumerate(pads):
        if lo or hi:
            idx = np.pad(np.arange(x.shape[d]), (lo, hi), mode=mode)
            x = torch.index_select(x, d, torch.as_tensor(idx,
                                                         device=x.device))
    return x


def _take_fill(x, idx, axis):
    """jnp.take's default: negative indices wrap, out-of-range read NaN
    (the dtype's minimum for integers, False for bool)."""
    n = x.shape[axis]
    idx = C.t(idx, x).long()
    wrapped = torch.where(idx < 0, idx + n, idx)
    ok = (wrapped >= 0) & (wrapped < n)
    out = torch.index_select(x, axis, wrapped.clamp(0, max(n - 1, 0))
                             .reshape(-1))
    out = out.reshape(tuple(x.shape[:axis]) + tuple(idx.shape)
                      + tuple(x.shape[axis + 1:]))
    if bool(ok.all()):
        return out
    fill = (float("nan") if x.is_floating_point() or x.is_complex()
            else (False if x.dtype == torch.bool
                  else torch.iinfo(x.dtype).min))
    okb = ok.reshape((1,) * axis + tuple(idx.shape)
                     + (1,) * (x.dim() - axis - 1))
    return torch.where(okb, out, torch.full_like(out, fill))


@op("gather", "gather_scatter")
def gather(x, indices, axis=0):
    x = C.t(x)
    return _take_fill(x, indices, axis % x.dim())


@op("gather_nd", "gather_scatter")
def gather_nd(x, indices):
    """indices [..., k] index the first k dims of x, clamped as JAX's
    indexing clamps."""
    x = C.t(x)
    idx = C.t(indices, x).long()
    parts = []
    for d in range(idx.shape[-1]):
        i = idx[..., d]
        i = torch.where(i < 0, i + x.shape[d], i)
        parts.append(i.clamp(0, x.shape[d] - 1))
    return x[tuple(parts)]


@op("take", "gather_scatter")
def take(x, indices, axis=None):
    x = C.t(x)
    if axis is None:
        return _take_fill(x.reshape(-1), indices, 0)
    return _take_fill(x, indices, axis % x.dim())


@op("take_along_axis", "gather_scatter")
def take_along_axis(x, indices, axis):
    x = C.t(x)
    idx = C.t(indices, x).long()
    n = x.shape[axis]
    wrapped = torch.where(idx < 0, idx + n, idx)
    ok = (wrapped >= 0) & (wrapped < n)
    shape = torch.broadcast_shapes(
        tuple(1 if d == axis % x.dim() else s for d, s in enumerate(x.shape)),
        tuple(1 if d == axis % x.dim() else s
              for d, s in enumerate(idx.shape)))
    xs = list(shape)
    xs[axis] = n
    ish = list(shape)
    ish[axis] = idx.shape[axis]
    out = torch.gather(x.expand(xs), axis,
                       wrapped.clamp(0, n - 1).expand(ish))
    if x.is_floating_point():
        out = torch.where(ok.expand(ish), out, float("nan"))
    return out


def _scatter_rows(ref, indices, updates, how):
    """``ref.at[indices]`` along axis 0 with ``how`` in set / add / mul /
    div / max / min; negative indices wrap, out-of-range ones are
    dropped."""
    ref = C.t(ref)
    n = ref.shape[0]
    idx = C.t(indices, ref)
    if idx.dim() == 0:
        idx = idx.reshape(1)
        upd = C.t(updates, ref).to(ref.dtype)
        upd = torch.broadcast_to(upd, tuple(ref.shape[1:])).reshape(
            (1,) + tuple(ref.shape[1:]))
    else:
        upd = torch.broadcast_to(C.t(updates, ref).to(ref.dtype),
                                 tuple(idx.shape) + tuple(ref.shape[1:]))
        upd = upd.reshape((-1,) + tuple(ref.shape[1:]))
    idx, ok = C.norm_index(idx.reshape(-1), n)
    idx, upd = idx[ok], upd[ok]
    out = ref.clone()
    if how == "set":
        out[idx] = upd
    elif how == "add":
        out.index_put_((idx,), upd, accumulate=True)
    elif how == "mul":
        out.index_reduce_(0, idx, upd, "prod")
    elif how == "div":
        prod = torch.ones_like(ref).index_reduce_(0, idx, upd, "prod")
        out = ref / prod
    elif how == "max":
        out.index_reduce_(0, idx, upd, "amax")
    elif how == "min":
        out.index_reduce_(0, idx, upd, "amin")
    return out


op("scatter_update", "gather_scatter")(
    lambda ref, indices, updates: _scatter_rows(ref, indices, updates, "set"))
op("scatter_add", "gather_scatter")(
    lambda ref, indices, updates: _scatter_rows(ref, indices, updates, "add"))
op("scatter_sub", "gather_scatter")(
    lambda ref, indices, updates: _scatter_rows(ref, indices,
                                                -C.t(updates), "add"))
op("scatter_mul", "gather_scatter")(
    lambda ref, indices, updates: _scatter_rows(ref, indices, updates, "mul"))
op("scatter_div", "gather_scatter")(
    lambda ref, indices, updates: _scatter_rows(ref, indices, updates, "div"))
op("scatter_max", "gather_scatter")(
    lambda ref, indices, updates: _scatter_rows(ref, indices, updates, "max"))
op("scatter_min", "gather_scatter")(
    lambda ref, indices, updates: _scatter_rows(ref, indices, updates, "min"))


def _scatter_nd(ref, indices, updates, how):
    """``ref.at[tuple(moveaxis(indices, -1, 0))]``: the last index axis
    addresses ref's leading k dims; out-of-range rows are dropped."""
    ref = C.t(ref)
    idx = C.t(indices, ref).long()
    if idx.dim() == 1:  # one k-index: one point
        idx = idx[None]
    k = idx.shape[-1]
    lead = tuple(ref.shape[:k])
    rows = idx.reshape(-1, k)
    ok = torch.ones(rows.shape[0], dtype=torch.bool, device=ref.device)
    lin = torch.zeros(rows.shape[0], dtype=torch.long, device=ref.device)
    for d in range(k):
        i = torch.where(rows[:, d] < 0, rows[:, d] + lead[d], rows[:, d])
        ok &= (i >= 0) & (i < lead[d])
        lin = lin * lead[d] + i
    tail = tuple(ref.shape[k:])
    upd = torch.broadcast_to(C.t(updates, ref).to(ref.dtype),
                             tuple(idx.shape[:-1]) + tail).reshape(
        (-1,) + tail)
    flat = ref.reshape((math.prod(lead),) + tail).clone()
    if how == "set":
        flat[lin[ok]] = upd[ok]
    else:
        flat.index_put_((lin[ok],), upd[ok], accumulate=True)
    return flat.reshape(ref.shape)


@op("scatter_nd", "gather_scatter")
def scatter_nd(indices, updates, shape):
    """Duplicate indices accumulate."""
    upd = C.t(updates)
    zeros = torch.zeros(C.shape(shape), dtype=upd.dtype, device=upd.device)
    return _scatter_nd(zeros, indices, upd, "add")


@op("onehot", "gather_scatter", aliases=("one_hot",), differentiable=False)
def one_hot(indices, depth, on_value=1.0, off_value=0.0, axis=-1,
            dtype="float32"):
    idx = C.t(indices)
    oh = torch.arange(depth, device=idx.device) == idx.unsqueeze(-1)
    oh = torch.where(oh, on_value, off_value).to(C.dtype(dtype))
    if axis != -1:
        oh = torch.movedim(oh, -1, axis)
    return oh


@op("dynamic_partition", "gather_scatter", differentiable=False)
def dynamic_partition(x, partitions, num_partitions):
    """Masked copies, one per partition (the reference's static form)."""
    x, p = C.t(x), C.t(partitions)
    extra = (None,) * (x.dim() - p.dim())
    return [torch.where((p == i)[(...,) + extra], x, 0)
            for i in range(num_partitions)]


@op("dynamic_stitch", "gather_scatter", differentiable=False)
def dynamic_stitch(indices_list, data_list):
    """Output rows = max(index)+1; later lists win on overlap."""
    n = max(int(C.t(i).max()) for i in indices_list) + 1
    first = C.t(data_list[0])
    out = torch.zeros((n,) + tuple(first.shape[1:]), dtype=first.dtype,
                      device=first.device)
    for idx, dat in zip(indices_list, data_list):
        out[C.t(idx, first).reshape(-1).long()] = C.t(dat).reshape(
            (-1,) + tuple(first.shape[1:]))
    return out


@op("sort", "sorting", differentiable=False)
def sort(x, axis=-1, descending=False):
    y = torch.sort(C.t(x), dim=axis, stable=True).values
    return torch.flip(y, (axis,)) if descending else y


@op("argsort", "sorting", differentiable=False)
def argsort(x, axis=-1, descending=False):
    y = torch.argsort(C.t(x), dim=axis, stable=True).to(torch.int32)
    return torch.flip(y, (axis,)) if descending else y


def _top_k(x, k):
    """lax.top_k: the k largest along the last axis, ties to the lower
    index; (values, int32 indices)."""
    x = C.t(x)
    idx = torch.sort(x, dim=-1, descending=True, stable=True).indices[
        ..., :int(k)]
    return torch.gather(x, -1, idx), idx.to(torch.int32)


@op("top_k", "sorting", differentiable=False)
def top_k(x, k, sorted=True):
    return _top_k(x, k)


@op("in_top_k", "sorting", differentiable=False)
def in_top_k(predictions, targets, k):
    _, idx = _top_k(predictions, k)
    return torch.any(idx == C.t(targets, idx)[:, None].to(idx.dtype), dim=-1)


def _unique(x, size, counts):
    x = C.t(x).reshape(-1)
    vals, cnt = torch.unique(x, sorted=True, return_counts=True)
    cnt = cnt.to(torch.int32)
    if size is not None:
        size = int(size)
        if vals.numel() >= size:
            vals, cnt = vals[:size], cnt[:size]
        else:
            fill = vals.min() if vals.numel() else torch.zeros(
                (), dtype=x.dtype, device=x.device)
            vals = torch.cat([vals, fill.expand(size - vals.numel())])
            cnt = torch.cat([cnt, torch.zeros(size - cnt.numel(),
                                              dtype=cnt.dtype,
                                              device=cnt.device)])
    return (vals, cnt) if counts else vals


op("unique", "sorting", differentiable=False)(
    lambda x, size=None: _unique(x, size, False))
op("unique_with_counts", "sorting", differentiable=False)(
    lambda x, size=None: _unique(x, size, True))


@op("listdiff", "sorting", aliases=("setdiff1d",), differentiable=False)
def listdiff(x, y):
    """Values of x not in y, and their int32 indices in x."""
    xa = C.t(x).reshape(-1)
    keep = ~torch.isin(xa, C.t(y, xa).reshape(-1))
    return xa[keep], torch.nonzero(keep)[:, 0].to(torch.int32)


@op("nth_element", "sorting", differentiable=False)
def nth_element(x, n, reverse=False):
    s = torch.sort(C.t(x), dim=-1).values
    return s[..., -int(n) - 1 if reverse else int(n)]


@op("searchsorted", "sorting", differentiable=False)
def searchsorted(sorted_seq, values, side="left"):
    a = C.t(sorted_seq)
    v = C.t(values, a)
    return torch.searchsorted(a, v.to(a.dtype),
                              right=(side == "right")).to(torch.int32)


@op("linspace", "creation", aliases=("lin_space",), differentiable=False)
def linspace(start, stop, num, dtype="float32"):
    return torch.linspace(float(start), float(stop), int(num),
                          dtype=torch.float64).to(C.dtype(dtype))


@op("logspace", "creation", differentiable=False)
def logspace(start, stop, num, base=10.0, dtype="float32"):
    return torch.logspace(float(start), float(stop), int(num), base=base,
                          dtype=torch.float64).to(C.dtype(dtype))


@op("arange", "creation", aliases=("range",), differentiable=False)
def arange(start, stop=None, step=1, dtype=None):
    """jnp.arange: int32 for integer arguments, float32 otherwise."""
    if stop is None:
        start, stop = 0, start
    dt = C.dtype(dtype)
    if dt is None:
        dt = (torch.int32 if all(isinstance(v, (int, np.integer))
                                 for v in (start, stop, step))
              else torch.float32)
    return torch.arange(start, stop, step, dtype=torch.float64
                        if dt.is_floating_point else torch.int64).to(dt)


@op("eye", "creation", differentiable=False)
def eye(n, m=None, dtype="float32"):
    return torch.eye(int(n), int(m) if m is not None else int(n),
                     dtype=C.dtype(dtype))


@op("zeros", "creation", differentiable=False)
def zeros(shape, dtype="float32"):
    return torch.zeros(C.shape(shape), dtype=C.dtype(dtype))


@op("ones", "creation", differentiable=False)
def ones(shape, dtype="float32"):
    return torch.ones(C.shape(shape), dtype=C.dtype(dtype))


@op("full", "creation", aliases=("fill",), differentiable=False)
def full(shape, value, dtype=None):
    dt = C.dtype(dtype)
    if dt is None:
        dt = (torch.bool if isinstance(value, bool)
              else torch.int32 if isinstance(value, (int, np.integer))
              else torch.float32)
    return torch.full(C.shape(shape), value, dtype=dt)


@op("meshgrid", "creation", differentiable=False)
def meshgrid(*arrays, indexing="xy"):
    return list(torch.meshgrid(*C.as_list(arrays), indexing=indexing))


@op("space_to_depth", "shape")
def space_to_depth(x, block_size, data_format="NHWC"):
    x = C.t(x)
    if data_format == "NCHW":
        x = x.permute(0, 2, 3, 1)
    n, h, w, c = x.shape
    b = block_size
    x = x.reshape(n, h // b, b, w // b, b, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // b, w // b, c * b * b)
    if data_format == "NCHW":
        x = x.permute(0, 3, 1, 2)
    return x


@op("depth_to_space", "shape")
def depth_to_space(x, block_size, data_format="NHWC"):
    x = C.t(x)
    if data_format == "NCHW":
        x = x.permute(0, 2, 3, 1)
    n, h, w, c = x.shape
    b = block_size
    x = x.reshape(n, h, w, b, b, c // (b * b))
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(n, h * b, w * b, c // (b * b))
    if data_format == "NCHW":
        x = x.permute(0, 3, 1, 2)
    return x


@op("space_to_batch", "shape", aliases=("space_to_batch_nd",))
def space_to_batch(x, block_shape, paddings):
    """TF space_to_batch_nd: zero-pad the M leading spatial dims, then move
    block factors from the spatial dims into batch."""
    x = C.t(x)
    block_shape = [int(b) for b in np.atleast_1d(block_shape)]
    paddings = [(int(a), int(b)) for a, b in np.atleast_2d(paddings)]
    if any(p0 < 0 or p1 < 0 for p0, p1 in paddings):
        raise ValueError(f"paddings must be non-negative, got {paddings}")
    m = len(block_shape)
    x = pad(x, [(0, 0)] + paddings + [(0, 0)] * (x.dim() - 1 - m))
    b = x.shape[0]
    spatial = tuple(x.shape[1:1 + m])
    rest = tuple(x.shape[1 + m:])
    for s, bs in zip(spatial, block_shape):
        if s % bs:
            raise ValueError(f"padded spatial dims {spatial} not divisible "
                             f"by block_shape {block_shape}")
    shape = (b,)
    for s, bs in zip(spatial, block_shape):
        shape += (s // bs, bs)
    y = x.reshape(shape + rest)
    perm = ([2 * i + 2 for i in range(m)] + [0]
            + [2 * i + 1 for i in range(m)]
            + list(range(1 + 2 * m, 1 + 2 * m + len(rest))))
    y = y.permute(*perm)
    prod = math.prod(block_shape)
    return y.reshape((b * prod,) + tuple(s // bs for s, bs in
                                         zip(spatial, block_shape)) + rest)


@op("batch_to_space", "shape", aliases=("batch_to_space_nd",))
def batch_to_space(x, block_shape, crops):
    """Inverse of space_to_batch: block factors back into the spatial
    dims, then crop."""
    x = C.t(x)
    block_shape = [int(b) for b in np.atleast_1d(block_shape)]
    crops = [(int(a), int(b)) for a, b in np.atleast_2d(crops)]
    if any(c0 < 0 or c1 < 0 for c0, c1 in crops):
        raise ValueError(f"crops must be non-negative, got {crops}")
    m = len(block_shape)
    b = x.shape[0]
    prod = math.prod(block_shape)
    if b % prod:
        raise ValueError(f"batch {b} not divisible by prod(block_shape)="
                         f"{prod}")
    spatial = tuple(x.shape[1:1 + m])
    rest = tuple(x.shape[1 + m:])
    y = x.reshape(tuple(block_shape) + (b // prod,) + spatial + rest)
    perm = [m]
    for i in range(m):
        perm.extend([m + 1 + i, i])
    perm.extend(range(1 + 2 * m, 1 + 2 * m + len(rest)))
    y = y.permute(*perm).reshape(
        (b // prod,) + tuple(s * bs for s, bs in zip(spatial, block_shape))
        + rest)
    idx = (slice(None),) + tuple(slice(c0, y.shape[1 + i] - c1)
                                 for i, (c0, c1) in enumerate(crops))
    return y[idx]


def _segment(data, segment_ids, num_segments, how, init):
    """jax.ops.segment_*: ids outside [0, num_segments) are dropped."""
    data = C.t(data)
    ids = C.t(segment_ids, data).long().reshape(-1)
    vals = data.reshape((ids.shape[0],) + tuple(data.shape[
        C.t(segment_ids).dim():]))
    ok = (ids >= 0) & (ids < num_segments)
    out = torch.full((int(num_segments),) + tuple(vals.shape[1:]), init,
                     dtype=data.dtype, device=data.device)
    if how == "sum":
        return out.index_add_(0, ids[ok], vals[ok])
    return out.index_reduce_(0, ids[ok], vals[ok], how)


def _lowest(dt):
    return float("-inf") if dt.is_floating_point else torch.iinfo(dt).min


def _highest(dt):
    return float("inf") if dt.is_floating_point else torch.iinfo(dt).max


@op("segment_sum", "segment", aliases=("unsorted_segment_sum",),
    differentiable=False)
def segment_sum(data, segment_ids, num_segments):
    return _segment(data, segment_ids, num_segments, "sum", 0)


def _fill_empty(out, segment_ids, num_segments, fill):
    counts = _segment(torch.ones(C.t(segment_ids).shape, dtype=torch.int32,
                                 device=out.device), segment_ids,
                      num_segments, "sum", 0)
    present = (counts > 0).reshape((-1,) + (1,) * (out.dim() - 1))
    return torch.where(present, out, torch.full_like(out, fill))


@op("segment_max", "segment", aliases=("unsorted_segment_max",),
    differentiable=False)
def segment_max(data, segment_ids, num_segments, empty_fill=None):
    out = _segment(data, segment_ids, num_segments, "amax",
                   _lowest(C.t(data).dtype))
    if empty_fill is None:
        return out
    return _fill_empty(out, segment_ids, num_segments, empty_fill)


@op("segment_min", "segment", aliases=("unsorted_segment_min",),
    differentiable=False)
def segment_min(data, segment_ids, num_segments, empty_fill=None):
    out = _segment(data, segment_ids, num_segments, "amin",
                   _highest(C.t(data).dtype))
    if empty_fill is None:
        return out
    return _fill_empty(out, segment_ids, num_segments, empty_fill)


@op("segment_mean", "segment", aliases=("unsorted_segment_mean",),
    differentiable=False)
def segment_mean(data, segment_ids, num_segments):
    data = C.t(data)
    sums = _segment(data, segment_ids, num_segments, "sum", 0)
    counts = _segment(torch.ones(C.t(segment_ids).shape, dtype=data.dtype,
                                 device=data.device), segment_ids,
                      num_segments, "sum", 0)
    return sums / torch.clamp_min(counts, 1).reshape(
        (-1,) + (1,) * (data.dim() - 1))


@op("segment_prod", "segment", aliases=("unsorted_segment_prod",),
    differentiable=False)
def segment_prod(data, segment_ids, num_segments):
    return _segment(data, segment_ids, num_segments, "prod", 1)


@op("batch_gather", "shape", differentiable=False)
def batch_gather(x, indices):
    """Per-batch-row gather along axis 1."""
    x = C.t(x)
    idx = C.t(indices, x)
    return take_along_axis(x, idx.reshape(tuple(idx.shape)
                                          + (1,) * (x.dim() - idx.dim())), 1)


@op("tensor_scatter_update", "shape", differentiable=False)
def tensor_scatter_update(tensor, indices, updates):
    return _scatter_nd(tensor, indices, updates, "set")


@op("sparse_to_dense", "shape", differentiable=False)
def sparse_to_dense(indices, output_shape, values, default_value=0):
    vals = C.t(values)
    out = torch.full(C.shape(output_shape), default_value, dtype=vals.dtype,
                     device=vals.device)
    idx = C.t(indices, vals)
    if idx.dim() == 1:
        idx = idx[:, None]
    return _scatter_nd(out, idx, vals, "set")


@op("confusion_matrix", "custom", differentiable=False)
def confusion_matrix(labels, predictions, num_classes, weights=None):
    li = C.t(labels).to(torch.int64).reshape(-1)
    pi = C.t(predictions, li).to(torch.int64).reshape(-1)
    w = (torch.ones(li.shape, dtype=torch.float32, device=li.device)
         if weights is None else C.t(weights, li).reshape(-1))
    flat = torch.zeros(num_classes * num_classes, dtype=w.dtype,
                       device=li.device)
    return flat.index_add_(0, li * num_classes + pi, w).reshape(
        num_classes, num_classes)


# ---------------------------------------------------------------------------
# TensorList ops: a list is a stacked array (N, *element); a reserved list is
# (N, 0) until its first set_item gives the element shape.
# ---------------------------------------------------------------------------


@op("tensorlist_reserve", "tensorlist")
def tensorlist_reserve(num_elements, dtype="float32"):
    return torch.zeros((int(num_elements), 0), dtype=C.dtype(dtype))


@op("tensorlist_from_tensor", "tensorlist")
def tensorlist_from_tensor(tensor):
    return tensor


@op("tensorlist_get_item", "tensorlist")
def tensorlist_get_item(lst, index):
    return C.t(lst)[int(index)]


@op("tensorlist_set_item", "tensorlist")
def tensorlist_set_item(lst, index, item):
    lst, item = C.t(lst), C.t(item)
    if tuple(lst.shape[1:]) != tuple(item.shape):
        lst = torch.zeros((lst.shape[0],) + tuple(item.shape),
                          dtype=item.dtype, device=item.device)
    out = lst.clone()
    out[int(index)] = item.to(lst.dtype)
    return out


@op("tensorlist_stack", "tensorlist")
def tensorlist_stack(lst):
    return lst


@op("tensorlist_length", "tensorlist")
def tensorlist_length(lst):
    return torch.tensor(C.t(lst).shape[0], dtype=torch.int32)


@op("reverse_sequence", "shape")
def reverse_sequence(x, seq_lengths, seq_axis=1, batch_axis=0):
    """Per-example reversal of the first seq_lengths steps."""
    x = C.t(x)
    xb = torch.movedim(x, batch_axis, 0)
    sa = seq_axis if seq_axis > batch_axis else seq_axis + 1
    xb = torch.movedim(xb, sa, 1)
    tt = xb.shape[1]
    lens = C.t(seq_lengths, x).long()
    idx = torch.arange(tt, device=x.device)[None, :]
    rev = torch.where(idx < lens[:, None], lens[:, None] - 1 - idx, idx)
    out = torch.gather(xb, 1, rev.reshape(rev.shape + (1,) * (xb.dim() - 2))
                       .expand(xb.shape))
    out = torch.movedim(out, 1, sa)
    return torch.movedim(out, 0, batch_axis)


@op("matrix_band_part", "shape")
def matrix_band_part(x, num_lower, num_upper):
    x = C.t(x)
    m, n = x.shape[-2], x.shape[-1]
    i = torch.arange(m, device=x.device)[:, None]
    j = torch.arange(n, device=x.device)[None, :]
    keep = torch.ones((m, n), dtype=torch.bool, device=x.device)
    if num_lower >= 0:
        keep = keep & (i - j <= num_lower)
    if num_upper >= 0:
        keep = keep & (j - i <= num_upper)
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


@op("mergeadd", "pairwise", aliases=("mergesum", "accumulate_n"))
def mergeadd(*xs):
    out = C.t(xs[0])
    for x in xs[1:]:
        out = out + x
    return out


@op("mergeavg", "pairwise")
def mergeavg(*xs):
    return mergeadd(*xs) / float(len(xs))


@op("mergemax", "pairwise")
def mergemax(*xs):
    out = C.t(xs[0])
    for x in xs[1:]:
        out = torch.maximum(out, C.t(x, out))
    return out


@op("scatter_nd_add", "gather_scatter")
def scatter_nd_add(ref, indices, updates):
    return _scatter_nd(ref, indices, updates, "add")


@op("scatter_nd_sub", "gather_scatter")
def scatter_nd_sub(ref, indices, updates):
    return _scatter_nd(ref, indices, -C.t(updates), "add")


@op("scatter_nd_update", "gather_scatter")
def scatter_nd_update(ref, indices, updates):
    return _scatter_nd(ref, indices, updates, "set")


@op("tear", "shape", differentiable=False)
def tear(x, axis=0):
    return list(torch.unbind(C.t(x), dim=axis))


@op("bitcast", "shape", differentiable=False)
def bitcast(x, dtype):
    """Reinterpret the bytes, TF semantics: a narrower type appends a
    trailing dim of the width ratio, a wider one consumes it."""
    x = C.t(x)
    dt = C.dtype(dtype)
    src, dst = x.element_size(), torch.empty((), dtype=dt).element_size()
    if src == dst:
        return x.view(dt)
    if src > dst:
        return x.contiguous().view(dt).reshape(tuple(x.shape)
                                               + (src // dst,))
    r = dst // src
    if x.dim() == 0 or x.shape[-1] != r:
        raise ValueError(f"bitcast to a {r}x wider dtype needs trailing dim "
                         f"{r}, got shape {tuple(x.shape)}")
    return x.contiguous().view(dt).reshape(tuple(x.shape[:-1]))


@op("broadcast_dynamic_shape", "shape", differentiable=False)
def broadcast_dynamic_shape(a, b):
    return torch.tensor(torch.broadcast_shapes(C.shape(a), C.shape(b)),
                        dtype=torch.int32)


@op("put_along_axis", "gather_scatter", aliases=("scatter_elements",))
def put_along_axis(x, indices, updates, axis=0, reduction="none"):
    """Axis-wise elementwise scatter (ONNX ScatterElements); ``reduction``
    none | add | mul | max | min."""
    x = C.t(x)
    idx = C.t(indices, x).long()
    idx = torch.where(idx < 0, idx + x.shape[axis], idx)
    upd = torch.broadcast_to(C.t(updates, x).to(x.dtype), idx.shape)
    if reduction == "none":
        return torch.scatter(x, axis, idx, upd)
    how = {"add": "sum", "mul": "prod", "max": "amax", "min": "amin"}
    if reduction not in how:
        raise ValueError(f"unknown reduction {reduction!r}")
    return torch.scatter_reduce(x, axis, idx, upd, how[reduction],
                                include_self=True)
