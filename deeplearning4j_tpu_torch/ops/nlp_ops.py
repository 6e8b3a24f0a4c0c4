"""NLP / manifold native-helper ops: the Word2Vec updates and the
Barnes-Hut t-SNE helpers (counterpart of deeplearning4j_tpu/ops/nlp_ops.py).

"In-place" table updates return the new table; duplicate rows in a
scatter add up, as ``.at[].add`` does in the reference.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.ops import _compat as C
from deeplearning4j_tpu_torch.ops.registry import op


def _bce(labels, p, dtype):
    eps = torch.tensor(1e-7, dtype=dtype, device=p.device)
    return -torch.sum(labels * torch.log(p + eps)
                      + (1 - labels) * torch.log(1 - p + eps))


@op("skipgram", "nlp")
def skipgram(syn0, syn1, target, samples, labels, lr=0.025):
    """One skip-gram update against sampled output rows: g = lr * (label -
    sigmoid(w . h)). Returns (new_syn0, new_syn1, loss)."""
    labels = C.t(labels, syn0).to(syn0.dtype)
    samples = C.t(samples, syn0).long()
    tgt = int(target)
    h = syn0[tgt]
    w = syn1[samples]
    p = torch.sigmoid(w @ h)
    g = (labels - p) * lr
    new_syn0 = syn0.clone()
    new_syn0[tgt] += g @ w
    new_syn1 = syn1.clone().index_add_(0, samples, g[:, None] * h[None, :])
    return new_syn0, new_syn1, _bce(labels, p, syn0.dtype)


@op("cbow", "nlp")
def cbow(syn0, syn1, context, samples, labels, lr=0.025, context_mask=None):
    """One CBOW update: the hidden vector is the (masked) mean of the
    context rows, its gradient spread back over them."""
    labels = C.t(labels, syn0).to(syn0.dtype)
    context = C.t(context, syn0).long()
    samples = C.t(samples, syn0).long()
    ctx = syn0[context]
    if context_mask is None:
        denom = torch.tensor(float(ctx.shape[0]), dtype=syn0.dtype,
                             device=syn0.device)
        h = ctx.sum(dim=0) / denom
        mask = None
    else:
        mask = C.t(context_mask, syn0).to(syn0.dtype)
        denom = torch.clamp_min(mask.sum(), 1.0)
        h = (ctx * mask[:, None]).sum(dim=0) / denom
    w = syn1[samples]
    p = torch.sigmoid(w @ h)
    g = (labels - p) * lr
    dctx = ((g @ w) / denom).expand(ctx.shape)
    if mask is not None:
        dctx = dctx * mask[:, None]
    new_syn0 = syn0.clone().index_add_(0, context, dctx)
    new_syn1 = syn1.clone().index_add_(0, samples, g[:, None] * h[None, :])
    return new_syn0, new_syn1, _bce(labels, p, syn0.dtype)


@op("barnes_symmetrized", "nlp", differentiable=False)
def barnes_symmetrized(rows, cols, vals):
    """P_sym = (P + P^T)/2 as the 2E-edge list (i,j,v/2), (j,i,v/2)."""
    rows, cols, vals = C.t(rows), C.t(cols), C.t(vals)
    return (torch.cat([rows, cols]), torch.cat([cols, rows]),
            torch.cat([vals, vals]) * 0.5)


@op("barnes_edge_forces", "nlp")
def barnes_edge_forces(rows, cols, vals, y):
    """F[i] += v_ij (y_i - y_j) / (1 + |y_i - y_j|^2) over the edges."""
    rows = C.t(rows, y).long()
    cols = C.t(cols, y).long()
    vals = C.t(vals, y).to(y.dtype)
    diff = y[rows] - y[cols]
    w = vals / (1.0 + (diff * diff).sum(dim=1))
    return torch.zeros_like(y).index_add_(0, rows, diff * w[:, None])


@op("barnes_gains", "nlp", differentiable=False)
def barnes_gains(gains, gradient, y_incs, min_gain=0.01):
    """+0.2 where the gradient flips the direction of travel, x0.8 where
    it persists, floored at ``min_gain``."""
    same = torch.sign(gradient) == torch.sign(y_incs)
    return torch.clamp_min(torch.where(same, gains * 0.8, gains + 0.2),
                           min_gain)


@op("cell_contains", "nlp", differentiable=False)
def cell_contains(corner, width, point):
    return torch.all((C.t(point) - C.t(corner)).abs() <= C.t(width))


@op("knn_mindistance", "nlp", differentiable=False)
def knn_mindistance(point, lowest, highest):
    """Minimum distance from ``point`` to the box [lowest, highest]."""
    point = C.t(point)
    gap = torch.clamp_min(torch.maximum(C.t(lowest, point) - point,
                                        point - C.t(highest, point)), 0.0)
    return torch.sqrt((gap * gap).sum())
