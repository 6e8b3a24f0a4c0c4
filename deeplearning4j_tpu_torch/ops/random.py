"""Random ops of the port (counterpart of deeplearning4j_tpu/ops/random.py).

The reference draws from explicit JAX keys; the port draws from an explicit
``torch.Generator`` the caller owns, in the key's place (a network makes
one at ``init``, seeded from ``conf.seed`` on its device). The two give
different bits from the same seed, so a test compares distributions
(shapes, types, ranges and moments over a large draw), never values; from
one generator state the port repeats itself exactly. Every draw happens on
the generator's device.
"""

from __future__ import annotations

import math

import torch

from deeplearning4j_tpu_torch.ops import _compat as C
from deeplearning4j_tpu_torch.ops.registry import op
from deeplearning4j_tpu_torch.util import xla_tuning as _xt


@op("random_split_key", "random", differentiable=False)
def random_split_key(gen, num=2):
    """``num`` new generators on gen's device, seeded from draws of gen."""
    seeds = torch.randint(0, 2 ** 62, (int(num),), generator=gen,
                          device=gen.device).tolist()
    return [torch.Generator(device=gen.device).manual_seed(int(s))
            for s in seeds]


def _uniform(gen, shape, dtype=torch.float32):
    return torch.rand(C.shape(shape), generator=gen, device=gen.device,
                      dtype=dtype)


@op("random_uniform", "random", aliases=("uniform", "randomuniform"),
    differentiable=False)
def random_uniform(gen, shape, minval=0.0, maxval=1.0, dtype="float32"):
    dt = C.dtype(dtype)
    return (minval + (maxval - minval) * _uniform(gen, shape)).to(dt)


@op("random_normal", "random",
    aliases=("normal", "randomnormal", "gaussian"), differentiable=False)
def random_normal(gen, shape, mean=0.0, stddev=1.0, dtype="float32"):
    z = torch.randn(C.shape(shape), generator=gen, device=gen.device)
    return (mean + stddev * z).to(C.dtype(dtype))


def _truncated(gen, shape, lo=-2.0, hi=2.0):
    """Standard normal truncated to [lo, hi] by the inverse CDF of a
    uniform over [Phi(lo), Phi(hi)]."""
    cdf = [0.5 * (1.0 + math.erf(v / math.sqrt(2.0))) for v in (lo, hi)]
    u = cdf[0] + (cdf[1] - cdf[0]) * _uniform(gen, shape, torch.float64)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    return torch.clamp(z, lo, hi)


@op("random_truncated_normal", "random", aliases=("truncatednormal",),
    differentiable=False)
def truncated_normal(gen, shape, mean=0.0, stddev=1.0, dtype="float32"):
    return (mean + stddev * _truncated(gen, shape)).to(C.dtype(dtype))


@op("random_lognormal", "random", aliases=("lognormal",),
    differentiable=False)
def lognormal(gen, shape, mean=0.0, stddev=1.0, dtype="float32"):
    return torch.exp(random_normal(gen, shape, mean, stddev, dtype))


@op("random_bernoulli", "random", aliases=("bernoulli",),
    differentiable=False)
def bernoulli(gen, shape, p=0.5, dtype="float32"):
    """``shape=None``: p's shape (``jax.random.bernoulli``'s default)."""
    if isinstance(p, torch.Tensor):
        p = p.to(gen.device)
    if shape is None:
        shape = tuple(torch.as_tensor(p).shape)
    return (_uniform(gen, shape) < p).to(C.dtype(dtype))


@op("random_binomial", "random", aliases=("binomial",), differentiable=False)
def binomial(gen, shape, n, p, dtype="float32"):
    shp = C.shape(shape)
    count = torch.full(shp, float(n), device=gen.device)
    prob = torch.full(shp, float(p), device=gen.device)
    return torch.binomial(count, prob, generator=gen).to(C.dtype(dtype))


@op("random_exponential", "random", aliases=("exponential",),
    differentiable=False)
def exponential(gen, shape, lam=1.0, dtype="float32"):
    e = torch.empty(C.shape(shape), device=gen.device).exponential_(
        1.0, generator=gen)
    return (e / lam).to(C.dtype(dtype))


def _standard_gamma(gen, alpha, shape):
    """Gamma(alpha, 1) by Marsaglia and Tsang's squeeze (alpha < 1 boosted
    by U^(1/alpha)), drawing from ``gen`` until every element accepts."""
    a = torch.full(shape, float(alpha), dtype=torch.float64,
                   device=gen.device) if not isinstance(alpha, torch.Tensor) \
        else torch.broadcast_to(alpha.double().to(gen.device), shape)
    boost = a < 1.0
    aa = torch.where(boost, a + 1.0, a)
    d = aa - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.empty(shape, dtype=torch.float64, device=gen.device)
    todo = torch.ones(shape, dtype=torch.bool, device=gen.device)
    while bool(todo.any()):
        z = torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float64)
        u = torch.rand(shape, generator=gen, device=gen.device,
                       dtype=torch.float64)
        v = (1.0 + c * z) ** 3
        ok = (v > 0) & (torch.log(u.clamp_min(1e-300))
                        < 0.5 * z * z + d - d * v
                        + d * torch.log(v.clamp_min(1e-300)))
        take = todo & ok
        out = torch.where(take, d * v, out)
        todo = todo & ~ok
    u = torch.rand(shape, generator=gen, device=gen.device,
                   dtype=torch.float64)
    return torch.where(boost, out * u ** (1.0 / a), out)


@op("random_gamma", "random", differentiable=False)
def gamma(gen, shape, alpha, dtype="float32"):
    return _standard_gamma(gen, alpha, C.shape(shape)).to(C.dtype(dtype))


@op("random_poisson", "random", differentiable=False)
def poisson(gen, shape, lam, dtype="int32"):
    rates = torch.full(C.shape(shape), float(lam), device=gen.device)
    return torch.poisson(rates, generator=gen).to(C.dtype(dtype))


@op("random_categorical", "random", aliases=("multinomial",),
    differentiable=False)
def categorical(gen, logits, num_samples=1):
    """int32 samples (..., num_samples) by the Gumbel-max draw over the
    last axis, as jax.random.categorical draws."""
    lg = C.t(logits).to(gen.device)
    shape = tuple(lg.shape[:-1]) + (int(num_samples), lg.shape[-1])
    u = torch.rand(shape, generator=gen, device=gen.device)
    g = -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))
    return torch.argmax(lg.unsqueeze(-2).float() + g, dim=-1).to(torch.int32)


@op("random_shuffle", "random", differentiable=False)
def shuffle(gen, x, axis=0):
    x = C.t(x)
    perm = torch.randperm(x.shape[axis], generator=gen,
                          device=gen.device).to(x.device)
    return torch.index_select(x, axis, perm)


@op("random_choice", "random", differentiable=False)
def choice(gen, x, shape, replace=True, p=None):
    """Draws from ``x`` (an int n means arange(n)), uniform or by the
    probabilities ``p``."""
    pool = (torch.arange(int(x), dtype=torch.int32, device=gen.device)
            if isinstance(x, int) else C.t(x).to(gen.device).reshape(-1))
    shp = C.shape(shape)
    count = math.prod(shp)
    n = pool.shape[0]
    if p is None:
        if replace:
            idx = torch.randint(0, n, (count,), generator=gen,
                                device=gen.device)
        else:
            idx = torch.randperm(n, generator=gen, device=gen.device)[:count]
    else:
        idx = torch.multinomial(C.t(p).to(gen.device).float(), count,
                                replacement=replace, generator=gen)
    return pool[idx].reshape(shp)


@op("dropout", "random")
def dropout(x, gen, rate, training=True):
    """Inverted dropout: each element kept with probability ``1 - rate``
    and scaled by ``1 / (1 - rate)``, the rest set to 0, so the expectation
    is kept; identity when not training or at rate 0. ``gen`` is a
    ``torch.Generator`` on x's device."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    # a remat stage's recompute reuses its forward's draw (xla_tuning.draw)
    u = _xt.draw(lambda: torch.rand(x.shape, generator=gen,
                                    device=x.device))
    return torch.where(u < keep, x / keep, 0.0).to(x.dtype)


@op("dropout_inverted", "random")
def dropout_inverted(x, gen, p, training=True):
    """ND4J's legacy API: ``p`` is the keep probability."""
    return dropout(x, gen, 1.0 - p, training=training)


@op("alpha_dropout", "random")
def alpha_dropout(x, gen, rate, training=True):
    """SELU-compatible dropout (AlphaDropout): dropped units go to the
    SELU saturation value and an affine map keeps mean and variance."""
    if not training or rate == 0.0:
        return x
    alpha_p = -1.7580993408473766
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    a = (keep + alpha_p ** 2 * keep * (1 - keep)) ** -0.5
    b = -a * alpha_p * (1 - keep)
    return (a * torch.where(mask, x, alpha_p) + b).to(x.dtype)
