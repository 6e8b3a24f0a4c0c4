"""Neural-net ops on the ported paths (counterpart of
deeplearning4j_tpu/ops/nn.py).

Layouts are the reference's: NHWC activations, HWIO conv weights. Sums of
products accumulate in fp32 whatever the input type, and results come back
in the input's type, as in the reference.

``conv2d`` is the one op here with hand-written kernels: its dispatch
(ops/kernels) launches the CUDA conv kernel on a CUDA tensor (or raises
for a geometry the kernel does not take), and the plain tap-sum version on
the CPU or under ``exact``; when autograd records it, its backward runs
the dgrad and wgrad kernels the same way (``Conv2dFunction``). Pooling,
batchnorm (inference and training), the dense product, the activations
(relu, tanh, sigmoid, gelu), softmax and the losses are XLA ops in the reference,
not Pallas kernels, so here they are
plain PyTorch; training batchnorm keeps the reference's arithmetic and its
hand-written VJP rather than ATen's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops.kernels import conv as _kconv
from deeplearning4j_tpu_torch.ops.registry import op


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _acc_dtype(t):
    """Accumulation dtype: fp32 unless the input is already fp64."""
    return torch.promote_types(t.dtype, torch.float32)


# ---------------------------------------------------------------------------
# Convolution
# ---------------------------------------------------------------------------


@op("conv2d", "conv")
def conv2d(x, w, b=None, strides=(1, 1), padding="SAME", dilation=(1, 1),
           data_format="NHWC", feature_group_count=1,
           preferred_element_type=None):
    """2-D convolution. x: [N,H,W,C] (NHWC) or [N,C,H,W] (NCHW);
    w: [kH,kW,Cin/groups,Cout] (HWIO). ``padding``: 'SAME' (the XLA
    asymmetric split), 'VALID', or symmetric (ph, pw) pixels.

    The dispatch mirrors deeplearning4j_tpu/ops/nn.py:83-118 on the NHWC
    view of x (NCHW input is permuted first): ``kernels.dispatch`` launches
    the CUDA kernel on a CUDA tensor, or raises if ``supports`` refuses the
    geometry, and takes the plain version on the CPU or under ``exact``;
    the bias is added after the kernel. Accumulation is fp32 on both paths
    and the output comes back in x's type, as the reference casts back.
    When autograd records the call (grad enabled and x or w needing a
    gradient) it goes through ``Conv2dFunction``, the reference's custom
    VJP, whose backward dispatches the dgrad and wgrad kernels."""
    if data_format not in ("NHWC", "NCHW"):
        raise ValueError(f"conv2d: unknown data_format {data_format!r}")
    strides_p, dil_p = _pair(strides), _pair(dilation)
    xh = x if data_format == "NHWC" else x.permute(0, 2, 3, 1)
    pads = _kconv.resolve_padding(padding, (xh.shape[1], xh.shape[2]),
                                  (w.shape[0], w.shape[1]), strides_p, dil_p)
    supported = _kconv.supports(xh, w, "NHWC", feature_group_count,
                                preferred_element_type)

    def describe():
        return (f"x {tuple(x.shape)} {x.dtype} ({data_format}), w "
                f"{tuple(w.shape)} {w.dtype}, groups {feature_group_count}, "
                f"preferred_element_type {preferred_element_type}")

    args = (xh, w, strides_p, pads, dil_p, feature_group_count, supported,
            describe)
    if torch.is_grad_enabled() and (xh.requires_grad or w.requires_grad):
        out = _kconv.Conv2dFunction.apply(*args)
    else:
        out = _kconv.conv2d(*args)
    if b is not None:
        out = out + b.reshape(1, 1, 1, -1).to(out.dtype)
    return out if data_format == "NHWC" else out.permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# Pooling
# ---------------------------------------------------------------------------


def _pool_pads(padding, hw, kernel, strides):
    """reduce_window padding as explicit ((top, bottom), (left, right)):
    'SAME' is XLA's asymmetric split (the extra pixel goes low-side last:
    a 3x3/s2 window on 112 pads (0, 1)); numbers are symmetric."""
    return _kconv.resolve_padding(padding, hw, kernel, strides, (1, 1))


def _to_nchw_padded(x, pads, data_format, value):
    xc = x.permute(0, 3, 1, 2) if data_format == "NHWC" else x
    (pt, pb), (pl, pr) = pads
    if pt or pb or pl or pr:
        xc = F.pad(xc, (pl, pr, pt, pb), value=value)
    return xc


def _from_nchw(y, data_format):
    return y.permute(0, 2, 3, 1).contiguous() if data_format == "NHWC" else y


@op("maxpool2d", "pooling", aliases=("max_pool2d", "maxpool"))
def max_pool2d(x, kernel=(2, 2), strides=None, padding="VALID",
               data_format="NHWC"):
    """Max pooling with reduce_window semantics: the window pads with
    -inf (the integer minimum for integer inputs), explicitly and
    asymmetrically for SAME, so a padded cell never wins."""
    strides = _pair(strides or kernel)
    kernel = _pair(kernel)
    hw = x.shape[1:3] if data_format == "NHWC" else x.shape[2:4]
    pads = _pool_pads(padding, hw, kernel, strides)
    fill = (float("-inf") if x.dtype.is_floating_point
            else torch.iinfo(x.dtype).min)
    xc = _to_nchw_padded(x, pads, data_format, fill)
    return _from_nchw(F.max_pool2d(xc, kernel, strides), data_format)


@op("avgpool2d", "pooling", aliases=("avg_pool2d", "avgpool"))
def avg_pool2d(x, kernel=(2, 2), strides=None, padding="VALID",
               data_format="NHWC"):
    """Average pooling with reduce_window semantics: VALID divides by the
    window size; SAME and numeric pads divide each window's sum by the
    number of in-bounds cells it covered (the reference's ``counts``)."""
    strides = _pair(strides or kernel)
    kernel = _pair(kernel)
    hw = x.shape[1:3] if data_format == "NHWC" else x.shape[2:4]
    pads = _pool_pads(padding, hw, kernel, strides)
    xc = _to_nchw_padded(x, pads, data_format, 0.0)
    summed = F.avg_pool2d(xc, kernel, strides, divisor_override=1)
    if padding == "VALID":
        out = summed / (kernel[0] * kernel[1])
    else:
        ones = torch.ones((1, 1) + tuple(hw), dtype=x.dtype, device=x.device)
        counts = F.avg_pool2d(_to_nchw_padded(ones, pads, "NCHW", 0.0),
                              kernel, strides, divisor_override=1)
        out = summed / counts
    return _from_nchw(out, data_format)


@op("global_avg_pool", "pooling", aliases=("globalavgpool",))
def global_avg_pool(x, data_format="NHWC", keepdims=False):
    dims = (1, 2) if data_format == "NHWC" else (2, 3)
    return x.mean(dim=dims, keepdim=keepdims)


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------


@op("batchnorm", "norm", aliases=("batch_norm", "batchnorm_new"))
def batchnorm(x, mean, variance, gamma=None, beta=None, eps=1e-5, axis=-1):
    """Normalize with given statistics (the inference form): rsqrt(var+eps)
    and the normalization in fp32, cast back to x's type."""
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    acc = _acc_dtype(x)
    inv = torch.rsqrt(variance.to(acc) + eps).reshape(shape)
    out = (x.to(acc) - mean.reshape(shape)) * inv
    if gamma is not None:
        out = out * gamma.reshape(shape)
    if beta is not None:
        out = out + beta.reshape(shape)
    return out.to(x.dtype)


def _bn_geometry(x, axis):
    ax = axis % x.dim()
    red = tuple(i for i in range(x.dim()) if i != ax)
    shape = [1] * x.dim()
    shape[ax] = x.shape[ax]
    n = 1
    for i in red:
        n *= x.shape[i]
    return red, shape, float(n)


class _BatchNormTrain(torch.autograd.Function):
    """The reference's ``_bn_train_fused`` (deeplearning4j_tpu/ops/nn.py
    :356-422): statistics from one paired sum (E[x], E[x^2]), the EMA
    update with the unbiased variance, and its hand-written VJP, including
    the EMA outputs' cotangents (None when nothing asks for them, as in
    training, where the states are not differentiated)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, rm, rv, momentum, eps, axis):
        red, shape, n = _bn_geometry(x, axis)
        xf = x.to(_acc_dtype(x))
        mean = xf.sum(dim=red) / n
        var = torch.clamp_min((xf * xf).sum(dim=red) / n - mean * mean, 0.0)
        inv = torch.rsqrt(var + eps)
        out = ((xf - mean.reshape(shape))
               * (inv * gamma.to(xf.dtype)).reshape(shape)
               + beta.to(xf.dtype).reshape(shape)).to(x.dtype)
        unbiased = var * (n / max(n - 1.0, 1.0))
        new_mean = momentum * rm + (1.0 - momentum) * mean.to(rm.dtype)
        new_var = momentum * rv + (1.0 - momentum) * unbiased.to(rv.dtype)
        ctx.save_for_backward(x, gamma, mean, inv)
        ctx.bn = (momentum, axis)
        ctx.set_materialize_grads(False)
        return out, new_mean, new_var

    @staticmethod
    def backward(ctx, dout, dm_ema, dv_ema):
        x, gamma, mean, inv = ctx.saved_tensors
        momentum, axis = ctx.bn
        red, shape, n = _bn_geometry(x, axis)
        xf = x.to(_acc_dtype(x))
        xhat = (xf - mean.reshape(shape)) * inv.reshape(shape)
        dx = dgamma = dbeta = None
        if dout is not None:
            dyf = dout.to(xf.dtype)
            g = dyf.sum(dim=red)
            g2 = (dyf * xhat).sum(dim=red)
            dgamma, dbeta = g2.to(gamma.dtype), g.to(gamma.dtype)
            ginv = gamma.to(xf.dtype) * inv
            dx = ginv.reshape(shape) * (dyf - (g / n).reshape(shape)
                                        - xhat * (g2 / n).reshape(shape))
        one_m = 1.0 - momentum
        if dm_ema is not None:
            t = (one_m / n) * dm_ema.to(xf.dtype).reshape(shape)
            dx = t if dx is None else dx + t
        if dv_ema is not None:
            scale = one_m * (n / max(n - 1.0, 1.0)) * 2.0 / n
            t = scale * dv_ema.to(xf.dtype).reshape(shape) * (
                xhat / inv.reshape(shape))
            dx = t if dx is None else dx + t
        if dx is not None:
            dx = dx.to(x.dtype)
        if not ctx.needs_input_grad[0]:
            dx = None
        return (dx, dgamma, dbeta,
                None if dm_ema is None else momentum * dm_ema,
                None if dv_ema is None else momentum * dv_ema,
                None, None, None)


@op("batchnorm_train", "norm")
def batchnorm_train(x, gamma, beta, running_mean, running_var, momentum=0.9,
                    eps=1e-5, axis=-1):
    """Training-mode batchnorm: batch statistics + EMA update (``new =
    momentum*old + (1-momentum)*batch``, unbiased variance), with the
    reference's single-pass statistics and hand-written VJP (not ATen's
    Welford batchnorm, which drifts from the reference over a trajectory).

    Returns (out, new_running_mean, new_running_var)."""
    return _BatchNormTrain.apply(x, gamma, beta, running_mean, running_var,
                                 float(momentum), float(eps), int(axis))


# ---------------------------------------------------------------------------
# Activations, softmax, dense
# ---------------------------------------------------------------------------

op("identity", "transform")(lambda x: x)
op("relu", "transform")(torch.relu)
op("tanh", "transform_float")(torch.tanh)
op("sigmoid", "transform_float")(torch.sigmoid)
# the reference's canonical gelu is the exact erf form
# (deeplearning4j_tpu/ops/elementwise.py:54-58), not the tanh approximation
op("gelu", "transform_float", aliases=("gelu_erf",))(
    lambda x: F.gelu(x, approximate="none"))
op("softmax", "softmax")(lambda x, axis=-1: torch.softmax(x, dim=axis))
op("log_softmax", "softmax")(
    lambda x, axis=-1: torch.log_softmax(x, dim=axis))


@op("xw_plus_b", "nn_misc", aliases=("linear_layer",))
def xw_plus_b(x, w, b):
    """x @ w + b with fp32 accumulation, result in x's type. A plain
    matrix product: the reference leaves it to XLA outside any Pallas
    kernel, so here it is ``torch.matmul`` on fp32 operands (TF32 stays
    off for fp32 parity)."""
    acc = _acc_dtype(x)
    out = torch.matmul(x.to(acc), w.to(acc)).to(x.dtype)
    return out + b.to(out.dtype)


# ---------------------------------------------------------------------------
# Loss ops (mean over the batch, optional per-example weights)
# ---------------------------------------------------------------------------


def _weighted_mean(per_example, weights):
    """Mean of ``per_example``, or its weighted mean with weights aligned on
    the leading axes. The normalizer multiplies by the reciprocal of the
    clamped weight sum, as the reference does (ops/nn.py:514-534), so a
    0/1-padded batch gives the unpadded mean; all-zero weights give 0."""
    if weights is None:
        return per_example.mean()
    if weights.dim() < per_example.dim():
        weights = weights.reshape(tuple(weights.shape)
                                  + (1,) * (per_example.dim() - weights.dim()))
    wfull = torch.broadcast_to(weights.to(per_example.dtype),
                               per_example.shape)
    return (per_example * wfull).sum() * (
        1.0 / torch.clamp_min(wfull.sum(), 1e-12))


@op("softmax_cross_entropy", "loss",
    aliases=("softmax_cross_entropy_loss", "mcxent"))
def softmax_cross_entropy(logits, labels, weights=None, label_smoothing=0.0):
    """Softmax cross-entropy with one-hot (or soft) labels [batch, classes],
    the log-softmax in fp32."""
    if label_smoothing > 0.0:
        k = labels.shape[-1]
        labels = labels * (1.0 - label_smoothing) + label_smoothing / k
    logp = torch.log_softmax(logits.to(_acc_dtype(logits)), dim=-1)
    per = -(labels * logp).sum(dim=-1)
    return _weighted_mean(per, weights)


def _mean_rest(t):
    """Mean over every axis but the first; a 1-D tensor as it is (the
    reference's ``jnp.mean(axis=())``)."""
    return t.mean(dim=tuple(range(1, t.dim()))) if t.dim() > 1 else t


@op("sparse_softmax_cross_entropy", "loss")
def sparse_softmax_cross_entropy(logits, label_indices, weights=None):
    """Softmax cross-entropy with integer class indices [batch]."""
    logp = torch.log_softmax(logits.to(_acc_dtype(logits)), dim=-1)
    idx = label_indices.long()[..., None]
    per = -torch.gather(logp, -1, idx)[..., 0]
    return _weighted_mean(per, weights)


@op("sigmoid_cross_entropy", "loss", aliases=("xent",))
def sigmoid_cross_entropy(logits, labels, weights=None):
    """Binary cross-entropy from logits, summed over the outputs of an
    example, in fp32."""
    z = logits.to(_acc_dtype(logits))
    per = (torch.clamp_min(z, 0) - z * labels
           + torch.log1p(torch.exp(-z.abs())))
    if per.dim() > 1:
        per = per.sum(dim=tuple(range(1, per.dim())))
    return _weighted_mean(per, weights)


@op("mse_loss", "loss", aliases=("mean_sqerr_loss", "l2_loss_per_example"))
def mse_loss(predictions, labels, weights=None):
    return _weighted_mean(_mean_rest((predictions - labels) ** 2), weights)


@op("mae_loss", "loss", aliases=("absolute_difference_loss", "l1"))
def mae_loss(predictions, labels, weights=None):
    return _weighted_mean(_mean_rest((predictions - labels).abs()), weights)


@op("huber_loss", "loss")
def huber_loss(predictions, labels, delta=1.0, weights=None):
    abs_err = (predictions - labels).abs()
    quad = torch.clamp_max(abs_err, delta)
    per = 0.5 * quad ** 2 + delta * (abs_err - quad)
    return _weighted_mean(_mean_rest(per), weights)


@op("hinge_loss", "loss")
def hinge_loss(predictions, labels, weights=None):
    """Labels in {0, 1} mapped to -1/+1 (the ND4J convention)."""
    signed = 2.0 * labels - 1.0
    per = torch.clamp_min(1.0 - signed * predictions, 0.0)
    return _weighted_mean(_mean_rest(per), weights)


@op("squared_hinge_loss", "loss")
def squared_hinge_loss(predictions, labels, weights=None):
    signed = 2.0 * labels - 1.0
    per = torch.clamp_min(1.0 - signed * predictions, 0.0) ** 2
    return _weighted_mean(_mean_rest(per), weights)


@op("log_loss", "loss")
def log_loss(predictions, labels, eps=1e-7, weights=None):
    p = torch.clamp(predictions, eps, 1.0 - eps)
    per = -_mean_rest(labels * torch.log(p) + (1.0 - labels) * torch.log1p(-p))
    return _weighted_mean(per, weights)


@op("poisson_loss", "loss")
def poisson_loss(predictions, labels, weights=None):
    per = predictions - labels * torch.log(torch.clamp_min(predictions, 1e-12))
    return _weighted_mean(_mean_rest(per), weights)


@op("kl_divergence", "loss", aliases=("kld",))
def kl_divergence(predictions, labels, eps=1e-12, weights=None):
    per = (labels * (torch.log(torch.clamp_min(labels, eps))
                     - torch.log(torch.clamp_min(predictions, eps)))
           ).sum(dim=-1)
    return _weighted_mean(per, weights)


@op("cosine_distance_loss", "loss")
def cosine_distance_loss(predictions, labels, axis=-1, weights=None):
    num = (predictions * labels).sum(dim=axis)
    n_p = torch.sqrt((predictions ** 2).sum(dim=axis))
    n_l = torch.sqrt((labels ** 2).sum(dim=axis))
    per = 1.0 - num / torch.clamp_min(n_p * n_l, 1e-12)
    return _weighted_mean(per, weights)
