"""Neural-net ops on the ported paths (counterpart of
deeplearning4j_tpu/ops/nn.py).

Layouts are the reference's: NHWC activations, HWIO conv weights. Sums of
products accumulate in fp32 whatever the input type, and results come back
in the input's type, as in the reference.

``conv2d`` is the op here with hand-written kernels: its dispatch
(ops/kernels) launches the CUDA conv kernel on a CUDA tensor (or raises
for a geometry the kernel does not take), and the plain tap-sum version on
the CPU or under ``exact``; when autograd records it, its backward runs
the dgrad and wgrad kernels the same way (``Conv2dFunction``). ``conv1d``,
``depthwise_conv2d`` and ``separable_conv2d`` reach the forward kernel
through it, and the TF grad ops ``conv2d_backprop_input`` and
``conv2d_backprop_filter`` reach the dgrad and wgrad kernels through
``conv2d_bwd`` by the same rule. Pooling,
batchnorm (inference and training), the dense product, the activations
(relu, tanh, sigmoid, gelu), softmax and the losses are XLA ops in the reference,
not Pallas kernels, so here they are
plain PyTorch; training batchnorm keeps the reference's arithmetic and its
hand-written VJP rather than ATen's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops import kernels as _kern
from deeplearning4j_tpu_torch.ops import shape_ops
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


# ---------------------------------------------------------------------------
# The rest of the reference's ops/nn.py: the conv family around conv2d,
# pooling, normalization, attention, the TF grad ops and the losses.
# ---------------------------------------------------------------------------


def _same_pads(size, k, s, d=1):
    """XLA's SAME split of one axis: the extra pixel goes high."""
    out = -(-size // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def _pads_nd(padding, sizes, ks, strides, dil=None):
    dil = dil or (1,) * len(sizes)
    if isinstance(padding, str):
        if padding == "VALID":
            return [(0, 0)] * len(sizes)
        return [_same_pads(n, k, s, d)
                for n, k, s, d in zip(sizes, ks, strides, dil)]
    if isinstance(padding, int):
        padding = (padding,) * len(sizes)
    return [(p, p) if isinstance(p, int) else tuple(p) for p in padding]


def _flat_pads(pads):
    """[(lo, hi) per spatial dim] -> F.pad's order (last dim first)."""
    return [v for lo_hi in reversed(pads) for v in lo_hi]


@op("conv1d", "conv")
def conv1d(x, w, b=None, stride=1, padding="SAME", dilation=1,
           data_format="NWC"):
    """1-D convolution, x [N,W,C]; w [kW,Cin,Cout]: a conv2d over a unit
    height, so it reaches the conv kernel on a CUDA tensor."""
    x4 = x.unsqueeze(1 if data_format == "NWC" else 2)
    df = "NHWC" if data_format == "NWC" else "NCHW"
    pad = padding if isinstance(padding, str) else (0, padding)
    out = conv2d(x4, w.unsqueeze(0), b, strides=(1, stride), padding=pad,
                 dilation=(1, dilation), data_format=df)
    return out.squeeze(1 if data_format == "NWC" else 2)


def _conv_nd(x, w, strides, pads, dilation, nd):
    """Channels-last N-d correlation with a (*k, I, O) weight, fp32
    accumulation, result in x's type."""
    fn = {2: F.conv2d, 3: F.conv3d}[nd]
    acc = _acc_dtype(x)
    xc = x.to(acc).movedim(-1, 1)
    xc = F.pad(xc, _flat_pads(pads))
    wc = w.to(acc).movedim(-1, 0).movedim(-1, 1)
    out = fn(xc, wc, stride=tuple(strides), dilation=tuple(dilation))
    return out.movedim(1, -1).to(x.dtype)


@op("conv3d", "conv")
def conv3d(x, w, b=None, strides=(1, 1, 1), padding="SAME",
           dilation=(1, 1, 1), data_format="NDHWC"):
    """3-D convolution, x [N,D,H,W,C]; w [kD,kH,kW,Cin,Cout]."""
    strides = (strides,) * 3 if isinstance(strides, int) else tuple(strides)
    dilation = ((dilation,) * 3 if isinstance(dilation, int)
                else tuple(dilation))
    xl = x if data_format.endswith("C") else x.movedim(1, -1)
    if not isinstance(padding, str):
        padding = padding if len(padding) == 3 else (padding,) * 3
    pads = _pads_nd(padding, xl.shape[1:4], w.shape[:3], strides, dilation)
    out = _conv_nd(xl, w, strides, pads, dilation, 3)
    if b is not None:
        out = out + b.reshape(1, 1, 1, 1, -1).to(out.dtype)
    return out if data_format.endswith("C") else out.movedim(-1, 1)


@op("depthwise_conv2d", "conv", aliases=("sconv2d_depthwise",))
def depthwise_conv2d(x, w, b=None, strides=(1, 1), padding="SAME",
                     dilation=(1, 1), data_format="NHWC"):
    """Depthwise conv, w [kH,kW,C,multiplier]: conv2d with one group per
    channel (the conv kernel on a CUDA tensor)."""
    c = x.shape[-1] if data_format == "NHWC" else x.shape[1]
    kh, kw, cin, mult = w.shape
    return conv2d(x, w.reshape(kh, kw, 1, cin * mult), b, strides=strides,
                  padding=padding, dilation=dilation,
                  data_format=data_format, feature_group_count=c)


@op("separable_conv2d", "conv", aliases=("sconv2d",))
def separable_conv2d(x, depth_w, point_w, b=None, strides=(1, 1),
                     padding="SAME", data_format="NHWC"):
    y = depthwise_conv2d(x, depth_w, None, strides=strides, padding=padding,
                         data_format=data_format)
    return conv2d(y, point_w, b, strides=(1, 1), padding="VALID",
                  data_format=data_format)


def _transpose_pads(k, s, padding):
    """lax.conv_transpose's padding of the stride-dilated input."""
    if padding == "SAME":
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    elif padding == "VALID":
        pad_len = k + s - 2 + max(k - s, 0)
        pad_a = k - 1
    else:
        raise ValueError(f"unknown padding {padding!r}")
    return pad_a, pad_len - pad_a


def _deconv(x, w, strides, padding, nd):
    """lax.conv_transpose (transpose_kernel False): x dilated by the
    strides, padded, and correlated with w unflipped; channels last."""
    ks = w.shape[:nd]
    if isinstance(padding, str):
        pads = [_transpose_pads(k, s, padding) for k, s in zip(ks, strides)]
    else:
        pads = [(p, p) for p in (padding if not isinstance(padding, int)
                                 else (padding,) * nd)]
    if any(s > 1 for s in strides):
        n, *sp, c = x.shape
        dil = x.new_zeros((n,) + tuple((v - 1) * s + 1
                                       for v, s in zip(sp, strides)) + (c,))
        dil[(slice(None),) + tuple(slice(None, None, s) for s in strides)] = x
        x = dil
    return _conv_nd(x, w, (1,) * nd, pads, (1,) * nd, nd)


@op("deconv2d", "conv", aliases=("conv2d_transpose",))
def deconv2d(x, w, b=None, strides=(1, 1), padding="SAME",
             data_format="NHWC"):
    """Transposed convolution; w [kH,kW,Cout,Cin] per HWIO with I = x's
    channels."""
    xl = x if data_format == "NHWC" else x.permute(0, 2, 3, 1)
    out = _deconv(xl, w, _pair(strides), padding if isinstance(padding, str)
                  else _pair(padding), 2)
    if b is not None:
        out = out + b.reshape(1, 1, 1, -1).to(out.dtype)
    return out if data_format == "NHWC" else out.permute(0, 3, 1, 2)


@op("upsampling2d", "conv")
def upsampling2d(x, scale=2, data_format="NHWC"):
    sh, sw = _pair(scale)
    ah, aw = (1, 2) if data_format == "NHWC" else (2, 3)
    return x.repeat_interleave(sh, dim=ah).repeat_interleave(sw, dim=aw)


@op("im2col", "conv")
def im2col(x, kernel, strides=(1, 1), padding=(0, 0), dilation=(1, 1)):
    """Patches of NHWC x as (N, C*kh*kw, OH, OW), features in (C, kh, kw)
    order (lax.conv_general_dilated_patches)."""
    kh, kw = _pair(kernel)
    ph, pw = _pair(padding)
    xc = F.pad(x.permute(0, 3, 1, 2), (pw, pw, ph, ph))
    sh, sw = _pair(strides)
    dh, dw = _pair(dilation)
    oh = (xc.shape[2] - (kh - 1) * dh - 1) // sh + 1
    ow = (xc.shape[3] - (kw - 1) * dw - 1) // sw + 1
    cols = F.unfold(xc, (kh, kw), dilation=(dh, dw), stride=(sh, sw))
    return cols.reshape(x.shape[0], -1, oh, ow)


@op("col2im", "conv")
def col2im(patches, output_shape, kernel, strides=(1, 1), padding=(0, 0),
           dilation=(1, 1)):
    """The adjoint of :func:`im2col`: patches summed back into the NHWC
    image ``output_shape``."""
    n, h, w, c = (int(s) for s in output_shape)
    ph, pw = _pair(padding)
    cols = patches.reshape(n, patches.shape[1], -1)
    img = F.fold(cols, (h + 2 * ph, w + 2 * pw), _pair(kernel),
                 dilation=_pair(dilation), stride=_pair(strides))
    return img[:, :, ph:ph + h, pw:pw + w].permute(0, 2, 3, 1)


@op("pnormpool2d", "pooling")
def pnorm_pool2d(x, kernel=(2, 2), strides=None, padding="VALID", p=2,
                 data_format="NHWC"):
    strides = _pair(strides or kernel)
    kernel = _pair(kernel)
    hw = x.shape[1:3] if data_format == "NHWC" else x.shape[2:4]
    pads = _pool_pads(padding, hw, kernel, strides)
    xc = _to_nchw_padded(torch.abs(x) ** p, pads, data_format, 0.0)
    s = F.avg_pool2d(xc, kernel, strides, divisor_override=1)
    return _from_nchw(s ** (1.0 / p), data_format)


@op("global_max_pool", "pooling", aliases=("globalmaxpool",))
def global_max_pool(x, data_format="NHWC", keepdims=False):
    dims = (1, 2) if data_format == "NHWC" else (2, 3)
    return torch.amax(x, dim=dims, keepdim=keepdims)


@op("maxpool3d", "pooling")
def max_pool3d(x, kernel=(2, 2, 2), strides=None, padding="VALID"):
    strides = tuple(strides or kernel)
    pads = _pads_nd(padding, x.shape[1:4], kernel, strides)
    xc = F.pad(x.movedim(-1, 1), _flat_pads(pads), value=float("-inf"))
    return F.max_pool3d(xc, tuple(kernel), strides).movedim(1, -1)


@op("avgpool3d", "pooling")
def avg_pool3d(x, kernel=(2, 2, 2), strides=None, padding="VALID"):
    strides = tuple(strides or kernel)
    pads = _pads_nd(padding, x.shape[1:4], kernel, strides)
    xc = F.pad(x.movedim(-1, 1), _flat_pads(pads))
    summed = F.avg_pool3d(xc, tuple(kernel), strides, divisor_override=1)
    if padding == "VALID":
        out = summed / (kernel[0] * kernel[1] * kernel[2])
    else:
        ones = F.pad(torch.ones((1, 1) + tuple(x.shape[1:4]), dtype=x.dtype,
                                device=x.device), _flat_pads(pads))
        out = summed / F.avg_pool3d(ones, tuple(kernel), strides,
                                    divisor_override=1)
    return out.movedim(1, -1)


@op("layernorm", "norm", aliases=("layer_norm",))
def layernorm(x, gamma=None, beta=None, eps=1e-5, axis=-1):
    xf = x.to(_acc_dtype(x))
    mean = xf.mean(dim=axis, keepdim=True)
    var = xf.var(dim=axis, keepdim=True, correction=0)
    out = (xf - mean) * torch.rsqrt(var + eps)
    if gamma is not None:
        out = out * gamma
    if beta is not None:
        out = out + beta
    return out.to(x.dtype)


@op("rmsnorm", "norm")
def rmsnorm(x, gamma=None, eps=1e-6, axis=-1):
    xf = x.to(_acc_dtype(x))
    out = xf * torch.rsqrt((xf * xf).mean(dim=axis, keepdim=True) + eps)
    if gamma is not None:
        out = out * gamma
    return out.to(x.dtype)


@op("standardize", "norm")
def standardize(x, axis=-1, eps=1e-5):
    mean = x.mean(dim=axis, keepdim=True)
    return (x - mean) / (x.std(dim=axis, keepdim=True, correction=0) + eps)


@op("lrn", "norm", aliases=("local_response_normalization",))
def lrn(x, depth_radius=5, bias=1.0, alpha=1.0, beta=0.5):
    """Local response normalization over the last (channel) axis."""
    sq = F.pad(x * x, (depth_radius, depth_radius))
    sums = sq.unfold(-1, 2 * depth_radius + 1, 1).sum(-1)
    return x / torch.pow(bias + alpha * sums, beta)


@op("l2_normalize", "norm")
def l2_normalize(x, axis=-1, eps=1e-12):
    return x * torch.rsqrt(torch.clamp_min(
        (x * x).sum(dim=axis, keepdim=True), eps))


@op("moments", "norm")
def moments(x, axes, keepdims=False):
    dims = tuple(axes) if not isinstance(axes, int) else (axes,)
    mean = x.mean(dim=dims, keepdim=True)
    var = torch.square(x - mean).mean(dim=dims, keepdim=True)
    if not keepdims:
        mean, var = mean.squeeze(dims), var.squeeze(dims)
    return mean, var


@op("softmax_derivative", "softmax")
def softmax_derivative(x, grad, axis=-1):
    s = torch.softmax(x, dim=axis)
    return s * (grad - (grad * s).sum(dim=axis, keepdim=True))


@op("l2_loss", "loss")
def l2_loss(x):
    return 0.5 * torch.sum(torch.square(x))


@op("ctc_loss", "loss")
def ctc_loss(log_probs, labels, logit_lengths, label_lengths, blank_id=0):
    """Mean CTC loss over the batch: log_probs (B, T, C) renormalized by
    a log-softmax (as optax treats its input as logits), the forward
    recursion per sequence."""
    lp = torch.log_softmax(log_probs.to(_acc_dtype(log_probs)), dim=-1)
    per = F.ctc_loss(lp.transpose(0, 1), labels.long(),
                     logit_lengths.long(), label_lengths.long(),
                     blank=blank_id, reduction="none")
    return per.mean()


@op("dot_product_attention", "attention")
def dot_product_attention(q, k, v, mask=None, scale=None, is_causal=False):
    """Scaled dot-product attention, the reference's ops/nn.py form (its
    last registration of the name): fp32 logits, -1e30 at masked entries,
    the softmax cast back to q's type before the product with v.
    q, k, v: [..., T, d]; ``mask`` a boolean (True = attend) broadcastable
    to the logits."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / float(d) ** 0.5
    acc = _acc_dtype(q)
    logits = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    neg = torch.tensor(-1e30, dtype=acc, device=q.device)
    if is_causal:
        tq, tk = logits.shape[-2], logits.shape[-1]
        causal = torch.tril(torch.ones((tq, tk), dtype=torch.bool,
                                       device=q.device), diagonal=tk - tq)
        logits = torch.where(causal, logits, neg)
    if mask is not None:
        logits = torch.where(mask.to(q.device).bool(), logits, neg)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(weights.to(acc), v.to(acc)).to(q.dtype)


@op("multihead_attention", "attention")
def multi_head_attention(x_q, x_kv, wq, wk, wv, wo, num_heads, mask=None,
                         is_causal=False):
    """Project, split heads, attend (:func:`dot_product_attention`),
    merge. x_q [B,Tq,D], x_kv [B,Tk,D]; wq/wk/wv [D, H*dh]; wo [H*dh, D]."""
    b, tq = x_q.shape[:2]

    def split(x, w):
        y = torch.matmul(x, w)
        return y.reshape(b, -1, num_heads, y.shape[-1] // num_heads) \
            .transpose(1, 2)

    ctx = dot_product_attention(split(x_q, wq), split(x_kv, wk),
                                split(x_kv, wv), mask=mask,
                                is_causal=is_causal)
    return torch.matmul(ctx.transpose(1, 2).reshape(b, tq, -1), wo)


@op("embedding_lookup", "nn_misc")
def embedding_lookup(table, ids):
    return shape_ops.take(table, ids, axis=0)


@op("bias_add", "nn_misc")
def bias_add(x, b, data_format="NHWC"):
    if data_format == "NCHW" and x.dim() == 4:
        return x + b.reshape(1, -1, 1, 1)
    return x + b


@op("batch_dot", "nn_misc")
def batch_dot(a, b):
    return torch.einsum("b...i,b...i->b", a, b)


@op("weighted_cross_entropy_with_logits", "loss")
def weighted_cross_entropy_with_logits(targets, logits, pos_weight):
    """TF semantics, elementwise: sigmoid CE with positive targets scaled
    by pos_weight."""
    z = logits.to(_acc_dtype(logits))
    tg = targets.to(_acc_dtype(targets))
    log1p = torch.log1p(torch.exp(-z.abs()))
    return ((1 - tg) * z + (1 + (pos_weight - 1) * tg)
            * (log1p + torch.clamp_min(-z, 0)))


# ------------------------------------------------------------- TF grad ops


@op("relu_grad", "transform_float", differentiable=False)
def relu_grad(dy, f):
    return dy * (f > 0).to(dy.dtype)


@op("relu6_grad", "transform_float", differentiable=False)
def relu6_grad(dy, f):
    return dy * ((f > 0) & (f < 6)).to(dy.dtype)


@op("tanh_grad", "transform_float", differentiable=False)
def tanh_grad(y, dy):
    """TF TanhGrad input order: (y, dy)."""
    return dy * (1.0 - y * y)


@op("sigmoid_grad", "transform_float", differentiable=False)
def sigmoid_grad(y, dy):
    return dy * y * (1.0 - y)


@op("bias_add_grad", "reduce", differentiable=False)
def bias_add_grad(dy, data_format="NHWC"):
    ax = (-1 if data_format.endswith("C") else 1) % dy.dim()
    return dy.sum(dim=tuple(i for i in range(dy.dim()) if i != ax))


def _nhwc(t, data_format):
    return t if data_format == "NHWC" else t.permute(0, 2, 3, 1)


@op("conv2d_backprop_input", "conv", differentiable=False)
def conv2d_backprop_input(w, dy, input_sizes, strides=(1, 1),
                          padding="SAME", dilation=(1, 1),
                          data_format="NHWC"):
    """dx of :func:`conv2d` for the output gradient dy (the reference's
    jax.vjp of conv2d): the dgrad kernel on a CUDA tensor, or raise; the
    plain version on the CPU or under ``exact``. Result in dy's type."""
    sizes = tuple(int(s) for s in input_sizes)
    dyh = _nhwc(dy, data_format).to(w.dtype)
    x_hw = sizes[1:3] if data_format == "NHWC" else sizes[2:4]
    strides_p, dil_p = _pair(strides), _pair(dilation)
    pads = _kconv.resolve_padding(padding, x_hw, (w.shape[0], w.shape[1]),
                                  strides_p, dil_p)
    geometry = (x_hw, strides_p, pads, dil_p, 1)
    if _kern.dispatch("conv2d_dgrad",
                      _kconv.supports_dgrad(dyh, w, 1, strides_p), dyh,
                      lambda: f"dy {tuple(dy.shape)} {dy.dtype}, w "
                              f"{tuple(w.shape)} {w.dtype}, strides "
                              f"{strides_p}"):
        dx = _kconv.conv2d_dgrad(dyh.contiguous(), w.contiguous(), *geometry)
    else:
        dx = _kconv.conv2d_dgrad_reference(dyh, w, *geometry)
    dx = dx.to(dy.dtype)
    return dx if data_format == "NHWC" else dx.permute(0, 3, 1, 2)


@op("conv2d_backprop_filter", "conv", differentiable=False)
def conv2d_backprop_filter(x, dy, filter_sizes, strides=(1, 1),
                           padding="SAME", dilation=(1, 1),
                           data_format="NHWC"):
    """dW of :func:`conv2d` for the output gradient dy: the wgrad kernel
    on a CUDA tensor, or raise; the plain version on the CPU or under
    ``exact``. Result in dy's type."""
    kh, kw = (int(s) for s in tuple(filter_sizes)[:2])
    xh, dyh = _nhwc(x, data_format), _nhwc(dy, data_format)
    strides_p, dil_p = _pair(strides), _pair(dilation)
    pads = _kconv.resolve_padding(padding, (xh.shape[1], xh.shape[2]),
                                  (kh, kw), strides_p, dil_p)
    geometry = (kh, kw, strides_p, pads, dil_p, 1)
    if _kern.dispatch("conv2d_wgrad", _kconv.supports_wgrad(xh, dyh, 1), xh,
                      lambda: f"x {tuple(x.shape)} {x.dtype}, dy "
                              f"{tuple(dy.shape)} {dy.dtype}"):
        dw = _kconv.conv2d_wgrad(xh.contiguous(), dyh.contiguous(),
                                 *geometry)
    else:
        dw = _kconv.conv2d_wgrad_reference(xh, dyh, *geometry)
    return dw.to(dy.dtype)


def _vjp(fn, x, dy):
    with torch.enable_grad():
        xx = x.detach().requires_grad_(True)
        return torch.autograd.grad(fn(xx), xx, dy)[0]


@op("maxpool2d_grad", "pooling", differentiable=False)
def maxpool2d_grad(x, dy, kernel=(2, 2), strides=(2, 2), padding="VALID",
                   data_format="NHWC"):
    return _vjp(lambda v: max_pool2d(v, kernel=kernel, strides=strides,
                                     padding=padding,
                                     data_format=data_format), x, dy)


@op("avgpool2d_grad", "pooling", differentiable=False)
def avgpool2d_grad(x, dy, kernel=(2, 2), strides=(2, 2), padding="VALID",
                   data_format="NHWC"):
    return _vjp(lambda v: avg_pool2d(v, kernel=kernel, strides=strides,
                                     padding=padding,
                                     data_format=data_format), x, dy)


@op("fused_batch_norm_grad", "norm", differentiable=False)
def fused_batch_norm_grad(dy, x, scale, mean_in, var_in, epsilon=1e-3,
                          is_training=True):
    """FusedBatchNormGrad -> (dx, dscale, doffset), NHWC, fp32 sums; the
    training form recomputes the batch moments from x."""
    acc = _acc_dtype(x)
    xf, dyf = x.to(acc), dy.to(acc)
    red = tuple(range(x.dim() - 1))
    n = 1.0
    for i in red:
        n *= x.shape[i]
    if is_training:
        mean = xf.sum(dim=red) / n
        var = torch.clamp_min((xf * xf).sum(dim=red) / n - mean * mean, 0.0)
    else:
        mean, var = mean_in.to(acc), var_in.to(acc)
    inv = torch.rsqrt(var + epsilon)
    xhat = (xf - mean) * inv
    dsum, dxhat_sum = dyf.sum(dim=red), (dyf * xhat).sum(dim=red)
    if is_training:
        dx = (scale.to(acc) * inv / n) * (n * dyf - dsum - xhat * dxhat_sum)
    else:
        dx = dyf * scale.to(acc) * inv
    return (dx.to(x.dtype), dxhat_sum.to(scale.dtype),
            dsum.to(scale.dtype))


@op("softmax_cross_entropy_with_logits_grad", "loss", differentiable=False)
def softmax_cross_entropy_with_logits_grad(logits, labels):
    """(per-example loss, backprop)."""
    log_softmax = logits - torch.logsumexp(logits, dim=-1, keepdim=True)
    return (-(labels * log_softmax).sum(dim=-1),
            torch.exp(log_softmax) - labels)


@op("strided_slice_grad", "gather_scatter", differentiable=False)
def strided_slice_grad(dy, shape, spec):
    """dy scattered into zeros(shape) at the slice the forward took;
    ``spec`` entries: ("e",) ellipsis, ("n",) new axis, ("i", i) shrink,
    ("s", b, e, st) slice."""
    if any(s[0] == "e" for s in spec) and any(s[0] == "n" for s in spec):
        raise NotImplementedError("StridedSliceGrad with ellipsis + new_axis")
    squeeze, dy_axis = [], 0
    for s in spec:
        if s[0] == "n":
            squeeze.append(dy_axis)
            dy_axis += 1
        elif s[0] in ("s", "e"):
            dy_axis += 1
    if squeeze:
        dy = dy.squeeze(tuple(squeeze))
    idx = tuple(Ellipsis if s[0] == "e" else s[1] if s[0] == "i"
                else slice(s[1], s[2], s[3]) for s in spec if s[0] != "n")
    out = torch.zeros(tuple(int(d) for d in shape), dtype=dy.dtype,
                      device=dy.device)
    out[idx] = dy
    return out


@op("normalize_moments", "norm", differentiable=False)
def normalize_moments(counts, mean_ss, variance_ss, shift=None):
    divisor = 1.0 / counts
    shifted_mean = mean_ss * divisor
    mean = shifted_mean + shift if shift is not None else shifted_mean
    return mean, variance_ss * divisor - shifted_mean * shifted_mean


@op("log_poisson_loss", "loss")
def log_poisson_loss(log_input, targets, compute_full_loss=False):
    """exp(c) - z c, plus Stirling's term when full."""
    loss = torch.exp(log_input) - targets * log_input
    if compute_full_loss:
        stirling = (targets * torch.log(torch.clamp_min(targets, 1e-12))
                    - targets + 0.5 * torch.log(
                        2.0 * torch.pi * torch.clamp_min(targets, 1.0)))
        loss = loss + torch.where(targets >= 1.0, stirling, 0.0)
    return loss


def _patches2d(x, kh, kw, strides, rates, padding):
    """(B, OH, OW, kh*kw, C) window view and the pads, by shifted strided
    slices of the padded image."""
    sh, sw = strides
    rh, rw = rates
    b, h, w, c = x.shape
    eff_kh, eff_kw = (kh - 1) * rh + 1, (kw - 1) * rw + 1
    if padding == "SAME":
        ho, wo = -(-h // sh), -(-w // sw)
        pad_h = max((ho - 1) * sh + eff_kh - h, 0)
        pad_w = max((wo - 1) * sw + eff_kw - w, 0)
        pads = ((0, 0), (pad_h // 2, pad_h - pad_h // 2),
                (pad_w // 2, pad_w - pad_w // 2), (0, 0))
    else:
        ho, wo = (h - eff_kh) // sh + 1, (w - eff_kw) // sw + 1
        pads = ((0, 0), (0, 0), (0, 0), (0, 0))
    neg = (float("-inf") if x.is_floating_point()
           else torch.iinfo(x.dtype).min)
    xp = F.pad(x, (0, 0, pads[2][0], pads[2][1], pads[1][0], pads[1][1]),
               value=neg)
    cols = [xp[:, dy * rh:dy * rh + (ho - 1) * sh + 1:sh,
               dx * rw:dx * rw + (wo - 1) * sw + 1:sw]
            for dy in range(kh) for dx in range(kw)]
    return torch.stack(cols, dim=3), pads


@op("dilation2d", "conv")
def dilation2d(x, filter, strides=(1, 1), rates=(1, 1), padding="SAME"):
    """Grayscale morphological dilation: max over the window of
    (x + filter); filter (kh, kw, C)."""
    filt = filter.to(x.dtype)
    kh, kw, _ = filt.shape
    pat, _ = _patches2d(x, kh, kw, _pair(strides), _pair(rates), padding)
    return torch.amax(pat + filt.reshape(1, 1, 1, kh * kw, -1), dim=3)


@op("erosion2d", "conv")
def erosion2d(x, filter, strides=(1, 1), rates=(1, 1), padding="SAME"):
    """erosion(x, f) = -dilation(-x, reverse(f))."""
    return -dilation2d(-x, filter.to(x.dtype).flip(0, 1), strides=strides,
                       rates=rates, padding=padding)


@op("max_pool_with_argmax", "pooling", differentiable=False)
def max_pool_with_argmax(x, kernel=(2, 2), strides=None, padding="VALID",
                         include_batch_in_index=False):
    """(values, int32 argmax) with TF's flat index ((b*H + y)*W + x)*C + c
    (the b term only with ``include_batch_in_index``)."""
    kh, kw = _pair(kernel)
    strides = _pair(strides if strides is not None else kernel)
    b, h, w, c = x.shape
    pat, pads = _patches2d(x, kh, kw, strides, (1, 1), padding)
    vals = torch.amax(pat, dim=3)
    arg = torch.argmax(pat, dim=3)
    ho, wo = arg.shape[1], arg.shape[2]
    dev = x.device
    oy = (torch.arange(ho, device=dev).reshape(1, ho, 1, 1) * strides[0]
          - pads[1][0])
    ox = (torch.arange(wo, device=dev).reshape(1, 1, wo, 1) * strides[1]
          - pads[2][0])
    iy = torch.clamp(oy + arg // kw, 0, h - 1)
    ix = torch.clamp(ox + arg % kw, 0, w - 1)
    flat = (iy * w + ix) * c + torch.arange(c, device=dev).reshape(1, 1, 1, c)
    if include_batch_in_index:
        flat = flat + torch.arange(b, device=dev).reshape(b, 1, 1, 1) * (
            h * w * c)
    return vals, flat.to(torch.int32)


@op("deconv3d", "conv", aliases=("conv3d_transpose",))
def deconv3d(x, w, b=None, strides=(1, 1, 1), padding="SAME"):
    """3-D transposed convolution, NDHWC; w [kD,kH,kW,C,Cout]."""
    strides = (strides,) * 3 if isinstance(strides, int) else tuple(strides)
    if len(strides) != 3:
        raise ValueError(f"deconv3d strides must be length 3, got {strides}")
    out = _deconv(x, w, strides, padding, 3)
    if b is not None:
        out = out + b.reshape(1, 1, 1, 1, -1).to(out.dtype)
    return out


@op("upsampling3d", "conv")
def upsampling3d(x, scale=2):
    sd, sh, sw = (scale,) * 3 if isinstance(scale, int) else tuple(scale)
    return (x.repeat_interleave(sd, dim=1).repeat_interleave(sh, dim=2)
            .repeat_interleave(sw, dim=3))


@op("relu_layer", "nn_misc")
def relu_layer(x, w, b=None):
    y = x @ w
    if b is not None:
        y = y + b
    return torch.relu(y)


@op("mean_pairwssqerr_loss", "loss")
def mean_pairwssqerr_loss(predictions, labels, weights=None):
    """Per sample, the mean over ordered pairs (i != j) of
    (d_i - d_j)^2 / 2, d = prediction - label."""
    acc = _acc_dtype(predictions)
    d = (predictions.to(acc) - labels.to(acc)).reshape(
        predictions.shape[0], -1)
    n = d.shape[1]
    if n < 2:
        return torch.zeros((), dtype=acc, device=d.device)
    per = (n * (d * d).sum(dim=1) - torch.square(d.sum(dim=1))) / (
        n * (n - 1))
    return _weighted_mean(per, weights)


@op("ctc_beam_search_decoder", "decoder", differentiable=False)
def ctc_beam_search_decoder(log_probs, sequence_lengths=None, beam_width=16,
                            top_paths=1, blank_index=0):
    """CTC prefix beam search on the host (a serving-path utility, as in
    the reference). log_probs (B, T, C). Returns (a length-B list of up to
    ``top_paths`` label lists, a (B, top_paths) float32 numpy array of
    path log-probabilities)."""
    import numpy as _np

    lp = _np.asarray(log_probs.detach().cpu().double().numpy()
                     if isinstance(log_probs, torch.Tensor) else log_probs,
                     _np.float64)
    bsz, tmax, _ = lp.shape
    if sequence_lengths is None:
        sequence_lengths = [tmax] * bsz
    if isinstance(sequence_lengths, torch.Tensor):
        sequence_lengths = sequence_lengths.cpu().numpy()
    sequence_lengths = _np.asarray(sequence_lengths)
    neg = -_np.inf

    def lse(a, b):
        if a == neg:
            return b
        if b == neg:
            return a
        m = max(a, b)
        return m + _np.log(_np.exp(a - m) + _np.exp(b - m))

    all_paths, all_logp = [], []
    for b in range(bsz):
        beams = {(): (0.0, neg)}
        for t in range(int(sequence_lengths[b])):
            step = lp[b, t]
            new = {}
            for prefix, (pb, pnb) in beams.items():
                total = lse(pb, pnb)
                nb, nn = new.get(prefix, (neg, neg))
                new[prefix] = (lse(nb, total + step[blank_index]), nn)
                if prefix:
                    last = prefix[-1]
                    nb, nn = new.get(prefix, (neg, neg))
                    new[prefix] = (nb, lse(nn, pnb + step[last]))
                for s in _np.argsort(step)[::-1][:beam_width]:
                    s = int(s)
                    if s == blank_index:
                        continue
                    ext = prefix + (s,)
                    nb, nn = new.get(ext, (neg, neg))
                    if prefix and s == prefix[-1]:
                        new[ext] = (nb, lse(nn, pb + step[s]))
                    else:
                        new[ext] = (nb, lse(nn, total + step[s]))
            ranked = sorted(new.items(), key=lambda kv: -lse(*kv[1]))
            beams = dict(ranked[:beam_width])
        ranked = sorted(beams.items(), key=lambda kv: -lse(*kv[1]))[
            :top_paths]
        all_paths.append([list(p) for p, _ in ranked])
        row = [lse(*v) for _, v in ranked]
        row += [neg] * (top_paths - len(row))
        all_logp.append(row)
    return all_paths, _np.asarray(all_logp, _np.float32)


@op("nll_loss", "loss")
def nll_loss(log_probs, target, weight=None, reduction="mean",
             ignore_index=None):
    """Negative log-likelihood over class axis 1 (ONNX
    NegativeLogLikelihoodLoss); the mean is weight-normalized and an
    all-ignored batch gives 0."""
    lp = log_probs.to(_acc_dtype(log_probs))
    target = target.long()
    safe = torch.clamp(target, 0, lp.shape[1] - 1)
    picked = -torch.gather(lp, 1, safe.unsqueeze(1))[:, 0]
    w_el = (weight.to(lp.dtype)[safe] if weight is not None
            else torch.ones_like(picked))
    if ignore_index is not None:
        w_el = w_el * (target != ignore_index).to(lp.dtype)
    picked = picked * w_el
    if reduction == "none":
        return picked
    if reduction == "sum":
        return picked.sum()
    w_sum = w_el.sum()
    return torch.where(w_sum > 0, picked.sum() / torch.clamp_min(w_sum,
                                                                 1e-12),
                       torch.zeros((), dtype=lp.dtype, device=lp.device))


@op("max_unpool2d", "pooling", differentiable=False)
def max_unpool2d(x, indices, output_shape):
    """Pooled values scattered to their row-major flat positions in the
    full output; the rest zero."""
    total = 1
    for s in output_shape:
        total *= int(s)
    flat = torch.zeros(total, dtype=x.dtype, device=x.device)
    flat[indices.reshape(-1).long()] = x.reshape(-1)
    return flat.reshape(tuple(int(s) for s in output_shape))
