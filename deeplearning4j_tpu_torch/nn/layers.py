"""Layer configurations and their forward functions (counterpart of
deeplearning4j_tpu/nn/layers.py), all eighteen of its classes.

As in the reference, one frozen dataclass per layer carries the config and
the functions (``initialize``, ``apply``, ``output_shape``); its fields and
defaults are the reference's, field for field, so a conf JSON moves between
the two packages unchanged. Params and state are plain dicts of tensors
keyed as the reference keys them (``W``, ``b``, ``gamma``, ``beta``,
``mean``, ``var``).

SeparableConvolution2D's depthwise half is ``ops.nn.conv2d`` with one group
per channel and its pointwise half a 1x1 conv, so on a CUDA tensor both
launch the conv kernel (K1; dgrad and K3 in training). Deconvolution2D is
``ops.nn.deconv2d`` (the reference's ``lax.conv_transpose``, no Pallas
kernel there). SharedLayer owns no params: ComputationGraph applies its
``layer`` with the params of the node named ``source``.

Conventions: shapes exclude the batch dimension; CNN data is NHWC, so
``input_shape`` is (H, W, C). ``apply`` returns (output, new_state).

``training=True`` gives batchnorm its batch statistics and EMA update
(``ops.nn.batchnorm_train``); ``OutputLayer.compute_loss`` is the loss
head of ``fit`` and ``score``; ``regularization`` is the l1/l2 penalty on
weights. ``dropout`` is the input dropout rate (``Layer._maybe_dropout``,
``ops/random.py``), applied where the reference applies it (the dense and
conv layers' ``apply``, the output layers' ``compute_loss``, the recurrent
layers) in training only, drawing from the network's ``gen``: the
``torch.Generator`` in place of the reference's ``key``. The inference
forward and ``output(train=True)`` pass none and apply no dropout, as in
the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from deeplearning4j_tpu_torch.nn import activations as act
from deeplearning4j_tpu_torch.nn import losses as losses_mod
from deeplearning4j_tpu_torch.nn import weights as winit
from deeplearning4j_tpu_torch.ops import nn as nnops
from deeplearning4j_tpu_torch.ops import random as randops
from deeplearning4j_tpu_torch.tree import tree_items

_LAYER_TYPES: Dict[str, type] = {}


def register_layer(cls):
    _LAYER_TYPES[cls.__name__] = cls
    return cls


def layer_from_dict(d: dict) -> "Layer":
    d = dict(d)
    kind = d.pop("@layer")
    cls = _LAYER_TYPES.get(kind)
    if cls is None:
        raise KeyError(f"layer type {kind!r} is not ported yet; ported: "
                       f"{sorted(_LAYER_TYPES)}")
    for k, v in list(d.items()):
        if isinstance(v, dict) and "@layer" in v:  # a wrapper's layer
            d[k] = layer_from_dict(v)
    return cls(**d)


@dataclasses.dataclass(frozen=True)
class Layer:
    """Base layer config. ``updater`` is kept as the reference's updater
    dict (``{"@updater": "Adam", ...}``): the node's own learning rule, in
    place of the conf's."""

    name: Optional[str] = None
    dropout: float = 0.0  # input dropout rate, applied only in training
    l1: float = 0.0
    l2: float = 0.0
    updater: Optional[Any] = None

    def initialize(self, gen: torch.Generator, input_shape):
        """-> (params, state) as CPU tensors."""
        return {}, {}

    def apply(self, params, state, x, *, training=False, gen=None):
        raise NotImplementedError

    def output_shape(self, input_shape):
        return tuple(input_shape)

    def has_params(self) -> bool:
        return True

    def _maybe_dropout(self, x, training, gen):
        """Input dropout at ``self.dropout`` in training, when the network
        passed its generator (reference ``nn/layers.py:121``)."""
        if training and self.dropout > 0.0 and gen is not None:
            return randops.dropout(x, gen, self.dropout, training=True)
        return x

    def regularization(self, params):
        """L1/L2 penalty on weight params (DL4J applies it to W, not biases
        or batchnorm params), summed in the params' type; 0.0 when the
        layer has neither. It walks nested params (Bidirectional's fwd/bwd)
        with this layer's own rates, as the reference's does, so the bias
        rule sees leaf names only."""
        reg = 0.0
        if not (self.l1 or self.l2):
            return reg
        for path, p in tree_items(params):
            name = path[-1]
            if name.startswith("b") or name in ("gamma", "beta", "mean",
                                                "var"):
                continue
            if self.l1:
                reg = reg + self.l1 * p.abs().sum()
            if self.l2:
                reg = reg + 0.5 * self.l2 * (p * p).sum()
        return reg

    def to_dict(self) -> dict:
        d = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        d["@layer"] = type(self).__name__
        return d


@register_layer
@dataclasses.dataclass(frozen=True)
class DenseLayer(Layer):
    """Fully connected layer (conf/layers/DenseLayer.java)."""

    n_in: int = 0
    n_out: int = 0
    activation: str = "identity"
    weight_init: str = "xavier"
    has_bias: bool = True

    def initialize(self, gen, input_shape):
        n_in = self.n_in
        if not n_in:
            n_in = 1
            for s in input_shape:
                n_in *= int(s)
        params = {"W": winit.init(gen, self.weight_init, (n_in, self.n_out))}
        if self.has_bias:
            params["b"] = torch.zeros((self.n_out,))
        return params, {}

    def _dense(self, params, x):
        if x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        b = params.get("b")
        if b is None:
            b = torch.zeros(params["W"].shape[1], dtype=x.dtype,
                            device=x.device)
        return nnops.xw_plus_b(x, params["W"], b)

    def apply(self, params, state, x, *, training=False, gen=None):
        x = self._maybe_dropout(x, training, gen)
        return act.resolve(self.activation)(self._dense(params, x)), state

    def output_shape(self, input_shape):
        return (self.n_out,)


@register_layer
@dataclasses.dataclass(frozen=True)
class ConvolutionLayer(Layer):
    """2-D convolution (conf/layers/ConvolutionLayer.java); the forward is
    ``ops.nn.conv2d``, i.e. the CUDA conv kernel on the card."""

    n_in: int = 0  # input channels (inferred if 0)
    n_out: int = 0
    kernel_size: tuple = (3, 3)
    stride: tuple = (1, 1)
    padding: Any = "SAME"  # 'SAME' | 'VALID' | (ph, pw)
    dilation: tuple = (1, 1)
    activation: str = "identity"
    weight_init: str = "relu"
    has_bias: bool = True

    def initialize(self, gen, input_shape):
        c_in = self.n_in or input_shape[-1]
        kh, kw = self.kernel_size
        params = {"W": winit.init(gen, self.weight_init,
                                  (kh, kw, c_in, self.n_out))}
        if self.has_bias:
            params["b"] = torch.zeros((self.n_out,))
        return params, {}

    def apply(self, params, state, x, *, training=False, gen=None):
        x = self._maybe_dropout(x, training, gen)
        y = nnops.conv2d(x, params["W"], params.get("b"),
                         strides=self.stride, padding=self.padding,
                         dilation=self.dilation)
        return act.resolve(self.activation)(y), state

    def output_shape(self, input_shape):
        h, w, _ = input_shape
        kh, kw = self.kernel_size
        sh, sw = self.stride
        if self.padding == "SAME":
            oh, ow = -(-h // sh), -(-w // sw)
        elif self.padding == "VALID":
            eff_kh = (kh - 1) * self.dilation[0] + 1
            eff_kw = (kw - 1) * self.dilation[1] + 1
            oh, ow = (h - eff_kh) // sh + 1, (w - eff_kw) // sw + 1
        else:
            ph, pw = (self.padding if not isinstance(self.padding, int)
                      else (self.padding,) * 2)
            oh = (h + 2 * ph - kh) // sh + 1
            ow = (w + 2 * pw - kw) // sw + 1
        return (oh, ow, self.n_out)


@register_layer
@dataclasses.dataclass(frozen=True)
class SubsamplingLayer(Layer):
    """Pooling (conf/layers/SubsamplingLayer.java): pooling_type MAX | AVG |
    PNORM (``(sum |x|^p)^(1/p)`` over each window, ``ops.nn.pnorm_pool2d``)."""

    kernel_size: tuple = (2, 2)
    stride: Optional[tuple] = None
    padding: Any = "VALID"
    pooling_type: str = "max"
    pnorm: int = 2

    def apply(self, params, state, x, *, training=False, gen=None):
        strides = self.stride or self.kernel_size
        pt = self.pooling_type.lower()
        if pt == "max":
            y = nnops.max_pool2d(x, self.kernel_size, strides, self.padding)
        elif pt in ("avg", "average"):
            y = nnops.avg_pool2d(x, self.kernel_size, strides, self.padding)
        elif pt == "pnorm":
            y = nnops.pnorm_pool2d(x, self.kernel_size, strides,
                                   self.padding, p=self.pnorm)
        else:
            raise ValueError(f"unknown pooling_type {self.pooling_type}")
        return y, state

    def output_shape(self, input_shape):
        h, w, c = input_shape
        kh, kw = self.kernel_size
        sh, sw = self.stride or self.kernel_size
        if self.padding == "SAME":
            return (-(-h // sh), -(-w // sw), c)
        if self.padding == "VALID":
            return ((h - kh) // sh + 1, (w - kw) // sw + 1, c)
        ph, pw = self.padding
        return ((h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1, c)


@register_layer
@dataclasses.dataclass(frozen=True)
class BatchNormalization(Layer):
    """Batch norm over the channel axis (conf/layers/BatchNormalization.java).
    Params gamma/beta, state running mean/var (an EMA with ``decay``)."""

    n_out: int = 0  # channels (inferred if 0)
    decay: float = 0.9
    eps: float = 1e-5
    gamma_init: float = 1.0
    beta_init: float = 0.0
    lock_gamma_beta: bool = False

    def initialize(self, gen, input_shape):
        c = self.n_out or input_shape[-1]
        params = {}
        if not self.lock_gamma_beta:
            params = {"gamma": torch.full((c,), float(self.gamma_init)),
                      "beta": torch.full((c,), float(self.beta_init))}
        state = {"mean": torch.zeros((c,)), "var": torch.ones((c,))}
        return params, state

    def apply(self, params, state, x, *, training=False, gen=None):
        gamma, beta = params.get("gamma"), params.get("beta")
        if training:
            y, new_mean, new_var = nnops.batchnorm_train(
                x, gamma, beta, state["mean"], state["var"],
                momentum=self.decay, eps=self.eps)
            return y, {"mean": new_mean, "var": new_var}
        y = nnops.batchnorm(x, state["mean"], state["var"], gamma, beta,
                            eps=self.eps)
        return y, state


@register_layer
@dataclasses.dataclass(frozen=True)
class ActivationLayer(Layer):
    """Standalone activation (conf/layers/ActivationLayer.java)."""

    activation: str = "relu"
    activation_args: Optional[dict] = None

    def apply(self, params, state, x, *, training=False, gen=None):
        fn = act.resolve(self.activation)
        if self.activation_args:
            return fn(x, **self.activation_args), state
        return fn(x), state


@register_layer
@dataclasses.dataclass(frozen=True)
class GlobalPoolingLayer(Layer):
    """Global pooling (conf/layers/GlobalPoolingLayer.java, reference
    ``nn/layers.py:327``): over the spatial axes of CNN (B, H, W, C) input,
    and over time for recurrent (B, T, F) input, where a (B, T) mask keeps
    the masked steps out (the max fills them with the type's lowest
    value, and an all-masked row of ``avg`` divides by 1e-9)."""

    pooling_type: str = "avg"
    pnorm: int = 2

    def apply(self, params, state, x, *, training=False, gen=None,
              mask=None):
        pt = self.pooling_type.lower()
        if pt not in ("avg", "max", "sum", "pnorm"):
            raise ValueError(f"unknown pooling_type {self.pooling_type!r}")
        if x.dim() == 3 and mask is not None:
            m = mask[:, :, None].to(x.dtype)
            if pt == "avg":
                return (x * m).sum(dim=1) / torch.clamp(m.sum(dim=1),
                                                        min=1e-9), state
            if pt == "sum":
                return (x * m).sum(dim=1), state
            if pt == "pnorm":
                return torch.pow(torch.pow(x.abs() * m, self.pnorm).sum(
                    dim=1), 1.0 / self.pnorm), state
            low = torch.finfo(x.dtype).min
            return torch.where(m > 0, x, x.new_full((), low)).amax(
                dim=1), state
        axes = tuple(range(1, x.dim() - 1))  # time, or the spatial axes
        if pt == "avg":
            return x.mean(dim=axes), state
        if pt == "sum":
            return x.sum(dim=axes), state
        if pt == "pnorm":
            return torch.pow(torch.pow(x.abs(), self.pnorm).sum(dim=axes),
                             1.0 / self.pnorm), state
        return x.amax(dim=axes), state

    def output_shape(self, input_shape):
        return (input_shape[-1],)


@register_layer
@dataclasses.dataclass(frozen=True)
class OutputLayer(DenseLayer):
    """Dense + loss head (conf/layers/OutputLayer.java). Its inference
    forward is the dense product followed by the activation; the loss
    pairs with the activation for the fused logits path when it can
    (softmax + MCXENT)."""

    loss: str = "mcxent"
    activation: str = "softmax"

    def compute_loss(self, params, state, x, labels, *, training=True,
                     gen=None, weights=None):
        """Loss from the layer's INPUT x (pre-dense), a scalar: the fused
        logits path when the activation matches the loss's pair."""
        x = self._maybe_dropout(x, training, gen)
        if x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        logits = self._dense(params, x)
        logits_fn, act_fn, fused_act = losses_mod.resolve(self.loss)
        if logits_fn is not None and fused_act == self.activation.lower():
            return logits_fn(logits, labels, weights)
        if act_fn is None:
            raise ValueError(f"loss {self.loss} requires activation "
                             f"{fused_act}")
        return act_fn(act.resolve(self.activation)(logits), labels,
                      weights=weights)


@register_layer
@dataclasses.dataclass(frozen=True)
class DropoutLayer(Layer):
    """Standalone dropout (conf/layers/DropoutLayer.java, reference
    ``nn/layers.py:316``): at ``rate`` in training, from the network's
    generator; identity otherwise."""

    rate: float = 0.5

    def apply(self, params, state, x, *, training=False, gen=None):
        if training and gen is not None:
            x = randops.dropout(x, gen, self.rate, training=True)
        return x, state


@register_layer
@dataclasses.dataclass(frozen=True)
class EmbeddingLayer(Layer):
    """Index -> vector lookup (conf/layers/EmbeddingLayer.java, reference
    ``:391``); the input holds integer ids (any numeric type)."""

    n_in: int = 0  # vocabulary
    n_out: int = 0  # dimension
    weight_init: str = "normal"

    def initialize(self, gen, input_shape):
        return {"W": winit.init(gen, self.weight_init,
                                (self.n_in, self.n_out))}, {}

    def apply(self, params, state, x, *, training=False, gen=None):
        return nnops.embedding_lookup(params["W"], x.to(torch.long)), state

    def output_shape(self, input_shape):
        return tuple(input_shape) + (self.n_out,)


@register_layer
@dataclasses.dataclass(frozen=True)
class LossLayer(Layer):
    """Loss-only head without params (conf/layers/LossLayer.java, reference
    ``:438``). The row weights go to the loss by keyword, as OutputLayer's
    do (the reference passes them positionally, where huber's third
    argument is its delta: ROADMAP Queue 3)."""

    loss: str = "mse"
    activation: str = "identity"

    def apply(self, params, state, x, *, training=False, gen=None):
        return act.resolve(self.activation)(x), state

    def compute_loss(self, params, state, x, labels, *, training=True,
                     gen=None, weights=None):
        logits_fn, act_fn, fused_act = losses_mod.resolve(self.loss)
        if logits_fn is not None and fused_act == self.activation.lower():
            return logits_fn(x, labels, weights)
        if act_fn is None:
            raise ValueError(f"loss {self.loss} requires activation "
                             f"{fused_act}")
        return act_fn(act.resolve(self.activation)(x), labels,
                      weights=weights)


@register_layer
@dataclasses.dataclass(frozen=True)
class ZeroPaddingLayer(Layer):
    """Zeros around the spatial axes (conf/layers/ZeroPaddingLayer.java,
    reference ``:462``): ``padding`` ((top, bottom), (left, right))."""

    padding: tuple = ((1, 1), (1, 1))

    def apply(self, params, state, x, *, training=False, gen=None):
        (pt, pb), (pl, pr) = self.padding
        return torch.nn.functional.pad(x, (0, 0, pl, pr, pt, pb)), state

    def output_shape(self, input_shape):
        h, w, c = input_shape
        (pt, pb), (pl, pr) = self.padding
        return (h + pt + pb, w + pl + pr, c)


@register_layer
@dataclasses.dataclass(frozen=True)
class Upsampling2D(Layer):
    """Nearest-neighbour upsampling by ``size`` (conf/layers/
    Upsampling2D.java, reference ``:482``)."""

    size: int = 2

    def apply(self, params, state, x, *, training=False, gen=None):
        return nnops.upsampling2d(x, self.size), state

    def output_shape(self, input_shape):
        h, w, c = input_shape
        return (h * self.size, w * self.size, c)


@register_layer
@dataclasses.dataclass(frozen=True)
class Deconvolution2D(Layer):
    """Transposed convolution (conf/layers/Deconvolution2D.java, reference
    ``:500``): W (kh, kw, Cin, Cout), ``ops.nn.deconv2d``."""

    n_in: int = 0
    n_out: int = 0
    kernel_size: tuple = (2, 2)
    stride: tuple = (2, 2)
    padding: Any = "SAME"
    activation: str = "identity"
    weight_init: str = "relu"
    has_bias: bool = True

    def initialize(self, gen, input_shape):
        c_in = self.n_in or input_shape[-1]
        kh, kw = self.kernel_size
        params = {"W": winit.init(gen, self.weight_init,
                                  (kh, kw, c_in, self.n_out))}
        if self.has_bias:
            params["b"] = torch.zeros((self.n_out,))
        return params, {}

    def apply(self, params, state, x, *, training=False, gen=None):
        x = self._maybe_dropout(x, training, gen)
        y = nnops.deconv2d(x, params["W"], params.get("b"),
                           strides=self.stride, padding=self.padding)
        return act.resolve(self.activation)(y), state

    def output_shape(self, input_shape):
        h, w, _ = input_shape
        sh, sw = self.stride
        if self.padding == "SAME":
            return (h * sh, w * sw, self.n_out)
        kh, kw = self.kernel_size
        return ((h - 1) * sh + kh, (w - 1) * sw + kw, self.n_out)


@register_layer
@dataclasses.dataclass(frozen=True)
class SeparableConvolution2D(Layer):
    """Depthwise then pointwise conv (conf/layers/
    SeparableConvolution2D.java, reference ``:538``; Xception's block):
    ``depthW`` (kh, kw, Cin, depth_multiplier), ``pointW`` (1, 1,
    Cin * depth_multiplier, Cout), ``b``; ``ops.nn.separable_conv2d``,
    the conv kernel twice on a CUDA tensor (groups = Cin, then 1)."""

    n_in: int = 0
    n_out: int = 0
    kernel_size: tuple = (3, 3)
    stride: tuple = (1, 1)
    padding: Any = "SAME"
    depth_multiplier: int = 1
    activation: str = "identity"
    weight_init: str = "relu"
    has_bias: bool = True

    def initialize(self, gen, input_shape):
        c_in = self.n_in or input_shape[-1]
        kh, kw = self.kernel_size
        mult = self.depth_multiplier
        params = {
            "depthW": winit.init(gen, self.weight_init, (kh, kw, c_in, mult)),
            "pointW": winit.init(gen, self.weight_init,
                                 (1, 1, c_in * mult, self.n_out))}
        if self.has_bias:
            params["b"] = torch.zeros((self.n_out,))
        return params, {}

    def apply(self, params, state, x, *, training=False, gen=None):
        x = self._maybe_dropout(x, training, gen)
        y = nnops.separable_conv2d(x, params["depthW"], params["pointW"],
                                   params.get("b"), strides=self.stride,
                                   padding=self.padding)
        return act.resolve(self.activation)(y), state

    def output_shape(self, input_shape):
        h, w, _ = input_shape
        sh, sw = self.stride
        if self.padding == "SAME":
            return (-(-h // sh), -(-w // sw), self.n_out)
        kh, kw = self.kernel_size
        return ((h - kh) // sh + 1, (w - kw) // sw + 1, self.n_out)


@register_layer
@dataclasses.dataclass(frozen=True)
class LocalResponseNormalization(Layer):
    """Cross-channel LRN (conf/layers/LocalResponseNormalization.java,
    reference ``:583``): a window of ``n`` channels (radius n // 2)."""

    n: int = 5
    k: float = 2.0
    alpha: float = 1e-4
    beta: float = 0.75

    def apply(self, params, state, x, *, training=False, gen=None):
        return nnops.lrn(x, depth_radius=self.n // 2, bias=self.k,
                         alpha=self.alpha, beta=self.beta), state


@register_layer
@dataclasses.dataclass(frozen=True)
class Cropping2D(Layer):
    """Crop the spatial axes (conf/layers/convolutional/Cropping2D.java,
    reference ``:603``): ``cropping`` ((top, bottom), (left, right))."""

    cropping: tuple = ((0, 0), (0, 0))

    def apply(self, params, state, x, *, training=False, gen=None):
        (ct, cb), (cl, cr) = self.cropping
        return x[:, ct:x.shape[1] - cb, cl:x.shape[2] - cr, :], state

    def output_shape(self, input_shape):
        h, w, c = input_shape
        (ct, cb), (cl, cr) = self.cropping
        return (h - ct - cb, w - cl - cr, c)


@register_layer
@dataclasses.dataclass(frozen=True)
class LayerNormalization(Layer):
    """Layer norm over the last axis (reference ``:623``): ``gamma`` and
    ``beta`` of the last axis's size."""

    n_out: int = 0

    def initialize(self, gen, input_shape):
        c = self.n_out or input_shape[-1]
        return {"gamma": torch.ones((c,)), "beta": torch.zeros((c,))}, {}

    def apply(self, params, state, x, *, training=False, gen=None):
        return nnops.layernorm(x, params["gamma"], params["beta"]), state


@register_layer
@dataclasses.dataclass(frozen=True)
class SharedLayer(Layer):
    """Weight sharing (reference ``:639``): ``layer``'s computation with the
    params (and state) of the graph node named ``source``. It owns none;
    ComputationGraph resolves the source at every call site, so autograd
    sums both sites' gradients into the source's params."""

    source: str = ""
    layer: Optional[Layer] = None

    def output_shape(self, input_shape):
        return self.layer.output_shape(input_shape)

    def apply(self, params, state, x, *, training=False, gen=None):
        raise RuntimeError(
            "SharedLayer is resolved by ComputationGraph (it needs the "
            "source node's params); it cannot be applied standalone")

    def to_dict(self):
        d = super().to_dict()
        d["layer"] = self.layer.to_dict()
        return d
