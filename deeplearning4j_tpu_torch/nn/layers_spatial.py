"""1-D and 3-D spatial layers, locally connected and the other layers of
deeplearning4j_tpu/nn/layers_spatial.py, all nineteen of its classes.

As in ``layers.py``, each class's fields and defaults are the reference's,
field for field, so a conf JSON moves between the two packages unchanged,
and params are keyed as the reference keys them: ``W``/``b`` for the
convolutions and the locally connected layers, ``alpha`` for PReLU,
``w``/``b`` for ElementWiseMultiplicationLayer.

Data formats are the reference's, channels last: 1-D (B, T, C), 3-D
(B, D, H, W, C).

Kernel routes: DepthwiseConvolution2D is ``ops.nn.depthwise_conv2d``, the
conv kernel (K1) with one group per channel; Convolution1D is
``ops.nn.conv1d``, K1 over a unit height. In training both run
``Conv2dFunction``'s dgrad and wgrad kernels. Convolution3D's ``conv3d``
and the locally connected layers' unshared product (an einsum over
im2col patches) are XLA ops in the reference, outside any Pallas kernel,
so here they are plain PyTorch.

MaskZeroLayer passes ``mask=`` to its layer when that layer's ``apply``
takes one, as the reference decides it (by signature): every recurrent
layer of the port takes one.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Optional

import torch

from deeplearning4j_tpu_torch.nn import activations as act
from deeplearning4j_tpu_torch.nn import weights as winit
from deeplearning4j_tpu_torch.nn.layers import Layer, register_layer
from deeplearning4j_tpu_torch.ops import nn as nnops


def _len_out(t, k, s, padding, dilation=1):
    if padding == "SAME":
        return -(-t // s)
    eff = (k - 1) * dilation + 1
    if padding == "VALID":
        return (t - eff) // s + 1
    p = padding if isinstance(padding, int) else padding[0]
    return (t + 2 * p - eff) // s + 1


@register_layer
@dataclasses.dataclass(frozen=True)
class Convolution1D(Layer):
    """(conf/layers/Convolution1DLayer.java, reference ``:40``). Input
    (B, T, C), W (k, Cin, Cout)."""

    n_in: int = 0
    n_out: int = 0
    kernel_size: int = 3
    stride: int = 1
    padding: Any = "SAME"
    dilation: int = 1
    activation: str = "identity"
    weight_init: str = "relu"
    has_bias: bool = True

    def initialize(self, gen, input_shape):
        c_in = self.n_in or input_shape[-1]
        params = {"W": winit.init(gen, self.weight_init,
                                  (self.kernel_size, c_in, self.n_out))}
        if self.has_bias:
            params["b"] = torch.zeros((self.n_out,))
        return params, {}

    def apply(self, params, state, x, *, training=False, gen=None):
        x = self._maybe_dropout(x, training, gen)
        y = nnops.conv1d(x, params["W"], params.get("b"), stride=self.stride,
                         padding=self.padding, dilation=self.dilation)
        return act.resolve(self.activation)(y), state

    def output_shape(self, input_shape):
        t, _ = input_shape
        return (_len_out(t, self.kernel_size, self.stride, self.padding,
                         self.dilation), self.n_out)


@register_layer
@dataclasses.dataclass(frozen=True)
class Subsampling1DLayer(Layer):
    """(conf/layers/Subsampling1DLayer.java, reference ``:75``): the 2-D
    pooling over (B, T, 1, C)."""

    kernel_size: int = 2
    stride: Optional[int] = None
    padding: Any = "VALID"
    pooling_type: str = "max"

    def has_params(self):
        return False

    def apply(self, params, state, x, *, training=False, gen=None):
        s = self.stride or self.kernel_size
        x4 = x[:, :, None, :]
        pool = (nnops.max_pool2d if self.pooling_type.lower() == "max"
                else nnops.avg_pool2d)
        y = pool(x4, (self.kernel_size, 1), (s, 1), self.padding)
        return y.squeeze(2), state

    def output_shape(self, input_shape):
        t, c = input_shape
        return (_len_out(t, self.kernel_size, self.stride or self.kernel_size,
                         self.padding), c)


@register_layer
@dataclasses.dataclass(frozen=True)
class Cropping1D(Layer):
    """(conf/layers/convolutional/Cropping1D.java, reference ``:105``)."""

    cropping: tuple = (1, 1)

    def has_params(self):
        return False

    def apply(self, params, state, x, *, training=False, gen=None):
        a, b = self.cropping
        return x[:, a: x.shape[1] - b], state

    def output_shape(self, input_shape):
        t, c = input_shape
        return (t - sum(self.cropping), c)


@register_layer
@dataclasses.dataclass(frozen=True)
class ZeroPadding1DLayer(Layer):
    """(conf/layers/ZeroPadding1DLayer.java, reference ``:124``)."""

    padding: tuple = (1, 1)

    def has_params(self):
        return False

    def apply(self, params, state, x, *, training=False, gen=None):
        a, b = self.padding
        return torch.nn.functional.pad(x, (0, 0, a, b)), state

    def output_shape(self, input_shape):
        t, c = input_shape
        return (t + sum(self.padding), c)


@register_layer
@dataclasses.dataclass(frozen=True)
class Upsampling1D(Layer):
    """(conf/layers/Upsampling1D.java, reference ``:143``)."""

    size: int = 2

    def has_params(self):
        return False

    def apply(self, params, state, x, *, training=False, gen=None):
        return x.repeat_interleave(self.size, dim=1), state

    def output_shape(self, input_shape):
        t, c = input_shape
        return (t * self.size, c)


@register_layer
@dataclasses.dataclass(frozen=True)
class Convolution3D(Layer):
    """(conf/layers/Convolution3D.java, reference ``:161``). Input
    (B, D, H, W, C), W (kD, kH, kW, Cin, Cout)."""

    n_in: int = 0
    n_out: int = 0
    kernel_size: tuple = (3, 3, 3)
    stride: tuple = (1, 1, 1)
    padding: Any = "SAME"
    dilation: tuple = (1, 1, 1)
    activation: str = "identity"
    weight_init: str = "relu"
    has_bias: bool = True

    def initialize(self, gen, input_shape):
        c_in = self.n_in or input_shape[-1]
        kd, kh, kw = self.kernel_size
        params = {"W": winit.init(gen, self.weight_init,
                                  (kd, kh, kw, c_in, self.n_out))}
        if self.has_bias:
            params["b"] = torch.zeros((self.n_out,))
        return params, {}

    def apply(self, params, state, x, *, training=False, gen=None):
        x = self._maybe_dropout(x, training, gen)
        y = nnops.conv3d(x, params["W"], params.get("b"), strides=self.stride,
                         padding=self.padding, dilation=self.dilation)
        return act.resolve(self.activation)(y), state

    def output_shape(self, input_shape):
        dims = [_len_out(t, k, s, self.padding, dl)
                for t, k, s, dl in zip(input_shape[:3], self.kernel_size,
                                       self.stride, self.dilation)]
        return tuple(dims) + (self.n_out,)


@register_layer
@dataclasses.dataclass(frozen=True)
class Subsampling3DLayer(Layer):
    """(conf/layers/Subsampling3DLayer.java, reference ``:200``)."""

    kernel_size: tuple = (2, 2, 2)
    stride: Optional[tuple] = None
    padding: Any = "VALID"
    pooling_type: str = "max"

    def has_params(self):
        return False

    def apply(self, params, state, x, *, training=False, gen=None):
        s = self.stride or self.kernel_size
        pool = (nnops.max_pool3d if self.pooling_type.lower() == "max"
                else nnops.avg_pool3d)
        return pool(x, self.kernel_size, s, self.padding), state

    def output_shape(self, input_shape):
        s = self.stride or self.kernel_size
        dims = [_len_out(t, k, st, self.padding)
                for t, k, st in zip(input_shape[:3], self.kernel_size, s)]
        return tuple(dims) + (input_shape[3],)


@register_layer
@dataclasses.dataclass(frozen=True)
class Cropping3D(Layer):
    """(conf/layers/convolutional/Cropping3D.java, reference ``:230``)."""

    cropping: tuple = ((1, 1), (1, 1), (1, 1))

    def has_params(self):
        return False

    def apply(self, params, state, x, *, training=False, gen=None):
        (da, db), (ha, hb), (wa, wb) = self.cropping
        return x[:, da: x.shape[1] - db, ha: x.shape[2] - hb,
                 wa: x.shape[3] - wb], state

    def output_shape(self, input_shape):
        d, h, w, c = input_shape
        (da, db), (ha, hb), (wa, wb) = self.cropping
        return (d - da - db, h - ha - hb, w - wa - wb, c)


@register_layer
@dataclasses.dataclass(frozen=True)
class ZeroPadding3DLayer(Layer):
    """(conf/layers/ZeroPadding3DLayer.java, reference ``:251``)."""

    padding: tuple = ((1, 1), (1, 1), (1, 1))

    def has_params(self):
        return False

    def apply(self, params, state, x, *, training=False, gen=None):
        (da, db), (ha, hb), (wa, wb) = self.padding
        return torch.nn.functional.pad(x, (0, 0, wa, wb, ha, hb, da, db)), \
            state

    def output_shape(self, input_shape):
        d, h, w, c = input_shape
        (da, db), (ha, hb), (wa, wb) = self.padding
        return (d + da + db, h + ha + hb, w + wa + wb, c)


@register_layer
@dataclasses.dataclass(frozen=True)
class Upsampling3D(Layer):
    """(conf/layers/Upsampling3D.java, reference ``:272``)."""

    size: int = 2

    def has_params(self):
        return False

    def apply(self, params, state, x, *, training=False, gen=None):
        y = x
        for ax in (1, 2, 3):
            y = y.repeat_interleave(self.size, dim=ax)
        return y, state

    def output_shape(self, input_shape):
        d, h, w, c = input_shape
        return (d * self.size, h * self.size, w * self.size, c)


@register_layer
@dataclasses.dataclass(frozen=True)
class DepthwiseConvolution2D(Layer):
    """(conf/layers/DepthwiseConvolution2D.java, reference ``:293``).
    W (kH, kW, C, multiplier), b (C * multiplier,):
    ``ops.nn.depthwise_conv2d``, the conv kernel at groups = C on the card
    (MobileNetV2's 17 depthwise layers, at strides 1 and 2)."""

    n_in: int = 0
    depth_multiplier: int = 1
    kernel_size: tuple = (3, 3)
    stride: tuple = (1, 1)
    padding: Any = "SAME"
    activation: str = "identity"
    weight_init: str = "relu"
    has_bias: bool = True

    def initialize(self, gen, input_shape):
        c_in = self.n_in or input_shape[-1]
        kh, kw = self.kernel_size
        params = {"W": winit.init(gen, self.weight_init,
                                  (kh, kw, c_in, self.depth_multiplier))}
        if self.has_bias:
            params["b"] = torch.zeros((c_in * self.depth_multiplier,))
        return params, {}

    def apply(self, params, state, x, *, training=False, gen=None):
        x = self._maybe_dropout(x, training, gen)
        y = nnops.depthwise_conv2d(x, params["W"], params.get("b"),
                                   strides=self.stride, padding=self.padding)
        return act.resolve(self.activation)(y), state

    def output_shape(self, input_shape):
        h, w, c = input_shape
        kh, kw = self.kernel_size
        sh, sw = self.stride
        return (_len_out(h, kh, sh, self.padding),
                _len_out(w, kw, sw, self.padding),
                c * self.depth_multiplier)


def _locally_connected_matmul(patches, W):
    """patches (B, P, K), W (P, K, n_out) -> (B, P, n_out), unshared."""
    return torch.einsum("bpk,pko->bpo", patches, W.to(patches.dtype))


@register_layer
@dataclasses.dataclass(frozen=True)
class LocallyConnected2D(Layer):
    """Unshared-weights convolution (conf/layers/LocallyConnected2D.java,
    reference ``:336``), VALID: W (oH * oW, kH * kW * Cin, Cout) over the
    im2col patches (features in (C, kh, kw) order), b (oH * oW, Cout)."""

    n_in: int = 0
    n_out: int = 0
    kernel_size: tuple = (2, 2)
    stride: tuple = (1, 1)
    input_size: tuple = ()
    activation: str = "identity"
    weight_init: str = "xavier"
    has_bias: bool = True

    def _out_hw(self, h, w):
        kh, kw = self.kernel_size
        sh, sw = self.stride
        return (h - kh) // sh + 1, (w - kw) // sw + 1

    def initialize(self, gen, input_shape):
        h, w = self.input_size or input_shape[:2]
        c_in = self.n_in or input_shape[-1]
        oh, ow = self._out_hw(h, w)
        kh, kw = self.kernel_size
        params = {"W": winit.init(gen, self.weight_init,
                                  (oh * ow, kh * kw * c_in, self.n_out))}
        if self.has_bias:
            params["b"] = torch.zeros((oh * ow, self.n_out))
        return params, {}

    def apply(self, params, state, x, *, training=False, gen=None):
        x = self._maybe_dropout(x, training, gen)
        n, h, w, c = x.shape
        oh, ow = self._out_hw(h, w)
        patches = nnops.im2col(x, self.kernel_size, self.stride)
        patches = patches.reshape(n, -1, oh * ow).transpose(1, 2)
        y = _locally_connected_matmul(patches, params["W"])
        if self.has_bias:
            y = y + params["b"].to(y.dtype)
        y = y.reshape(n, oh, ow, self.n_out)
        return act.resolve(self.activation)(y), state

    def output_shape(self, input_shape):
        oh, ow = self._out_hw(*input_shape[:2])
        return (oh, ow, self.n_out)


@register_layer
@dataclasses.dataclass(frozen=True)
class LocallyConnected1D(Layer):
    """(conf/layers/LocallyConnected1D.java, reference ``:385``). Input
    (B, T, C), VALID: W (oT, k * Cin, Cout), b (oT, Cout)."""

    n_in: int = 0
    n_out: int = 0
    kernel_size: int = 2
    stride: int = 1
    input_size: int = 0
    activation: str = "identity"
    weight_init: str = "xavier"
    has_bias: bool = True

    def _out_t(self, t):
        return (t - self.kernel_size) // self.stride + 1

    def initialize(self, gen, input_shape):
        t = self.input_size or input_shape[0]
        c_in = self.n_in or input_shape[-1]
        ot = self._out_t(t)
        params = {"W": winit.init(gen, self.weight_init,
                                  (ot, self.kernel_size * c_in, self.n_out))}
        if self.has_bias:
            params["b"] = torch.zeros((ot, self.n_out))
        return params, {}

    def apply(self, params, state, x, *, training=False, gen=None):
        x = self._maybe_dropout(x, training, gen)
        n, t, c = x.shape
        ot = self._out_t(t)
        idx = (torch.arange(ot, device=x.device)[:, None] * self.stride
               + torch.arange(self.kernel_size, device=x.device))
        patches = x[:, idx, :].reshape(n, ot, self.kernel_size * c)
        y = _locally_connected_matmul(patches, params["W"])
        if self.has_bias:
            y = y + params["b"].to(y.dtype)
        return act.resolve(self.activation)(y), state

    def output_shape(self, input_shape):
        return (self._out_t(input_shape[0]), self.n_out)


@register_layer
@dataclasses.dataclass(frozen=True)
class PReLULayer(Layer):
    """Learnable leaky-relu slopes (conf/layers/PReLULayer.java, reference
    ``:427``): one ``alpha`` per feature of the last axis, 0.25 at init."""

    n_in: int = 0

    def initialize(self, gen, input_shape):
        n = self.n_in or input_shape[-1]
        return {"alpha": torch.full((n,), 0.25)}, {}

    def apply(self, params, state, x, *, training=False, gen=None):
        x = self._maybe_dropout(x, training, gen)
        a = params["alpha"].to(x.dtype)
        return torch.where(x >= 0, x, a * x), state


@register_layer
@dataclasses.dataclass(frozen=True)
class ElementWiseMultiplicationLayer(Layer):
    """out = activation(x * w + b), per-feature ``w`` and ``b``
    (conf/layers/misc/ElementWiseMultiplicationLayer.java, reference
    ``:446``)."""

    n_in: int = 0
    n_out: int = 0
    activation: str = "identity"

    def initialize(self, gen, input_shape):
        n = self.n_in or input_shape[-1]
        if self.n_out and self.n_out != n:
            raise ValueError("ElementWiseMultiplicationLayer needs n_in == n_out")
        return {"w": torch.ones((n,)), "b": torch.zeros((n,))}, {}

    def apply(self, params, state, x, *, training=False, gen=None):
        x = self._maybe_dropout(x, training, gen)
        y = x * params["w"].to(x.dtype) + params["b"].to(x.dtype)
        return act.resolve(self.activation)(y), state


@register_layer
@dataclasses.dataclass(frozen=True)
class MaskLayer(Layer):
    """Zeroes masked time steps (conf/layers/util/MaskLayer.java, reference
    ``:468``): a (B, T, F) input times the (B, T) mask."""

    def has_params(self):
        return False

    def apply(self, params, state, x, *, training=False, gen=None, mask=None):
        if mask is not None and x.dim() == 3:
            x = x * mask[:, :, None].to(x.dtype)
        return x, state


@register_layer
@dataclasses.dataclass(frozen=True)
class MaskZeroLayer(Layer):
    """Wraps a recurrent layer, masking the time steps whose input is all
    ``mask_value`` (conf/layers/recurrent/MaskZeroLayer.java, reference
    ``:483``). ``carry_masked_output=False`` zeroes the masked steps'
    outputs; True repeats the last valid output through them (tf.keras's
    Masking, for the Keras importer)."""

    underlying: Optional[Layer] = None
    mask_value: float = 0.0
    carry_masked_output: bool = False

    def initialize(self, gen, input_shape):
        return self.underlying.initialize(gen, input_shape)

    def has_params(self):
        return self.underlying.has_params()

    def output_shape(self, input_shape):
        return self.underlying.output_shape(input_shape)

    def _derived_mask(self, x):
        # (B, T): a step is masked when every feature equals mask_value
        return (x != self.mask_value).any(dim=tuple(range(2, x.dim())))

    def apply(self, params, state, x, *, training=False, gen=None):
        mask = self._derived_mask(x)
        kw = {}
        if "mask" in inspect.signature(self.underlying.apply).parameters:
            kw["mask"] = mask
        y, ns = self.underlying.apply(params, state, x, training=training,
                                      gen=gen, **kw)
        if y.dim() >= 3:
            m = mask.reshape(tuple(mask.shape) + (1,) * (y.dim() - 2)).to(
                y.dtype)
            if self.carry_masked_output:
                # forward-fill the last valid output through masked steps
                c = torch.zeros_like(y[:, 0])
                outs = []
                for yt, mt in zip((y * m).unbind(1), m.unbind(1)):
                    c = mt * yt + (1 - mt) * c
                    outs.append(c)
                y = torch.stack(outs, dim=1)
            else:
                y = y * m
        return y, ns

    def to_dict(self):
        d = super().to_dict()
        d["underlying"] = self.underlying.to_dict()
        return d


@register_layer
@dataclasses.dataclass(frozen=True)
class RepeatVector(Layer):
    """(B, C) -> (B, n, C) (conf/layers/misc/RepeatVector.java, reference
    ``:546``)."""

    n: int = 1

    def has_params(self):
        return False

    def apply(self, params, state, x, *, training=False, gen=None):
        return x[:, None, :].expand(x.shape[0], self.n, x.shape[1]), state

    def output_shape(self, input_shape):
        return (self.n, input_shape[-1])


@register_layer
@dataclasses.dataclass(frozen=True)
class TimeDistributed(Layer):
    """A layer applied to each time step, (B, T, ...) -> (B, T, out),
    time folded into the batch (reference ``:564``; Keras's
    TimeDistributed)."""

    underlying: Optional[Layer] = None

    def initialize(self, gen, input_shape):
        return self.underlying.initialize(gen, tuple(input_shape[1:]))

    def has_params(self):
        return self.underlying.has_params()

    def apply(self, params, state, x, *, training=False, gen=None):
        b, t = x.shape[0], x.shape[1]
        flat = x.reshape((b * t,) + tuple(x.shape[2:]))
        y, ns = self.underlying.apply(params, state, flat, training=training,
                                      gen=gen)
        return y.reshape((b, t) + tuple(y.shape[1:])), ns

    def output_shape(self, input_shape):
        return (input_shape[0],) + tuple(
            self.underlying.output_shape(tuple(input_shape[1:])))

    def to_dict(self):
        d = super().to_dict()
        d["underlying"] = self.underlying.to_dict()
        return d
