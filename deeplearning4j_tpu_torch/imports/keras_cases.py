"""Seeded Keras files for the Keras importer (no counterpart in the
reference, whose tests save their models with ``tf.keras``): the machine
with the card has neither ``tensorflow`` nor ``h5py``, so the tests and
``chip_smoke.py`` take these, written with ``h5mini`` in the form tf.keras
3's legacy HDF5 save writes (``model.save("x.h5")``):

- root attributes ``backend``, ``keras_version`` and ``model_config`` (the
  model's JSON, one variable-length string);
- ``model_weights`` with ``backend``, ``keras_version`` and ``layer_names``
  (every layer, the input included), and a group a layer holding its
  ``weight_names`` (an empty float array for a layer without weights) and
  its float32 datasets at those paths under it.

Models:

- :func:`mobilenet_v2_h5`: ``tf.keras.applications.MobileNetV2(weights=
  None, ...)``, the functional config layer for layer (Conv2D, 17
  DepthwiseConv2D, BatchNormalization, ``ReLU(6.0)``, ``ZeroPadding2D``
  with ``correct_pad``'s asymmetric padding before the stride-2
  depthwise convs, ``Add``, the pooling and the head), with weights at a
  He-fan scale (normal, std sqrt(2 / fan_in) for the depthwise kernels,
  sqrt(1 / fan_in) for the others), BN gamma 1, beta 0 and moving
  statistics 0/1;
- :func:`conv1d_h5`: a Sequential Conv1D / pooling stack (K1 at unit
  height);
- :func:`depthwise_h5`: a Sequential ``DepthwiseConv2D(depth_multiplier=
  2)`` (K1, dgrad and K3 at two outputs a group);
- :func:`lstm_h5`: a Sequential LSTM (K4), ``return_sequences`` on.
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

import numpy as np

from deeplearning4j_tpu_torch.imports import h5mini

KERAS_VERSION = "3.13.1"
F32 = np.float32


def _dtype_policy():
    return {"module": "keras", "class_name": "DTypePolicy",
            "config": {"name": "float32"}, "registered_name": None}


def _initializer(name, config=None):
    return {"module": "keras.initializers", "class_name": name,
            "config": {} if config is None else config,
            "registered_name": None}


def _base(name):
    return {"name": name, "trainable": True, "dtype": _dtype_policy()}


def _conv2d(name, filters, kernel, strides=1, padding="same",
            use_bias=False, activation="linear"):
    return {**_base(name), "filters": filters, "kernel_size": [kernel] * 2,
            "strides": [strides] * 2, "padding": padding,
            "data_format": "channels_last", "dilation_rate": [1, 1],
            "groups": 1, "activation": activation, "use_bias": use_bias,
            "kernel_initializer": _initializer("GlorotUniform",
                                               {"seed": None}),
            "bias_initializer": _initializer("Zeros"),
            "kernel_regularizer": None, "bias_regularizer": None,
            "activity_regularizer": None, "kernel_constraint": None,
            "bias_constraint": None}


def _depthwise(name, strides, padding, depth_multiplier=1, use_bias=False,
               kernel=3, activation="linear"):
    return {**_base(name), "depth_multiplier": depth_multiplier,
            "kernel_size": [kernel] * 2, "strides": [strides] * 2,
            "padding": padding, "data_format": "channels_last",
            "dilation_rate": [1, 1], "activation": activation,
            "use_bias": use_bias,
            "depthwise_initializer": _initializer("GlorotUniform",
                                                  {"seed": None}),
            "bias_initializer": _initializer("Zeros"),
            "depthwise_regularizer": None, "bias_regularizer": None,
            "activity_regularizer": None, "depthwise_constraint": None,
            "bias_constraint": None}


def _bn(name):
    return {**_base(name), "axis": -1, "momentum": 0.999, "epsilon": 0.001,
            "center": True, "scale": True,
            "beta_initializer": _initializer("Zeros"),
            "gamma_initializer": _initializer("Ones"),
            "moving_mean_initializer": _initializer("Zeros"),
            "moving_variance_initializer": _initializer("Ones"),
            "beta_regularizer": None, "gamma_regularizer": None,
            "beta_constraint": None, "gamma_constraint": None,
            "synchronized": False}


def _relu6(name):
    return {**_base(name), "max_value": 6.0, "negative_slope": 0.0,
            "threshold": 0.0}


def _dense(name, units, activation):
    return {**_base(name), "units": units, "activation": activation,
            "use_bias": True,
            "kernel_initializer": _initializer("GlorotUniform",
                                               {"seed": None}),
            "bias_initializer": _initializer("Zeros"),
            "kernel_regularizer": None, "bias_regularizer": None,
            "kernel_constraint": None, "bias_constraint": None,
            "quantization_config": None}


def _make_divisible(v, divisor, min_value=None):
    """keras.applications.mobilenet_v2._make_divisible."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class _Functional:
    """Layers in call order, each with its inbound tensors (name, shape),
    and the weight shapes each layer saves, in save order."""

    def __init__(self):
        self.layers: List[dict] = []
        self.weights: Dict[str, List[Tuple[str, tuple]]] = {}

    @staticmethod
    def _tensor(src):
        name, shape = src
        return {"class_name": "__keras_tensor__",
                "config": {"shape": [None] + list(shape), "dtype": "float32",
                           "keras_history": [name, 0, 0]}}

    def input(self, name, shape):
        self.layers.append({"class_name": "InputLayer", "config": {
            "batch_shape": [None] + list(shape), "dtype": "float32",
            "sparse": False, "ragged": False, "name": name,
            "optional": False}, "name": name, "inbound_nodes": []})
        self.weights[name] = []
        return name, tuple(shape)

    def call(self, cls, config, src, out_shape, weights=(), kwargs=None):
        srcs = src if isinstance(src, list) else [src]
        args = ([[self._tensor(s) for s in srcs]] if isinstance(src, list)
                else [self._tensor(src)])
        name = config["name"]
        self.layers.append({"class_name": cls, "config": config,
                            "name": name, "inbound_nodes": [
                                {"args": args, "kwargs": kwargs or {}}]})
        self.weights[name] = [(f"{name}/{w}", tuple(s)) for w, s in weights]
        return name, tuple(out_shape)


def _same(n, s):
    return -(-n // s)


def mobilenet_v2_config(input_shape=(224, 224, 3), alpha=1.0, classes=1000,
                        include_top=True, pooling=None):
    """The ``model_config`` of ``tf.keras.applications.MobileNetV2(
    weights=None, ...)`` and its weights' (path, shape) a layer, in save
    order."""
    m = _Functional()
    h, w, c = input_shape
    x = m.input("input_layer", input_shape)
    first = _make_divisible(32 * alpha, 8)
    h, w = _same(h, 2), _same(w, 2)
    x = m.call("Conv2D", _conv2d("Conv1", first, 3, 2), x, (h, w, first),
               [("kernel", (3, 3, c, first))])
    c = first

    def bn_relu(x, name, relu):
        x = m.call("BatchNormalization", _bn(name), x, x[1],
                   [(k, (x[1][-1],)) for k in
                    ("gamma", "beta", "moving_mean", "moving_variance")],
                   kwargs={"mask": None})
        if relu:
            x = m.call("ReLU", _relu6(relu), x, x[1])
        return x

    x = bn_relu(x, "bn_Conv1", "Conv1_relu")
    blocks = [(16, 1, 1), (24, 2, 6), (24, 1, 6), (32, 2, 6), (32, 1, 6),
              (32, 1, 6), (64, 2, 6), (64, 1, 6), (64, 1, 6), (64, 1, 6),
              (96, 1, 6), (96, 1, 6), (96, 1, 6), (160, 2, 6), (160, 1, 6),
              (160, 1, 6), (320, 1, 6)]
    for block_id, (filters, stride, expansion) in enumerate(blocks):
        inputs = x
        in_ch = c
        pw = _make_divisible(int(filters * alpha), 8)
        prefix = f"block_{block_id}_"
        if block_id:
            e = expansion * in_ch
            x = m.call("Conv2D", _conv2d(f"{prefix}expand", e, 1), x,
                       (h, w, e), [("kernel", (1, 1, in_ch, e))])
            x = bn_relu(x, f"{prefix}expand_BN", f"{prefix}expand_relu")
            c = e
        else:
            prefix = "expanded_conv_"
        if stride == 2:
            # imagenet_utils.correct_pad: ((h % 2, 1), (w % 2, 1))
            pad = ((h % 2, 1), (w % 2, 1))
            h, w = h + h % 2 + 1, w + w % 2 + 1
            x = m.call("ZeroPadding2D", {
                **_base(f"{prefix}pad"), "padding": [list(p) for p in pad],
                "data_format": "channels_last"}, x, (h, w, c))
            h, w = (h - 3) // 2 + 1, (w - 3) // 2 + 1
        x = m.call("DepthwiseConv2D", _depthwise(
            f"{prefix}depthwise", stride, "same" if stride == 1 else "valid"),
            x, (h, w, c), [("kernel", (3, 3, c, 1))])
        x = bn_relu(x, f"{prefix}depthwise_BN", f"{prefix}depthwise_relu")
        x = m.call("Conv2D", _conv2d(f"{prefix}project", pw, 1), x,
                   (h, w, pw), [("kernel", (1, 1, c, pw))])
        x = bn_relu(x, f"{prefix}project_BN", None)
        c = pw
        if in_ch == pw and stride == 1:
            x = m.call("Add", _base(f"{prefix}add"), [inputs, x], (h, w, c))
    last = _make_divisible(1280 * alpha, 8) if alpha > 1.0 else 1280
    x = m.call("Conv2D", _conv2d("Conv_1", last, 1, padding="valid"), x,
               (h, w, last), [("kernel", (1, 1, c, last))])
    x = bn_relu(x, "Conv_1_bn", "out_relu")
    pool = {**_base("global_average_pooling2d"),
            "data_format": "channels_last", "keepdims": False}
    if include_top:
        x = m.call("GlobalAveragePooling2D", pool, x, (last,))
        x = m.call("Dense", _dense("predictions", classes, "softmax"), x,
                   (classes,),
                   [("kernel", (last, classes)), ("bias", (classes,))])
    elif pooling == "avg":
        x = m.call("GlobalAveragePooling2D", pool, x, (last,))
    elif pooling == "max":
        x = m.call("GlobalMaxPooling2D", {
            **pool, "name": "global_max_pooling2d"}, x, (last,))
    config = {"class_name": "Functional", "config": {
        "name": f"mobilenetv2_{alpha:0.2f}_{input_shape[0]}",
        "trainable": True, "layers": m.layers,
        "input_layers": ["input_layer", 0, 0],
        "output_layers": [x[0], 0, 0]}}
    return config, m.weights


def _he(rng, path, shape):
    """Fan-in scaled normal draws for kernels: std sqrt(2 / fan_in) for the
    depthwise convs (fan_in the 3x3 window), sqrt(1 / fan_in) for the
    others (fan_in every axis but the last), so the activations keep their
    scale through the 17 blocks and the residual adds (features of order
    1, near-uniform probabilities); BN gamma 1, beta, moving mean and
    biases 0, moving variance 1."""
    leaf = path.rsplit("/", 1)[-1]
    if leaf in ("gamma", "moving_variance"):
        return np.ones(shape, F32)
    if leaf in ("beta", "moving_mean", "bias"):
        return np.zeros(shape, F32)
    depthwise = "depthwise" in path and len(shape) == 4
    fan_in = (shape[0] * shape[1] if depthwise
              else int(np.prod(shape[:-1])))
    gain = 2.0 if depthwise else 1.0
    return (rng.standard_normal(shape, dtype=F32)
            * F32(np.sqrt(gain / fan_in))).astype(F32)


def write_legacy_h5(path, config, weights, values=None, seed=0,
                    prefix=None):
    """A legacy Keras HDF5 file of ``config`` (the model JSON) with the
    weights ``weights`` (layer name -> [(weight path, shape)] in save
    order), drawn by :func:`_he` from ``seed`` unless ``values`` (weight
    path -> array) gives them. ``prefix`` nests the datasets under it (a
    Sequential's ``sequential/``), as tf.keras writes them."""
    rng = np.random.default_rng(seed)
    root = h5mini.Writer()
    root.attrs["backend"] = "tensorflow"
    root.attrs["keras_version"] = KERAS_VERSION
    root.attrs["model_config"] = json.dumps(config)
    mw = root.create_group("model_weights")
    mw.attrs["backend"] = "tensorflow"
    mw.attrs["keras_version"] = KERAS_VERSION
    mw.attrs["layer_names"] = list(weights)
    for layer, ws in weights.items():
        g = mw.create_group(layer)
        names = [(prefix or "") + p for p, _ in ws]
        g.attrs["weight_names"] = names if names else np.zeros((0,))
        for name, (p, shape) in zip(names, ws):
            v = (values[p] if values is not None and p in values
                 else _he(rng, p, shape))
            g.create_dataset(name, np.asarray(v, F32).reshape(shape))
    root.save(path)
    return path


def mobilenet_v2_h5(path, input_shape=(224, 224, 3), classes=1000,
                    alpha=1.0, seed=12345, include_top=True, pooling=None):
    """MobileNetV2 as tf.keras saves it (legacy HDF5), seeded weights."""
    config, weights = mobilenet_v2_config(input_shape, alpha, classes,
                                          include_top, pooling)
    return write_legacy_h5(path, config, weights, seed=seed)


# ---------------------------------------------------------- Sequential


def _sequential(layers, input_shape, name="sequential"):
    return {"class_name": "Sequential", "config": {
        "name": name, "trainable": True, "dtype": _dtype_policy(),
        "layers": [{"class_name": "InputLayer", "config": {
            "batch_shape": [None] + list(input_shape), "dtype": "float32",
            "sparse": False, "ragged": False, "name": "input_layer",
            "optional": False}}] + [{"class_name": cls, "config": cfg}
                                    for cls, cfg in layers],
        "build_input_shape": [None] + list(input_shape)}}


def _conv1d(name, filters, kernel, padding, activation):
    return {**_base(name), "filters": filters, "kernel_size": [kernel],
            "strides": [1], "padding": padding,
            "data_format": "channels_last", "dilation_rate": [1],
            "groups": 1, "activation": activation, "use_bias": True,
            "kernel_initializer": _initializer("GlorotUniform",
                                               {"seed": None}),
            "bias_initializer": _initializer("Zeros"),
            "kernel_regularizer": None, "bias_regularizer": None,
            "activity_regularizer": None, "kernel_constraint": None,
            "bias_constraint": None}


def _pool1d(name, size):
    return {**_base(name), "pool_size": [size], "padding": "valid",
            "strides": [size], "data_format": "channels_last"}


def _seq_weights(spec):
    """layer -> [(path, shape)] under ``sequential/``, with the
    ``top_level_model_weights`` group tf.keras adds."""
    out = {"input_layer": []}
    out.update(spec)
    out["top_level_model_weights"] = []
    return out


def _write_seq(path, layers, input_shape, weights, seed, values=None):
    config = _sequential(layers, input_shape)
    return write_legacy_h5(path, config, _seq_weights(weights),
                           values=values, seed=seed, prefix="sequential/")


def conv1d_h5(path, length=128, channels=64, filters=(128, 96), seed=5):
    """Sequential[Input(length, channels), Conv1D(filters[0], 3, same,
    relu), MaxPooling1D(2), Conv1D(filters[1], 3, valid),
    GlobalMaxPooling1D, Dense(10, softmax)]."""
    f0, f1 = filters
    layers = [("Conv1D", _conv1d("conv1d", f0, 3, "same", "relu")),
              ("MaxPooling1D", _pool1d("max_pooling1d", 2)),
              ("Conv1D", _conv1d("conv1d_1", f1, 3, "valid", "linear")),
              ("GlobalMaxPooling1D", {**_base("global_max_pooling1d"),
                                      "data_format": "channels_last",
                                      "keepdims": False}),
              ("Dense", _dense("dense", 10, "softmax"))]
    weights = {"conv1d": [("conv1d/kernel", (3, channels, f0)),
                          ("conv1d/bias", (f0,))],
               "max_pooling1d": [],
               "conv1d_1": [("conv1d_1/kernel", (3, f0, f1)),
                            ("conv1d_1/bias", (f1,))],
               "global_max_pooling1d": [],
               "dense": [("dense/kernel", (f1, 10)), ("dense/bias", (10,))]}
    return _write_seq(path, layers, (length, channels), weights, seed)


def depthwise_h5(path, size=28, channels=32, depth_multiplier=2, stride=2,
                 seed=6):
    """Sequential[Input(size, size, channels), DepthwiseConv2D(3,
    strides=stride, depth_multiplier, valid, bias, relu),
    GlobalAveragePooling2D]."""
    cfg = _depthwise("depthwise_conv2d", stride, "valid", depth_multiplier,
                     use_bias=True, activation="relu")
    layers = [("DepthwiseConv2D", cfg),
              ("GlobalAveragePooling2D", {
                  **_base("global_average_pooling2d"),
                  "data_format": "channels_last", "keepdims": False})]
    weights = {"depthwise_conv2d": [
        ("depthwise_conv2d/kernel", (3, 3, channels, depth_multiplier)),
        ("depthwise_conv2d/bias", (channels * depth_multiplier,))],
        "global_average_pooling2d": []}
    vals = {"depthwise_conv2d/bias": np.random.default_rng(seed + 1)
            .normal(size=(channels * depth_multiplier,)).astype(F32) * 0.1}
    return _write_seq(path, layers, (size, size, channels), weights, seed,
                      vals)


def lstm_h5(path, steps=50, features=47, units=256, seed=7):
    """Sequential[Input(steps, features), LSTM(units,
    return_sequences=True)] (the char-RNN's width), weights at
    1/sqrt(units) and Keras's unit forget bias."""
    cfg = {**_base("lstm"), "return_sequences": True, "return_state": False,
           "go_backwards": False, "stateful": False, "unroll": False,
           "zero_output_for_mask": False, "units": units,
           "activation": "tanh", "recurrent_activation": "sigmoid",
           "use_bias": True,
           "kernel_initializer": _initializer("GlorotUniform",
                                              {"seed": None}),
           "recurrent_initializer": _initializer("Orthogonal",
                                                 {"seed": None, "gain": 1.0}),
           "bias_initializer": _initializer("Zeros"),
           "unit_forget_bias": True, "kernel_regularizer": None,
           "recurrent_regularizer": None, "bias_regularizer": None,
           "activity_regularizer": None, "kernel_constraint": None,
           "recurrent_constraint": None, "bias_constraint": None,
           "dropout": 0.0, "recurrent_dropout": 0.0, "seed": None}
    rng = np.random.default_rng(seed)
    s = F32(1.0 / np.sqrt(units))
    bias = np.zeros(4 * units, F32)
    bias[units:2 * units] = 1.0
    vals = {"lstm/lstm_cell/kernel": rng.uniform(
                -s, s, (features, 4 * units)).astype(F32),
            "lstm/lstm_cell/recurrent_kernel": rng.uniform(
                -s, s, (units, 4 * units)).astype(F32),
            "lstm/lstm_cell/bias": bias}
    weights = {"lstm": [(p, v.shape) for p, v in vals.items()]}
    return _write_seq(path, [("LSTM", cfg)], (steps, features), weights,
                      seed, vals)


def mobilenet_v2_counts(input_shape=(224, 224, 3), alpha=1.0,
                        classes=1000) -> Dict[str, int]:
    """Layers a class and the param count, from the config."""
    config, weights = mobilenet_v2_config(input_shape, alpha, classes)
    counts: Dict[str, int] = {}
    for lc in config["config"]["layers"]:
        counts[lc["class_name"]] = counts.get(lc["class_name"], 0) + 1
    counts["params"] = int(sum(np.prod(s) for ws in weights.values()
                               for _, s in ws))
    return counts


def with_output_head(conf_json: str, updater=None, loss="mcxent") -> str:
    """The conf JSON of an imported network with its output DenseLayer made
    an OutputLayer (``loss``; the same fields and params) and ``updater``
    (an updater's ``to_dict()``) in place of the conf's: the head swap the
    importer leaves to transfer learning, done on the JSON so that both
    packages read the same trainable conf."""
    d = json.loads(conf_json)
    if "nodes" in d:
        last = next(n["node"] for n in d["nodes"]
                    if n["name"] == d["outputs"][0])
    else:
        last = d["layers"][-1]
    if last.get("@layer") != "DenseLayer":
        raise ValueError(f"the output is a {last.get('@layer')}, not a "
                         "DenseLayer")
    last["@layer"], last["loss"] = "OutputLayer", loss
    if updater is not None:
        d["updater"] = updater
    return json.dumps(d)


__all__ = ["mobilenet_v2_config", "mobilenet_v2_h5", "mobilenet_v2_counts",
           "conv1d_h5", "depthwise_h5", "lstm_h5", "with_output_head",
           "write_legacy_h5"]
