"""Keras HDF5 import -> MultiLayerNetwork / ComputationGraph (counterpart
of deeplearning4j_tpu/imports/keras_import.py; deeplearning4j-modelimport's
KerasModelImport.java, KerasSequentialModel.java, KerasModel.java).

It reads what the reference reads, the legacy Keras HDF5 file
(``model_config`` JSON attribute and ``model_weights`` groups) and the
Keras v3 ``.keras`` zip (``config.json`` and ``model.weights.h5``), with the
port's own HDF5 decoder (``h5mini``) in place of ``h5py``: neither
``h5py`` nor ``tensorflow`` is needed. Sequential and single-path
functional models become a MultiLayerNetwork, functional DAGs a
ComputationGraph with the merge layers as vertices, and every layer
builder, gate permutation (Keras LSTM [i, f, c, o] -> [i, f, o, g], GRU
[z, r, h] -> [r, z, n]), masking rule and error message is the
reference's. The network is built on ``device`` (CUDA unless named
otherwise), where DepthwiseConv2D, Conv2D, SeparableConv2D and Conv1D run
the conv kernels and LSTM the K4 segment kernel.

The reference's faults are mirrored, as the bar is the reference: Keras's
``ReLU`` layer imports as a plain relu, dropping ``max_value``,
``negative_slope`` and ``threshold`` (so MobileNetV2's ReLU6 is a relu
here as there; ROADMAP Queue 3).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

import numpy as np

import torch

from deeplearning4j_tpu_torch.imports import h5mini
from deeplearning4j_tpu_torch.nn import MultiLayerNetwork, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.nn import layers_spatial as LS
from deeplearning4j_tpu_torch.nn import recurrent as R

_ACT = {"relu": "relu", "softmax": "softmax", "sigmoid": "sigmoid",
        "tanh": "tanh", "linear": "identity", "elu": "elu", "selu": "selu",
        "softplus": "softplus", "softsign": "softsign", "swish": "swish",
        "gelu": "gelu", "hard_sigmoid": "hard_sigmoid",
        "exponential": "exp"}
# NOT mapped: the string form activation="leaky_relu" — Keras applies
# negative_slope=0.2 there while the op default is 0.01, and the string
# path cannot carry the slope; the LeakyReLU LAYER form imports correctly
# (activation_args) and _act() raises for the string per the no-silent-
# substitution convention.


class KerasImportError(ValueError):
    pass


def _act(cfg, default="identity"):
    a = cfg.get("activation", default) or default
    if isinstance(a, dict):
        a = a.get("class_name", "linear").lower()
    if a not in _ACT:
        raise KerasImportError(f"unsupported activation {a!r}")
    return _ACT[a]


def _global_pool(cfg, pooling_type):
    """Global pooling builder with config guards: GlobalPoolingLayer pools
    every spatial axis assuming channels_last and always collapses rank —
    refuse loudly what it cannot honor instead of mis-pooling."""
    if cfg.get("data_format", "channels_last") != "channels_last":
        raise KerasImportError(
            "GlobalPooling requires channels_last (got channels_first)")
    if cfg.get("keepdims", False):
        raise KerasImportError("GlobalPooling keepdims=True unsupported")
    return L.GlobalPoolingLayer(pooling_type=pooling_type)


def _pad(cfg):
    return "SAME" if cfg.get("padding", "valid") == "same" else "VALID"


class KerasModelImport:
    """KerasModelImport.java parity. The reference reads the legacy HDF5
    whole-model format; this importer additionally accepts the Keras v3
    ``.keras`` zip (config.json + model.weights.h5) — the save default since
    Keras 3, so modern exports import without a re-save."""

    @staticmethod
    def import_keras_model_and_weights(path: str, device=None):
        """The network of a Keras file (legacy HDF5 or ``.keras`` zip), its
        weights loaded, on ``device`` (CUDA unless named otherwise)."""
        import zipfile

        if zipfile.is_zipfile(path):
            return KerasModelImport._import_keras_v3(path, device)
        with h5mini.File(path, "r") as f:
            raw = f.attrs["model_config"]
            if isinstance(raw, bytes):
                raw = raw.decode("utf-8")
            config = json.loads(raw)
            weights = _read_weights(f["model_weights"])
        return _build(config, weights, device)

    @staticmethod
    def _import_keras_v3(path: str, device=None):
        import zipfile

        with zipfile.ZipFile(path) as z:
            config = json.loads(z.read("config.json"))
            with h5mini.File(z.read("model.weights.h5"), "r") as f:
                by_group = _read_weights_v3(f)
        # v3 weight groups are per-class snake_case slugs with per-model
        # occurrence suffixes ("dense", "dense_1", ...), NOT the config
        # layer names — remap onto config names for _build's lookups
        weights: Dict[str, List[np.ndarray]] = {}
        counters: Dict[str, int] = {}
        consumed = set()
        for lc in config["config"]["layers"]:
            cls = lc["class_name"]
            if cls == "InputLayer":
                continue
            slug = _to_snake_case(cls)
            k = counters.get(slug, 0)
            counters[slug] = k + 1
            group = slug if k == 0 else f"{slug}_{k}"
            if group in by_group:
                weights[lc["config"]["name"]] = by_group[group]
                consumed.add(group)
        # a group that matched NO config layer means the slug/counter
        # reconstruction diverged from the store layout — fail loudly
        # rather than importing an uninitialized model
        unused = set(by_group) - consumed
        if unused:
            raise KerasImportError(
                f".keras weight groups {sorted(unused)} did not match any "
                "config layer (Keras weight-store layout drift?)")
        return _build(config, weights, device)

    # convenience alias matching the reference's Sequential entry point
    importSequentialModelAndWeights = import_keras_model_and_weights


def _read_weights(grp) -> Dict[str, List[np.ndarray]]:
    """layer name → [arrays] in SAVE order (kernel, bias, ...).

    The h5 group's ``weight_names`` attr records the true order; hdf5 group
    iteration is alphabetical (bias before kernel) and must not be trusted."""

    out: Dict[str, List[np.ndarray]] = {}
    for lname in grp:
        sub = grp[lname]
        names = sub.attrs.get("weight_names")
        arrays: List[np.ndarray] = []
        if names is not None:
            for wn in names:
                wn = wn.decode() if isinstance(wn, bytes) else str(wn)
                arrays.append(np.asarray(sub[wn]))
        else:  # fallback: datasets sorted kernel-first
            found: List[tuple] = []

            def visit(name, obj):
                if isinstance(obj, h5mini.Dataset):
                    base = name.rsplit("/", 1)[-1]
                    rank = {"kernel:0": 0, "depthwise_kernel:0": 0,
                            "pointwise_kernel:0": 1, "recurrent_kernel:0": 1,
                            "bias:0": 2, "gamma:0": 0, "beta:0": 1,
                            "moving_mean:0": 2, "moving_variance:0": 3}
                    found.append((rank.get(base, 9), name, np.asarray(obj)))

            sub.visititems(visit)
            arrays = [a for _, _, a in sorted(found, key=lambda t: (t[0], t[1]))]
        if arrays:
            out[lname] = arrays
    return out


def _to_snake_case(name: str) -> str:
    """Keras's class-name → slug rule (Conv2D→conv2d, PReLU→p_re_lu,
    ConvLSTM2D→conv_lstm2d) — the naming the v3 weight store uses."""
    import re

    name = re.sub(r"\W+", "", name)
    name = re.sub(r"(.)([A-Z][a-z]+)", r"\1_\2", name)
    return re.sub(r"([a-z])([A-Z])", r"\1_\2", name).lower()


def _read_weights_v3(f) -> Dict[str, List[np.ndarray]]:
    """weight-group name → [arrays] from a Keras v3 model.weights.h5: each
    layer group holds a ``vars`` subgroup with numerically-keyed datasets in
    SAVE order (kernel=0, bias=1, ...); nested wrapper layers
    (Bidirectional, TimeDistributed, RNN cells) hold their sublayers'
    groups, collected depth-first — forward before backward, matching the
    legacy weight order the builders expect."""

    out: Dict[str, List[np.ndarray]] = {}
    layers = f.get("layers")
    if layers is None:
        return out

    def collect(grp) -> List[np.ndarray]:
        arrays: List[np.ndarray] = []
        vars_grp = grp.get("vars")
        if isinstance(vars_grp, h5mini.Group):
            for k in sorted(vars_grp, key=lambda s: (len(s), s)):
                arrays.append(np.asarray(vars_grp[k]))
        children = [k for k in grp
                    if k != "vars" and isinstance(grp[k], h5mini.Group)]
        children.sort(key=lambda s: (s == "backward_layer", s))
        for k in children:
            arrays.extend(collect(grp[k]))
        return arrays

    for lname in layers:
        arrays = collect(layers[lname])
        if arrays:
            out[lname] = arrays
    return out


def _walk_refs(obj, refs):
    """Collect (layer_name, node_index) producer refs from an inbound spec
    (v2 list format or v3 __keras_tensor__/keras_history format)."""
    if isinstance(obj, dict):
        hist = obj.get("config", {}).get("keras_history")
        if obj.get("class_name") == "__keras_tensor__" and hist:
            refs.append((hist[0], int(hist[1]) if len(hist) > 1 else 0))
        else:
            for v in obj.values():
                _walk_refs(v, refs)
    elif isinstance(obj, (list, tuple)):
        if (len(obj) >= 3 and isinstance(obj[0], str)
                and isinstance(obj[1], int)):  # v2 [name, node, tensor, ...]
            refs.append((obj[0], int(obj[1])))
        else:
            for v in obj:
                _walk_refs(v, refs)


def _inbound_names(layer_cfg):
    """Source layer names from Keras inbound_nodes (all call nodes)."""
    refs: list = []
    _walk_refs(layer_cfg.get("inbound_nodes", []), refs)
    return [r[0] for r in refs]


def _inbound_refs_per_call(layer_cfg):
    """Per call node: [(producer_name, producer_node_index), ...] — the
    node_index distinguishes calls of weight-shared layers."""
    out = []
    for entry in layer_cfg.get("inbound_nodes", []) or []:
        refs: list = []
        _walk_refs(entry, refs)
        out.append(refs)
    return out


def _n_call_nodes(layer_cfg) -> int:
    """Number of call nodes (a weight-shared layer is called more than once)."""
    return len(layer_cfg.get("inbound_nodes", []) or [])


def _is_dag(config) -> bool:
    """True when the functional graph is not a simple chain: merges,
    multi-inbound layers, multiple outputs, or any edge that skips the
    immediately preceding layer (fan-out)."""
    layer_cfgs = config["config"]["layers"]
    outs = config["config"].get("output_layers") or []
    if isinstance(outs, list) and outs and isinstance(outs[0], list) and len(outs) > 1:
        return True
    prev = None
    for lc in layer_cfgs:
        if _n_call_nodes(lc) > 1:  # weight sharing → SharedLayer nodes
            return True
        inbound = _inbound_names(lc)
        if len(inbound) > 1 or lc["class_name"] in _MERGE_VERTICES:
            return True
        if inbound and prev is not None and inbound[0] != prev:
            return True
        prev = lc.get("config", {}).get("name", lc["class_name"])
    return False


def _build(config, weights, device=None):
    cls = config["class_name"]
    if cls == "Sequential":
        layer_cfgs = config["config"]["layers"]
    elif cls in ("Model", "Functional"):
        layer_cfgs = config["config"]["layers"]
        if _is_dag(config):
            return _build_functional(config, weights, device)
    else:
        raise KerasImportError(f"unsupported model class {cls}")

    layers: List = []
    params: List[dict] = []
    states: List[dict] = []
    input_shape: Optional[tuple] = None
    pending_mask: Optional[_PendingMasking] = None
    for lc in layer_cfgs:
        kcls = lc["class_name"]
        cfg = lc.get("config", {})
        name = cfg.get("name", kcls)
        if kcls == "InputLayer":
            shape = cfg.get("batch_shape") or cfg.get("batch_input_shape")
            input_shape = tuple(shape[1:])
            continue
        if input_shape is None and "batch_input_shape" in cfg:
            input_shape = tuple(cfg["batch_input_shape"][1:])
        built = _LAYER_BUILDERS.get(kcls)
        if built is None:
            raise KerasImportError(f"unsupported Keras layer {kcls!r} ({name})")
        out = built(cfg, weights.get(name, []))
        lyr, p = out[0], out[1]
        st = out[2] if len(out) > 2 else {}
        if isinstance(lyr, _PendingMasking):
            pending_mask = lyr
            continue
        if lyr is not None:
            if pending_mask is not None:
                import inspect

                from deeplearning4j_tpu_torch.nn.layers_spatial import \
                    MaskZeroLayer

                # only mask-consuming layers (recurrent) change behavior
                # under a Keras mask; wrapping e.g. Dense would forward-fill
                # outputs Keras computes at every step
                if "mask" not in inspect.signature(lyr.apply).parameters:
                    raise KerasImportError(
                        f"Masking followed by {type(lyr).__name__}, which "
                        "does not consume masks — import the model with the "
                        "mask consumer directly after Masking")
                lyr = MaskZeroLayer(underlying=lyr,
                                    mask_value=pending_mask.mask_value,
                                    carry_masked_output=True)
                pending_mask = None
            layers.append(lyr)
            params.append(p)
            states.append(st)
    if pending_mask is not None:
        raise KerasImportError(
            "Masking is the last layer — nothing consumes its mask; the "
            "import would silently drop the masking semantics")
    if input_shape is None:
        raise KerasImportError("could not determine input shape")

    lb = NeuralNetConfiguration.builder().seed(0).list()
    for lyr in layers:
        lb.layer(lyr)
    lb.set_input_type(tuple(input_shape))
    net = MultiLayerNetwork(lb.build()).init(device=device)
    # overwrite initialized params/state with imported weights
    for i, (p, st) in enumerate(zip(params, states)):
        for k, v in p.items():
            net.params[i][k] = _to_arrays(v, net.device)
        for k, v in st.items():
            net.states[i][k] = _to_arrays(v, net.device)
    return _rebound(net)


# ------------------------------------------------------------ layer builders


_MERGE_VERTICES = {"Add": "add", "Subtract": "sub", "Multiply": "mul",
                   "Average": "avg", "Maximum": "max", "Minimum": "min",
                   "Concatenate": None}
_MERGE_VERTICES.update({"Subtract": "subtract", "Multiply": "product"})


def _build_functional(config, weights, device=None):
    """Functional DAG → ComputationGraph (KerasModel.java parity). Merge
    layers map to vertices; imports are inference-ready (replace the head
    with an OutputLayer via TransferLearning-style surgery to train)."""
    from deeplearning4j_tpu_torch.nn import ComputationGraph
    from deeplearning4j_tpu_torch.nn.vertices import (ElementWiseVertex,
                                                      MergeVertex)

    cfgd = config["config"]
    layer_cfgs = cfgd["layers"]
    gb = NeuralNetConfiguration.builder().seed(0).graph_builder()
    input_shapes = []
    param_map = {}
    state_map = {}
    # (keras layer name, call node idx) -> CG node name; pass-through layers
    # (Flatten) alias to their inbound
    node_name = {}

    def cg_name(ref):
        return node_name.get(ref, ref[0])

    for lc in layer_cfgs:
        kcls = lc["class_name"]
        cfg = lc.get("config", {})
        name = cfg.get("name", kcls)
        calls = _inbound_refs_per_call(lc)
        if kcls == "InputLayer":
            shape = cfg.get("batch_shape") or cfg.get("batch_input_shape")
            gb.add_inputs(name)
            node_name[(name, 0)] = name
            input_shapes.append(tuple(shape[1:]))
            continue
        if kcls in _MERGE_VERTICES:
            op = _MERGE_VERTICES[kcls]
            for k, refs in enumerate(calls):
                nm = name if k == 0 else f"{name}@{k}"
                vertex = (MergeVertex() if op is None
                          else ElementWiseVertex(op=op))
                gb.add_vertex(nm, vertex, *[cg_name(r) for r in refs])
                node_name[(name, k)] = nm
            continue
        built = _LAYER_BUILDERS.get(kcls)
        if built is None:
            raise KerasImportError(f"unsupported Keras layer {kcls!r} ({name})")
        out = built(cfg, weights.get(name, []))
        lyr, p = out[0], out[1]
        st = out[2] if len(out) > 2 else {}
        if isinstance(lyr, _PendingMasking):
            raise KerasImportError(
                "Masking inside a functional (DAG) model is not supported — "
                "only the Sequential Masking->recurrent pattern imports")
        if lyr is None:  # pass-through (Flatten): downstream reads its input
            for k, refs in enumerate(calls):
                node_name[(name, k)] = cg_name(refs[0])
            continue
        for k, refs in enumerate(calls):
            inbound = [cg_name(r) for r in refs]
            if k == 0:
                gb.add_layer(name, lyr, *inbound)
                node_name[(name, 0)] = name
            else:  # weight sharing: computation repeats over call 0's params
                nm = f"{name}@{k}"
                gb.add_layer(nm, L.SharedLayer(source=name, layer=lyr),
                             *inbound)
                node_name[(name, k)] = nm
        param_map[name] = p
        state_map[name] = st
    outs = cfgd.get("output_layers", [])
    out_refs = ([(o[0], int(o[1]) if len(o) > 1 else 0) for o in outs]
                if outs and isinstance(outs[0], list)
                else [(outs[0], 0)] if outs
                else [(layer_cfgs[-1]["config"]["name"], 0)])
    out_names = [cg_name(r) for r in out_refs]
    gb.set_outputs(*out_names)
    gb.set_input_types(*input_shapes)
    net = ComputationGraph(gb.build()).init(device=device)
    for name, p in param_map.items():
        for k, v in p.items():
            net.params[name][k] = _to_arrays(v, net.device)
        for k, v in state_map.get(name, {}).items():
            net.states[name][k] = _to_arrays(v, net.device)
    return _rebound(net)


def _to_arrays(v, device):
    """Leaf arrays become fp32 tensors on the network's device; nested
    dicts (Bidirectional fwd/bwd) recurse."""
    if isinstance(v, dict):
        return {k: _to_arrays(x, device) for k, x in v.items()}
    return torch.from_numpy(np.array(v, np.float32, copy=True)).to(device)


def _rebound(net):
    """New tensors were bound: drop the casts and captured programs that
    read the initialized ones (as ``interop``'s loaders do)."""
    net._cast_cache = {}
    net._drop_programs()
    return net


def _dense(cfg, w):
    lyr = L.DenseLayer(n_in=int(w[0].shape[0]) if w else 0,
                       n_out=cfg["units"], activation=_act(cfg))
    p = {}
    if w:
        p["W"] = w[0]
        if cfg.get("use_bias", True) and len(w) > 1:
            p["b"] = w[1]
    return lyr, p


def _conv2d(cfg, w):
    lyr = L.ConvolutionLayer(
        n_out=cfg["filters"], kernel_size=tuple(cfg["kernel_size"]),
        stride=tuple(cfg["strides"]), padding=_pad(cfg),
        dilation=tuple(cfg.get("dilation_rate", (1, 1))),
        activation=_act(cfg), has_bias=cfg.get("use_bias", True))
    p = {}
    if w:
        p["W"] = w[0]
        if cfg.get("use_bias", True) and len(w) > 1:
            p["b"] = w[1]
    return lyr, p


def _sepconv2d(cfg, w):
    lyr = L.SeparableConvolution2D(
        n_out=cfg["filters"], kernel_size=tuple(cfg["kernel_size"]),
        stride=tuple(cfg["strides"]), padding=_pad(cfg),
        depth_multiplier=cfg.get("depth_multiplier", 1),
        activation=_act(cfg), has_bias=cfg.get("use_bias", True))
    p = {}
    if w:
        p["depthW"], p["pointW"] = w[0], w[1]
        if cfg.get("use_bias", True) and len(w) > 2:
            p["b"] = w[2]
    return lyr, p


def _bn(cfg, w):
    lyr = L.BatchNormalization(eps=cfg.get("epsilon", 1e-3),
                               decay=cfg.get("momentum", 0.99))
    p, st = {}, {}
    if w:
        # keras order: gamma, beta, moving_mean, moving_variance;
        # running stats live in layer STATE here, not params
        names = ["gamma", "beta", "mean", "var"]
        if not cfg.get("scale", True):
            names.remove("gamma")
        if not cfg.get("center", True):
            names.remove("beta")
        full = dict(zip(names, list(w)))
        st = {k: full.pop(k) for k in ("mean", "var") if k in full}
        p = full
    return lyr, p, st


def _pool2d_max(cfg, w):
    return L.SubsamplingLayer(kernel_size=tuple(cfg["pool_size"]),
                              stride=tuple(cfg["strides"] or cfg["pool_size"]),
                              padding=_pad(cfg), pooling_type="max"), {}


def _pool2d_avg(cfg, w):
    return L.SubsamplingLayer(kernel_size=tuple(cfg["pool_size"]),
                              stride=tuple(cfg["strides"] or cfg["pool_size"]),
                              padding=_pad(cfg), pooling_type="avg"), {}


def _perm_gates(arr, order, n):
    """Reorder fused gate blocks along the last axis."""
    blocks = np.split(np.asarray(arr), n, axis=-1)
    return np.concatenate([blocks[i] for i in order], axis=-1)


def _recurrent_act(cfg):
    """recurrent_activation with _act()'s semantics: dict unwrap + raise on
    unsupported names (no silent sigmoid substitution)."""
    return _act({"activation": cfg.get("recurrent_activation", "sigmoid")},
                default="sigmoid")


def _lstm(cfg, w):
    units = cfg["units"]
    lyr = R.LSTM(n_in=int(w[0].shape[0]) if w else 0, n_out=units,
                 activation=_act(cfg, "tanh"),
                 gate_activation=_recurrent_act(cfg))
    p = {}
    if w:
        # keras gate order [i,f,c,o] -> ours [i,f,o,g(c)]
        perm = (0, 1, 3, 2)
        p["W"] = _perm_gates(w[0], perm, 4)
        p["U"] = _perm_gates(w[1], perm, 4)
        b = w[2] if len(w) > 2 else np.zeros(4 * units, np.float32)
        p["b"] = _perm_gates(b, perm, 4)
    return lyr, p


def _conv_lstm2d(cfg, w):
    filters = cfg["filters"]
    dil = tuple(cfg.get("dilation_rate", (1, 1)))
    if dil != (1, 1):
        raise KerasImportError(
            "ConvLSTM2D dilation_rate != (1,1) is not supported")
    if cfg.get("data_format", "channels_last") != "channels_last":
        raise KerasImportError("ConvLSTM2D requires channels_last")
    lyr = R.ConvLSTM2D(
        n_in=int(w[0].shape[2]) if w else 0,
        n_out=filters,
        kernel_size=tuple(cfg["kernel_size"]),
        stride=tuple(cfg.get("strides", (1, 1))),
        padding=_pad(cfg),
        activation=_act(cfg, "tanh"),
        gate_activation=_recurrent_act(cfg),
        return_sequences=cfg.get("return_sequences", False),
    )
    p = {}
    if w:
        # keras gate order [i,f,c,o] -> ours [i,f,o,g(c)]; blocks live on the
        # last axis of both the input and recurrent kernels
        perm = (0, 1, 3, 2)
        p["W"] = _perm_gates(w[0], perm, 4)
        p["U"] = _perm_gates(w[1], perm, 4)
        b = w[2] if len(w) > 2 else np.zeros(4 * filters, np.float32)
        p["b"] = _perm_gates(b, perm, 4)
    return lyr, p


class _PendingMasking:
    """Sentinel from the Keras ``Masking`` layer: wraps the NEXT layer in
    MaskZeroLayer so the derived (input != mask_value) mask gates its scan —
    the Keras mask-propagation contract collapsed to the adjacent-consumer
    case (KerasMasking.java maps to MaskZeroLayer the same way)."""

    def __init__(self, mask_value):
        self.mask_value = float(mask_value)


def _gru(cfg, w):
    units = cfg["units"]
    if not cfg.get("reset_after", True):
        # reset_after=False multiplies r BEFORE the recurrent matmul — a
        # different recurrence; our GRU implements the (default, CuDNN/MXU)
        # reset-after form
        raise KerasImportError("GRU reset_after=False not supported; "
                               "re-save with reset_after=True (the default)")
    lyr = R.GRU(n_in=int(w[0].shape[0]) if w else 0, n_out=units,
                activation=_act(cfg, "tanh"),
                gate_activation=_recurrent_act(cfg),
                recurrent_bias=True)
    p = {}
    if w:
        # keras gate order [z,r,h] -> ours [r,z,n]
        perm = (1, 0, 2)
        p["W"] = _perm_gates(w[0], perm, 3)
        p["U"] = _perm_gates(w[1], perm, 3)
        b = w[2] if len(w) > 2 else np.zeros((2, 3 * units), np.float32)
        b = np.asarray(b)
        if b.ndim == 2:  # reset_after: row 0 = input bias, row 1 = recurrent
            p["b"] = _perm_gates(b[0], perm, 3)
            p["b_rec"] = _perm_gates(b[1], perm, 3)
        else:
            p["b"] = _perm_gates(b, perm, 3)
            p["b_rec"] = np.zeros((3 * units,), np.float32)
    return lyr, p


def _simple_rnn(cfg, w):
    units = cfg["units"]
    lyr = R.SimpleRnn(n_in=int(w[0].shape[0]) if w else 0, n_out=units,
                      activation=_act(cfg, "tanh"))
    p = {}
    if w:
        p["W"], p["U"] = w[0], w[1]
        p["b"] = w[2] if len(w) > 2 else np.zeros(units, np.float32)
    return lyr, p


def _embedding(cfg, w):
    lyr = L.EmbeddingLayer(n_in=cfg["input_dim"], n_out=cfg["output_dim"])
    return lyr, ({"W": w[0]} if w else {})


def _conv2d_transpose(cfg, w):
    """Keras Conv2DTranspose -> Deconvolution2D. Keras stores the kernel as
    (kh, kw, out, in); our deconv2d takes HWIO with I = input channels, and
    the transpose semantics additionally require the spatial FLIP (verified
    against an fp64 manual conv-transpose: flip+swap is exact; the keras
    kernel as-is through lax.conv_transpose is not)."""
    if cfg.get("output_padding") not in (None, [None, None]):
        raise NotImplementedError("Conv2DTranspose output_padding")
    if tuple(cfg.get("dilation_rate", (1, 1))) != (1, 1):
        raise NotImplementedError("Conv2DTranspose dilation")
    lyr = L.Deconvolution2D(
        n_out=cfg["filters"], kernel_size=tuple(cfg["kernel_size"]),
        stride=tuple(cfg["strides"]), padding=_pad(cfg),
        activation=_act(cfg), has_bias=cfg.get("use_bias", True))
    p = {}
    if w:
        p["W"] = np.ascontiguousarray(
            w[0][::-1, ::-1].transpose(0, 1, 3, 2))
        if cfg.get("use_bias", True) and len(w) > 1:
            p["b"] = w[1]
    return lyr, p


def _conv1d(cfg, w):
    if cfg.get("padding") == "causal":
        raise KerasImportError("Conv1D causal padding not supported")
    lyr = LS.Convolution1D(
        n_in=int(w[0].shape[1]) if w else 0,
        n_out=cfg["filters"], kernel_size=int(cfg["kernel_size"][0]),
        stride=int((cfg.get("strides") or [1])[0]),
        padding=cfg.get("padding", "valid").upper(),
        dilation=int((cfg.get("dilation_rate") or [1])[0]),
        activation=_act(cfg))
    p = {}
    if w:
        p["W"] = w[0]
        if len(w) > 1:
            p["b"] = w[1]
        else:
            lyr = dataclasses.replace(lyr, has_bias=False)
    return lyr, p


def _conv3d(cfg, w):
    lyr = LS.Convolution3D(
        n_in=int(w[0].shape[3]) if w else 0,
        n_out=cfg["filters"], kernel_size=tuple(cfg["kernel_size"]),
        stride=tuple(cfg.get("strides") or (1, 1, 1)),
        padding=cfg.get("padding", "valid").upper(),
        dilation=tuple(cfg.get("dilation_rate") or (1, 1, 1)),
        activation=_act(cfg))
    p = {}
    if w:
        p["W"] = w[0]
        if len(w) > 1:
            p["b"] = w[1]
        else:
            lyr = dataclasses.replace(lyr, has_bias=False)
    return lyr, p


def _depthwise2d(cfg, w):
    lyr = LS.DepthwiseConvolution2D(
        n_in=int(w[0].shape[2]) if w else 0,
        depth_multiplier=cfg.get("depth_multiplier", 1),
        kernel_size=tuple(cfg["kernel_size"]),
        stride=tuple(cfg.get("strides") or (1, 1)),
        padding=cfg.get("padding", "valid").upper(),
        activation=_act(cfg))
    p = {}
    if w:
        p["W"] = w[0]
        if len(w) > 1:
            p["b"] = w[1]
        else:
            lyr = dataclasses.replace(lyr, has_bias=False)
    return lyr, p


_RNN_BUILDERS_FOR_BIDIR = {}  # filled after _LAYER_BUILDERS below


def _bidirectional(cfg, w):
    inner_cfg = cfg["layer"]
    kcls = inner_cfg["class_name"]
    builder = _RNN_BUILDERS_FOR_BIDIR.get(kcls)
    if builder is None:
        raise KerasImportError(f"Bidirectional({kcls}) not supported")
    half = len(w) // 2
    fwd_lyr, pf = builder(inner_cfg["config"], w[:half])
    _, pb = builder(inner_cfg["config"], w[half:])
    mode = {"concat": "concat", "sum": "add", "mul": "mul",
            "ave": "ave"}.get(cfg.get("merge_mode", "concat"))
    if mode is None:
        raise KerasImportError(
            f"Bidirectional merge_mode {cfg.get('merge_mode')!r}")
    return R.Bidirectional(layer=fwd_lyr, mode=mode), {"fwd": pf, "bwd": pb}


def _time_distributed(cfg, w):
    inner_cfg = cfg["layer"]
    kcls = inner_cfg["class_name"]
    if kcls != "Dense":
        raise KerasImportError(f"TimeDistributed({kcls}) not supported "
                               "(Dense only)")
    inner, p = _dense(inner_cfg["config"], w)
    return LS.TimeDistributed(underlying=inner), p


def _prelu(cfg, w):
    alpha = np.asarray(w[0]) if w else None
    if alpha is not None and alpha.ndim > 1:
        # shared_axes collapse everything but the channel axis
        squeezed = alpha.squeeze()
        if squeezed.ndim > 1:
            raise KerasImportError("PReLU with per-position alpha (set "
                                   "shared_axes to all but the channel axis)")
        alpha = squeezed
    lyr = LS.PReLULayer(n_in=int(alpha.shape[0]) if alpha is not None else 0)
    return lyr, ({"alpha": alpha} if alpha is not None else {})


def _pool1d(pt):
    def build(cfg, w):
        return LS.Subsampling1DLayer(
            kernel_size=int(cfg["pool_size"][0]),
            stride=int((cfg.get("strides") or cfg["pool_size"])[0]),
            padding=cfg.get("padding", "valid").upper(),
            pooling_type=pt), {}
    return build


def _pool3d(pt):
    def build(cfg, w):
        return LS.Subsampling3DLayer(
            kernel_size=tuple(cfg["pool_size"]),
            stride=tuple(cfg.get("strides") or cfg["pool_size"]),
            padding=cfg.get("padding", "valid").upper(),
            pooling_type=pt), {}
    return build


_LAYER_BUILDERS = {
    "Dense": _dense,
    "Conv2D": _conv2d,
    "SeparableConv2D": _sepconv2d,
    "BatchNormalization": _bn,
    "MaxPooling2D": _pool2d_max,
    "AveragePooling2D": _pool2d_avg,
    "LSTM": _lstm,
    "GRU": _gru,
    "SimpleRNN": _simple_rnn,
    "Embedding": _embedding,
    "Dropout": lambda cfg, w: (L.DropoutLayer(rate=cfg.get("rate", 0.5)), {}),
    # DenseLayer flattens >2D input itself (channels_last order matches)
    "Flatten": lambda cfg, w: (None, {}),
    "Activation": lambda cfg, w: (L.ActivationLayer(activation=_act(cfg)), {}),
    # GlobalPoolingLayer pools every spatial axis (channels_last, rank-5
    # NDHWC included); _global_pool guards the configs it cannot honor
    "GlobalMaxPooling2D": lambda cfg, w: (_global_pool(cfg, "max"), {}),
    "GlobalAveragePooling2D": lambda cfg, w: (_global_pool(cfg, "avg"), {}),
    "GlobalMaxPooling1D": lambda cfg, w: (_global_pool(cfg, "max"), {}),
    "GlobalAveragePooling1D": lambda cfg, w: (_global_pool(cfg, "avg"), {}),
    "GlobalMaxPooling3D": lambda cfg, w: (_global_pool(cfg, "max"), {}),
    "GlobalAveragePooling3D": lambda cfg, w: (_global_pool(cfg, "avg"), {}),
    "ZeroPadding2D": lambda cfg, w: (L.ZeroPaddingLayer(
        padding=tuple(cfg["padding"]) if isinstance(cfg["padding"], (list, tuple))
        else cfg["padding"]), {}),
    "UpSampling2D": lambda cfg, w: (L.Upsampling2D(size=tuple(cfg["size"])), {}),
    "Cropping2D": lambda cfg, w: (L.Cropping2D(cropping=tuple(
        tuple(c) for c in cfg["cropping"])), {}),
    "LayerNormalization": lambda cfg, w: (
        L.LayerNormalization(eps=cfg.get("epsilon", 1e-3)),
        {"gamma": w[0], "beta": w[1]} if len(w) >= 2 else {}),
    # -- 1-D, 3-D, depthwise, wrappers and activations ---------------------
    "Conv1D": _conv1d,
    "Conv3D": _conv3d,
    "Conv2DTranspose": _conv2d_transpose,
    "DepthwiseConv2D": _depthwise2d,
    "Bidirectional": _bidirectional,
    "TimeDistributed": _time_distributed,
    "PReLU": _prelu,
    "MaxPooling1D": _pool1d("max"),
    "AveragePooling1D": _pool1d("avg"),
    "MaxPooling3D": _pool3d("max"),
    "AveragePooling3D": _pool3d("avg"),
    "ZeroPadding1D": lambda cfg, w: (LS.ZeroPadding1DLayer(
        padding=tuple(cfg["padding"]) if not isinstance(cfg["padding"], int)
        else (cfg["padding"],) * 2), {}),
    "Cropping1D": lambda cfg, w: (LS.Cropping1D(
        cropping=tuple(cfg["cropping"])), {}),
    "UpSampling1D": lambda cfg, w: (LS.Upsampling1D(size=cfg["size"]), {}),
    "ZeroPadding3D": lambda cfg, w: (LS.ZeroPadding3DLayer(
        padding=tuple(tuple(p) if not isinstance(p, int) else (p, p)
                      for p in cfg["padding"])), {}),
    "Cropping3D": lambda cfg, w: (LS.Cropping3D(
        cropping=tuple(tuple(c) for c in cfg["cropping"])), {}),
    "UpSampling3D": lambda cfg, w: (LS.Upsampling3D(
        size=cfg["size"][0] if not isinstance(cfg["size"], int)
        else cfg["size"]), {}),
    "RepeatVector": lambda cfg, w: (LS.RepeatVector(n=cfg["n"]), {}),
    "ELU": lambda cfg, w: (L.ActivationLayer(activation="elu"), {}),
    "ReLU": lambda cfg, w: (L.ActivationLayer(activation="relu"), {}),
    "Softmax": lambda cfg, w: (L.ActivationLayer(activation="softmax"), {}),
    # channel dropout ≈ elementwise dropout at import level: identical at
    # inference (golden path); training differs only in correlation structure
    "SpatialDropout1D": lambda cfg, w: (
        L.DropoutLayer(rate=cfg.get("rate", 0.5)), {}),
    "SpatialDropout2D": lambda cfg, w: (
        L.DropoutLayer(rate=cfg.get("rate", 0.5)), {}),
    # -- ConvLSTM2D, masking, LeakyReLU, noise --------------------------------
    "ConvLSTM2D": _conv_lstm2d,
    "Masking": lambda cfg, w: (
        _PendingMasking(cfg.get("mask_value", 0.0)), {}),
    "LeakyReLU": lambda cfg, w: (L.ActivationLayer(
        activation="leakyrelu",
        activation_args={"alpha": float(cfg.get(
            "negative_slope", cfg.get("alpha", 0.3)))}), {}),
    "GaussianNoise": lambda cfg, w: (None, {}),    # identity at inference
    "GaussianDropout": lambda cfg, w: (None, {}),  # identity at inference
}

_RNN_BUILDERS_FOR_BIDIR.update({
    "LSTM": _lstm, "GRU": _gru, "SimpleRNN": _simple_rnn,
})
