"""SameDiff core (counterpart of deeplearning4j_tpu/samediff/core.py):
graph recording, execution, autodiff and training.

The recorded graph is the reference's, node for node: the same
``Node`` records, op names, attrs (numpy dtypes included), variable names,
``graph.json`` and array files, so a graph saved by either package loads
in the other. What differs is how a graph runs:

- ``output`` (reference ``:989-1043``, jitted per signature) runs the
  recorded nodes through the port's op table. Outside
  ``nn.capture.disabled()`` each signature becomes a ``nn/capture.py``
  :class:`Program` (``note_trace("SameDiff.output", feeds)``), captured as
  a CUDA graph on the card. Programs live in a process-wide cache keyed by
  the graph's structural :meth:`SameDiff.fingerprint`, the signature and
  the device (``_EXEC_CACHE``, reference ``:478-524``, held weakly: a
  program's device memory goes with the last instance using it), so
  instances that share a structure share one program. Each call copies the calling
  instance's own arrays into the program's static buffers before the
  replay, so instances with different weights get their own answers.
- ``calculate_gradients`` (``:1122``) is autograd over the same trace, one
  program per signature (``"SameDiff.calculate_gradients"``).
- ``fit`` (``:1189``) runs one program per feed signature
  (``"SameDiff.fit"``): forward, ``torch.autograd.grad``, the updater on
  the device step sizes of ``nn/updaters.py::StepSizes``, the trainables
  and optimizer state updated in place.
- A graph whose control flow needs a value on the host (``__cf_if__``,
  ``__cf_while__``, ``__cf_loop__`` with a data-dependent trip count,
  ``if_cond``/``while_loop``) or that draws random numbers (a generator is
  seeded from its key constant on the host) is run eagerly by design:
  its programs are built with an ``eager`` reason, never captured, and
  ``programs()`` shows the reason. A graph that is capturable and fails to
  capture raises ``CaptureError``.
- Shape inference (``_infer``, reference ``:1057``: ``jax.eval_shape``)
  runs the graph on the ``meta`` device; where an op refuses meta tensors
  (it reads values on the host), a CPU run with the stored arrays and zero
  placeholders takes its place.
- Random values: JAX keys and torch generators never agree. A key
  constant holds the reference's key bits (``[0, seed]`` as uint32), and
  the port seeds a ``torch.Generator`` from them at each call, so one seed
  gives the same draws every call, as the reference's fixed key does.
  ``var``'s seeded init draws from a CPU generator seeded the same way.
- Feeds and stored arrays reach the device with ``jnp.asarray``'s types
  (64-bit types off: float64 -> float32, int64 -> int32).
"""

from __future__ import annotations

import base64
import dataclasses
import enum
import hashlib
import inspect
import io
import json
import weakref
import zipfile
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn import capture
from deeplearning4j_tpu_torch.nn import updaters as upd
from deeplearning4j_tpu_torch.nn import weights as winit
from deeplearning4j_tpu_torch.ops import registry
from deeplearning4j_tpu_torch.util.model_serializer import jax_items


class VariableType(enum.Enum):
    VARIABLE = "VARIABLE"      # trainable, persisted
    CONSTANT = "CONSTANT"      # fixed, persisted
    PLACEHOLDER = "PLACEHOLDER"  # fed per call
    ARRAY = "ARRAY"            # op output, recomputed


def _split_arity(sd, args, attrs):
    ns = attrs.get("num_or_sections")
    if ns is None:
        raise ValueError("split requires num_or_sections")
    return ns if isinstance(ns, int) else len(tuple(ns)) + 1


def _unstack_arity(sd, args, attrs):
    # 'num' is arity-only (the op takes just axis): consume it here
    num = attrs.pop("num", None)
    if num is not None:
        return num
    axis = attrs.get("axis", 0)
    shp = args[0].shape if hasattr(args[0], "shape") else None
    if shp is not None and shp[axis] is not None and shp[axis] >= 0:
        return shp[axis]
    raise ValueError("unstack requires num= when the input shape is unknown")


# Ops that return a tuple: fixed arity, or (sd, args, attrs) -> arity.
_MULTI_OUT: Dict[str, Any] = {
    "moments": 2,
    "top_k": 2,
    "qr": 2,
    "lu": 2,
    "eigh": 2,
    "eig": 2,
    "svd": 3,
    "batchnorm_train": 3,
    "split": _split_arity,
    "split_v": lambda sd, args, attrs: len(tuple(attrs["sizes"])),
    "unstack": _unstack_arity,
    "dynamic_partition": lambda sd, args, attrs: attrs["num_partitions"],
    "lstm_layer": 3,
    "gru_layer": 2,
    "rnn_layer": 2,
    "lstm_cell": 2,
}


@dataclasses.dataclass
class Node:
    """One recorded op: op name -> the op table's function at run time."""

    op: str
    inputs: Tuple[Any, ...]          # var names, or ("__lit__", pyscalar)
    outputs: Tuple[str, ...]
    attrs: Dict[str, Any]

    def to_dict(self):
        return {
            "op": self.op,
            "inputs": [list(i) if isinstance(i, tuple) else i
                       for i in self.inputs],
            "outputs": list(self.outputs),
            "attrs": _jsonify(self.attrs),
        }

    @staticmethod
    def from_dict(d):
        ins = tuple(tuple(i) if isinstance(i, list) else i
                    for i in d["inputs"])
        return Node(d["op"], ins, tuple(d["outputs"]), _unjsonify(d["attrs"]))


def _jsonify(x):
    if isinstance(x, dict):
        return {k: _jsonify(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return {"__tuple__": [_jsonify(v) for v in x]}
    if isinstance(x, np.integer):
        return int(x)
    if isinstance(x, np.floating):
        return float(x)
    if isinstance(x, type) and issubclass(x, np.generic):
        return {"__dtype__": np.dtype(x).name}
    if isinstance(x, np.dtype):
        return {"__dtype__": x.name}
    return x


def _unjsonify(x):
    if isinstance(x, dict):
        if "__tuple__" in x:
            return tuple(_unjsonify(v) for v in x["__tuple__"])
        if "__dtype__" in x:
            return np.dtype(x["__dtype__"])
        return {k: _unjsonify(v) for k, v in x.items()}
    return x


# ----------------------------------------------------------- array helpers

#: numpy types as ``jnp.asarray`` stores them with 64-bit types off
_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
           np.dtype(np.uint64): np.uint32,
           np.dtype(np.complex128): np.complex64}
_TORCH_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32,
                 torch.uint64: torch.uint32, torch.complex128: torch.complex64}


def _to_device(a, device) -> torch.Tensor:
    """An array, scalar or tensor on ``device`` in the type
    ``jnp.asarray`` gives it."""
    if isinstance(a, torch.Tensor):
        t = a.detach()
        t = t.to(_TORCH_NARROW.get(t.dtype, t.dtype))
        return t.to(device)
    arr = np.asarray(a)
    narrow = _NARROW.get(arr.dtype)
    if narrow is not None:
        arr = arr.astype(narrow)
    if not arr.flags.c_contiguous or not arr.flags.writeable:
        arr = arr.copy()  # (np.ascontiguousarray would make a 0-d array 1-d)
    return torch.from_numpy(arr).to(device)


def _torch_dtype(dt) -> torch.dtype:
    """A numpy type as the tensor type it is stored in on the device."""
    return _to_device(np.zeros((), np.dtype(dt)), "cpu").dtype


def _np_dtype(dt: torch.dtype):
    """A tensor type as the numpy type the reference reports; bfloat16,
    which numpy lacks, by its name."""
    if dt == torch.bfloat16:
        return "bfloat16"
    return np.dtype(str(dt).replace("torch.", ""))


def _host(v) -> np.ndarray:
    """A result on the host as numpy (bfloat16 as float32)."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy()
    return np.asarray(v)


# ------------------------------------------------------------ namespaces


class SDVariable:
    """Symbolic handle into a SameDiff graph (SDVariable.java parity).

    Arithmetic operators record ops; ``.eval()`` runs the graph up to this
    variable."""

    __slots__ = ("sd", "name", "vtype")

    def __init__(self, sd: "SameDiff", name: str, vtype: VariableType):
        self.sd = sd
        self.name = name
        self.vtype = vtype

    @property
    def shape(self) -> Optional[Tuple[int, ...]]:
        return self.sd._infer(self.name, "shape")

    @property
    def dtype(self):
        return self.sd._infer(self.name, "dtype")

    def eval(self, feeds: Optional[Dict[str, Any]] = None):
        return self.sd.output(feeds or {}, [self.name])[self.name]

    def get_arr(self):
        """getArr() parity: the stored value of a VARIABLE/CONSTANT."""
        return self.sd._arrays.get(self.name)

    def set_arr(self, value):
        self.sd._arrays[self.name] = np.asarray(value)
        self.sd._invalidate()

    def rename(self, new_name: str) -> "SDVariable":
        self.sd._rename(self.name, new_name)
        return self

    def _bin(self, opname, other, reverse=False):
        a, b = (other, self) if reverse else (self, other)
        return self.sd._op(opname, [a, b])

    def __add__(self, o):
        return self._bin("add", o)

    __radd__ = __add__

    def __sub__(self, o):
        return self._bin("subtract", o)

    def __rsub__(self, o):
        return self._bin("subtract", o, reverse=True)

    def __mul__(self, o):
        return self._bin("multiply", o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._bin("divide", o)

    def __rtruediv__(self, o):
        return self._bin("divide", o, reverse=True)

    def __pow__(self, o):
        return self._bin("pow", o)

    def __neg__(self):
        return self.sd._op("neg", [self])

    def __matmul__(self, o):
        return self._bin("matmul", o)

    def __gt__(self, o):
        return self._bin("greater", o)

    def __lt__(self, o):
        return self._bin("less", o)

    def __ge__(self, o):
        return self._bin("greaterequal", o)

    def __le__(self, o):
        return self._bin("lessequal", o)

    def eq(self, o):
        return self._bin("equals", o)

    def neq(self, o):
        return self._bin("notequals", o)

    def __getitem__(self, idx):
        if not isinstance(idx, tuple):
            idx = (idx,)
        spec = []
        for it in idx:
            if isinstance(it, int):
                spec.append(("i", it))
            elif isinstance(it, slice):
                spec.append(("s", it.start, it.stop, it.step))
            elif it is None:
                spec.append(("n",))
            elif it is Ellipsis:
                spec.append(("e",))
            else:
                raise TypeError(f"unsupported index {it!r}")
        return self.sd._op("getitem", [self], attrs={"spec": tuple(spec)})

    def sum(self, *axes, keepdims=False):
        return self.sd.math.sum(self, axis=axes or None, keepdims=keepdims)

    def mean(self, *axes, keepdims=False):
        return self.sd.math.mean(self, axis=axes or None, keepdims=keepdims)

    def max(self, *axes, keepdims=False):
        return self.sd.math.max(self, axis=axes or None, keepdims=keepdims)

    def min(self, *axes, keepdims=False):
        return self.sd.math.min(self, axis=axes or None, keepdims=keepdims)

    def std(self, *axes, keepdims=False, bias_corrected=True):
        return self.sd._op(
            "std", [self],
            attrs={"axis": axes or None, "keepdims": keepdims,
                   "bias_corrected": bias_corrected})

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return self.sd._op("reshape", [self], attrs={"shape": tuple(shape)})

    def transpose(self):
        return self.sd._op("transpose", [self])

    def permute(self, *dims):
        return self.sd._op("permute", [self], attrs={"axes": tuple(dims)})

    def cast(self, dtype):
        return self.sd._op("cast", [self], attrs={"dtype": np.dtype(dtype)})

    def add(self, o):
        return self.__add__(o)

    def sub(self, o):
        return self.__sub__(o)

    def mul(self, o):
        return self.__mul__(o)

    def div(self, o):
        return self.__truediv__(o)

    def mmul(self, o):
        return self.__matmul__(o)

    def __repr__(self):
        return f"SDVariable(name={self.name!r}, type={self.vtype.value})"


class _OpNamespace:
    """Dynamic namespace over the op table (SDMath/SDNN/... parity): any
    registered op is ``sd.<ns>.<opname>(*vars, **attrs)``; the aliases
    below keep DL4J's camelCase names."""

    _ALIAS: Dict[str, str] = {}

    def __init__(self, sd: "SameDiff"):
        self._sd = sd

    def __getattr__(self, opname: str):
        name = self._ALIAS.get(opname, opname)
        if not registry.has_op(name):
            raise AttributeError(
                f"op {opname!r} not in registry ({type(self).__name__})")

        def factory(*args, name_out=None, **attrs):
            spec = _MULTI_OUT.get(name)
            if spec is None:
                n_out = 1
            elif isinstance(spec, int):
                n_out = spec
            else:
                n_out = spec(self._sd, args, attrs)
            return self._sd._op(name, list(args), attrs=attrs, n_out=n_out,
                                name=name_out)

        factory.__name__ = name
        return factory


class SDMath(_OpNamespace):
    _ALIAS = {
        "squaredDifference": "squareddifference", "logSumExp": "logsumexp",
        "isNaN": "isnan", "isInfinite": "isinf", "countNonZero": "countnonzero",
        "cosineSimilarity": "cosinesimilarity", "euclideanDistance": "euclidean",
        "manhattanDistance": "manhattan", "oneHot": "onehot",
        "confusionMatrix": "confusion_matrix",
    }


class SDNN(_OpNamespace):
    _ALIAS = {
        "leakyRelu": "leakyrelu", "logSoftmax": "log_softmax",
        "softPlus": "softplus", "hardTanh": "hard_tanh",
        "hardSigmoid": "hard_sigmoid", "logSigmoid": "log_sigmoid",
        "layerNorm": "layernorm", "batchNorm": "batchnorm",
        "biasAdd": "bias_add", "dotProductAttention": "dot_product_attention",
        "multiHeadDotProductAttention": "multi_head_dot_product_attention",
        "linear": "xw_plus_b",
    }


class SDLoss(_OpNamespace):
    _ALIAS = {
        "softmaxCrossEntropy": "softmax_cross_entropy",
        "sigmoidCrossEntropy": "sigmoid_cross_entropy",
        "sparseSoftmaxCrossEntropy": "sparse_softmax_cross_entropy",
        "meanSquaredError": "mse_loss", "absoluteDifference": "mae_loss",
        "logLoss": "log_loss", "huberLoss": "huber_loss",
        "hingeLoss": "hinge_loss", "logPoisson": "poisson_loss",
        "cosineDistance": "cosine_distance_loss", "l2Loss": "l2_loss",
    }


class SDRandom(_OpNamespace):
    _ALIAS = {
        "normal": "random_normal", "uniform": "random_uniform",
        "bernoulli": "random_bernoulli", "exponential": "random_exponential",
        "logNormal": "random_lognormal",
    }


class SDLinalg(_OpNamespace):
    _ALIAS = {"mmul": "matmul", "matrixDeterminant": "matrix_determinant",
              "matrixInverse": "matrix_inverse", "tensorMmul": "tensormmul"}


class SDBitwise(_OpNamespace):
    _ALIAS = {"leftShift": "shift_left", "rightShift": "shift_right",
              "and_": "and", "or_": "or", "xor_": "xor"}


class SDRNN(_OpNamespace):
    """sd.rnn() parity (SDRNN.java): whole-sequence ops and cells."""

    _ALIAS = {"lstmLayer": "lstm_layer", "gruLayer": "gru_layer",
              "lstmCell": "lstm_cell", "gruCell": "gru_cell",
              "simpleRnn": "rnn_layer"}


class SDCNN(_OpNamespace):
    """sd.cnn() parity (SDCNN.java)."""

    _ALIAS = {"conv2d": "conv2d", "conv1d": "conv1d", "conv3d": "conv3d",
              "depthWiseConv2d": "depthwise_conv2d",
              "separableConv2d": "separable_conv2d",
              "deconv2d": "deconv2d", "maxPooling2d": "maxpool2d",
              "avgPooling2d": "avgpool2d", "maxPooling3d": "maxpool3d",
              "avgPooling3d": "avgpool3d", "upsampling2d": "upsampling2d",
              "im2Col": "im2col", "spaceToDepth": "space_to_depth",
              "depthToSpace": "depth_to_space", "batchToSpace": "batch_to_space",
              "localResponseNormalization": "lrn"}


class SDImage(_OpNamespace):
    """sd.image() parity (SDImage.java)."""

    _ALIAS = {"resizeBiLinear": "resize_bilinear",
              "resizeNearestNeighbor": "resize_nearest",
              "resizeBiCubic": "resize_bicubic",
              "cropAndResize": "crop_and_resize",
              "nonMaxSuppression": "non_max_suppression",
              "extractImagePatches": "extract_image_patches",
              "adjustContrast": "adjust_contrast",
              "adjustSaturation": "adjust_saturation",
              "adjustHue": "adjust_hue", "randomCrop": "random_crop",
              "rgbToHsv": "rgb_to_hsv", "hsvToRgb": "hsv_to_rgb",
              "rgbToYuv": "rgb_to_yuv", "yuvToRgb": "yuv_to_rgb"}


@dataclasses.dataclass
class TrainingConfig:
    """TrainingConfig.java parity: updater, feature/label placeholder
    mapping, and L1/L2 on the VARIABLEs added to the loss."""

    updater: upd.Updater = dataclasses.field(default_factory=lambda: upd.Adam())
    data_set_feature_mapping: Sequence[str] = ()
    data_set_label_mapping: Sequence[str] = ()
    l1: float = 0.0
    l2: float = 0.0
    minimize: bool = True

    def to_dict(self):
        return {
            "updater": self.updater.to_dict(),
            "data_set_feature_mapping": list(self.data_set_feature_mapping),
            "data_set_label_mapping": list(self.data_set_label_mapping),
            "l1": self.l1,
            "l2": self.l2,
            "minimize": self.minimize,
        }

    @staticmethod
    def from_dict(d):
        return TrainingConfig(
            updater=upd.updater_from_dict(d["updater"]),
            data_set_feature_mapping=d["data_set_feature_mapping"],
            data_set_label_mapping=d["data_set_label_mapping"],
            l1=d["l1"],
            l2=d["l2"],
            minimize=d.get("minimize", True),
        )


# ---------------------------------------------------------------------------
# Execution. _EXEC_CACHE: output() programs shared by structurally identical
# graphs (a reload, an importer re-run), keyed by fingerprint, signature and
# device; the arrays are program ARGUMENTS, copied in at each call. A
# program holds device memory (its static buffers, its CUDA graph's pool),
# so the cache holds it weakly: it lives while an instance's own table
# (``_jit_cache``) does.
# ---------------------------------------------------------------------------
_EXEC_CACHE: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()

#: custom ops (if_cond / while_loop) that branch or loop on the host
_HOST_CUSTOM: set = set()

_GEN_POS: Dict[str, Tuple[int, ...]] = {}


def _gen_positions(op: str) -> Tuple[int, ...]:
    """Positions of an op's ``gen`` parameter (the port's random ops take
    a generator where the reference's take a key)."""
    pos = _GEN_POS.get(op)
    if pos is None:
        try:
            params = list(inspect.signature(registry.get_op(op).fn).parameters)
        except (TypeError, ValueError):
            params = []
        pos = tuple(i for i, p in enumerate(params) if p == "gen")
        _GEN_POS[op] = pos
    return pos


def key_seed(key) -> int:
    """The seed a key constant stands for: the reference's PRNGKey bits
    ``[hi, lo]`` as one integer (any other integer array by its CRC)."""
    k = np.asarray(key.detach().cpu() if isinstance(key, torch.Tensor)
                   else key)
    if k.size == 2 and k.dtype.kind in "ui":
        hi, lo = (int(v) & 0xFFFFFFFF for v in k.reshape(-1))
        return (hi << 32) | lo
    return zlib.crc32(np.ascontiguousarray(k).tobytes())


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``'s bits for a seed in [0, 2**32)."""
    return np.asarray([0, int(seed) & 0xFFFFFFFF], np.uint32)


def _key_generator(key, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(key_seed(key) & ((1 << 63) - 1))
    return gen


def _required(nodes, targets) -> set:
    """ids of the nodes the targets need (a backward sweep)."""
    needed = set(targets)
    required: set = set()
    for node in reversed(nodes):
        if any(o in needed for o in node.outputs):
            required.add(id(node))
            for i in node.inputs:
                if isinstance(i, str):
                    needed.add(i)
    return required


def _trace_nodes(nodes, values: Dict[str, Any], targets: Sequence[str],
                 skip_known: bool = False):
    """Run ``nodes`` (recorded topologically) until all targets are
    computed (``skip_known``: not the nodes whose outputs ``values``
    already holds). Module-level so a shared program closes over a
    node-list snapshot, never over a whole SameDiff instance."""
    required = _required(nodes, targets)
    for node in nodes:
        if id(node) not in required:
            continue
        if skip_known and all(o in values for o in node.outputs):
            continue
        args = []
        for i in node.inputs:
            if isinstance(i, tuple):
                args.append(None if i[0] == "__none__" else i[1])
            else:
                args.append(values[i])
        if node.op.startswith("__cf_"):
            out = _exec_cf(node, args)
        else:
            for p in _gen_positions(node.op):
                if p < len(args) and isinstance(args[p],
                                                (torch.Tensor, np.ndarray)):
                    dev = args[p].device if isinstance(args[p], torch.Tensor) \
                        else "cpu"
                    args[p] = _key_generator(args[p], dev)
            out = registry.exec_op(node.op, *args, **node.attrs)
        if len(node.outputs) == 1:
            values[node.outputs[0]] = out
        else:
            for o, val in zip(node.outputs, out):
                values[o] = val
    return [values[t] for t in targets]


def _host_reason(nodes, targets=None) -> Optional[str]:
    """Why running ``nodes`` (those ``targets`` need) takes a value on the
    host at each call, or None when it can be captured."""
    req = _required(nodes, targets) if targets is not None else None
    for node in nodes:
        if req is not None and id(node) not in req:
            continue
        a = node.attrs
        if node.op in ("__cf_if__", "__cf_while__"):
            return f"{node.op} node {node.outputs[0]!r} branches on its " \
                   "predicate on the host"
        if node.op == "__cf_loop__" and not int(a.get("n_scan_out", 0)):
            return f"__cf_loop__ node {node.outputs[0]!r} has a " \
                   "data-dependent trip count"
        if node.op in _HOST_CUSTOM:
            return f"custom control flow {node.op!r} runs on the host"
        if not node.op.startswith("__cf_") and _gen_positions(node.op):
            return f"random op {node.op!r} seeds a generator from its key " \
                   "on the host"
        for key in ("body_spec", "then_spec", "else_spec", "cond_spec"):
            if key in a:
                sub = _spec_nodes(a[key])
                why = _host_reason(sub)
                if why is not None:
                    return why
    return None


def _spec_nodes(spec) -> List[Node]:
    meta = json.loads(spec["meta_json"])
    return [Node.from_dict(nd) for nd in meta["nodes"]]


def _stable_digest(obj) -> str:
    """Deterministic digest of attrs and structures: containers recurse,
    ndarrays hash shape, type and bytes, everything else its repr."""
    h = hashlib.sha256()

    def feed(o):
        if isinstance(o, dict):
            h.update(b"{")
            for k in sorted(o, key=str):
                feed(k)
                feed(o[k])
            h.update(b"}")
        elif isinstance(o, (list, tuple)):
            h.update(b"[")
            for v in o:
                feed(v)
            h.update(b"]")
        elif isinstance(o, np.ndarray):
            h.update(f"nd{o.shape}{o.dtype}".encode())
            h.update(np.ascontiguousarray(o).tobytes())
        else:
            h.update(repr(o).encode())

    feed(obj)
    return h.hexdigest()


def _merge_opt_state(fresh, old):
    """Conform a saved or stale optimizer state to a fresh one: the fresh
    tree gives the structure (the current trainables), old values are kept
    wherever path, shape and type still match."""
    if isinstance(fresh, dict):
        if not isinstance(old, dict):
            return fresh
        return {k: _merge_opt_state(v, old[k]) if k in old else v
                for k, v in fresh.items()}
    if isinstance(fresh, (tuple, list)):
        if not isinstance(old, (tuple, list)) or len(old) != len(fresh):
            return fresh
        return type(fresh)(_merge_opt_state(f, o) for f, o in zip(fresh, old))
    if getattr(old, "shape", None) == getattr(fresh, "shape", None) and (
            getattr(old, "dtype", None) == getattr(fresh, "dtype", None)):
        return old
    return fresh


def _getitem_op(x, spec=()):
    """Serializable basic indexing (SDIndex parity), one axis at a time: a
    negative step, which torch slicing lacks, is the positive-step slice
    over the same elements, flipped."""
    n_real = sum(1 for it in spec if it[0] in ("i", "s"))
    items = []
    for it in spec:
        if it[0] == "e":
            items.extend([("s", None, None, None)] * (x.dim() - n_real))
        else:
            items.append(it)
    out, axis = x, 0
    for it in items:
        if it[0] == "n":
            out = out.unsqueeze(axis)
            axis += 1
        elif it[0] == "i":
            out = out.select(axis, it[1])
        elif it[0] == "s":
            step = it[3] if it[3] is not None else 1
            lead = (slice(None),) * axis
            if step > 0:
                out = out[lead + (slice(it[1], it[2], step),)]
            else:
                rng = range(out.shape[axis])[slice(it[1], it[2], step)]
                if len(rng):
                    out = out[lead + (slice(rng[-1], rng[0] + 1, -step),)]
                    out = torch.flip(out, (axis,))
                else:
                    out = out[lead + (slice(0, 0),)]
            axis += 1
    return out


if not registry.has_op("getitem"):
    registry.register("getitem", _getitem_op, category="shape",
                      doc="Serializable basic indexing (SDIndex parity).")


class SameDiff:
    """The graph container and its run, grad and train front end
    (SameDiff.java parity). ``device``: where it runs (None: the current
    CUDA device; raises without one). Importers and ``load`` take it too."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._nodes: List[Node] = []
        self._vars: Dict[str, SDVariable] = {}
        self._host: Dict[str, np.ndarray] = {}   # VARIABLE + CONSTANT values
        # trainables fit() updated on the device, copied to _host when
        # _arrays is next read
        self._pending: Optional[Dict[str, torch.Tensor]] = None
        self._ph_specs: Dict[str, Tuple[Optional[Tuple[int, ...]], Any]] = {}
        self._producer: Dict[str, Node] = {}
        self._loss_vars: List[str] = []
        self._counter = 0
        self._jit_cache: Dict[Any, Any] = {}
        self._train_steps: Dict[Any, capture.Program] = {}
        self._train_leaves: Optional[list] = None
        self._opt_state = None
        self._sizes: Optional[upd.StepSizes] = None
        self._it_count = 0  # persists across fit() calls (schedules, Adam)
        self.training_config: Optional[TrainingConfig] = None
        self._listeners: List[Any] = []
        self._device_cache: Optional[Dict[str, torch.Tensor]] = None
        self._grad_fn_cache: Dict[Any, Any] = {}
        self._meta_cache: Dict[int, Dict[str, Any]] = {}
        # names of constants carrying the importers' -1 dynamic-dim
        # sentinel: output() refuses any target whose ancestors hold one
        self._poison_vars: set = set()
        self._fingerprint = None

    @property
    def _arrays(self) -> Dict[str, np.ndarray]:
        """The stored VARIABLE and CONSTANT values as numpy (the
        reference's ``_arrays``), current after any ``fit``."""
        if self._pending:
            for n, t in self._pending.items():
                self._host[n] = _host(t).astype(self._host[n].dtype,
                                                copy=False)
            self._pending = None
        return self._host

    @_arrays.setter
    def _arrays(self, value):
        self._host = value
        self._pending = None

    # -- namespaces ---------------------------------------------------------
    @property
    def math(self):
        return SDMath(self)

    @property
    def nn(self):
        return SDNN(self)

    @property
    def loss(self):
        return SDLoss(self)

    @property
    def random(self):
        return SDRandom(self)

    @property
    def linalg(self):
        return SDLinalg(self)

    @property
    def bitwise(self):
        return SDBitwise(self)

    @property
    def rnn(self):
        return SDRNN(self)

    @property
    def cnn(self):
        return SDCNN(self)

    @property
    def image(self):
        return SDImage(self)

    # -- variable creation --------------------------------------------------
    def _unique(self, base: str) -> str:
        if base not in self._vars:
            return base
        while True:
            self._counter += 1
            cand = f"{base}_{self._counter}"
            if cand not in self._vars:
                return cand

    def _register_var(self, name, vtype) -> SDVariable:
        v = SDVariable(self, name, vtype)
        self._vars[name] = v
        return v

    def var(self, name: str, *shape_or_array, weight_init: str = "xavier",
            dtype=np.float32, seed: int = 0) -> SDVariable:
        """Trainable variable: ``sd.var("w", 4, 3)`` (weight init by
        shape) or ``sd.var("w", array)``."""
        name = self._unique(name)
        if len(shape_or_array) == 1 and hasattr(shape_or_array[0], "__array__"):
            arr = np.asarray(shape_or_array[0], dtype=dtype)
        elif len(shape_or_array) == 1 and isinstance(shape_or_array[0],
                                                     (tuple, list)):
            arr = self._init_array(tuple(shape_or_array[0]), weight_init,
                                   dtype, name, seed)
        else:
            shape = tuple(int(s) for s in shape_or_array)
            arr = self._init_array(shape, weight_init, dtype, name, seed)
        self._arrays[name] = arr
        self._invalidate()
        return self._register_var(name, VariableType.VARIABLE)

    def _init_array(self, shape, weight_init, dtype, name, seed):
        # zlib.crc32, not hash(): str hashes are salted per process
        gen = torch.Generator().manual_seed(
            zlib.crc32(f"{name}:{seed}".encode()))
        arr = winit.init(gen, weight_init, shape)
        return np.asarray(arr.numpy(), dtype=dtype)

    def constant(self, value, name: str = "const") -> SDVariable:
        name = self._unique(name)
        self._arrays[name] = np.asarray(value)
        self._invalidate()
        return self._register_var(name, VariableType.CONSTANT)

    def placeholder(self, name: str, shape=None, dtype=np.float32) -> SDVariable:
        name = self._unique(name)
        shp = tuple(int(s) if s is not None and s >= 0 else -1 for s in shape) \
            if shape is not None else None
        self._ph_specs[name] = (shp, np.dtype(dtype))
        return self._register_var(name, VariableType.PLACEHOLDER)

    def one(self, name, *shape):
        return self.constant(np.ones(shape, np.float32), name)

    def zero(self, name, *shape):
        return self.constant(np.zeros(shape, np.float32), name)

    def get_variable(self, name) -> SDVariable:
        return self._vars[name]

    def variables(self) -> List[SDVariable]:
        return list(self._vars.values())

    def trainable_names(self) -> List[str]:
        return [n for n, v in self._vars.items()
                if v.vtype is VariableType.VARIABLE]

    def convert_to_variable(self, *names) -> "SameDiff":
        """CONSTANT -> VARIABLE (convertToVariable parity): makes imported
        weights trainable, the TF-import fine-tune path."""
        for name in names:
            name = name.name if isinstance(name, SDVariable) else name
            v = self._vars[name]
            if v.vtype is VariableType.VARIABLE:
                continue
            if v.vtype is not VariableType.CONSTANT:
                raise ValueError(f"{name!r} is {v.vtype.value}, not CONSTANT")
            self._vars[name] = SDVariable(self, name, VariableType.VARIABLE)
        self._invalidate()
        return self

    def convert_to_constant(self, *names) -> "SameDiff":
        """VARIABLE -> CONSTANT (convertToConstant parity: freeze)."""
        for name in names:
            name = name.name if isinstance(name, SDVariable) else name
            v = self._vars[name]
            if v.vtype is VariableType.CONSTANT:
                continue
            if v.vtype is not VariableType.VARIABLE:
                raise ValueError(f"{name!r} is {v.vtype.value}, not VARIABLE")
            self._vars[name] = SDVariable(self, name, VariableType.CONSTANT)
        self._invalidate()
        return self

    # -- graph recording ----------------------------------------------------
    def _coerce_input(self, a):
        if isinstance(a, SDVariable):
            if a.sd is not self:
                raise ValueError("variable belongs to another SameDiff instance")
            return a.name
        if isinstance(a, (int, float, bool)):
            return ("__lit__", a)
        if hasattr(a, "__array__"):
            return self.constant(np.asarray(a)).name
        if a is None:
            return ("__none__",)
        raise TypeError(f"cannot use {type(a)} as op input")

    def _op(self, opname: str, inputs: Sequence[Any], attrs: Optional[dict] = None,
            n_out: int = 1, name: Optional[str] = None):
        if not opname.startswith("__cf_"):   # structured control-flow nodes
            registry.get_op(opname)  # validate early
        ins = tuple(self._coerce_input(a) for a in inputs)
        base = name or opname
        outs = tuple(self._unique(base if n_out == 1 else f"{base}:{i}")
                     for i in range(n_out))
        node = Node(opname, ins, outs, dict(attrs or {}))
        self._nodes.append(node)
        out_vars = []
        for o in outs:
            v = self._register_var(o, VariableType.ARRAY)
            self._producer[o] = node
            out_vars.append(v)
        self._invalidate(values=False)
        return out_vars[0] if n_out == 1 else tuple(out_vars)

    def custom_op(self, fn: Callable, *inputs, n_out: int = 1, name: str = "custom"):
        """Record an arbitrary torch function as a node. Not serializable
        (save() raises): the escape hatch for Python control flow."""
        opname = f"__custom__:{name}:{id(fn)}"
        registry.register(opname, fn, category="custom")
        return self._op(opname, list(inputs), n_out=n_out, name=name)

    def if_cond(self, pred, true_fn, false_fn, *operands, name="cond"):
        """A branch on ``pred`` over tensor-level functions (Switch/Merge
        parity); the predicate is read on the host, so the graph runs
        eagerly."""
        def cond(p, *ops):
            return true_fn(*ops) if bool(p.reshape(())) else false_fn(*ops)

        out = self.custom_op(cond, pred, *operands, name=name)
        _HOST_CUSTOM.add(self._producer[out.name].op)
        return out

    def while_loop(self, cond_fn, body_fn, *loop_vars, name="while"):
        """A host while loop over tensor-level functions (Enter/Exit/
        LoopCond parity); returns the final values as a tuple. NOT
        serializable (closures): while_loop_graph saves."""
        n = len(loop_vars)

        def loop(*vs):
            vs = tuple(vs)
            while bool(torch.as_tensor(cond_fn(*vs)).reshape(())):
                vs = tuple(body_fn(*vs))
            return vs

        out = self.custom_op(loop, *loop_vars, n_out=n, name=name)
        first = out[0] if isinstance(out, tuple) else out
        _HOST_CUSTOM.add(self._producer[first.name].op)
        return out

    def while_loop_graph(self, cond_sd: "SameDiff", cond_inputs, cond_output,
                         body_sd: "SameDiff", body_inputs, body_outputs,
                         *loop_vars, name="while"):
        """SERIALIZABLE while loop (SameDiff.whileLoop parity): ``cond_sd``
        and ``body_sd`` are sub-graphs whose named placeholders receive the
        carried values; the node saves and loads with the graph."""
        def names(xs):
            return [x.name if isinstance(x, SDVariable) else x for x in xs]

        cond_spec = make_subgraph_spec(cond_sd, names(cond_inputs),
                                       names([cond_output]))
        body_spec = make_subgraph_spec(body_sd, names(body_inputs),
                                       names(body_outputs))
        n = len(loop_vars)
        return self._op("__cf_while__", list(loop_vars), attrs=dict(
            cond_spec=cond_spec, body_spec=body_spec, n_carried=n),
            n_out=n, name=name)

    def _rename(self, old, new):
        if new in self._vars:
            raise ValueError(f"variable {new!r} exists")
        v = self._vars.pop(old)
        v.name = new
        self._vars[new] = v
        if old in self._arrays:
            self._arrays[new] = self._arrays.pop(old)
        if old in self._ph_specs:
            self._ph_specs[new] = self._ph_specs.pop(old)
        for node in self._nodes:
            node.inputs = tuple(new if i == old else i for i in node.inputs)
            node.outputs = tuple(new if o == old else o for o in node.outputs)
        if old in self._producer:
            self._producer[new] = self._producer.pop(old)
        self._loss_vars = [new if n == old else n for n in self._loss_vars]
        self._invalidate()

    def _invalidate(self, values: bool = True):
        """The graph changed: forget the programs (and, when stored arrays
        or their set may have changed, the device copies and the inferred
        shapes)."""
        self._jit_cache.clear()
        self._train_steps = {}
        self._train_leaves = None
        self._grad_fn_cache.clear()
        self._fingerprint = None
        if values:
            self._device_cache = None
            self._meta_cache = {}

    def fingerprint(self) -> str:
        """Structural fingerprint of the graph: ops, wiring, attrs, stored
        array shapes and types (NOT values: they are program arguments).
        Equal fingerprints run the same program, which is what keys the
        cross-instance cache."""
        fp = self._fingerprint
        if fp is None:
            fp = _stable_digest([
                [(n.op, n.inputs, n.outputs, n.attrs) for n in self._nodes],
                sorted((k, v.shape, str(v.dtype))
                       for k, v in self._host.items()),
                sorted((k, spec[0], str(spec[1]))
                       for k, spec in self._ph_specs.items()),
                sorted(self._poison_vars),
            ])
            self._fingerprint = fp
        return fp

    # -- execution ----------------------------------------------------------
    def _trace(self, values: Dict[str, Any], targets: Sequence[str]):
        return _trace_nodes(self._nodes, values, targets)

    def _ancestors(self, targets: Sequence[str]) -> set:
        needed = set(targets)
        for node in reversed(self._nodes):
            if any(o in needed for o in node.outputs):
                needed.update(i for i in node.inputs if isinstance(i, str))
        return needed

    def _missing_check(self, feeds, targets):
        have = set(feeds) | set(self._host)
        missing = [n for n in self._ancestors(targets)
                   if n in self._ph_specs and n not in have]
        if missing:
            raise ValueError(f"placeholders not fed: {missing}")

    def poisoned_ancestor(self, targets: Sequence[str]) -> Optional[str]:
        """First dynamic-dim-sentinel constant among the ancestors of
        ``targets``, or None."""
        if not self._poison_vars:
            return None
        hit = self._ancestors(targets) & self._poison_vars
        return next(iter(hit)) if hit else None

    def poisoned_ancestor_refined(self, targets: Sequence[str]) -> Optional[str]:
        """``poisoned_ancestor`` refined by probing values at the static/
        runtime boundary (reference ``:913-947``): only a placeholder-free
        boundary var whose VALUE changes with the sentinel is a real hit."""
        if self.poisoned_ancestor(targets) is None:
            return None
        needed = self._ancestors(targets)
        static = set(self._arrays)
        for node in self._nodes:
            ins = [i for i in node.inputs if isinstance(i, str)]
            if all(i in static for i in ins):
                static.update(node.outputs)
        boundary = {t for t in targets if t in static and t in needed}
        for node in self._nodes:
            if not all(o in static for o in node.outputs):
                boundary.update(i for i in node.inputs
                                if isinstance(i, str) and i in static
                                and i in needed)
        for bv in sorted(boundary):
            if self.derives_poisoned(bv):
                return bv
        return None

    def derives_poisoned(self, var_name: str) -> bool:
        """True if ``var_name``'s VALUE depends on a dynamic-dim sentinel:
        evaluated twice with the -1 entries replaced by 2 and by 3, a
        difference means it does (reference ``:949-965``)."""
        if self.poisoned_ancestor([var_name]) is None:
            return False
        try:
            r2, r3 = (self._probe_poison_eval(var_name, p) for p in (2, 3))
        except Exception:
            return True  # un-evaluable chain: stay conservative
        return r2.shape != r3.shape or bool((r2 != r3).any())

    def _check_loss_poison(self):
        bad = self.poisoned_ancestor_refined(self._loss_vars)
        if bad is not None:
            raise NotImplementedError(
                f"loss depends on {bad!r}, a shape constant carrying the -1 "
                "dynamic-dim sentinel (graph imported with a dynamic batch "
                "dim) — training would silently compute with -1; re-export "
                "with static shapes")

    def _probe_poison_eval(self, var_name: str, probe: int) -> np.ndarray:
        """``var_name`` evaluated on the CPU with every poison constant's
        -1 entries replaced by ``probe`` (the chain is placeholder-free)."""
        vals: Dict[str, Any] = {}
        for k in self._ancestors([var_name]) & set(self._arrays):
            a = np.asarray(self._arrays[k])
            if k in self._poison_vars:
                a = np.where(a == -1, probe, a)
            vals[k] = _to_device(a, "cpu")
        with torch.no_grad():
            return _host(self._trace(vals, [var_name])[0])

    def output(self, feeds: Dict[str, Any], outputs: Sequence[str],
               *, _allow_poison: bool = False):
        """batchOutput()/exec() parity: the outputs' values as numpy, from
        one program per (outputs, feed signature), shared across instances
        (see the module doc). Within ``nn.capture.disabled()`` the nodes
        run eagerly with no program.

        ``_allow_poison`` is the importers' import-time constant
        evaluation: sentinel-derived shape math on purpose, run eagerly."""
        outputs = list(outputs)
        self._missing_check(feeds, outputs)
        feeds = {k: _to_device(v, self.device) for k, v in feeds.items()}
        if _allow_poison or not capture.enabled():
            if not _allow_poison:
                self._poison_check(outputs)
            with torch.no_grad():
                need = self._ancestors(outputs)
                vals = {k: v for k, v in self._device_arrays().items()
                        if k in need} if _allow_poison else \
                    dict(self._device_arrays())
                vals.update(feeds)
                res = self._trace(vals, outputs)
            return {n: _host(r) for n, r in zip(outputs, res)}
        sig = (
            tuple(outputs),
            tuple(sorted((k, tuple(v.shape), str(v.dtype))
                         for k, v in feeds.items())),
            len(self._nodes),
        )
        prog = self._jit_cache.get(sig)
        if prog is None:
            # the poison check only on a miss: its verdict is stable per
            # signature and the ancestor scan stays off the hot path
            self._poison_check(outputs)
            gkey = (self.fingerprint(), sig, str(self.device))
            prog = _EXEC_CACHE.get(gkey)
            if prog is None:
                prog = self._output_program(outputs, feeds)
                _EXEC_CACHE[gkey] = prog
            self._jit_cache[sig] = prog
        res = prog(self._device_arrays(), feeds)
        return {n: _host(r) for n, r in zip(outputs, res)}

    def _poison_check(self, outputs):
        bad = self.poisoned_ancestor_refined(outputs)
        if bad is not None:
            raise NotImplementedError(
                f"output depends on {bad!r}, a shape constant carrying the "
                "-1 dynamic-dim sentinel (graph imported with a dynamic "
                "batch dim) — its value would silently reach runtime "
                "arithmetic as -1; re-export with static shapes")

    def _output_program(self, outputs, feeds) -> capture.Program:
        # a snapshot, NOT self: the shared program outlives this instance
        # and must not pin its weights
        nodes = list(self._nodes)

        def run(arrays, phs):
            with torch.no_grad():
                vals = dict(arrays)
                vals.update(phs)
                return _trace_nodes(nodes, vals, outputs)

        return capture.Program(
            "SameDiff.output", run, (self._device_arrays(), feeds),
            device=self.device, trace_args=(feeds,),
            eager=_host_reason(nodes, outputs))

    def _device_arrays(self) -> Dict[str, torch.Tensor]:
        """Device copies of the stored arrays, kept until the graph or a
        value changes; ``fit`` updates the trainables' copies in place."""
        if self._device_cache is None:
            self._device_cache = {}
            host = self._arrays  # (current: a rebuild reads fit's values)
        else:
            host = self._host
        cache = self._device_cache
        if len(cache) != len(host):
            for k, v in host.items():
                if k not in cache:
                    cache[k] = _to_device(v, self.device)
        return cache

    def programs(self) -> Dict[str, capture.Program]:
        """Every program this instance holds, by function and signature;
        ``Program.eager`` says why one runs eagerly (None: captured)."""
        out = {f"SameDiff.output {sig}": p for sig, p in self._jit_cache.items()}
        out.update({f"SameDiff.calculate_gradients {sig}": p
                    for sig, p in self._grad_fn_cache.items()})
        out.update({f"SameDiff.fit {sig}": p
                    for sig, p in self._train_steps.items()})
        return out

    def exec(self, feeds: Dict[str, Any], *outputs: Union[str, SDVariable]):
        names = [o.name if isinstance(o, SDVariable) else o for o in outputs]
        return self.output(feeds, names)

    def _abstract_values(self, sub: int, device, vals=None) -> Dict[str, Any]:
        """Stored arrays and placeholders (-1 dims as ``sub``) as tensors
        on ``device``, added to ``vals``: empty on ``meta``, the real
        arrays and zero placeholders on the CPU."""
        vals = {} if vals is None else vals
        for k, v in (self._host if device == "meta" else self._arrays).items():
            if k in vals:
                continue
            if device == "meta":
                vals[k] = torch.empty(v.shape, dtype=_torch_dtype(v.dtype),
                                      device="meta")
            else:
                vals[k] = _to_device(v, "cpu")
        for k, (shp, dt) in self._ph_specs.items():
            if k not in vals:
                shape = tuple(sub if s == -1 else s for s in (shp or ()))
                vals[k] = torch.zeros(shape, dtype=_torch_dtype(dt),
                                      device=device)
        return vals

    def _abstract(self, name: str, sub: int):
        """``name``'s shape and type with placeholders' -1 dims as ``sub``,
        as a meta tensor: from the meta device (values cached as the graph
        grows), else from a CPU run."""
        cache = self._meta_cache.setdefault(sub, {})
        try:
            vals = self._abstract_values(sub, "meta", cache)
            with torch.no_grad():
                out = _trace_nodes(self._nodes, vals, [name],
                                   skip_known=True)[0]
        except Exception:
            vals = self._abstract_values(sub, "cpu")
            with torch.no_grad():
                out = _trace_nodes(self._nodes, vals, [name])[0]
        if not isinstance(out, torch.Tensor):
            out = torch.as_tensor(np.asarray(out))
        return torch.empty(out.shape, dtype=out.dtype, device="meta")

    def _infer(self, name: str, what: str, *, mark_dynamic: bool = False):
        """Shape/dtype inference. With ``mark_dynamic=True`` (shape only),
        dims that depend on a dynamic (-1) placeholder dim come back as -1:
        the graph is evaluated with -1 as 1 and as 2 and the dims that
        differ are marked."""
        v = self._vars[name]
        if v.vtype in (VariableType.VARIABLE, VariableType.CONSTANT):
            arr = self._host[name]
            return arr.shape if what == "shape" else arr.dtype
        if v.vtype is VariableType.PLACEHOLDER:
            shp, dt = self._ph_specs[name]
            return shp if what == "shape" else dt
        try:
            out = self._abstract(name, 1)
            if what != "shape":
                return _np_dtype(out.dtype)
            if mark_dynamic and any(-1 in (shp or ())
                                    for shp, _ in self._ph_specs.values()):
                out2 = self._abstract(name, 2)
                if out.dim() != out2.dim():
                    return None  # the rank itself depends on the dynamic dim
                return tuple(s if s == s2 else -1
                             for s, s2 in zip(out.shape, out2.shape))
            return tuple(out.shape)
        except Exception:
            return None

    # -- autodiff -----------------------------------------------------------
    def set_loss_variables(self, *names: Union[str, SDVariable]):
        self._loss_vars = [n.name if isinstance(n, SDVariable) else n
                           for n in names]
        self._invalidate(values=False)

    def _loss_value(self, values: Dict[str, Any], l1=0.0, l2=0.0,
                    trainables: Optional[Dict[str, Any]] = None):
        if not self._loss_vars:
            raise ValueError("no loss variables set (set_loss_variables)")
        outs = self._trace(values, self._loss_vars)
        loss = sum(torch.sum(o) for o in outs)
        if trainables is not None and (l1 or l2):
            for w in trainables.values():
                if l2:
                    loss = loss + l2 * 0.5 * torch.sum(torch.square(w))
                if l1:
                    loss = loss + l1 * torch.sum(torch.abs(w))
        return loss

    def calculate_gradients(self, feeds: Dict[str, Any],
                            *wrt: Union[str, SDVariable]) -> Dict[str, np.ndarray]:
        """calculateGradients() parity: d(sum of the loss vars)/d(wrt) by
        autograd over the recorded nodes, one program per signature."""
        names = [w.name if isinstance(w, SDVariable) else w for w in wrt]
        self._missing_check(feeds, self._loss_vars)
        feeds = {k: _to_device(v, self.device) for k, v in feeds.items()}
        diff = {}
        rest = dict(self._device_arrays())
        phs = dict(feeds)
        for n in names:
            if n in rest:
                diff[n] = rest.pop(n)
            elif n in phs:
                diff[n] = phs.pop(n)
            else:
                raise ValueError(f"cannot differentiate wrt ARRAY var {n!r}")

        def body(diff, rest, phs):
            with torch.enable_grad():
                d = {k: v.detach().requires_grad_(True)
                     for k, v in diff.items()}
                vals = dict(rest)
                vals.update(phs)
                vals.update(d)
                loss = self._loss_value(vals)
                gs = torch.autograd.grad(loss, list(d.values()),
                                         allow_unused=True)
            return {k: g if g is not None else torch.zeros_like(d[k])
                    for k, g in zip(d, gs)}

        if not capture.enabled():
            self._check_loss_poison()
            grads = body(diff, rest, phs)
            return {k: _host(v) for k, v in grads.items()}
        sig = (tuple(sorted(diff)), tuple(sorted(rest)),
               capture.dispatch_sig(feeds))
        gfn = self._grad_fn_cache.get(sig)
        if gfn is None:
            self._check_loss_poison()
            gfn = capture.Program(
                "SameDiff.calculate_gradients", body, (diff, rest, phs),
                device=self.device, trace_args=(feeds,),
                eager=_host_reason(self._nodes, self._loss_vars))
            self._grad_fn_cache[sig] = gfn
        grads = gfn(diff, rest, phs)
        return {k: _host(v) for k, v in grads.items()}

    def grad(self, name: str) -> np.ndarray:
        raise NotImplementedError(
            "use calculate_gradients(feeds, name) — grads are not graph "
            "variables in this design")

    # -- training -----------------------------------------------------------
    def set_training_config(self, cfg: TrainingConfig):
        self.training_config = cfg
        self._invalidate(values=False)
        self._sizes = None

    def add_listener(self, listener):
        self._listeners.append(listener)

    def _train_program(self, feeds, trainables, consts):
        """One train step for this feed signature: loss, gradients, the
        updater on the device step sizes, and the trainables and optimizer
        state updated in place."""
        cfg = self.training_config
        updater = cfg.updater
        names = list(trainables)
        params = [trainables[n] for n in names]
        slots = {s: [self._opt_state[s][n] for n in names]
                 for s in updater.slots}
        sizes = self._sizes

        def step(fd):
            with torch.enable_grad():
                tr = {n: p.detach().requires_grad_(True)
                      for n, p in zip(names, params)}
                vals = dict(consts)
                vals.update(tr)
                vals.update(fd)
                loss = self._loss_value(vals, cfg.l1, cfg.l2, trainables=tr)
                gs = torch.autograd.grad(loss, list(tr.values()),
                                         allow_unused=True)
            grads = [g if g is not None else torch.zeros_like(p)
                     for g, p in zip(gs, params)]
            with torch.no_grad():
                updates, new = updater.apply(grads, slots, sizes.views[0],
                                             params)
                if not isinstance(updater, upd.NoOp):
                    updates = [u.to(p.dtype) for u, p in zip(updates, params)]
                    if cfg.minimize:
                        torch._foreach_sub_(params, updates)
                    else:
                        torch._foreach_add_(params, updates)
                    for s in updater.slots:
                        torch._foreach_copy_(slots[s], new[s])
            return loss.detach()

        state = params + [t for s in updater.slots for t in slots[s]]
        if not capture.enabled():
            return step
        return capture.Program(
            "SameDiff.fit", step, (feeds,), device=self.device,
            state=state, trace_args=(feeds,),
            eager=_host_reason(self._nodes, self._loss_vars))

    def fit(self, data, epochs: int = 1, batch_size: Optional[int] = None):
        """fit(DataSetIterator) parity. ``data``: an iterator of DataSets,
        a DataSet, or a (features, labels) tuple. Each step is one program
        per feed signature (eager within ``nn.capture.disabled()``)."""
        from deeplearning4j_tpu_torch.data.dataset import DataSet
        from deeplearning4j_tpu_torch.data.iterators import ArrayDataSetIterator

        if self.training_config is None:
            raise ValueError("call set_training_config first")
        cfg = self.training_config
        if isinstance(data, tuple):
            data = DataSet(np.asarray(data[0]), np.asarray(data[1]))
        if isinstance(data, DataSet):
            data = ArrayDataSetIterator(
                data.features, data.labels,
                batch=batch_size or data.num_examples())

        arrays = self._device_arrays()
        names = self.trainable_names()
        trainables = {n: arrays[n] for n in names}
        consts = {k: v for k, v in arrays.items() if k not in trainables}
        if self._opt_state is None or self._train_leaves is None:
            fresh = cfg.updater.init_state(trainables)
            # the graph may have gained or lost trainables since the state
            # was made (or loaded): keep the moments where they still match
            self._opt_state = fresh if self._opt_state is None else \
                _merge_opt_state(fresh, self._opt_state)
        leaves = [t for _, t in jax_items(self._opt_state)] + list(
            trainables.values())
        if self._train_leaves is None or len(leaves) != len(
                self._train_leaves) or any(
                a is not b for a, b in zip(leaves, self._train_leaves)):
            self._check_loss_poison()
            self._train_steps = {}
            self._train_leaves = leaves
        if self._sizes is None:
            self._sizes = upd.StepSizes([(cfg.updater, ["sd"])], self.device)

        feat_names = list(cfg.data_set_feature_mapping)
        lab_names = list(cfg.data_set_label_mapping)
        history = []
        for _ in range(epochs):
            losses = []
            if hasattr(data, "reset"):
                data.reset()
            for ds in data:
                feats = ds.features if isinstance(ds.features, (list, tuple)) \
                    else [ds.features]
                labs = ds.labels if isinstance(ds.labels, (list, tuple)) \
                    else [ds.labels]
                feeds = {n: _to_device(a, self.device)
                         for n, a in zip(feat_names, feats)}
                feeds.update({n: _to_device(a, self.device)
                              for n, a in zip(lab_names, labs)})
                if capture.enabled():
                    sig = capture.dispatch_sig(feeds)
                    step = self._train_steps.get(sig)
                    if step is None:
                        step = self._train_steps[sig] = self._train_program(
                            feeds, trainables, consts)
                else:
                    step = self._train_program(feeds, trainables, consts)
                self._sizes.write(self._it_count)
                loss = step(feeds).clone()
                self._it_count += 1
                losses.append(loss)
                for lst in self._listeners:
                    if hasattr(lst, "iteration_done"):
                        lst.iteration_done(self, self._it_count, float(loss))
            history.append(float(np.mean(
                _host(torch.stack(losses)).astype(np.float32))))
        if trainables:
            self._pending = dict(trainables)  # copied out when next read
        # no _invalidate(): the device copies are the updated trainables,
        # and the programs and optimizer state carry on to the next fit()
        return history

    def score(self, feeds: Dict[str, Any]) -> float:
        feeds = {k: _to_device(v, self.device) for k, v in feeds.items()}
        vals = dict(self._device_arrays())
        vals.update(feeds)
        with torch.no_grad():
            return float(self._loss_value(vals))

    # -- serialization ------------------------------------------------------
    def save(self, path: str, save_updater_state: bool = False):
        """sd.save(file) parity: zip{graph.json, arrays.npz[, updater.npz]}
        in the reference's format ``dl4j-tpu-samediff-v1``; the updater
        leaves in jax.tree_util order, so either package loads the other's
        file."""
        for node in self._nodes:
            if node.op.startswith("__custom__"):
                raise ValueError(
                    f"graph contains non-serializable custom op {node.op!r}")
        meta = {
            "format": "dl4j-tpu-samediff-v1",
            "vars": [
                {"name": v.name, "type": v.vtype.value,
                 **({"shape": list(self._ph_specs[v.name][0] or []),
                     "dtype": np.dtype(self._ph_specs[v.name][1]).name}
                    if v.vtype is VariableType.PLACEHOLDER else {})}
                for v in self._vars.values()
            ],
            "nodes": [n.to_dict() for n in self._nodes],
            "loss_vars": self._loss_vars,
            "training_config": self.training_config.to_dict()
            if self.training_config else None,
            "it_count": self._it_count,
            **({"poison_vars": sorted(self._poison_vars)}
               if self._poison_vars else {}),
        }
        buf = io.BytesIO()
        np.savez(buf, **self._arrays)
        with zipfile.ZipFile(path, "w") as zf:
            zf.writestr("graph.json", json.dumps(meta))
            zf.writestr("arrays.npz", buf.getvalue())
            if save_updater_state and self._opt_state is not None:
                sbuf = io.BytesIO()
                np.savez(sbuf, *[_host(x) for _, x in
                                 jax_items(self._opt_state)])
                zf.writestr("updater.npz", sbuf.getvalue())

    @staticmethod
    def load(path: str, device=None) -> "SameDiff":
        sd = SameDiff(device=device)
        with zipfile.ZipFile(path) as zf:
            meta = json.loads(zf.read("graph.json"))
            arrays = np.load(io.BytesIO(zf.read("arrays.npz")))
            sd._arrays = {k: arrays[k] for k in arrays.files}
            _restore_vars(sd, meta)
            sd._loss_vars = meta["loss_vars"]
            sd._it_count = meta.get("it_count", 0)
            sd._poison_vars = set(meta.get("poison_vars", ()))
            if meta.get("training_config"):
                sd.training_config = TrainingConfig.from_dict(
                    meta["training_config"])
            if "updater.npz" in zf.namelist() and sd.training_config:
                st = np.load(io.BytesIO(zf.read("updater.npz")))
                flat = [st[f"arr_{i}"] for i in range(len(st.files))]
                arrs = sd._device_arrays()
                ref = sd.training_config.updater.init_state(
                    {n: arrs[n] for n in sd.trainable_names()})
                items = jax_items(ref)
                if len(items) != len(flat):
                    raise ValueError(
                        f"updater.npz has {len(flat)} arrays, the updater "
                        f"needs {len(items)}")
                for (_, dst), src in zip(items, flat):
                    dst.copy_(_to_device(src, sd.device))
                sd._opt_state = ref
        return sd

    # -- introspection ------------------------------------------------------
    def summary(self) -> str:
        lines = [f"SameDiff: {len(self._vars)} vars, {len(self._nodes)} ops"]
        for v in self._vars.values():
            lines.append(f"  {v.vtype.value:<12} {v.name}")
        for n in self._nodes:
            lines.append(
                f"  op {n.op}({', '.join(map(str, n.inputs))}) -> {n.outputs}")
        return "\n".join(lines)

    def ops(self) -> List[Node]:
        return list(self._nodes)

    def __repr__(self):
        return f"SameDiff(vars={len(self._vars)}, ops={len(self._nodes)})"


def _restore_vars(sd: SameDiff, meta: dict) -> None:
    for vd in meta["vars"]:
        vt = VariableType(vd["type"])
        v = sd._register_var(vd["name"], vt)
        if vt is VariableType.PLACEHOLDER:
            shp = tuple(vd.get("shape", [])) or None
            sd._ph_specs[v.name] = (shp, np.dtype(vd.get("dtype", "float32")))
    sd._nodes = [Node.from_dict(nd) for nd in meta["nodes"]]
    for node in sd._nodes:
        for o in node.outputs:
            sd._producer[o] = node


# ---------------------------------------------------------------------------
# Structured (serializable) control-flow nodes, "__cf_*" ops (reference
# :1347-1528). Each imported ONNX Loop/If/Scan and TF While/If is ONE node
# whose attrs carry the sub-graph as an opaque JSON spec (graph meta and a
# base64 npz of its constants), so save()/load() round-trips it. The port
# runs the sub-graph eagerly per iteration or branch: an If and a While
# read their predicate on the host (so a graph holding one is never
# captured), a Scan and a Loop with a static trip count run a fixed number
# of steps on the device.
# ---------------------------------------------------------------------------


def make_subgraph_spec(sub_sd: SameDiff, in_names, out_names) -> dict:
    """Serializable spec of a sub-SameDiff, as an opaque JSON string so the
    attr jsonifier does not rewrap its nested lists."""
    meta = {
        "vars": [
            {"name": v.name, "type": v.vtype.value,
             **({"shape": list(sub_sd._ph_specs[v.name][0] or []),
                 "dtype": np.dtype(sub_sd._ph_specs[v.name][1]).name}
                if v.vtype is VariableType.PLACEHOLDER else {})}
            for v in sub_sd._vars.values()
        ],
        "nodes": [n.to_dict() for n in sub_sd._nodes],
        "inputs": list(in_names),
        "outputs": list(out_names),
    }
    buf = io.BytesIO()
    np.savez(buf, **{k: np.asarray(v) for k, v in sub_sd._arrays.items()})
    return {
        "meta_json": json.dumps(meta),
        "arrays_b64": base64.b64encode(buf.getvalue()).decode("ascii"),
    }


def _spec_to_runner(spec: dict):
    """spec -> (run(*tensors) -> [tensors], n_outputs); the sub-graph's
    constants follow the first tensor argument's device."""
    meta = json.loads(spec["meta_json"])
    sub = SameDiff(device="cpu")
    arrays = np.load(io.BytesIO(base64.b64decode(spec["arrays_b64"])))
    sub._arrays = {k: arrays[k] for k in arrays.files}
    _restore_vars(sub, meta)
    ins = list(meta["inputs"])
    outs = list(meta["outputs"])
    on_device: Dict[str, Dict[str, torch.Tensor]] = {}

    def run(*arrs):
        dev = next((a.device for a in arrs if isinstance(a, torch.Tensor)),
                   torch.device("cpu"))
        consts = on_device.get(str(dev))
        if consts is None:
            consts = on_device[str(dev)] = {
                k: _to_device(v, dev) for k, v in sub._arrays.items()}
        vals = dict(consts)
        vals.update(zip(ins, arrs))
        return sub._trace(vals, outs)

    return run, len(outs)


def _cf_runner(node: Node, key: str):
    cache = getattr(node, "_cf_cache", None)
    if cache is None:
        cache = {}
        node._cf_cache = cache
    if key not in cache:
        cache[key] = _spec_to_runner(node.attrs[key])
    return cache[key]


def _flag(v) -> torch.Tensor:
    return torch.as_tensor(v).reshape(()).to(torch.bool)


def _pick(cond, new, old):
    return torch.where(cond, torch.as_tensor(new), torch.as_tensor(old))


def _exec_cf(node: Node, args):
    a = node.attrs
    if node.op == "__cf_if__":
        run_t, _ = _cf_runner(node, "then_spec")
        run_e, _ = _cf_runner(node, "else_spec")
        t_idx = [int(i) for i in a["t_idx"]]
        e_idx = [int(i) for i in a["e_idx"]]
        n_out = int(a["n_out"])
        pred, *caps = args
        if bool(_flag(pred)):
            out = tuple(run_t(*[caps[i] for i in t_idx]))
        else:
            out = tuple(run_e(*[caps[i] for i in e_idx]))
        return out if n_out > 1 else out[0]

    if node.op == "__cf_scan__":
        run, n_out = _cf_runner(node, "body_spec")
        L, S = int(a["n_state"]), int(a["n_scan"])
        st = tuple(args[:L])
        sc = tuple(args[L:L + S])
        capsv = tuple(args[L + S:])
        ys: List[list] = []
        for t in range(sc[0].shape[0] if sc else 0):
            outs = run(*st, *[x[t] for x in sc], *capsv)
            st = tuple(outs[:L])
            ys.append(list(outs[L:]))
        stacked = tuple(torch.stack([y[j] for y in ys])
                        for j in range(n_out - L)) if ys else ()
        out = tuple(st) + stacked
        return out if len(out) > 1 else out[0]

    if node.op == "__cf_loop__":
        run, n_out = _cf_runner(node, "body_spec")
        N = int(a["n_carried"])
        K = int(a["n_scan_out"])
        has_cond = bool(a["has_cond"])
        m_static = a.get("m_static")
        dynamic_m = bool(a.get("dynamic_m"))
        if K > 0:  # scan form (static trip count): no host predicate
            i = 0
            cond = torch.ones((), dtype=torch.bool)
            if has_cond:
                cond = _flag(args[0])
                i = 1
            carr = tuple(args[i:i + N])
            capsv = tuple(args[i + N:])
            dev = next((x.device for x in args
                        if isinstance(x, torch.Tensor)), None)
            cond = cond.to(dev) if dev is not None else cond
            scans: List[list] = []
            for it in range(int(m_static)):
                outs = run(torch.tensor(it, dtype=torch.int32, device=dev),
                           cond, *carr, *capsv)
                new_cond = cond & _flag(outs[0])
                carr = tuple(_pick(cond, nw, old)
                             for nw, old in zip(outs[1:1 + N], carr))
                cond = new_cond
                scans.append(list(outs[1 + N:]))
            stacked = tuple(torch.stack([s[j] for s in scans])
                            for j in range(K))
            return tuple(carr) + stacked
        i = 0
        limit = None
        if dynamic_m:
            limit = int(torch.as_tensor(args[0]).reshape(()))
            i = 1
        elif m_static is not None:
            limit = min(int(m_static), 2**31 - 1)
        cond = True
        if has_cond:
            cond = bool(_flag(args[i]))
            i += 1
        carr = tuple(args[i:i + N])
        capsv = tuple(args[i + N:])
        dev = next((x.device for x in args if isinstance(x, torch.Tensor)),
                   None)
        it = 0
        while cond and (limit is None or it < limit):
            outs = run(torch.tensor(it, dtype=torch.int32, device=dev),
                       torch.tensor(cond, device=dev), *carr, *capsv)
            cond = bool(_flag(outs[0]))
            carr = tuple(outs[1:1 + N])
            it += 1
        return carr if N > 1 else carr[0]

    if node.op == "__cf_while__":
        # TF2 functional While: separate cond/body graphs, explicit args
        cond_run, _ = _cf_runner(node, "cond_spec")
        body_run, _ = _cf_runner(node, "body_spec")
        n = int(a["n_carried"])
        vs = tuple(args)
        # TensorList carries: freshly reserved lists enter as (N, 0);
        # re-seed them with the body's OUTPUT shape, as the reference does
        # to keep its while carry shape-invariant
        if any(isinstance(v, torch.Tensor) and 0 in v.shape for v in vs):
            shapes = [torch.as_tensor(o) for o in body_run(*vs)]
            vs = tuple(
                torch.zeros(s.shape, dtype=s.dtype, device=s.device)
                if isinstance(v, torch.Tensor) and tuple(v.shape) != tuple(
                    s.shape) and 0 in v.shape else v
                for v, s in zip(vs, shapes))
        while bool(_flag(cond_run(*vs)[0])):
            vs = tuple(body_run(*vs))
        return vs if n > 1 else vs[0]

    raise ValueError(f"unknown control-flow op {node.op!r}")
