"""ONNX ModelProto -> SameDiff importer (counterpart of
deeplearning4j_tpu/imports/onnx_import.py; samediff-import-onnx).

The proto is read with the ``protomini`` wire codec against ONNX's field
numbers (no ``onnx`` package). One rule per ONNX op type (all 161 of the
reference), each onto the op table by name: an imported ``Conv`` reaches
the conv kernels through ``conv2d`` (NCHW/OIHW graphs are transposed to
NHWC/HWIO at the boundary), an imported ``LSTM`` reaches the LSTM segment
kernel through ``lstm_layer``. Shape arguments (Reshape targets, axes
tensors) must be initializers/Constants, becoming static attrs. Loop, If
and Scan become serializable ``__cf_*`` nodes (``samediff/core.py``).
ONNX's Random ops draw from a generator seeded from the reference's key
bits, so their values are the port's own.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

import torch

from deeplearning4j_tpu_torch.imports import protomini as pm
from deeplearning4j_tpu_torch.samediff.core import (SameDiff, SDVariable,
                                                    make_subgraph_spec,
                                                    prng_key)

# ONNX TensorProto.DataType
_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 5: np.int16, 6: np.int32,
           7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
           12: np.uint32, 13: np.uint64}


def parse_tensor(buf: bytes) -> np.ndarray:
    f = pm.decode(buf)
    dims = pm.get_ints(f, 1)
    dt = _DTYPES[pm.get_int(f, 2, 1)]
    raw = pm.get_bytes(f, 9, None)
    if raw is not None:
        arr = np.frombuffer(raw, dtype=dt).copy()
    elif dt == np.float32:
        arr = np.asarray(pm.get_floats(f, 4), np.float32)
    elif dt in (np.int32, np.int8, np.int16, np.bool_, np.uint8):
        arr = np.asarray(pm.get_ints(f, 5), dt)
    elif dt == np.int64:
        arr = np.asarray(pm.get_ints(f, 7), np.int64)
    elif dt == np.float64:
        arr = np.asarray(pm.get_doubles(f, 10), np.float64)
    else:
        raise NotImplementedError(f"tensor dtype {dt}")
    return arr.reshape(dims) if dims else arr.reshape(())


def tensor_name(buf: bytes) -> str:
    return pm.get_str(pm.decode(buf), 8)


class _GraphAttr:
    """Raw GraphProto bytes carried as a node attribute (Loop/If/Scan
    bodies) — wrapped so rules can tell them from string attrs."""

    __slots__ = ("buf",)

    def __init__(self, buf: bytes):
        self.buf = buf


class _Node:
    def __init__(self, buf: bytes):
        f = pm.decode(buf)
        self.inputs = pm.get_strs(f, 1)
        self.outputs = pm.get_strs(f, 2)
        self.name = pm.get_str(f, 3)
        self.op_type = pm.get_str(f, 4)
        self.attrs: Dict[str, object] = {}
        for ab in pm.get_messages(f, 5):
            af = pm.decode(ab)
            aname = pm.get_str(af, 1)
            atype = pm.get_int(af, 20)
            if atype == 1:    # FLOAT
                self.attrs[aname] = pm.get_float(af, 2)
            elif atype == 2:  # INT
                self.attrs[aname] = pm.get_int(af, 3)
            elif atype == 3:  # STRING
                self.attrs[aname] = pm.get_str(af, 4)
            elif atype == 4:  # TENSOR
                self.attrs[aname] = parse_tensor(pm.get_bytes(af, 5))
            elif atype == 5:  # GRAPH (control-flow body)
                self.attrs[aname] = _GraphAttr(pm.get_bytes(af, 6))
            elif atype == 6:  # FLOATS
                self.attrs[aname] = pm.get_floats(af, 7)
            elif atype == 7:  # INTS
                self.attrs[aname] = pm.get_ints(af, 8)
            elif atype == 8:  # STRINGS (e.g. RNN `activations`)
                self.attrs[aname] = pm.get_strs(af, 9)
            elif atype == 10:  # GRAPHS
                self.attrs[aname] = [
                    _GraphAttr(b) for b in pm.get_messages(af, 11)]
            else:
                self.attrs[aname] = None

    def attr(self, name, default=None):
        return self.attrs.get(name, default)


def _value_info(buf: bytes):
    """ValueInfoProto → (name, shape|None, dtype|None)."""
    f = pm.decode(buf)
    name = pm.get_str(f, 1)
    tbuf = pm.get_bytes(f, 2, None)
    shape = dtype = None
    if tbuf is not None:
        tf_ = pm.decode(tbuf)
        tt = pm.get_bytes(tf_, 1, None)  # tensor_type
        if tt is not None:
            ttf = pm.decode(tt)
            dtype = _DTYPES.get(pm.get_int(ttf, 1, 1))
            sbuf = pm.get_bytes(ttf, 2, None)
            if sbuf is not None:
                dims = []
                for db in pm.get_messages(pm.decode(sbuf), 1):
                    df = pm.decode(db)
                    dims.append(pm.get_int(df, 1, -1) or -1)
                shape = tuple(dims)
    return name, shape, dtype


_ORULES: Dict[str, Callable] = {}


def orule(*ops):
    def deco(fn):
        for o in ops:
            _ORULES[o] = fn
        return fn
    return deco


class OnnxImporter:
    """``device``: the imported graph's (None: the current CUDA device)."""

    def __init__(self, model_bytes: bytes = None, *, graph_buf: bytes = None,
                 device=None):
        if graph_buf is None:
            mf = pm.decode(memoryview(model_bytes))
            graph_buf = pm.get_bytes(mf, 7)
        gf = pm.decode(graph_buf)
        self.nodes = [_Node(b) for b in pm.get_messages(gf, 1)]
        self.initializers = {
            tensor_name(b): parse_tensor(b) for b in pm.get_messages(gf, 5)
        }
        self.graph_inputs = [_value_info(b) for b in pm.get_messages(gf, 11)]
        self.graph_outputs = [_value_info(b)[0] for b in pm.get_messages(gf, 12)]
        self.sd = SameDiff(device=device)
        self.vars: Dict[str, SDVariable] = {}
        self.const_vals: Dict[str, np.ndarray] = {}
        # sd-var names of Shape-fold constants carrying the -1 dynamic-dim
        # sentinel (torch dynamic_axes exports) — const() refuses values
        # derived from these unless the calling rule opts in, so the
        # sentinel can never silently reach Slice/Tile/arithmetic as a
        # plain -1 (only Reshape targets express a dynamic dim under XLA).
        # Shared with the graph's poison set: output() additionally refuses
        # targets whose runtime ancestors include one of these constants.
        self.dyn_vars = self.sd._poison_vars

    def get(self, name: str) -> SDVariable:
        return self.vars[name]

    @staticmethod
    def has_input(node, i: int) -> bool:
        """ONNX optional-input convention: empty-string name = omitted."""
        return len(node.inputs) > i and node.inputs[i] != ""

    def const(self, name: str, *, allow_dynamic: bool = False) -> np.ndarray:
        if name not in self.const_vals:
            # eager-eval fallback: shape chains (Shape→Gather→Unsqueeze→
            # Concat…, torch LSTM/attention exports build state shapes and
            # masks this way) are placeholder-free once Shape folds — run
            # the producing subgraph now and record the value
            try:
                v = self.vars[name]
                val = np.asarray(
                    self.sd.output({}, [v.name], _allow_poison=True)[v.name])
            except Exception as e:
                raise NotImplementedError(
                    f"input {name!r} must be an initializer/Constant (static "
                    f"shapes under XLA); eager eval failed: {e!r}") from e
            self.const_vals[name] = val
        if not allow_dynamic and self._derives_dynamic(name):
            raise NotImplementedError(
                f"const input {name!r} derives from a dynamic (-1) "
                "placeholder dim (torch dynamic_axes export) — only a "
                "Reshape target can carry a dynamic dim under XLA; export "
                "without dynamic_axes or feed static shapes")
        return self.const_vals[name]

    def _derives_dynamic(self, name: str) -> bool:
        """True if `name`'s value derives (through the recorded graph) from
        a Shape fold that contained the -1 dynamic-dim sentinel."""
        v = self.vars.get(name)
        return v is not None and self.sd.derives_poisoned(v.name)

    def set(self, name: str, var, const_val=None):
        self.vars[name] = var
        if const_val is not None:
            self.const_vals[name] = np.asarray(const_val)

    def build(self) -> SameDiff:
        for name, arr in self.initializers.items():
            self.set(name, self.sd.constant(arr, name=name), const_val=arr)
        for name, shape, dtype in self.graph_inputs:
            if name in self.vars:
                continue  # initializer also listed as input (pre-IR4 style)
            self.set(name, self.sd.placeholder(
                name, shape=shape, dtype=dtype or np.float32))
        for node in self.nodes:
            fn = _ORULES.get(node.op_type)
            if fn is None:
                raise NotImplementedError(
                    f"no import rule for ONNX op {node.op_type!r} "
                    f"({len(_ORULES)} op types supported)")
            fn(self, node)
        # rules that lower one ONNX node to several graph ops (Gemm, Conv)
        # leave the final var under an internal name; alias graph outputs to
        # their ONNX names so callers can address them
        for out in self.graph_outputs:
            v = self.vars.get(out)
            if v is not None and v.name != out:
                self.vars[out] = self.sd._op("identity", [v], name=out)
        # import-time version of the output() poison check: if any graph
        # output's runtime ancestors include a dynamic-dim sentinel constant
        # (it slipped past const() into real arithmetic), fail now — not at
        # the first inference call
        bad = self.sd.poisoned_ancestor_refined(
            [self.vars[o].name for o in self.graph_outputs
             if o in self.vars])
        if bad is not None:
            raise NotImplementedError(
                f"graph output computes with {bad!r}, a shape constant "
                "carrying the -1 dynamic-dim sentinel (torch dynamic_axes "
                "export) — re-export with static shapes")
        self.sd.onnx_outputs = list(self.graph_outputs)
        return self.sd


def import_onnx(model, *, device=None) -> SameDiff:
    """bytes | path -> SameDiff on ``device`` (outputs listed in
    sd.onnx_outputs)."""
    if isinstance(model, str):
        with open(model, "rb") as f:
            model = f.read()
    return OnnxImporter(model, device=device).build()


# ---------------------------------------------------------------- op rules

_OBIN = {"Add": "add", "Sub": "subtract", "Mul": "multiply", "Div": "divide",
         "Pow": "pow", "MatMul": "matmul", "Greater": "greater", "Less": "less",
         "Equal": "equals", "Max": "maximum", "Min": "minimum", "And": "and",
         "Or": "or", "LessOrEqual": "lessequal",
         "GreaterOrEqual": "greaterequal", "Xor": "xor"}
_OUN = {"Relu": "relu", "Sigmoid": "sigmoid", "Tanh": "tanh", "Exp": "exp",
        "Log": "log", "Sqrt": "sqrt", "Neg": "neg", "Abs": "abs",
        "Erf": "erf", "Floor": "floor", "Ceil": "ceil", "Round": "round",
        "Softplus": "softplus", "Softsign": "softsign", "Sign": "sign",
        "Reciprocal": "reciprocal", "Not": "not", "Selu": "selu",
        "Sin": "sin", "Cos": "cos", "Tan": "tan", "Mish": "mish",
        "HardSigmoid": "hard_sigmoid", "HardSwish": "hardswish",
        "IsNaN": "isnan", "Identity": "identity",
        "Atan": "atan", "Asin": "asin", "Acos": "acos", "Sinh": "sinh",
        "Cosh": "cosh", "Atanh": "atanh", "Asinh": "asinh", "Acosh": "acosh",
        "Det": "matrix_determinant"}


def _register_onnx_simple():
    def bin_rule(opname):
        def fn(m, node):
            a, b = m.get(node.inputs[0]), m.get(node.inputs[1])
            m.set(node.outputs[0], m.sd._op(opname, [a, b],
                                            name=node.outputs[0]))
        return fn

    def un_rule(opname):
        def fn(m, node):
            m.set(node.outputs[0], m.sd._op(opname, [m.get(node.inputs[0])],
                                            name=node.outputs[0]))
        return fn

    for o, n in _OBIN.items():
        _ORULES[o] = bin_rule(n)
    for o, n in _OUN.items():
        _ORULES[o] = un_rule(n)


_register_onnx_simple()


@orule("Constant")
def _o_const(m, node):
    val = node.attr("value")
    if val is None:
        raise NotImplementedError("Constant without tensor value")
    m.set(node.outputs[0], m.sd.constant(val, name=node.outputs[0]),
          const_val=val)


@orule("Gemm")
def _o_gemm(m, node):
    a, b = m.get(node.inputs[0]), m.get(node.inputs[1])
    alpha = node.attr("alpha", 1.0)
    beta = node.attr("beta", 1.0)
    y = m.sd._op("matmul", [a, b], attrs=dict(
        transpose_a=bool(node.attr("transA", 0)),
        transpose_b=bool(node.attr("transB", 0))))
    if alpha != 1.0:
        y = m.sd._op("scalar_mul", [y, float(alpha)])
    if len(node.inputs) > 2:
        c = m.get(node.inputs[2])
        if beta != 1.0:
            c = m.sd._op("scalar_mul", [c, float(beta)])
        y = m.sd._op("add", [y, c])
    m.set(node.outputs[0], y)


@orule("Softmax")
def _o_softmax(m, node):
    m.set(node.outputs[0], m.sd._op(
        "softmax", [m.get(node.inputs[0])],
        attrs=dict(axis=node.attr("axis", -1)), name=node.outputs[0]))


@orule("LogSoftmax")
def _o_log_softmax(m, node):
    m.set(node.outputs[0], m.sd._op(
        "log_softmax", [m.get(node.inputs[0])],
        attrs=dict(axis=node.attr("axis", -1)), name=node.outputs[0]))


@orule("Reshape")
def _o_reshape(m, node):
    x = m.get(node.inputs[0])
    # the reshape op resolves one -1 at runtime — the one consumer where the
    # dynamic-dim sentinel is expressible, so it opts in
    shape = [int(s) for s in m.const(node.inputs[1], allow_dynamic=True)]
    if 0 in shape and not node.attr("allowzero", 0):
        # ONNX: dim 0 = copy the corresponding input dim (torch RNN exports
        # emit e.g. [0, 0, -1])
        xs = x.shape
        if xs is None:
            raise NotImplementedError("Reshape 0-dim with unknown input shape")
        shape = [xs[i] if s == 0 else s for i, s in enumerate(shape)]
        if sum(1 for s in shape if s == -1) > 1:
            # a copied dim was itself dynamic (-1) next to an explicit -1 —
            # the reshape op allows only one unknown dim
            raise NotImplementedError(
                "Reshape 0-dim copying a dynamic input dim alongside -1")
    m.set(node.outputs[0], m.sd._op("reshape", [x],
                                    attrs=dict(shape=tuple(shape)),
                                    name=node.outputs[0]))


@orule("Flatten")
def _o_flatten(m, node):
    x = m.get(node.inputs[0])
    axis = node.attr("axis", 1)
    if axis != 1:
        raise NotImplementedError("Flatten axis != 1")
    shp = x.shape
    if shp is not None and all(s is not None and s >= 0 for s in shp[1:]):
        trailing = int(np.prod(shp[1:])) if len(shp) > 1 else 1
        shape = (-1, trailing)  # batch dim may be dynamic
    else:
        raise NotImplementedError("Flatten with unknown trailing dims")
    m.set(node.outputs[0], m.sd._op("reshape", [x], attrs=dict(shape=shape),
                                    name=node.outputs[0]))


@orule("Transpose")
def _o_transpose(m, node):
    x = m.get(node.inputs[0])
    perm = node.attr("perm")
    m.set(node.outputs[0], m.sd._op(
        "permute" if perm else "transpose", [x],
        attrs=dict(axes=tuple(perm)) if perm else {}, name=node.outputs[0]))


@orule("Concat")
def _o_concat(m, node):
    vs = [m.get(i) for i in node.inputs]
    m.set(node.outputs[0], m.sd._op("concat_n", vs,
                                    attrs=dict(axis=node.attr("axis", 0)),
                                    name=node.outputs[0]))


@orule("Squeeze")
def _o_squeeze(m, node):
    x = m.get(node.inputs[0])
    axes = node.attr("axes")
    if axes is None and m.has_input(node, 1):  # opset 13: axes as input
        axes = [int(a) for a in m.const(node.inputs[1])]
    m.set(node.outputs[0], m.sd._op(
        "squeeze", [x], attrs=dict(axis=tuple(axes)) if axes else {},
        name=node.outputs[0]))


@orule("Unsqueeze")
def _o_unsqueeze(m, node):
    x = m.get(node.inputs[0])
    axes = node.attr("axes")
    if axes is None and m.has_input(node, 1):
        axes = [int(a) for a in m.const(node.inputs[1])]
    v = x
    for a in sorted(axes):
        v = m.sd._op("expand_dims", [v], attrs=dict(axis=int(a)))
    m.set(node.outputs[0], v)


@orule("Gather")
def _o_gather(m, node):
    x, idx = m.get(node.inputs[0]), m.get(node.inputs[1])
    m.set(node.outputs[0], m.sd._op("gather", [x, idx],
                                    attrs=dict(axis=node.attr("axis", 0)),
                                    name=node.outputs[0]))


@orule("ReduceMean", "ReduceSum", "ReduceMax", "ReduceMin")
def _o_reduce(m, node):
    opname = {"ReduceMean": "mean", "ReduceSum": "sum", "ReduceMax": "max",
              "ReduceMin": "min"}[node.op_type]
    x = m.get(node.inputs[0])
    axes = node.attr("axes")
    if axes is None and m.has_input(node, 1):
        axes = [int(a) for a in m.const(node.inputs[1])]
    kd = bool(node.attr("keepdims", 1))
    attrs = dict(keepdims=kd)
    if axes:
        attrs["axis"] = tuple(axes) if len(axes) > 1 else int(axes[0])
    m.set(node.outputs[0], m.sd._op(opname, [x], attrs=attrs,
                                    name=node.outputs[0]))


def _reduce_axes_attrs(m, node):
    axes = node.attr("axes")
    if axes is None and m.has_input(node, 1):
        axes = [int(a) for a in m.const(node.inputs[1])]
    attrs = dict(keepdims=bool(node.attr("keepdims", 1)))
    if axes:
        attrs["axis"] = tuple(axes) if len(axes) > 1 else int(axes[0])
    return attrs


@orule("ReduceProd")
def _o_reduce_prod(m, node):
    m.set(node.outputs[0], m.sd._op("prod", [m.get(node.inputs[0])],
                                    attrs=_reduce_axes_attrs(m, node),
                                    name=node.outputs[0]))


@orule("ReduceL1", "ReduceL2", "ReduceSumSquare", "ReduceLogSum",
       "ReduceLogSumExp")
def _o_reduce_composed(m, node):
    x = m.get(node.inputs[0])
    attrs = _reduce_axes_attrs(m, node)
    t = node.op_type
    if t == "ReduceLogSumExp":
        out = m.sd._op("logsumexp", [x], attrs=attrs)
    else:
        pre = {"ReduceL1": "abs", "ReduceL2": "square",
               "ReduceSumSquare": "square", "ReduceLogSum": None}[t]
        v = m.sd._op(pre, [x]) if pre else x
        out = m.sd._op("sum", [v], attrs=attrs)
        if t == "ReduceL2":
            out = m.sd._op("sqrt", [out])
        elif t == "ReduceLogSum":
            out = m.sd._op("log", [out])
    m.set(node.outputs[0], m.sd._op("identity", [out], name=node.outputs[0]))


@orule("Sum", "Mean")
def _o_variadic(m, node):
    acc = m.get(node.inputs[0])
    for i in node.inputs[1:]:
        acc = m.sd._op("add", [acc, m.get(i)])
    if node.op_type == "Mean" and len(node.inputs) > 1:
        acc = m.sd._op("divide", [acc, m.sd.constant(
            np.float32(len(node.inputs)), name=(node.name or "mean") + "_n")])
    m.set(node.outputs[0], m.sd._op("identity", [acc], name=node.outputs[0]))


@orule("CastLike")
def _o_cast_like(m, node):
    x, like = m.get(node.inputs[0]), m.get(node.inputs[1])
    dt = like.dtype
    if dt is None:
        raise NotImplementedError("CastLike target dtype unknown")
    m.set(node.outputs[0], m.sd._op("cast", [x], attrs=dict(dtype=np.dtype(dt)),
                                    name=node.outputs[0]))


@orule("Size")
def _o_size(m, node):
    shp = m.get(node.inputs[0]).shape
    if shp is None or any(s is None or s < 0 for s in shp):
        raise NotImplementedError("Size of dynamically-shaped tensor")
    arr = np.asarray(int(np.prod(shp)), np.int64)
    m.set(node.outputs[0], m.sd.constant(arr, name=node.outputs[0]),
          const_val=arr)


@orule("EyeLike")
def _o_eyelike(m, node):
    shp = m.get(node.inputs[0]).shape
    if shp is None or len(shp) != 2:
        raise NotImplementedError("EyeLike needs a static 2-D input")
    dt = _DTYPES[node.attr("dtype")] if node.attr("dtype") else \
        (m.get(node.inputs[0]).dtype or np.float32)
    arr = np.eye(shp[0], shp[1], k=int(node.attr("k", 0)), dtype=dt)
    m.set(node.outputs[0], m.sd.constant(arr, name=node.outputs[0]),
          const_val=arr)


@orule("GatherND")
def _o_gather_nd(m, node):
    if node.attr("batch_dims", 0):
        raise NotImplementedError("GatherND batch_dims != 0")
    x, idx = m.get(node.inputs[0]), m.get(node.inputs[1])
    m.set(node.outputs[0], m.sd._op("gather_nd", [x, idx],
                                    name=node.outputs[0]))


@orule("Celu")
def _o_celu(m, node):
    m.set(node.outputs[0], m.sd._op(
        "celu", [m.get(node.inputs[0])],
        attrs=dict(alpha=float(node.attr("alpha", 1.0))),
        name=node.outputs[0]))


@orule("ThresholdedRelu")
def _o_thresholded_relu(m, node):
    m.set(node.outputs[0], m.sd._op(
        "thresholded_relu", [m.get(node.inputs[0])],
        attrs=dict(alpha=float(node.attr("alpha", 1.0))),
        name=node.outputs[0]))


@orule("Shrink")
def _o_shrink(m, node):
    m.set(node.outputs[0], m.sd._op(
        "shrink", [m.get(node.inputs[0])],
        attrs=dict(lambd=float(node.attr("lambd", 0.5)),
                   bias=float(node.attr("bias", 0.0))),
        name=node.outputs[0]))


@orule("LpNormalization")
def _o_lp_norm(m, node):
    if int(node.attr("p", 2)) != 2:
        raise NotImplementedError("LpNormalization p != 2")
    m.set(node.outputs[0], m.sd._op(
        "l2_normalize", [m.get(node.inputs[0])],
        attrs=dict(axis=int(node.attr("axis", -1))),
        name=node.outputs[0]))


@orule("Cast")
def _o_cast(m, node):
    dt = _DTYPES[node.attr("to", 1)]
    m.set(node.outputs[0], m.sd._op("cast", [m.get(node.inputs[0])],
                                    attrs=dict(dtype=dt), name=node.outputs[0]))


@orule("Dropout")
def _o_dropout(m, node):  # inference: identity
    m.set(node.outputs[0], m.get(node.inputs[0]))


@orule("Clip")
def _o_clip(m, node):
    x = m.get(node.inputs[0])
    lo = (float(np.asarray(m.const(node.inputs[1])))
          if m.has_input(node, 1) else node.attr("min", -np.inf))
    hi = (float(np.asarray(m.const(node.inputs[2])))
          if m.has_input(node, 2) else node.attr("max", np.inf))
    m.set(node.outputs[0], m.sd._op("clipbyvalue", [x],
                                    attrs=dict(clip_min=lo, clip_max=hi),
                                    name=node.outputs[0]))


@orule("LeakyRelu")
def _o_leaky(m, node):
    m.set(node.outputs[0], m.sd._op(
        "leakyrelu", [m.get(node.inputs[0])],
        attrs=dict(alpha=node.attr("alpha", 0.01)), name=node.outputs[0]))


@orule("Gelu")
def _o_gelu(m, node):
    m.set(node.outputs[0], m.sd._op("gelu", [m.get(node.inputs[0])],
                                    name=node.outputs[0]))


@orule("Where")
def _o_where(m, node):
    c, a, b = (m.get(i) for i in node.inputs)
    m.set(node.outputs[0], m.sd._op("where", [c, a, b], name=node.outputs[0]))


@orule("Conv")
def _o_conv(m, node):
    # ONNX is NCHW with OIHW weights; our conv is NHWC/HWIO (TPU layout)
    x, w = m.get(node.inputs[0]), m.get(node.inputs[1])
    strides = tuple(node.attr("strides", [1, 1]))
    pads = node.attr("pads", [0, 0, 0, 0])
    dil = tuple(node.attr("dilations", [1, 1]))
    group = node.attr("group", 1)
    auto_pad = node.attr("auto_pad", "NOTSET")
    xh = m.sd._op("permute", [x], attrs=dict(axes=(0, 2, 3, 1)))
    if auto_pad in ("SAME_UPPER", "SAME_LOWER"):
        padding = "SAME"
    elif pads[0] == pads[2] and pads[1] == pads[3]:
        padding = (pads[0], pads[1])
    else:  # asymmetric: explicit zero-pad then VALID conv
        xh = m.sd._op("pad", [xh], attrs=dict(
            paddings=((0, 0), (pads[0], pads[2]), (pads[1], pads[3]), (0, 0))))
        padding = "VALID"
    wh = m.sd._op("permute", [w], attrs=dict(axes=(2, 3, 1, 0)))  # OIHW→HWIO
    attrs = dict(strides=strides, padding=padding, dilation=dil,
                 feature_group_count=group)
    ins = [xh, wh]
    if len(node.inputs) > 2:
        ins.append(m.get(node.inputs[2]))
    y = m.sd._op("conv2d", ins, attrs=attrs)
    m.set(node.outputs[0], m.sd._op("permute", [y], attrs=dict(axes=(0, 3, 1, 2)),
                                    name=node.outputs[0]))


@orule("MaxPool", "AveragePool")
def _o_pool(m, node):
    x = m.get(node.inputs[0])
    k = tuple(node.attr("kernel_shape"))
    # ONNX spec: strides default to 1 per spatial axis (NOT kernel_shape —
    # torch always writes the attr, so the corpus never hit this default)
    strides = tuple(node.attr("strides", [1] * len(k)))
    pads = node.attr("pads", [0, 0, 0, 0])
    xh = m.sd._op("permute", [x], attrs=dict(axes=(0, 2, 3, 1)))
    if node.attr("auto_pad", "NOTSET") in ("SAME_UPPER", "SAME_LOWER"):
        padding = "SAME"
    elif all(p == 0 for p in pads):
        padding = "VALID"
    elif pads[0] == pads[2] and pads[1] == pads[3]:
        padding = (pads[0], pads[1])
    elif node.op_type == "MaxPool":  # asymmetric: -inf pad then VALID
        xh = m.sd._op("pad", [xh], attrs=dict(
            paddings=((0, 0), (pads[0], pads[2]), (pads[1], pads[3]), (0, 0)),
            constant_value=float("-inf")))
        padding = "VALID"
    elif node.attr("count_include_pad", 0):  # zero-pad counts toward the mean
        xh = m.sd._op("pad", [xh], attrs=dict(
            paddings=((0, 0), (pads[0], pads[2]), (pads[1], pads[3]), (0, 0))))
        padding = "VALID"
    else:
        raise NotImplementedError(
            "asymmetric AveragePool pads with count_include_pad=0")
    y = m.sd._op("maxpool2d" if node.op_type == "MaxPool" else "avgpool2d",
                 [xh], attrs=dict(kernel=k, strides=strides, padding=padding))
    m.set(node.outputs[0], m.sd._op("permute", [y], attrs=dict(axes=(0, 3, 1, 2)),
                                    name=node.outputs[0]))


def _spatial_axes(x):
    """All spatial axes of an N,C,spatial... input — the Global*Pool ops are
    defined over every spatial dim, so rank-5 (N,C,D,H,W) pools (2, 3, 4),
    not a hardcoded (2, 3)."""
    shp = x.shape
    if shp is None:
        raise NotImplementedError("Global pooling with unknown input rank")
    if len(shp) < 3:
        raise NotImplementedError(
            f"Global pooling needs an N,C,spatial... input, got rank {len(shp)}")
    return tuple(range(2, len(shp)))


@orule("GlobalAveragePool")
def _o_gap(m, node):
    x = m.get(node.inputs[0])
    m.set(node.outputs[0], m.sd._op("mean", [x], attrs=dict(
        axis=_spatial_axes(x), keepdims=True), name=node.outputs[0]))


@orule("BatchNormalization")
def _o_bn(m, node):
    x, gamma, beta, mean, var = (m.get(i) for i in node.inputs[:5])
    eps = node.attr("epsilon", 1e-5)
    # NCHW: normalize over axis 1
    m.set(node.outputs[0], m.sd._op(
        "batchnorm", [x, mean, var, gamma, beta],
        attrs=dict(eps=eps, axis=1), name=node.outputs[0]))


@orule("LayerNormalization")
def _o_ln(m, node):
    x, gamma = m.get(node.inputs[0]), m.get(node.inputs[1])
    ins = [x, gamma]
    if len(node.inputs) > 2:
        ins.append(m.get(node.inputs[2]))
    m.set(node.outputs[0], m.sd._op(
        "layernorm", ins, attrs=dict(eps=node.attr("epsilon", 1e-5)),
        name=node.outputs[0]))


@orule("IsInf")
def _o_isinf(m, node):
    x = m.get(node.inputs[0])
    if not (node.attr("detect_positive", 1) and node.attr("detect_negative", 1)):
        raise NotImplementedError("IsInf one-sided detection")
    m.set(node.outputs[0], m.sd._op("isinf", [x], name=node.outputs[0]))


@orule("Mod")
def _o_mod(m, node):
    # fmod=0 (default): sign follows the divisor (python %); fmod=1: C fmod
    a, b = m.get(node.inputs[0]), m.get(node.inputs[1])
    opname = "fmod" if node.attr("fmod", 0) else "mod"
    m.set(node.outputs[0], m.sd._op(opname, [a, b], name=node.outputs[0]))


@orule("BitShift")
def _o_bitshift(m, node):
    """Opset-11 elementwise integer shift. ``direction`` ("LEFT"/"RIGHT")
    picks the registry shift op — the r7 WAIVED.md row burned down (the
    waiver was absence-of-demand, not difficulty; scenario-diversity
    sweep, ROADMAP item 5)."""
    a, b = m.get(node.inputs[0]), m.get(node.inputs[1])
    direction = node.attr("direction")
    if isinstance(direction, bytes):
        direction = direction.decode()
    if direction not in ("LEFT", "RIGHT"):
        raise ValueError(
            f"BitShift direction must be LEFT or RIGHT, got {direction!r}")
    opname = "shift_left" if direction == "LEFT" else "shift_right"
    m.set(node.outputs[0], m.sd._op(opname, [a, b], name=node.outputs[0]))


@orule("Shape")
def _o_shape(m, node):
    # static under XLA. Dims that depend on a dynamic (-1) placeholder dim
    # (torch dynamic_axes exports) fold as the -1 sentinel, which survives
    # Gather/Concat const chains into Reshape targets (the reshape op resolves
    # one -1 per target at runtime); consumers that cannot express a
    # dynamic dim (Expand, Range...) reject the sentinel loudly instead of
    # silently baking batch=1
    v = m.get(node.inputs[0])
    from deeplearning4j_tpu_torch.samediff.core import VariableType

    shp = m.sd._infer(v.name, "shape", mark_dynamic=True) \
        if v.vtype is VariableType.ARRAY else v.shape
    if shp is None or any(s is None for s in shp):
        raise NotImplementedError("Shape of dynamically-shaped tensor")
    arr = np.asarray(shp, np.int64)
    cvar = m.sd.constant(arr, name=node.outputs[0])
    m.set(node.outputs[0], cvar, const_val=arr)
    if (arr == -1).any():
        m.dyn_vars.add(cvar.name)


# ------------------------------------------------------------ recurrent ops
# Reference parity: samediff-import-onnx RNN mappings (path-cite, mount empty
# this round). Lowered onto the ops.rnn whole-sequence ops: lstm_layer is
# one launch of the LSTM segment kernel per direction on CUDA.


def _o_rnn_common(m, node, n_optional):
    """Shared input unpack: X, W, R, [B, sequence_lens, initial_h, ...]."""
    ins = [m.get(node.inputs[0]), m.get(node.inputs[1]), m.get(node.inputs[2])]
    for i in range(3, 3 + n_optional):
        ins.append(m.get(node.inputs[i]) if m.has_input(node, i) else None)
    return ins


def _o_rnn_acts(node, n_per_dir):
    """ONNX `activations` attr → (gate_activation, activation) kwargs."""
    acts = node.attr("activations")
    out = {}
    if acts:
        acts = [a.lower() for a in acts[:n_per_dir]]  # fwd direction names
        if n_per_dir >= 2:
            out["gate_activation"] = acts[0]
            out["activation"] = acts[1]
            if n_per_dir == 3 and len(acts) > 2 and acts[2] != acts[1]:
                raise NotImplementedError(
                    "LSTM with distinct cell/hidden activations (g != h)")
        else:
            out["activation"] = acts[0]
    return out


def _o_rnn_set_outputs(m, node, outs):
    for name, var in zip(node.outputs, outs):
        if name:
            # alias to the ONNX output name (rules lower to internal names)
            m.set(name, m.sd._op("identity", [var], name=name))


@orule("LSTM")
def _o_lstm(m, node):
    x, W, R, b, seq_lens, h0, c0 = _o_rnn_common(m, node, 4)
    attrs = dict(hidden_size=int(node.attr("hidden_size")),
                 direction=node.attr("direction", "forward"),
                 layout=int(node.attr("layout", 0)))
    attrs.update(_o_rnn_acts(node, 3))
    if node.attr("clip") is not None:
        raise NotImplementedError("LSTM cell clipping")
    if node.attr("input_forget", 0):
        raise NotImplementedError("LSTM input_forget coupling")
    y, yh, yc = m.sd._op("lstm_layer", [x, W, R, b, seq_lens, h0, c0],
                         attrs=attrs, n_out=3, name=node.name or "lstm")
    _o_rnn_set_outputs(m, node, (y, yh, yc))


@orule("GRU")
def _o_gru(m, node):
    x, W, R, b, seq_lens, h0 = _o_rnn_common(m, node, 3)
    attrs = dict(hidden_size=int(node.attr("hidden_size")),
                 direction=node.attr("direction", "forward"),
                 layout=int(node.attr("layout", 0)),
                 linear_before_reset=int(node.attr("linear_before_reset", 0)))
    attrs.update(_o_rnn_acts(node, 2))
    if node.attr("clip") is not None:
        raise NotImplementedError("GRU cell clipping")
    y, yh = m.sd._op("gru_layer", [x, W, R, b, seq_lens, h0],
                     attrs=attrs, n_out=2, name=node.name or "gru")
    _o_rnn_set_outputs(m, node, (y, yh))


@orule("RNN")
def _o_simple_rnn(m, node):
    x, W, R, b, seq_lens, h0 = _o_rnn_common(m, node, 3)
    attrs = dict(hidden_size=int(node.attr("hidden_size")),
                 direction=node.attr("direction", "forward"),
                 layout=int(node.attr("layout", 0)))
    attrs.update(_o_rnn_acts(node, 1))
    y, yh = m.sd._op("rnn_layer", [x, W, R, b, seq_lens, h0],
                     attrs=attrs, n_out=2, name=node.name or "rnn")
    _o_rnn_set_outputs(m, node, (y, yh))


# ------------------------------------------------------------- round-3 tail
# Breadth beyond the r2 set (samediff-import-onnx rule files, path-cite):
# shape/indexing, remaining reductions, ConvTranspose/InstanceNorm/Resize,
# and the elementwise stragglers common in exported vision/NLP models.


@orule("Slice")
def _o_slice(m, node):
    x = m.get(node.inputs[0])
    starts = [int(v) for v in m.const(node.inputs[1])]
    ends = [int(v) for v in m.const(node.inputs[2])]
    axes = ([int(v) for v in m.const(node.inputs[3])]
            if m.has_input(node, 3) else list(range(len(starts))))
    steps = ([int(v) for v in m.const(node.inputs[4])]
             if m.has_input(node, 4) else [1] * len(starts))
    if x.shape is not None:
        nd = len(x.shape)
    else:
        if any(a < 0 for a in axes):
            raise NotImplementedError(
                "Slice with negative axes on an unknown-rank input")
        nd = max(axes) + 1
    spec = [("s", None, None, None)] * nd
    BIG = 2**31 - 1
    for s, e, a, st in zip(starts, ends, axes, steps):
        # INT_MIN/INT_MAX are ONNX's "to the end" sentinels in either
        # direction; map them to open slice bounds
        s_ = None if abs(s) >= BIG else s
        e_ = None if abs(e) >= BIG else e
        spec[a % nd] = ("s", s_, e_, st)
    m.set(node.outputs[0], m.sd._op("getitem", [x],
                                    attrs=dict(spec=tuple(spec)),
                                    name=node.outputs[0]))


@orule("Split")
def _o_split(m, node):
    x = m.get(node.inputs[0])
    axis = int(node.attr("axis", 0))
    sizes = node.attr("split")
    if sizes is None and m.has_input(node, 1):
        sizes = [int(v) for v in m.const(node.inputs[1])]
    if sizes is None:
        outs = m.sd.math.split(x, num_or_sections=len(node.outputs),
                               axis=axis)
    else:
        outs = m.sd._op("split_v", [x], attrs=dict(sizes=tuple(sizes),
                                                   axis=axis),
                        n_out=len(node.outputs))
        if not isinstance(outs, tuple):
            outs = (outs,)
    for o, v in zip(node.outputs, outs):
        m.set(o, v)


@orule("Pad")
def _o_pad(m, node):
    x = m.get(node.inputs[0])
    mode = node.attr("mode", "constant")
    if isinstance(mode, bytes):
        mode = mode.decode()
    pads = [int(v) for v in (m.const(node.inputs[1])
                             if m.has_input(node, 1)
                             else node.attr("pads"))]
    n = len(pads) // 2
    per_axis = [(pads[i], pads[i + n]) for i in range(n)]
    if m.has_input(node, 3):  # opset-18 axes: pads cover only these axes
        if x.shape is None:
            raise NotImplementedError("Pad with axes on unknown-rank input")
        axes = [int(a) % len(x.shape) for a in m.const(node.inputs[3])]
        full = [(0, 0)] * len(x.shape)
        for a, p in zip(axes, per_axis):
            full[a] = p
        per_axis = full
    elif x.shape is not None and n != len(x.shape):
        raise NotImplementedError(
            f"Pad pads cover {n} axes but input has {len(x.shape)}")
    paddings = tuple(per_axis)
    cv = (float(np.asarray(m.const(node.inputs[2])))
          if m.has_input(node, 2) else 0.0)
    attrs = dict(paddings=paddings)
    if mode == "constant":
        attrs["constant_value"] = cv
    else:
        attrs["mode"] = {"reflect": "reflect", "edge": "edge"}[mode]
    m.set(node.outputs[0], m.sd._op("pad", [x], attrs=attrs,
                                    name=node.outputs[0]))


@orule("Tile")
def _o_tile(m, node):
    x = m.get(node.inputs[0])
    reps = tuple(int(v) for v in m.const(node.inputs[1]))
    m.set(node.outputs[0], m.sd._op("tile", [x], attrs=dict(reps=reps),
                                    name=node.outputs[0]))


@orule("Expand")
def _o_expand(m, node):
    x = m.get(node.inputs[0])
    # opts in to keep its own (more specific) dynamic-dim guard below
    shape = [int(v) for v in m.const(node.inputs[1], allow_dynamic=True)]
    # ONNX Expand: dim value 1 broadcasts; other values must match or x is 1
    xs = x.shape
    if xs is not None and len(xs) == len(shape):
        shape = [int(a) if s in (1, -1) and a not in (None, -1) else int(s)
                 for s, a in zip(shape, xs)]
    if any(s < 0 for s in shape):
        # the Shape rule's dynamic-dim sentinel: a broadcast target cannot
        # be dynamic under XLA (dynamic_axes exports building runtime state
        # shapes, e.g. torch RNN initial states, land here)
        raise NotImplementedError(
            "Expand target derived from a dynamic dim (export without "
            "dynamic_axes, or pass explicit initial states)")
    m.set(node.outputs[0], m.sd._op("broadcast_to", [x],
                                    attrs=dict(shape=tuple(shape)),
                                    name=node.outputs[0]))


@orule("ConstantOfShape")
def _o_const_of_shape(m, node):
    # opts in to keep its own (more specific) dynamic-dim guard below
    shape = tuple(int(v) for v in m.const(node.inputs[0], allow_dynamic=True))
    if any(s < 0 for s in shape):
        raise NotImplementedError(
            "ConstantOfShape target derived from a dynamic dim (export "
            "without dynamic_axes, or pass explicit initial states)")
    val = node.attr("value")
    v = float(np.asarray(val).reshape(-1)[0]) if val is not None else 0.0
    dt = np.asarray(val).dtype if val is not None else np.float32
    arr = np.full(shape, v, dtype=dt)
    m.set(node.outputs[0], m.sd.constant(arr, name=node.outputs[0]),
          const_val=arr)


@orule("Range")
def _o_range(m, node):
    s, l, d = (np.asarray(m.const(i)).item() for i in node.inputs[:3])
    arr = np.arange(s, l, d)
    m.set(node.outputs[0], m.sd.constant(arr, name=node.outputs[0]),
          const_val=arr)


@orule("ArgMax", "ArgMin")
def _o_argminmax(m, node):
    opname = "argmax" if node.op_type == "ArgMax" else "argmin"
    x = m.get(node.inputs[0])
    axis = int(node.attr("axis", 0))
    kd = bool(node.attr("keepdims", 1))
    y = m.sd._op(opname, [x], attrs=dict(axis=axis))
    if kd:
        y = m.sd._op("expand_dims", [y], attrs=dict(axis=axis))
    m.set(node.outputs[0], m.sd._op("identity", [y], name=node.outputs[0]))


@orule("CumSum")
def _o_cumsum(m, node):
    x = m.get(node.inputs[0])
    axis = int(np.asarray(m.const(node.inputs[1])))
    if node.attr("exclusive", 0) or node.attr("reverse", 0):
        raise NotImplementedError("CumSum exclusive/reverse")
    m.set(node.outputs[0], m.sd._op("cumsum", [x], attrs=dict(axis=axis),
                                    name=node.outputs[0]))


@orule("PRelu")
def _o_prelu(m, node):
    x, slope = m.get(node.inputs[0]), m.get(node.inputs[1])
    m.set(node.outputs[0], m.sd._op("prelu", [x, slope],
                                    name=node.outputs[0]))


@orule("Elu")
def _o_elu(m, node):
    if node.attr("alpha", 1.0) != 1.0:
        raise NotImplementedError("Elu alpha != 1")
    m.set(node.outputs[0], m.sd._op("elu", [m.get(node.inputs[0])],
                                    name=node.outputs[0]))


@orule("GlobalMaxPool")
def _o_gmp(m, node):
    x = m.get(node.inputs[0])
    m.set(node.outputs[0], m.sd._op("max", [x], attrs=dict(
        axis=_spatial_axes(x), keepdims=True), name=node.outputs[0]))


@orule("ConvTranspose")
def _o_conv_transpose(m, node):
    x, w = m.get(node.inputs[0]), m.get(node.inputs[1])
    strides = tuple(node.attr("strides", [1, 1]))
    pads = node.attr("pads", [0, 0, 0, 0])
    if node.attr("dilations", [1, 1]) != [1, 1]:
        raise NotImplementedError("ConvTranspose dilations")
    if node.attr("group", 1) != 1:
        raise NotImplementedError("ConvTranspose groups")
    if node.attr("output_padding") or node.attr("output_shape"):
        raise NotImplementedError("ConvTranspose output_padding/output_shape")
    auto_pad = node.attr("auto_pad", "NOTSET")
    if isinstance(auto_pad, bytes):
        auto_pad = auto_pad.decode()
    kshape = node.attr("kernel_shape")
    if kshape is None and w.shape is not None:
        kshape = w.shape[2:4]
    if auto_pad == "SAME_LOWER":
        # upper-biased 'SAME' would shift the output one pixel whenever the
        # total padding is odd
        raise NotImplementedError("ConvTranspose SAME_LOWER")
    if auto_pad == "SAME_UPPER":
        padding = "SAME"
    elif all(p == 0 for p in pads):
        padding = "VALID"
    elif pads[0] == pads[2] and pads[1] == pads[3]:
        # ONNX/torch pads p mean "crop p from the full deconv output"; the
        # underlying dilated conv needs k-1-p explicit padding per side
        # (verified vs torch: k=4, s=2, p=1 → padding 2)
        if kshape is None:
            raise NotImplementedError(
                "ConvTranspose pads without a known kernel shape")
        kh, kw = int(kshape[0]), int(kshape[1])
        if kh - 1 - pads[0] < 0 or kw - 1 - pads[1] < 0:
            raise NotImplementedError("ConvTranspose pads > kernel-1")
        padding = (kh - 1 - pads[0], kw - 1 - pads[1])  # symmetric pairs
    else:
        raise NotImplementedError("ConvTranspose asymmetric pads")
    xh = m.sd._op("permute", [x], attrs=dict(axes=(0, 2, 3, 1)))
    # ONNX ConvTranspose weights are IOHW (I = x's channels); deconv2d's
    # HWIO spec wants that same I in slot 2 → axes (2, 3, 0, 1). ONNX (like
    # torch) defines the op as the GRADIENT of conv — spatially flipped
    # relative to deconv2d's fractionally-strided convolution — so flip H/W.
    wh = m.sd._op("permute", [w], attrs=dict(axes=(2, 3, 0, 1)))
    wh = m.sd._op("flip", [wh], attrs=dict(axis=(0, 1)))
    ins = [xh, wh]
    if m.has_input(node, 2):
        ins.append(m.get(node.inputs[2]))
    y = m.sd._op("deconv2d", ins, attrs=dict(strides=strides,
                                             padding=padding))
    m.set(node.outputs[0], m.sd._op("permute", [y],
                                    attrs=dict(axes=(0, 3, 1, 2)),
                                    name=node.outputs[0]))


@orule("InstanceNormalization")
def _o_instancenorm(m, node):
    x, gamma, beta = (m.get(i) for i in node.inputs[:3])
    eps = node.attr("epsilon", 1e-5)

    def inorm(xv, g, b):
        axes = tuple(range(2, xv.dim()))
        mu = torch.mean(xv, dim=axes, keepdim=True)
        var = torch.var(xv, dim=axes, keepdim=True, unbiased=False)
        shape = (1, -1) + (1,) * (xv.dim() - 2)
        return ((xv - mu) / torch.sqrt(var + eps) * g.reshape(shape)
                + b.reshape(shape))

    m.set(node.outputs[0], m.sd.custom_op(inorm, x, gamma, beta,
                                          name=node.outputs[0]))


@orule("DepthToSpace")
def _o_d2s(m, node):
    x = m.get(node.inputs[0])
    bs = int(node.attr("blocksize"))
    mode = node.attr("mode", "DCR")
    if isinstance(mode, bytes):
        mode = mode.decode()
    if mode != "DCR":
        # our depth_to_space decomposes channels as (b, b, C') — ONNX DCR
        raise NotImplementedError("DepthToSpace CRD mode")
    xh = m.sd._op("permute", [x], attrs=dict(axes=(0, 2, 3, 1)))
    y = m.sd._op("depth_to_space", [xh], attrs=dict(block_size=bs))
    m.set(node.outputs[0], m.sd._op("permute", [y],
                                    attrs=dict(axes=(0, 3, 1, 2)),
                                    name=node.outputs[0]))


@orule("SpaceToDepth")
def _o_s2d(m, node):
    x = m.get(node.inputs[0])
    bs = int(node.attr("blocksize"))
    xh = m.sd._op("permute", [x], attrs=dict(axes=(0, 2, 3, 1)))
    y = m.sd._op("space_to_depth", [xh], attrs=dict(block_size=bs))
    m.set(node.outputs[0], m.sd._op("permute", [y],
                                    attrs=dict(axes=(0, 3, 1, 2)),
                                    name=node.outputs[0]))


@orule("TopK")
def _o_topk(m, node):
    x = m.get(node.inputs[0])
    k = int(np.asarray(m.const(node.inputs[1])))
    if int(node.attr("axis", -1)) not in (-1, len(x.shape or []) - 1):
        raise NotImplementedError("TopK on a non-last axis")
    if not node.attr("largest", 1):
        raise NotImplementedError("TopK largest=0")
    vals, idx = m.sd._op("top_k", [x], attrs=dict(k=k), n_out=2,
                         name=node.name or "topk")
    m.set(node.outputs[0], vals)
    if len(node.outputs) > 1:
        m.set(node.outputs[1], idx)


@orule("GatherElements")
def _o_gather_elements(m, node):
    x, idx = m.get(node.inputs[0]), m.get(node.inputs[1])
    axis = int(node.attr("axis", 0))
    m.set(node.outputs[0], m.sd._op("take_along_axis", [x, idx],
                                    attrs=dict(axis=axis),
                                    name=node.outputs[0]))


@orule("ScatterND")
def _o_scatternd(m, node):
    x, idx, upd = (m.get(i) for i in node.inputs[:3])
    m.set(node.outputs[0], m.sd._op("tensor_scatter_update", [x, idx, upd],
                                    name=node.outputs[0]))


@orule("OneHot")
def _o_onehot(m, node):
    idx = m.get(node.inputs[0])
    depth = int(np.asarray(m.const(node.inputs[1])))
    vals = np.asarray(m.const(node.inputs[2]))  # [off, on]
    axis = int(node.attr("axis", -1))
    m.set(node.outputs[0], m.sd._op(
        "onehot", [idx], attrs=dict(depth=depth, on_value=float(vals[1]),
                                    off_value=float(vals[0]), axis=axis),
        name=node.outputs[0]))


@orule("Trilu")
def _o_trilu(m, node):
    x = m.get(node.inputs[0])
    k = (int(np.asarray(m.const(node.inputs[1])))
         if m.has_input(node, 1) else 0)
    upper = bool(node.attr("upper", 1))

    def trilu(xv):
        return torch.triu(xv, k) if upper else torch.tril(xv, k)

    m.set(node.outputs[0], m.sd.custom_op(trilu, x, name=node.outputs[0]))


@orule("Resize")
def _o_resize(m, node):
    x = m.get(node.inputs[0])
    mode = node.attr("mode", "nearest")
    if isinstance(mode, bytes):
        mode = mode.decode()
    method = {"nearest": "nearest", "linear": "bilinear"}.get(mode)
    if method is None:
        raise NotImplementedError(f"Resize mode {mode!r}")
    ctm = node.attr("coordinate_transformation_mode")
    if ctm is None and len(node.inputs) == 2:
        # opset-10 Resize (inputs X, scales — no roi slot) has no attr and
        # implicit ASYMMETRIC semantics; must not default to half_pixel
        ctm = "asymmetric"
    elif ctm is None:
        ctm = "half_pixel"
    if isinstance(ctm, bytes):
        ctm = ctm.decode()
    if ctm not in ("half_pixel", "asymmetric"):
        # align_corners / pytorch_half_pixel etc. shift sampling points —
        # importing them through jax's half-pixel resize would be silently
        # wrong at non-integer scales
        raise NotImplementedError(
            f"Resize coordinate_transformation_mode {ctm!r}")
    nm = node.attr("nearest_mode")
    if nm is not None and (nm.decode() if isinstance(nm, bytes) else nm) \
            != "round_prefer_floor":
        raise NotImplementedError("Resize non-default nearest_mode")
    shp = x.shape
    if shp is None or any(s is None or s < 0 for s in shp[2:]):
        raise NotImplementedError("Resize with unknown spatial dims")
    if m.has_input(node, 3):  # sizes given directly
        sizes = [int(v) for v in m.const(node.inputs[3])]
        out_hw = tuple(sizes[2:])
    elif m.has_input(node, 2):
        scales = [float(v) for v in m.const(node.inputs[2])]
        out_hw = tuple(int(round(s * f)) for s, f in zip(shp[2:], scales[2:]))
    else:
        raise NotImplementedError("Resize without scales or sizes")
    if ctm == "asymmetric":
        # jax.image.resize samples at half-pixel coordinates; that coincides
        # with asymmetric (x_in = x_out/scale) only for nearest at exact
        # integer upscales, where both select floor(x_out/scale)
        if method != "nearest" or any(o % s for s, o in zip(shp[2:], out_hw)):
            raise NotImplementedError(
                "Resize coordinate_transformation_mode 'asymmetric' only "
                "supported for nearest integer upscales (where half-pixel "
                "and asymmetric sampling coincide)")
    xh = m.sd._op("permute", [x], attrs=dict(axes=(0, 2, 3, 1)))
    y = m.sd._op("image_resize", [xh], attrs=dict(size=out_hw,
                                                  method=method))
    m.set(node.outputs[0], m.sd._op("permute", [y],
                                    attrs=dict(axes=(0, 3, 1, 2)),
                                    name=node.outputs[0]))


# ----------------------------------------------------------- control flow
# Reference parity: samediff-import-onnx maps Loop/If/Scan onto SameDiff
# control-flow ops interpreted op-at-a-time on the JVM (path-cite, mount
# empty). As on the TF side (While/If), each control-flow node's GraphProto
# body is imported into a scratch SameDiff and serialized into ONE
# __cf_loop__ / __cf_if__ / __cf_scan__ node (run by samediff/core.py).
# ONNX subgraphs capture enclosing-scope tensors by NAME; captures that are
# constants fold into the sub-graph, the rest become trailing runtime
# arguments of the node.


def _graph_local_names(gf) -> set:
    names = {tensor_name(b) for b in pm.get_messages(gf, 5)}
    names |= {_value_info(b)[0] for b in pm.get_messages(gf, 11)}
    return names


def _external_refs(gf, scope=()) -> List[str]:
    """Names referenced in a GraphProto (recursively, through nested
    control-flow bodies) but defined neither locally nor in `scope`."""
    local = set(scope) | _graph_local_names(gf)
    refs: List[str] = []
    for nb in pm.get_messages(gf, 1):
        node = _Node(nb)
        for i in node.inputs:
            if i and i not in local and i not in refs:
                refs.append(i)
        for v in node.attrs.values():
            graphs = ([v] if isinstance(v, _GraphAttr) else
                      [g for g in v if isinstance(g, _GraphAttr)]
                      if isinstance(v, list) else [])
            for g in graphs:
                for r in _external_refs(pm.decode(g.buf), local):
                    if r not in refs:
                        refs.append(r)
        local.update(o for o in node.outputs if o)
    return refs


def _subgraph_fn(m, gattr: _GraphAttr, input_shapes=None):
    """GraphProto attr → (spec, formal_input_names, runtime_captures,
    n_outputs). The spec's callable takes the formal inputs followed by the
    runtime captures. ``input_shapes`` overrides formal-input (shape,
    dtype) pairs — subgraph value_infos often omit them, but the enclosing
    rule knows the carried shapes.

    Captured constants are passed as RUNTIME captures when the body builds
    without their static values — so a captured weight converted to a
    VARIABLE outside still receives gradients (trainable imported loops).
    Bodies that need a capture statically (shape/axis args) fall back to
    folding every const capture into the sub-graph."""
    gf = pm.decode(gattr.buf)

    def build(fold_consts):
        sub = OnnxImporter(graph_buf=gattr.buf, device="cpu")
        formal = [n for n, _, _ in sub.graph_inputs]
        runtime_caps: List[str] = []
        for c in _external_refs(gf):
            if c in formal:
                continue
            if fold_consts and c in m.const_vals:
                arr = np.asarray(m.const_vals[c])
                cvar = sub.sd.constant(arr, name=c)
                sub.set(c, cvar, const_val=arr)
                if m._derives_dynamic(c):  # taint crosses the subgraph edge
                    sub.dyn_vars.add(cvar.name)
            else:
                ov = m.get(c)
                sub.set(c, sub.sd.placeholder(c, shape=ov.shape,
                                              dtype=ov.dtype))
                runtime_caps.append(c)
        for idx, (n, shp, dt) in enumerate(sub.graph_inputs):
            if input_shapes is not None and idx < len(input_shapes):
                shp, dt = input_shapes[idx]
            sub.set(n, sub.sd.placeholder(n, shape=shp,
                                          dtype=dt or np.float32))
        sub.build()
        return sub, formal, runtime_caps

    try:
        sub, formal, runtime_caps = build(fold_consts=False)
    except NotImplementedError:
        sub, formal, runtime_caps = build(fold_consts=True)
    outnames = [sub.vars[o].name for o in sub.graph_outputs]

    spec = make_subgraph_spec(sub.sd, formal + runtime_caps, outnames)
    return spec, formal, runtime_caps, len(outnames)


@orule("Loop")
def _o_loop(m, node):
    """ONNX Loop -> ONE serializable ``__cf_loop__`` node: a while loop
    (loop-carried only; its predicate read on the host) or a scan (with scan
    outputs; needs a static trip count M) — run by
    samediff.core._exec_cf.

    Early-exit deviation on the scan path, as in the reference: the scan
    always runs M iterations — loop-carried values freeze exactly at the
    ONNX exit point (masked updates), but scan-output rows PAST the exit
    hold the frozen state's computation instead of being truncated. A
    static M stays a PYTHON int clamped to int32 (torch exports `while` as
    Loop with M=INT64_MAX)."""
    body = node.attr("body")
    has_M = m.has_input(node, 0)
    has_cond = m.has_input(node, 1)
    carried = [m.get(i) for i in node.inputs[2:]]
    N = len(carried)
    shapes = [((), np.int64), ((), np.bool_)] + \
        [(v.shape, v.dtype) for v in carried]
    spec, formal, caps, n_out = _subgraph_fn(m, body, input_shapes=shapes)
    if len(formal) != 2 + N:
        raise NotImplementedError(
            f"Loop body has {len(formal)} inputs for {N} carried vars")
    K = n_out - 1 - N
    cap_vars = [m.get(c) for c in caps]

    M_static = None
    if has_M:
        try:
            M_static = int(np.asarray(m.const(node.inputs[0])))
        except NotImplementedError:
            M_static = None
    if K > 0 and M_static is None:
        raise NotImplementedError(
            "Loop with scan outputs needs a static trip count M")
    dynamic_M = has_M and M_static is None

    ins = ([m.get(node.inputs[0])] if dynamic_M else []) + \
        ([m.get(node.inputs[1])] if has_cond else []) + carried + cap_vars
    outs = m.sd._op("__cf_loop__", ins, attrs=dict(
        body_spec=spec, n_carried=N, n_scan_out=K, has_cond=has_cond,
        m_static=M_static, dynamic_m=dynamic_M), n_out=N + K,
        name=node.name or "loop")
    outs = (outs,) if not isinstance(outs, tuple) else outs
    for i, o in enumerate(node.outputs):
        if o:
            m.set(o, outs[i])


@orule("If")
def _o_if(m, node):
    pred = m.get(node.inputs[0])
    t_spec, t_formal, t_caps, nt = _subgraph_fn(m, node.attr("then_branch"))
    e_spec, e_formal, e_caps, ne = _subgraph_fn(m, node.attr("else_branch"))
    if t_formal or e_formal:
        raise NotImplementedError("If branches take no formal inputs in ONNX")
    if nt != ne:
        raise NotImplementedError("If branch output arity mismatch")
    caps = list(dict.fromkeys(t_caps + e_caps))
    out = m.sd._op("__cf_if__", [pred] + [m.get(c) for c in caps],
                   attrs=dict(then_spec=t_spec, else_spec=e_spec,
                              t_idx=[caps.index(c) for c in t_caps],
                              e_idx=[caps.index(c) for c in e_caps],
                              n_out=nt),
                   n_out=nt, name=node.name or "if")
    out = (out,) if not isinstance(out, tuple) else out
    for i, o in enumerate(node.outputs):
        if o:
            m.set(o, out[i])


@orule("Scan")
def _o_scan(m, node):
    body = node.attr("body")
    S = int(node.attr("num_scan_inputs"))
    L = len(node.inputs) - S
    for a in ("scan_input_axes", "scan_output_axes"):
        if node.attr(a) and any(int(x) != 0 for x in node.attr(a)):
            raise NotImplementedError(f"Scan non-zero {a}")
    for a in ("scan_input_directions", "scan_output_directions"):
        if node.attr(a) and any(int(x) for x in node.attr(a)):
            raise NotImplementedError(f"Scan reverse {a}")
    states = [m.get(i) for i in node.inputs[:L]]
    scans = [m.get(i) for i in node.inputs[L:]]
    shapes = [(v.shape, v.dtype) for v in states] + \
        [((v.shape[1:] if v.shape is not None else None), v.dtype)
         for v in scans]
    spec, formal, caps, n_out = _subgraph_fn(m, body, input_shapes=shapes)
    if len(formal) != L + S:
        raise NotImplementedError(
            f"Scan body has {len(formal)} inputs for {L} states + {S} scans")
    K = n_out - L
    out = m.sd._op("__cf_scan__",
                   states + scans + [m.get(c) for c in caps],
                   attrs=dict(body_spec=spec, n_state=L, n_scan=S),
                   n_out=L + K, name=node.name or "scan")
    out = (out,) if not isinstance(out, tuple) else out
    for i, o in enumerate(node.outputs):
        if o:
            m.set(o, out[i])


@orule("ReverseSequence")
def _o_reverse_sequence(m, node):
    x, lens = m.get(node.inputs[0]), m.get(node.inputs[1])
    m.set(node.outputs[0], m.sd._op(
        "reverse_sequence", [x, lens],
        attrs=dict(seq_axis=int(node.attr("time_axis", 0)),
                   batch_axis=int(node.attr("batch_axis", 1))),
        name=node.outputs[0]))


@orule("Einsum")
def _o_einsum(m, node):
    eq = node.attr("equation")
    if isinstance(eq, bytes):
        eq = eq.decode()
    operands = [m.get(i) for i in node.inputs]
    m.set(node.outputs[0], m.sd._op("einsum_apply", operands,
                                    attrs=dict(equation=eq),
                                    name=node.outputs[0]))


# ---------------------------------------------------------------------------
# Round-5 rules: quantization (QDQ), normalization tail, spatial samplers,
# signal ops, losses, random family, const-foldable dynamics.
# ---------------------------------------------------------------------------

def _axis_shaped(m, var, axis, rank):
    """Reshape a per-axis 1-D param for broadcasting along `axis` of a
    rank-`rank` tensor (QuantizeLinear per-axis convention)."""
    shape = [1] * rank
    shape[axis] = -1
    return m.sd._op("reshape", [var], attrs=dict(shape=tuple(shape)))


def _q_range(np_dtype):
    info = np.iinfo(np_dtype)
    return float(info.min), float(info.max)


def _q_per_axis(m, scale_name, scale_var, op_name):
    """Per-axis detection for Quantize/DequantizeLinear (ADVICE r5 #2).

    A 1-D scale of size > 1 means per-axis. The const value decides when
    available; otherwise the DECLARED shape must — a non-constant 1-D
    scale of unknown size must fail loudly, never silently broadcast
    per-tensor along the wrong axis."""
    sc_val = m.const_vals.get(scale_name)
    if sc_val is not None:
        return sc_val.ndim == 1 and sc_val.size > 1
    shape = scale_var.shape
    if shape is None:
        raise NotImplementedError(
            f"{op_name}: scale {scale_name!r} is not a constant and has no "
            "declared shape — cannot decide per-tensor vs per-axis")
    if len(shape) == 0 or (len(shape) == 1 and shape[0] == 1):
        return False
    if len(shape) == 1:
        if shape[0] is None or shape[0] < 0:
            raise NotImplementedError(
                f"{op_name}: scale {scale_name!r} has dynamic size "
                f"{shape} — cannot decide per-tensor vs per-axis")
        return True
    raise NotImplementedError(
        f"{op_name}: scale {scale_name!r} has rank-{len(shape)} shape "
        f"{shape}; the spec allows scalar or 1-D only")


@orule("QuantizeLinear")
def _o_quantize_linear(m, node):
    x = m.get(node.inputs[0])
    scale = m.get(node.inputs[1])
    axis = node.attr("axis", 1)
    rank = len(x.shape) if x.shape is not None else None
    zp_arr = None
    if m.has_input(node, 2):
        zp_arr = m.const(node.inputs[2])
        qdt = zp_arr.dtype
    else:
        qdt = np.dtype(np.uint8)
    qmin, qmax = _q_range(qdt)
    per_axis = _q_per_axis(m, node.inputs[1], scale, "QuantizeLinear")
    if per_axis:
        if rank is None:
            raise NotImplementedError("per-axis QuantizeLinear needs rank")
        scale = _axis_shaped(m, scale, axis, rank)
    y = m.sd._op("div", [x, scale])
    y = m.sd._op("rint", [y])
    if zp_arr is not None and np.any(zp_arr):
        zp = m.sd._op("cast", [m.get(node.inputs[2])],
                      attrs=dict(dtype=np.float32))
        if per_axis:
            zp = _axis_shaped(m, zp, axis, rank)
        y = m.sd._op("add", [y, zp])
    y = m.sd._op("clipbyvalue", [y], attrs=dict(clip_min=qmin, clip_max=qmax))
    m.set(node.outputs[0], m.sd._op("cast", [y], attrs=dict(dtype=qdt),
                                    name=node.outputs[0]))


@orule("DequantizeLinear")
def _o_dequantize_linear(m, node):
    x = m.get(node.inputs[0])
    scale = m.get(node.inputs[1])
    axis = node.attr("axis", 1)
    rank = len(x.shape) if x.shape is not None else None
    xf = m.sd._op("cast", [x], attrs=dict(dtype=np.float32))
    per_axis = _q_per_axis(m, node.inputs[1], scale, "DequantizeLinear")
    if m.has_input(node, 2):
        zp = m.sd._op("cast", [m.get(node.inputs[2])],
                      attrs=dict(dtype=np.float32))
        if per_axis:
            if rank is None:
                raise NotImplementedError(
                    "per-axis DequantizeLinear needs rank")
            zp = _axis_shaped(m, zp, axis, rank)
        xf = m.sd._op("sub", [xf, zp])
    if per_axis:
        scale = _axis_shaped(m, scale, axis, rank)
    m.set(node.outputs[0], m.sd._op("mul", [xf, scale],
                                    name=node.outputs[0]))


@orule("DynamicQuantizeLinear")
def _o_dynamic_quantize(m, node):
    # spec: rmin=min(0,min(x)), rmax=max(0,max(x)); scale=(rmax-rmin)/255;
    # zp=round(clip(-rmin/scale, 0, 255)); y=round(x/scale)+zp clipped u8
    x = m.get(node.inputs[0])
    zero = m.sd.constant(np.float32(0.0))
    rmin = m.sd._op("minimum", [m.sd._op("reduce_min", [x]), zero])
    rmax = m.sd._op("maximum", [m.sd._op("reduce_max", [x]), zero])
    scale = m.sd._op("div", [m.sd._op("sub", [rmax, rmin]),
                             m.sd.constant(np.float32(255.0))])
    zp_f = m.sd._op("clipbyvalue", [
        m.sd._op("rint", [m.sd._op("div", [m.sd._op("neg", [rmin]),
                                           scale])])],
        attrs=dict(clip_min=0.0, clip_max=255.0))
    y = m.sd._op("clipbyvalue", [
        m.sd._op("add", [m.sd._op("rint", [m.sd._op("div", [x, scale])]),
                         zp_f])], attrs=dict(clip_min=0.0, clip_max=255.0))
    m.set(node.outputs[0], m.sd._op("cast", [y],
                                    attrs=dict(dtype=np.uint8),
                                    name=node.outputs[0]))
    m.set(node.outputs[1], scale)
    m.set(node.outputs[2], m.sd._op("cast", [zp_f],
                                    attrs=dict(dtype=np.uint8)))


@orule("GroupNormalization")
def _o_group_norm(m, node):
    # opset 18+: x (N, C, *spatial), scale (C), bias (C)
    x = m.get(node.inputs[0])
    eps = node.attr("epsilon", 1e-5)
    groups = node.attr("num_groups")
    shp = x.shape
    if shp is None or any(s is None or s < 0 for s in shp):
        raise NotImplementedError("GroupNormalization needs static shape")
    n, c = shp[0], shp[1]
    spatial = tuple(shp[2:])
    g = int(groups)
    xg = m.sd._op("reshape", [x], attrs=dict(
        shape=(n, g, c // g) + spatial))
    axes = tuple(range(2, 2 + 1 + len(spatial)))
    mean = m.sd._op("mean", [xg], attrs=dict(axis=axes, keepdims=True))
    diff = m.sd._op("sub", [xg, mean])
    var = m.sd._op("mean", [m.sd._op("square", [diff])],
                   attrs=dict(axis=axes, keepdims=True))
    denom = m.sd._op("sqrt", [m.sd._op("scalar_add", [var, float(eps)])])
    norm = m.sd._op("reshape", [m.sd._op("div", [diff, denom])],
                    attrs=dict(shape=(n, c) + spatial))
    pshape = (1, c) + (1,) * len(spatial)
    scale = m.sd._op("reshape", [m.get(node.inputs[1])],
                     attrs=dict(shape=pshape))
    bias = m.sd._op("reshape", [m.get(node.inputs[2])],
                    attrs=dict(shape=pshape))
    m.set(node.outputs[0], m.sd._op(
        "add", [m.sd._op("mul", [norm, scale]), bias],
        name=node.outputs[0]))


@orule("MeanVarianceNormalization")
def _o_mvn(m, node):
    x = m.get(node.inputs[0])
    axes = tuple(node.attr("axes", [0, 2, 3]))
    mean = m.sd._op("mean", [x], attrs=dict(axis=axes, keepdims=True))
    diff = m.sd._op("sub", [x, mean])
    var = m.sd._op("mean", [m.sd._op("square", [diff])],
                   attrs=dict(axis=axes, keepdims=True))
    m.set(node.outputs[0], m.sd._op(
        "div", [diff, m.sd._op("sqrt",
                               [m.sd._op("scalar_add", [var, 1e-9])])],
        name=node.outputs[0]))


@orule("ScatterElements")
def _o_scatter_elements(m, node):
    x, idx, upd = (m.get(i) for i in node.inputs[:3])
    red = node.attr("reduction", "none")
    if isinstance(red, bytes):
        red = red.decode()
    m.set(node.outputs[0], m.sd._op(
        "put_along_axis", [x, idx, upd],
        attrs=dict(axis=node.attr("axis", 0), reduction=red),
        name=node.outputs[0]))


@orule("LpPool")
def _o_lp_pool(m, node):
    x = m.get(node.inputs[0])
    p = node.attr("p", 2)
    k = tuple(node.attr("kernel_shape"))
    # ONNX spec: strides default to 1 per spatial axis (NOT kernel_shape)
    strides = tuple(node.attr("strides", [1] * len(k)))
    pads = node.attr("pads", [0, 0, 0, 0])
    if node.attr("auto_pad", "NOTSET") not in ("NOTSET", "VALID") \
            or any(pads):
        raise NotImplementedError("LpPool with padding")
    xh = m.sd._op("permute", [x], attrs=dict(axes=(0, 2, 3, 1)))
    y = m.sd._op("pnormpool2d", [xh], attrs=dict(
        kernel=k, strides=strides, padding="VALID", p=int(p)))
    m.set(node.outputs[0], m.sd._op("permute", [y],
                                    attrs=dict(axes=(0, 3, 1, 2)),
                                    name=node.outputs[0]))


@orule("GlobalLpPool")
def _o_global_lp_pool(m, node):
    x = m.get(node.inputs[0])
    p = float(node.attr("p", 2))
    ap = m.sd._op("pow", [m.sd._op("abs", [x]),
                          m.sd.constant(np.float32(p))])
    s = m.sd._op("sum", [ap], attrs=dict(axis=_spatial_axes(x), keepdims=True))
    m.set(node.outputs[0], m.sd._op(
        "pow", [s, m.sd.constant(np.float32(1.0 / p))],
        name=node.outputs[0]))


@orule("Upsample")
def _o_upsample(m, node):
    # deprecated opset-9 op: scales as input (or attr in opset 7)
    x = m.get(node.inputs[0])
    mode = node.attr("mode", "nearest")
    if isinstance(mode, bytes):
        mode = mode.decode()
    if mode not in ("nearest",):
        raise NotImplementedError(f"Upsample mode {mode!r} (use Resize)")
    scales = node.attr("scales")
    if scales is None:
        scales = [float(v) for v in m.const(node.inputs[1])]
    shp = x.shape
    if shp is None or any(s is None or s < 0 for s in shp[2:]):
        raise NotImplementedError("Upsample with unknown spatial dims")
    out_hw = tuple(int(np.floor(s * f))
                   for s, f in zip(shp[2:], scales[2:]))
    # Upsample is ASYMMETRIC-coordinate nearest; jax.image.resize samples
    # at half-pixel coords — they coincide only at integer upscales (same
    # guard as the Resize rule's 'asymmetric' branch)
    if any(o % s for s, o in zip(shp[2:], out_hw)):
        raise NotImplementedError(
            "Upsample with non-integer scale (asymmetric vs half-pixel "
            "sampling differ; re-export with Resize + an explicit "
            "coordinate_transformation_mode)")
    xh = m.sd._op("permute", [x], attrs=dict(axes=(0, 2, 3, 1)))
    y = m.sd._op("image_resize", [xh], attrs=dict(size=out_hw,
                                                  method="nearest"))
    m.set(node.outputs[0], m.sd._op("permute", [y],
                                    attrs=dict(axes=(0, 3, 1, 2)),
                                    name=node.outputs[0]))


@orule("HannWindow", "HammingWindow", "BlackmanWindow")
def _o_window(m, node):
    size = int(m.const(node.inputs[0]))
    periodic = bool(node.attr("periodic", 1))
    kind = {"HannWindow": "hann_window", "HammingWindow": "hamming_window",
            "BlackmanWindow": "blackman_window"}[node.op_type]
    m.set(node.outputs[0], m.sd._op(
        kind, [], attrs=dict(size=size, periodic=periodic),
        name=node.outputs[0]))


@orule("MelWeightMatrix")
def _o_mel_weight_matrix(m, node):
    """Opset-17 mel filterbank generator wired to the registry
    ``mel_weight_matrix`` op (the r7 WAIVED.md row burned down — the waiver
    was absence-of-demand, not difficulty; ROADMAP item 5). All five inputs
    are scalars that must fold to constants (the op IS a constant
    generator); ``output_datatype`` follows the TensorProto enum."""
    num_mel_bins = int(m.const(node.inputs[0]))
    dft_length = int(m.const(node.inputs[1]))
    sample_rate = int(m.const(node.inputs[2]))
    lower = float(m.const(node.inputs[3]))
    upper = float(m.const(node.inputs[4]))
    dtype = _DTYPES.get(node.attr("output_datatype", 1), np.float32)
    from deeplearning4j_tpu_torch.ops.signal import mel_weight_matrix

    arr = np.asarray(mel_weight_matrix(
        num_mel_bins, dft_length, sample_rate, lower, upper, dtype=dtype))
    cvar = m.sd.constant(arr, name=node.outputs[0])
    m.set(node.outputs[0], cvar, const_val=arr)


@orule("DFT")
def _o_dft(m, node):
    # input: (..., n, 1) real or (..., n, 2) real/imag pairs
    x = m.get(node.inputs[0])
    if node.attr("inverse", 0):
        raise NotImplementedError("inverse DFT")
    onesided = bool(node.attr("onesided", 0))
    rank = len(x.shape) if x.shape is not None else None
    if m.has_input(node, 2):
        # opset-20 form: axis is INPUT 2
        axis = int(np.asarray(m.const(node.inputs[2])).reshape(-1)[0])
    elif node.attr("axis") is not None:
        axis = node.attr("axis")        # opset-17 attr form
    elif rank == 3:
        axis = 1                        # defaults coincide: 1 == -2 at rank 3
    else:
        # opset-17 default (1) and opset-20 default (-2) differ here and
        # the node alone does not reveal its opset
        raise NotImplementedError(
            "DFT without an explicit axis on rank != 3 input is "
            "opset-ambiguous")
    if m.has_input(node, 1) and node.inputs[1]:
        raise NotImplementedError("DFT with explicit dft_length")
    shp = x.shape
    if shp is None:
        raise NotImplementedError("DFT needs known rank")
    # the node's axis counts in the FULL rank (incl. the trailing
    # component dim); normalize before squeeze/pack drops that dim
    axis = axis % len(shp)
    if axis == len(shp) - 1:
        raise NotImplementedError("DFT over the component dim")
    last = shp[-1]
    if last == 1:
        xr = m.sd._op("squeeze", [x], attrs=dict(axis=-1))
        if onesided:
            c = m.sd._op("rfft", [xr], attrs=dict(axis=axis))
        else:
            c = m.sd._op("fft", [xr], attrs=dict(axis=axis))
    elif last == 2:
        if onesided:
            raise NotImplementedError("onesided DFT of complex input")
        c = m.sd._op("fft", [m.sd._op("complex_pack", [x])],
                     attrs=dict(axis=axis))
    else:
        raise NotImplementedError("DFT input must end in dim 1 or 2")
    m.set(node.outputs[0], m.sd._op("complex_unpack", [c],
                                    name=node.outputs[0]))


@orule("STFT")
def _o_stft(m, node):
    x = m.get(node.inputs[0])
    step = int(m.const(node.inputs[1]))
    window = m.get(node.inputs[2]) if m.has_input(node, 2) else None
    if m.has_input(node, 3):
        frame_length = int(m.const(node.inputs[3]))
    elif window is not None:
        wshape = m.const(node.inputs[2]).shape
        frame_length = int(wshape[0])
    else:
        raise NotImplementedError("STFT without frame_length or window")
    onesided = bool(node.attr("onesided", 1))
    ins = [x] if window is None else [x, window]
    c = m.sd._op("stft", ins, attrs=dict(
        frame_length=frame_length, frame_step=step, onesided=onesided))
    m.set(node.outputs[0], m.sd._op("complex_unpack", [c],
                                    name=node.outputs[0]))


@orule("NegativeLogLikelihoodLoss")
def _o_nll_loss(m, node):
    ins = [m.get(node.inputs[0]), m.get(node.inputs[1])]
    if m.has_input(node, 2):
        ins.append(m.get(node.inputs[2]))
    red = node.attr("reduction", "mean")
    if isinstance(red, bytes):
        red = red.decode()
    m.set(node.outputs[0], m.sd._op(
        "nll_loss", ins,
        attrs=dict(reduction=red,
                   ignore_index=node.attr("ignore_index")),
        name=node.outputs[0]))


@orule("SoftmaxCrossEntropyLoss")
def _o_sce_loss(m, node):
    scores = m.get(node.inputs[0])
    target = m.get(node.inputs[1])
    red = node.attr("reduction", "mean")
    if isinstance(red, bytes):
        red = red.decode()
    logp = m.sd._op("log_softmax", [scores], attrs=dict(axis=1))
    ins = [logp, target]
    if m.has_input(node, 2):
        ins.append(m.get(node.inputs[2]))
    loss = m.sd._op("nll_loss", ins, attrs=dict(
        reduction=red, ignore_index=node.attr("ignore_index")),
        name=node.outputs[0])
    m.set(node.outputs[0], loss)
    if len(node.outputs) > 1 and node.outputs[1]:
        m.set(node.outputs[1], logp)


@orule("GridSample")
def _o_grid_sample(m, node):
    x, grid = m.get(node.inputs[0]), m.get(node.inputs[1])
    mode = node.attr("mode", "bilinear")
    if isinstance(mode, bytes):
        mode = mode.decode()
    mode = {"linear": "bilinear", "bilinear": "bilinear",
            "nearest": "nearest"}.get(mode)
    if mode is None:
        raise NotImplementedError("GridSample cubic mode")
    pad = node.attr("padding_mode", "zeros")
    if isinstance(pad, bytes):
        pad = pad.decode()
    m.set(node.outputs[0], m.sd._op(
        "grid_sample", [x, grid],
        attrs=dict(mode=mode, padding_mode=pad,
                   align_corners=bool(node.attr("align_corners", 0))),
        name=node.outputs[0]))


@orule("RoiAlign")
def _o_roi_align(m, node):
    x, rois, bidx = (m.get(i) for i in node.inputs[:3])
    # attr introduced in opset 16 (default there: half_pixel). A node
    # WITHOUT the attr is a pre-16 export whose semantics are the legacy
    # output_half_pixel (no 0.5 offset) — same attr-absent reasoning as
    # the Resize rule's opset-10 branch.
    ctm = node.attr("coordinate_transformation_mode", "output_half_pixel")
    if isinstance(ctm, bytes):
        ctm = ctm.decode()
    mode = node.attr("mode", "avg")
    if isinstance(mode, bytes):
        mode = mode.decode()
    ratio = node.attr("sampling_ratio", 0)
    if ratio <= 0:
        # ONNX default 0 means adaptive (data-dependent grid) — approximate
        # with the torchvision-export default of 2 samples per bin axis
        ratio = 2
    m.set(node.outputs[0], m.sd._op(
        "roi_align", [x, rois, bidx],
        attrs=dict(output_size=(node.attr("output_height", 1),
                                node.attr("output_width", 1)),
                   spatial_scale=node.attr("spatial_scale", 1.0),
                   sampling_ratio=int(ratio), mode=mode,
                   aligned=(ctm == "half_pixel")),
        name=node.outputs[0]))


@orule("CenterCropPad")
def _o_center_crop_pad(m, node):
    x = m.get(node.inputs[0])
    target = [int(v) for v in m.const(node.inputs[1])]
    shp = x.shape
    if shp is None or any(s is None or s < 0 for s in shp):
        raise NotImplementedError("CenterCropPad needs static shape")
    axes = node.attr("axes")
    axes = list(range(len(shp))) if axes is None \
        else [a % len(shp) for a in axes]
    new_shape = list(shp)
    begins = [0] * len(shp)
    sizes = list(shp)
    pads = [(0, 0)] * len(shp)
    for a, t in zip(axes, target):
        new_shape[a] = t
        if t < shp[a]:                     # crop centered
            begins[a] = (shp[a] - t) // 2
            sizes[a] = t
        elif t > shp[a]:                   # pad centered
            lo = (t - shp[a]) // 2
            pads[a] = (lo, t - shp[a] - lo)
    y = m.sd._op("slice", [x], attrs=dict(begin=tuple(begins),
                                          sizes=tuple(sizes)))
    if any(p != (0, 0) for p in pads):
        y = m.sd._op("pad", [y], attrs=dict(paddings=tuple(pads)))
    m.set(node.outputs[0], m.sd._op("identity", [y], name=node.outputs[0]))


@orule("MaxUnpool")
def _o_max_unpool(m, node):
    x, idx = m.get(node.inputs[0]), m.get(node.inputs[1])
    shp = x.shape
    if shp is None:
        raise NotImplementedError("MaxUnpool needs known input shape")
    if m.has_input(node, 2):
        out_shape = tuple(int(v) for v in m.const(node.inputs[2]))
    else:
        k = node.attr("kernel_shape")
        # spec: strides default to 1 per axis (NOT kernel_shape)
        strides = node.attr("strides", [1] * len(k))
        pads = node.attr("pads", [0] * (2 * len(k)))
        spatial = [
            (shp[2 + i] - 1) * strides[i] - pads[i] - pads[len(k) + i]
            + k[i] for i in range(len(k))]
        out_shape = tuple(shp[:2]) + tuple(spatial)
    m.set(node.outputs[0], m.sd._op(
        "max_unpool2d", [x, idx], attrs=dict(output_shape=out_shape),
        name=node.outputs[0]))


def _o_seed_key(m, node, tag):
    import zlib

    seed = node.attr("seed")
    seed_i = int(seed if seed is not None else 0) & 0x7FFFFFFF
    # crc32, not hash(): str hashes are salted per process (same convention
    # as samediff weight init) — imports must reproduce across processes.
    # The output name goes into the mix so two same-type random nodes in
    # one graph draw INDEPENDENT streams.
    mix = zlib.crc32(f"{tag}:{node.outputs[0]}".encode()) & 0x7FFFFFFF
    key = prng_key(seed_i ^ mix)
    return m.sd.constant(key, name=f"{node.outputs[0]}__key")


@orule("RandomNormal", "RandomNormalLike")
def _o_random_normal(m, node):
    if node.op_type == "RandomNormal":
        shape = tuple(node.attr("shape"))
        ref_dt = np.float32
    else:
        like = m.get(node.inputs[0])
        shp = like.shape
        if shp is None or any(s is None or s < 0 for s in shp):
            raise NotImplementedError("RandomNormalLike needs static shape")
        shape = tuple(shp)
        ref_dt = like.dtype or np.float32  # spec: inherit input dtype
    dt = _DTYPES[node.attr("dtype")] if node.attr("dtype") else ref_dt
    key = _o_seed_key(m, node, "normal")
    m.set(node.outputs[0], m.sd._op(
        "random_normal", [key],
        attrs=dict(shape=shape, mean=node.attr("mean", 0.0),
                   stddev=node.attr("scale", 1.0), dtype=np.dtype(dt)),
        name=node.outputs[0]))


@orule("RandomUniform", "RandomUniformLike")
def _o_random_uniform(m, node):
    if node.op_type == "RandomUniform":
        shape = tuple(node.attr("shape"))
        ref_dt = np.float32
    else:
        like = m.get(node.inputs[0])
        shp = like.shape
        if shp is None or any(s is None or s < 0 for s in shp):
            raise NotImplementedError("RandomUniformLike needs static shape")
        shape = tuple(shp)
        ref_dt = like.dtype or np.float32  # spec: inherit input dtype
    dt = _DTYPES[node.attr("dtype")] if node.attr("dtype") else ref_dt
    key = _o_seed_key(m, node, "uniform")
    m.set(node.outputs[0], m.sd._op(
        "random_uniform", [key],
        attrs=dict(shape=shape, minval=node.attr("low", 0.0),
                   maxval=node.attr("high", 1.0), dtype=np.dtype(dt)),
        name=node.outputs[0]))


@orule("Bernoulli")
def _o_bernoulli(m, node):
    x = m.get(node.inputs[0])
    shp = x.shape
    if shp is None or any(s is None or s < 0 for s in shp):
        raise NotImplementedError("Bernoulli needs static shape")
    ref_dt = x.dtype or np.float32  # spec: inherit input dtype
    dt = _DTYPES[node.attr("dtype")] if node.attr("dtype") else ref_dt
    key = _o_seed_key(m, node, "bernoulli")
    m.set(node.outputs[0], m.sd._op(
        "random_bernoulli", [key, None, x],
        attrs=dict(dtype=np.dtype(dt)), name=node.outputs[0]))


@orule("Multinomial")
def _o_multinomial(m, node):
    logits = m.get(node.inputs[0])
    key = _o_seed_key(m, node, "multinomial")
    samples = m.sd._op("random_categorical", [key, logits],
                       attrs=dict(num_samples=node.attr("sample_size", 1)))
    dt = _DTYPES[node.attr("dtype")] if node.attr("dtype") else np.int32
    m.set(node.outputs[0], m.sd._op("cast", [samples],
                                    attrs=dict(dtype=np.dtype(dt)),
                                    name=node.outputs[0]))


@orule("Compress")
def _o_compress(m, node):
    # output length is the number of True conditions — data-dependent, so
    # the condition must be constant (fold to a gather); loud otherwise
    cond = np.asarray(m.const(node.inputs[1])).astype(bool)
    idx = np.nonzero(cond)[0].astype(np.int64)
    x = m.get(node.inputs[0])
    axis = node.attr("axis")
    iv = m.sd.constant(idx, name=f"{node.outputs[0]}__idx")
    if axis is None:
        flat = m.sd._op("reshape", [x], attrs=dict(shape=(-1,)))
        m.set(node.outputs[0], m.sd._op("gather", [flat, iv],
                                        attrs=dict(axis=0),
                                        name=node.outputs[0]))
    else:
        m.set(node.outputs[0], m.sd._op("gather", [x, iv],
                                        attrs=dict(axis=int(axis)),
                                        name=node.outputs[0]))


@orule("NonZero")
def _o_nonzero(m, node):
    # output shape = number of nonzeros: XLA-dynamic. Constant inputs fold;
    # anything else fails loudly rather than guessing a size.
    val = m.const(node.inputs[0])
    out = np.stack(np.nonzero(np.asarray(val))).astype(np.int64)
    m.set(node.outputs[0], m.sd.constant(out, name=node.outputs[0]),
          const_val=out)


@orule("Unique")
def _o_unique(m, node):
    val = np.asarray(m.const(node.inputs[0]))
    if node.attr("axis") is not None:
        raise NotImplementedError("Unique with axis")
    sorted_attr = node.attr("sorted", 1)
    uniq, first_idx, inverse, counts = np.unique(
        val.reshape(-1), return_index=True, return_inverse=True,
        return_counts=True)
    if not sorted_attr:
        order = np.argsort(first_idx, kind="stable")
        remap = np.empty_like(order)
        remap[order] = np.arange(order.size)
        uniq = uniq[order]
        first_idx = first_idx[order]
        counts = counts[order]
        inverse = remap[inverse]
    outs = [uniq, first_idx.astype(np.int64), inverse.astype(np.int64),
            counts.astype(np.int64)]
    for i, o in enumerate(node.outputs):
        if o:
            m.set(o, m.sd.constant(outs[i], name=o), const_val=outs[i])


@orule("Hardmax")
def _o_hardmax(m, node):
    """Opset-13 semantics: one-hot of the argmax along ``axis`` (default -1).
    Registry ops only: argmax drops the axis, onehot re-inserts it there."""
    x = m.get(node.inputs[0])
    axis = int(node.attr("axis", -1))
    shape = x.shape
    if shape is None:
        raise NotImplementedError("Hardmax requires a static input shape")
    ax = axis % len(shape)
    idx = m.sd._op("argmax", [x], attrs=dict(axis=ax))
    m.set(node.outputs[0], m.sd._op(
        "onehot", [idx],
        attrs=dict(depth=int(shape[ax]), on_value=1.0, off_value=0.0,
                   axis=ax if ax != len(shape) - 1 else -1,
                   dtype=x.dtype or np.float32),  # ONNX: out type == in type
        name=node.outputs[0]))


@orule("NonMaxSuppression")
def _o_nms(m, node):
    """Wires to the registry's greedy ``non_max_suppression`` op (ops/image
    .py), once per (batch, class). ONNX emits a DYNAMIC (num_selected, 3)
    tensor; XLA needs static shapes, so the output here is the padded static
    variant — (B*C*max_out, 3) int32 triples [batch, class, box] with unused
    slots filled by [-1, -1, -1] (the registry op's own padding convention,
    same compromise as the waived SparseTensor decoders)."""
    boxes_v, scores_v = m.get(node.inputs[0]), m.get(node.inputs[1])
    max_out = (int(np.asarray(m.const(node.inputs[2])).ravel()[0])
               if m.has_input(node, 2) else 0)
    iou_th = (float(np.asarray(m.const(node.inputs[3])).ravel()[0])
              if m.has_input(node, 3) else 0.0)
    score_th = (float(np.asarray(m.const(node.inputs[4])).ravel()[0])
                if m.has_input(node, 4) else None)
    center = bool(node.attr("center_point_box", 0))
    bs, ss = boxes_v.shape, scores_v.shape
    if bs is None or ss is None:
        raise NotImplementedError("NonMaxSuppression requires static shapes")
    B, N, C = int(bs[0]), int(bs[1]), int(ss[1])
    m_eff = min(max_out, N) if max_out > 0 else 0

    def nms_all(bx, sc):
        from deeplearning4j_tpu_torch.ops.image import non_max_suppression

        if m_eff == 0:  # spec: max_output_boxes_per_class defaults to 0
            return torch.zeros((0, 3), dtype=torch.int32, device=bx.device)
        if center:  # [x_center, y_center, width, height]
            xc, yc, w, h = (bx[..., i] for i in range(4))
            bx = torch.stack([yc - h / 2, xc - w / 2,
                              yc + h / 2, xc + w / 2], dim=-1)
        else:  # [y1, x1, y2, x2], either diagonal pair: normalize corners
            b0, b1, b2, b3 = (bx[..., i] for i in range(4))
            bx = torch.stack([torch.minimum(b0, b2), torch.minimum(b1, b3),
                              torch.maximum(b0, b2), torch.maximum(b1, b3)],
                             dim=-1)
        rows = []
        for b in range(B):
            for c in range(C):
                sel = non_max_suppression(
                    bx[b], sc[b, c], m_eff, iou_threshold=iou_th,
                    score_threshold=(-float("inf") if score_th is None
                                     else score_th)).to(torch.int64)
                keep = sel >= 0
                neg = torch.full_like(sel, -1)
                rows.append(torch.stack(
                    [torch.where(keep, torch.full_like(sel, b), neg),
                     torch.where(keep, torch.full_like(sel, c), neg), sel],
                    dim=-1))
        return torch.cat(rows, dim=0).to(torch.int32)

    m.set(node.outputs[0], m.sd.custom_op(nms_all, boxes_v, scores_v,
                                          name=node.outputs[0]))
