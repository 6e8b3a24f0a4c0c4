"""TF GraphDef -> SameDiff importer (counterpart of
deeplearning4j_tpu/imports/tf_import.py; TFGraphMapper.java and the
samediff-import-tensorflow rules).

One import rule per TF op type (all 251 of the reference), each mapping a
node onto the op table by name, so imported graphs run through the same
SameDiff programs as natively built ones, and an imported conv, LSTM or
attention reaches the same kernels as the zoo's. Shape-argument inputs
(Reshape targets, reduction axes, the ConcatV2 axis...) must be constants:
they become static attrs at import time. NCHW graphs are transposed to
NHWC at the boundary, as in the reference.

The GraphDef is decoded without TensorFlow (``tf_proto.py``):
``import_graph_def`` takes its bytes, a path, or any object with
``SerializeToString()`` (a GraphDef TensorFlow built). TF's random ops
draw from a generator seeded from the reference's key bits
(``samediff/core.py``), so their values are the port's own.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.imports import tf_proto
from deeplearning4j_tpu_torch.samediff.core import (SameDiff, SDVariable,
                                                    make_subgraph_spec,
                                                    prng_key)

_RULES: Dict[str, Callable] = {}


def rule(*tf_ops):
    def deco(fn):
        for t in tf_ops:
            _RULES[t] = fn
        return fn
    return deco


class UnsupportedOpError(NotImplementedError):
    pass


class TFGraphMapper:
    """importGraph(GraphDef) parity. Use :func:`import_graph_def`.
    ``graph_def``: a ``tf_proto.GraphDef``; ``device``: the graph's."""

    def __init__(self, graph_def, device=None):
        self.gd = graph_def
        self.sd = SameDiff(device=device)
        self.vars: Dict[str, SDVariable] = {}      # "node:slot" -> var
        self.const_vals: Dict[str, np.ndarray] = {}  # import-time constants
        self.nodes = {n.name: n for n in graph_def.node}
        # FunctionDef library (TF2 functional control flow / calls)
        self.functions = {f.signature.name: f
                          for f in graph_def.library.function} \
            if graph_def.HasField("library") else {}
        # V1 cond support: tensor key -> (pred SDVariable, is_true_branch)
        self.branch_tag: Dict[str, tuple] = {}
        # sd-var names of Shape-fold constants carrying the -1 dynamic-dim
        # sentinel — const() refuses values derived from these unless the
        # calling rule opts in (Reshape, and rules with their own guards),
        # so the sentinel can never reach shape/axis math as a plain -1.
        # Shared with the graph's poison set: output() additionally refuses
        # targets whose runtime ancestors include one of these constants.
        self.dyn_vars = self.sd._poison_vars

    # ------------------------------------------------------------- plumbing
    @staticmethod
    def _canon(name: str) -> str:
        name = name.lstrip("^")
        return name if ":" in name else name + ":0"

    def get(self, name: str) -> SDVariable:
        return self.vars[self._canon(name)]

    def const(self, name: str, *, allow_dynamic: bool = False) -> np.ndarray:
        """Import-time value of a const input (shape args etc.)."""
        key = self._canon(name)
        if key not in self.const_vals:
            # eager-eval fallback: shape-math chains that some rule didn't
            # const-propagate (e.g. the Slice/Sub juggling inside TF's
            # softmax_cross_entropy_with_logits wrapper) are placeholder-
            # free — evaluate the producing subgraph now
            try:
                v = self.vars[key]
                val = np.asarray(
                    self.sd.output({}, [v.name], _allow_poison=True)[v.name])
            except Exception as e:
                raise UnsupportedOpError(
                    f"input {name!r} must be a constant (shape/axis "
                    "arguments are static under XLA); dynamic shape tensors "
                    f"are not importable (eager eval failed: {e!r})") from e
            self.const_vals[key] = val
        if not allow_dynamic and self._derives_dynamic(key):
            raise UnsupportedOpError(
                f"const input {name!r} derives from a dynamic (-1) "
                "placeholder dim — only a Reshape target can carry a "
                "dynamic dim under XLA; freeze with static shapes instead")
        return self.const_vals[key]

    def _derives_dynamic(self, key: str) -> bool:
        """True if `key`'s value derives (through the recorded graph) from
        a Shape fold that contained the -1 dynamic-dim sentinel."""
        v = self.vars.get(key)
        return v is not None and self.sd.derives_poisoned(v.name)

    def set(self, node_name: str, var, slot: int = 0, const_val=None):
        self.vars[f"{node_name}:{slot}"] = var
        if const_val is not None:
            self.const_vals[f"{node_name}:{slot}"] = np.asarray(const_val)

    def inputs(self, node) -> List[str]:
        return [i for i in node.input if not i.startswith("^")]

    # --------------------------------------------------------------- import
    def build(self) -> SameDiff:
        _import_nodes(self)
        # TF node name → samediff var name (they differ when a rule emits a
        # lowering postamble, e.g. the NCHW→NHWC boundary transposes)
        self.sd.tf_name_map = {
            k: v.name for k, v in self.vars.items()
        }
        return self.sd


def import_graph_def(graph_def, *, name: Optional[str] = None,
                     device=None) -> SameDiff:
    """Serialized bytes | path to .pb | an object with
    ``SerializeToString()`` | ``tf_proto.GraphDef`` -> SameDiff on
    ``device`` (None: the current CUDA device; raises without one)."""
    return TFGraphMapper(tf_proto.parse_graph_def(graph_def),
                         device=device).build()


# ---------------------------------------------------------------------------
# Attr helpers
# ---------------------------------------------------------------------------


def _tf_dtype(attr_dt) -> np.dtype:
    return tf_proto.numpy_dtype(attr_dt)


def _nhwc(node) -> bool:
    df = node.attr["data_format"].s.decode() if "data_format" in node.attr else "NHWC"
    if df not in ("NHWC", "NCHW"):
        raise UnsupportedOpError(f"data_format {df}")
    return df == "NHWC"


def _to_nhwc(m, node, x):
    """The convs are NHWC; transpose NCHW graphs at the boundary."""
    if _nhwc(node):
        return x, lambda y: y
    t_in = m.sd.math.permute(x, axes=(0, 2, 3, 1))
    return t_in, lambda y: m.sd.math.permute(y, axes=(0, 3, 1, 2))


# ---------------------------------------------------------------------------
# Sources
# ---------------------------------------------------------------------------


@rule("Placeholder", "PlaceholderWithDefault")
def _placeholder(m, node):
    try:
        dt = _tf_dtype(node.attr["dtype"].type)
    except (KeyError, TypeError):
        # variant/resource placeholders (e.g. the lowered graphs' unused
        # control-flow inputs): register with a dummy dtype — never fed
        dt = np.float32
    shape = None
    if "shape" in node.attr and not node.attr["shape"].shape.unknown_rank:
        shape = tuple(
            d.size if d.size >= 0 else -1 for d in node.attr["shape"].shape.dim
        )
    if node.op == "PlaceholderWithDefault":
        default = m.const(m.inputs(node)[0])
        m.set(node.name, m.sd.constant(default, name=node.name), const_val=default)
        return
    m.set(node.name, m.sd.placeholder(node.name, shape=shape, dtype=dt))


@rule("Const")
def _const(m, node):
    val = tf_proto.make_ndarray(node.attr["value"].tensor)
    m.set(node.name, m.sd.constant(np.asarray(val), name=node.name), const_val=val)


@rule("Identity", "StopGradient", "PreventGradient", "CheckNumerics")
def _identity(m, node):
    # a real graph node (not an alias): frozen-graph outputs are Identity
    # nodes and callers address them by TF node name
    src = m._canon(m.inputs(node)[0])
    m.set(node.name, m.sd._op("identity", [m.vars[src]], name=node.name),
          const_val=m.const_vals.get(src))


@rule("IdentityN")
def _identity_n(m, node):
    # N-ary Identity (tf.identity_n / custom_gradient plumbing — keras
    # EfficientNet's stem emits these): output i forwards input i
    for i, inp in enumerate(m.inputs(node)):
        src = m._canon(inp)
        m.set(node.name, m.sd._op("identity", [m.vars[src]]), slot=i,
              const_val=m.const_vals.get(src))


@rule("NoOp", "Assert")
def _noop(m, node):
    pass


# ---------------------------------------------------------------------------
# Math
# ---------------------------------------------------------------------------

_BINOP = {
    "Add": "add", "AddV2": "add", "Sub": "subtract", "Mul": "multiply",
    "RealDiv": "divide", "Div": "divide", "Maximum": "maximum",
    "Minimum": "minimum", "Pow": "pow", "SquaredDifference": "squareddifference",
    "FloorDiv": "floordiv", "FloorMod": "mod",
    "Mod": "fmod",  # raw Mod is C/truncation semantics (sign of dividend)
    "TruncateDiv": "truncatediv", "DivNoNan": "divide_no_nan",
    "Atan2": "atan2",
    "Greater": "greater", "GreaterEqual": "greaterequal", "Less": "less",
    "LessEqual": "lessequal", "Equal": "equals", "NotEqual": "notequals",
    "LogicalAnd": "and", "LogicalOr": "or",
}
_UNOP = {
    "Relu": "relu", "Relu6": "relu6", "Elu": "elu", "Selu": "selu",
    "Softplus": "softplus", "Softsign": "softsign", "Tanh": "tanh",
    "Sigmoid": "sigmoid", "Exp": "exp", "Log": "log", "Log1p": "log1p",
    "Sqrt": "sqrt", "Rsqrt": "rsqrt", "Square": "square", "Abs": "abs",
    "Neg": "neg", "Sign": "sign", "Floor": "floor", "Ceil": "ceil",
    "Round": "round", "Erf": "erf", "Erfc": "erfc", "Sin": "sin", "Cos": "cos",
    "Tan": "tan", "Asin": "asin", "Acos": "acos", "Atan": "atan",
    "Sinh": "sinh", "Cosh": "cosh", "Asinh": "asinh", "Acosh": "acosh",
    "Atanh": "atanh", "Reciprocal": "reciprocal", "LogicalNot": "not",
    "Expm1": "expm1", "IsNan": "isnan", "IsInf": "isinf", "IsFinite": "isfinite",
}


def _register_simple_rules():
    def bin_rule(opname):
        def fn(m, node):
            a, b = (m.get(i) for i in m.inputs(node))
            m.set(node.name, m.sd._op(opname, [a, b], name=node.name))
        return fn

    def un_rule(opname):
        def fn(m, node):
            m.set(node.name, m.sd._op(opname, [m.get(m.inputs(node)[0])],
                                      name=node.name))
        return fn

    for tf_op, opname in _BINOP.items():
        _RULES[tf_op] = bin_rule(opname)
    for tf_op, opname in _UNOP.items():
        _RULES[tf_op] = un_rule(opname)


_register_simple_rules()


@rule("MatMul")
def _matmul(m, node):
    a, b = (m.get(i) for i in m.inputs(node))
    m.set(node.name, m.sd._op("matmul", [a, b], attrs=dict(
        transpose_a=node.attr["transpose_a"].b,
        transpose_b=node.attr["transpose_b"].b), name=node.name))


@rule("BatchMatMul", "BatchMatMulV2")
def _batch_matmul(m, node):
    a, b = (m.get(i) for i in m.inputs(node))
    m.set(node.name, m.sd._op("matmul", [a, b], attrs=dict(
        transpose_a=node.attr["adj_x"].b, transpose_b=node.attr["adj_y"].b),
        name=node.name))


@rule("Einsum", "XlaEinsum")
def _einsum(m, node):
    """tf.einsum / XlaEinsum — what keras MultiHeadAttention lowers its
    projection and attention matmuls to. Lowered to the registered
    einsum_apply op (NOT custom_op: imported transformers stay
    serializable and nothing leaks into the global registry per node)."""
    eq = node.attr["equation"].s.decode()
    ins = [m.get(i) for i in m.inputs(node)]
    m.set(node.name, m.sd._op("einsum_apply", ins,
                              attrs=dict(equation=eq), name=node.name))


@rule("BiasAdd")
def _bias_add(m, node):
    x, b = (m.get(i) for i in m.inputs(node))
    if not _nhwc(node):
        raise UnsupportedOpError("BiasAdd NCHW")
    m.set(node.name, m.sd._op("add", [x, b], name=node.name))


@rule("AddN")
def _add_n(m, node):
    vs = [m.get(i) for i in m.inputs(node)]
    acc = vs[0]
    for v in vs[1:]:
        acc = m.sd._op("add", [acc, v])
    m.set(node.name, acc)


@rule("Softmax")
def _softmax(m, node):
    m.set(node.name, m.sd._op("softmax", [m.get(m.inputs(node)[0])],
                              attrs=dict(axis=-1), name=node.name))


@rule("LogSoftmax")
def _log_softmax(m, node):
    m.set(node.name, m.sd._op("log_softmax", [m.get(m.inputs(node)[0])],
                              attrs=dict(axis=-1), name=node.name))


_REDUCE = {"Mean": "mean", "Sum": "sum", "Max": "max", "Min": "min",
           "Prod": "prod", "All": "all", "Any": "any"}


def _register_reduce_rules():
    def red_rule(opname):
        def fn(m, node):
            x = m.get(m.inputs(node)[0])
            axes = m.const(m.inputs(node)[1])
            axis = tuple(int(a) for a in np.atleast_1d(axes))
            if not axis:  # reduce over no axes == identity
                m.set(node.name, m.sd._op("identity", [x], name=node.name))
                return
            m.set(node.name, m.sd._op(opname, [x], attrs=dict(
                axis=axis if len(axis) > 1 else axis[0],
                keepdims=bool(node.attr["keep_dims"].b)), name=node.name))
        return fn

    for tf_op, opname in _REDUCE.items():
        _RULES[tf_op] = red_rule(opname)


_register_reduce_rules()


@rule("ArgMax")
def _argmax(m, node):
    x = m.get(m.inputs(node)[0])
    axis = int(m.const(m.inputs(node)[1]))
    m.set(node.name, m.sd._op("argmax", [x], attrs=dict(axis=axis), name=node.name))


@rule("Cast")
def _cast(m, node):
    dt = _tf_dtype(node.attr["DstT"].type)
    m.set(node.name, m.sd._op("cast", [m.get(m.inputs(node)[0])],
                              attrs=dict(dtype=dt), name=node.name))


@rule("Select", "SelectV2")
def _select(m, node):
    c, a, b = (m.get(i) for i in m.inputs(node))
    m.set(node.name, m.sd._op("where", [c, a, b], name=node.name))


# ---------------------------------------------------------------------------
# Shape ops — shape arguments must be import-time constants
# ---------------------------------------------------------------------------


@rule("Reshape")
def _reshape(m, node):
    x = m.get(m.inputs(node)[0])
    # the reshape op resolves one -1 at runtime — the keras
    # Pack(StridedSlice(Shape(x)),…) dynamic-batch pattern lands here
    shape = tuple(int(s)
                  for s in m.const(m.inputs(node)[1], allow_dynamic=True))
    m.set(node.name, m.sd._op("reshape", [x], attrs=dict(shape=shape),
                              name=node.name))


@rule("Transpose")
def _transpose(m, node):
    x = m.get(m.inputs(node)[0])
    perm = tuple(int(p) for p in m.const(m.inputs(node)[1]))
    m.set(node.name, m.sd._op("permute", [x], attrs=dict(axes=perm),
                              name=node.name))


@rule("ExpandDims")
def _expand_dims(m, node):
    x = m.get(m.inputs(node)[0])
    axis = int(m.const(m.inputs(node)[1]))
    m.set(node.name, m.sd._op("expand_dims", [x], attrs=dict(axis=axis),
                              name=node.name))


@rule("Squeeze")
def _squeeze(m, node):
    x = m.get(m.inputs(node)[0])
    dims = tuple(node.attr["squeeze_dims"].list.i)
    attrs = dict(axis=dims) if dims else {}
    m.set(node.name, m.sd._op("squeeze", [x], attrs=attrs, name=node.name))


@rule("ConcatV2")
def _concat(m, node):
    ins = m.inputs(node)
    vs = [m.get(i) for i in ins[:-1]]
    axis = int(m.const(ins[-1]))
    m.set(node.name, m.sd._op("concat_n", vs, attrs=dict(axis=axis),
                              name=node.name))


@rule("Pack")
def _pack(m, node):
    vs = [m.get(i) for i in m.inputs(node)]
    axis = int(node.attr["axis"].i)
    m.set(node.name, m.sd._op("stack_n", vs, attrs=dict(axis=axis),
                              name=node.name))
    keys = [m._canon(i) for i in m.inputs(node)]
    if all(k in m.const_vals for k in keys):  # shape tuples stay static
        m.const_vals[node.name + ":0"] = np.stack(
            [np.asarray(m.const_vals[k]) for k in keys], axis=axis)


@rule("Unpack")
def _unpack(m, node):
    x = m.get(m.inputs(node)[0])
    num = int(node.attr["num"].i)
    axis = int(node.attr["axis"].i)
    outs = m.sd.math.unstack(x, axis=axis, num=num)
    for i, v in enumerate(outs):
        m.set(node.name, v, slot=i)


@rule("Split")
def _split(m, node):
    axis = int(m.const(m.inputs(node)[0]))
    x = m.get(m.inputs(node)[1])
    n = int(node.attr["num_split"].i)
    outs = m.sd.math.split(x, num_or_sections=n, axis=axis)
    for i, v in enumerate(outs):
        m.set(node.name, v, slot=i)


@rule("GatherV2", "Gather")
def _gather(m, node):
    ins = m.inputs(node)
    x, idx = m.get(ins[0]), m.get(ins[1])
    axis = int(m.const(ins[2])) if len(ins) > 2 else 0
    m.set(node.name, m.sd._op("gather", [x, idx], attrs=dict(axis=axis),
                              name=node.name))


@rule("Slice")
def _slice(m, node):
    ins = m.inputs(node)
    x = m.get(ins[0])
    begin = [int(v) for v in m.const(ins[1])]
    size = [int(v) for v in m.const(ins[2])]
    m.set(node.name, m.sd._op("slice", [x], attrs=dict(begin=begin, sizes=size),
                              name=node.name))


@rule("StridedSlice")
def _strided_slice(m, node):
    ins = m.inputs(node)
    x = m.get(ins[0])
    begin = [int(v) for v in m.const(ins[1])]
    end = [int(v) for v in m.const(ins[2])]
    strides = [int(v) for v in m.const(ins[3])]
    masks = {k: int(node.attr[k].i) for k in
             ("begin_mask", "end_mask", "ellipsis_mask", "new_axis_mask",
              "shrink_axis_mask")}
    # One spec entry per position of the begin/end/strides vectors; ellipsis
    # and new_axis positions consume a vector slot but no input axis (TF
    # guarantees at most one ellipsis). Maps 1:1 onto getitem's ("e",)/("n",)
    # spec entries — pure index arithmetic, no dynamic shapes.
    spec = []
    for d in range(len(begin)):
        if masks["ellipsis_mask"] & (1 << d):
            spec.append(("e",))
        elif masks["new_axis_mask"] & (1 << d):
            spec.append(("n",))
        elif masks["shrink_axis_mask"] & (1 << d):
            spec.append(("i", begin[d]))
        else:
            b = None if masks["begin_mask"] & (1 << d) else begin[d]
            e = None if masks["end_mask"] & (1 << d) else end[d]
            spec.append(("s", b, e, strides[d]))
    m.set(node.name, m.sd._op("getitem", [x], attrs=dict(spec=tuple(spec)),
                              name=node.name))
    src = m._canon(ins[0])
    if src in m.const_vals:  # slices of static shapes stay static
        idx = tuple(s[1] if s[0] == "i"
                    else None if s[0] == "n"
                    else Ellipsis if s[0] == "e"
                    else slice(s[1], s[2], s[3])
                    for s in spec)
        m.const_vals[node.name + ":0"] = np.asarray(m.const_vals[src])[idx]


@rule("SpaceToBatchND")
def _space_to_batch_nd(m, node):
    ins = m.inputs(node)
    x = m.get(ins[0])
    bs = tuple(int(v) for v in m.const(ins[1]))
    pads = tuple(tuple(int(v) for v in row)
                 for row in np.atleast_2d(m.const(ins[2])))
    m.set(node.name, m.sd._op("space_to_batch", [x],
                              attrs=dict(block_shape=bs, paddings=pads),
                              name=node.name))


@rule("BatchToSpaceND")
def _batch_to_space_nd(m, node):
    ins = m.inputs(node)
    x = m.get(ins[0])
    bs = tuple(int(v) for v in m.const(ins[1]))
    crops = tuple(tuple(int(v) for v in row)
                  for row in np.atleast_2d(m.const(ins[2])))
    m.set(node.name, m.sd._op("batch_to_space", [x],
                              attrs=dict(block_shape=bs, crops=crops),
                              name=node.name))


@rule("Pad", "PadV2")
def _pad(m, node):
    ins = m.inputs(node)
    x = m.get(ins[0])
    pads = [(int(a), int(b)) for a, b in np.asarray(m.const(ins[1]))]
    cv = float(np.asarray(m.const(ins[2]))) if len(ins) > 2 else 0.0
    m.set(node.name, m.sd._op("pad", [x], attrs=dict(
        paddings=tuple(pads), constant_value=cv), name=node.name))


@rule("Tile")
def _tile(m, node):
    x = m.get(m.inputs(node)[0])
    # opts in to keep its own (more specific) dynamic-dim guard below
    reps = tuple(int(v)
                 for v in m.const(m.inputs(node)[1], allow_dynamic=True))
    if any(r < 0 for r in reps):
        # -1 = the Shape rule's dynamic-dim sentinel; tiling by it is not
        # expressible statically
        raise UnsupportedOpError("Tile reps derived from a dynamic dim")
    m.set(node.name, m.sd._op("tile", [x], attrs=dict(reps=reps), name=node.name))


@rule("Fill")
def _fill(m, node):
    # opts in to keep its own (more specific) dynamic-dim guard below
    shape = tuple(int(v)
                  for v in m.const(m.inputs(node)[0], allow_dynamic=True))
    if any(s < 0 for s in shape):
        raise UnsupportedOpError("Fill shape derived from a dynamic dim")
    val = m.const(m.inputs(node)[1])
    arr = np.full(shape, val)
    m.set(node.name, m.sd.constant(arr, name=node.name), const_val=arr)


@rule("OneHot")
def _one_hot(m, node):
    ins = m.inputs(node)
    idx = m.get(ins[0])
    depth = int(m.const(ins[1]))
    on = float(np.asarray(m.const(ins[2])))
    off = float(np.asarray(m.const(ins[3])))
    axis = int(node.attr["axis"].i) if "axis" in node.attr else -1
    m.set(node.name, m.sd._op("onehot", [idx], attrs=dict(
        depth=depth, on_value=on, off_value=off, axis=axis), name=node.name))


# ---------------------------------------------------------------------------
# NN ops
# ---------------------------------------------------------------------------


def _strides_2d(node, nhwc):
    s = list(node.attr["strides"].list.i)
    return (s[1], s[2]) if nhwc else (s[2], s[3])


@rule("Conv2D")
def _conv2d(m, node):
    x, w = (m.get(i) for i in m.inputs(node))
    nhwc = _nhwc(node)
    x, back = _to_nhwc(m, node, x)
    dil = list(node.attr["dilations"].list.i) or [1, 1, 1, 1]
    y = m.sd._op("conv2d", [x, w], attrs=dict(
        strides=_strides_2d(node, nhwc),
        padding=node.attr["padding"].s.decode(),
        dilation=(dil[1], dil[2]) if nhwc else (dil[2], dil[3])),
        name=node.name)
    m.set(node.name, back(y))


@rule("DepthwiseConv2dNative")
def _depthwise(m, node):
    x, w = (m.get(i) for i in m.inputs(node))
    nhwc = _nhwc(node)
    x, back = _to_nhwc(m, node, x)
    y = m.sd._op("depthwise_conv2d", [x, w], attrs=dict(
        strides=_strides_2d(node, nhwc),
        padding=node.attr["padding"].s.decode()), name=node.name)
    m.set(node.name, back(y))


@rule("MaxPool", "AvgPool")
def _pool(m, node):
    x = m.get(m.inputs(node)[0])
    nhwc = _nhwc(node)
    x, back = _to_nhwc(m, node, x)
    k = list(node.attr["ksize"].list.i)
    y = m.sd._op("maxpool2d" if node.op == "MaxPool" else "avgpool2d", [x],
                 attrs=dict(kernel=(k[1], k[2]) if nhwc else (k[2], k[3]),
                            strides=_strides_2d(node, nhwc),
                            padding=node.attr["padding"].s.decode()),
                 name=node.name)
    m.set(node.name, back(y))


@rule("FusedBatchNorm", "FusedBatchNormV2", "FusedBatchNormV3")
def _fused_bn(m, node):
    ins = m.inputs(node)
    x, gamma, beta, mean, var = (m.get(i) for i in ins[:5])
    x, back = _to_nhwc(m, node, x)
    eps = float(node.attr["epsilon"].f)
    if node.attr["is_training"].b:
        # Training mode (samediff-import FusedBatchNormV3 rule parity,
        # path-cite — mount empty): normalize with biased batch variance,
        # output batch_mean + UNBIASED batch variance (verified vs installed
        # TF), optionally blended with the incoming running stats by
        # exponential_avg_factor f: out_stat = (1-f)*old + f*batch. That is
        # exactly the registry's fused-VJP batchnorm_train with momentum=1-f,
        # so imported conv nets fine-tune through BN with the same single-pass
        # fwd/bwd kernel the native layers use.
        # attr absent (V1/V2 nodes) means 1.0; an explicit 0.0 is meaningful
        # (TF returns the incoming running stats unchanged)
        f = (float(node.attr["exponential_avg_factor"].f)
             if "exponential_avg_factor" in node.attr else 1.0)
        # tf.compat.v1.nn.fused_batch_norm(training=True) with no running
        # stats passes EMPTY mean/var tensors; substitute zeros so the
        # blend broadcasts (f=1.0 there, so the values never contribute)
        for slot, stat in (("mean", mean), ("var", var)):
            cv = m.const_vals.get(m._canon(ins[3 if slot == "mean" else 4]))
            if cv is not None and cv.size == 0:
                c = gamma.shape[0]
                z = np.zeros(c, np.float32)
                repl = m.sd.constant(z, name=f"{node.name}_{slot}0")
                if slot == "mean":
                    mean = repl
                else:
                    var = repl
        y, new_mean, new_var = m.sd._op(
            "batchnorm_train", [x, gamma, beta, mean, var],
            attrs=dict(momentum=1.0 - f, eps=eps), n_out=3, name=node.name)
        m.set(node.name, back(y), slot=0)
        m.set(node.name, new_mean, slot=1)
        m.set(node.name, new_var, slot=2)
        # reserve_space_{1,2,3} feed only FusedBatchNormGrad, which a
        # forward training graph re-differentiated here never contains;
        # alias them to the stats so consumers resolve.
        m.set(node.name, new_mean, slot=3)
        m.set(node.name, new_var, slot=4)
        m.set(node.name, new_var, slot=5)
        return
    y = m.sd._op("batchnorm", [x, mean, var, gamma, beta],
                 attrs=dict(eps=eps), name=node.name)
    m.set(node.name, back(y))


@rule("Shape")
def _shape(m, node):
    # static under XLA: materialize as a constant. Dims that depend on a
    # dynamic (-1) placeholder dim fold as the -1 sentinel (TF's own
    # unknown-dim convention) — the keras Reshape pattern
    # Pack(StridedSlice(Shape(x)), 1, 1, C) then reaches the reshape op as a
    # (-1, 1, 1, C) target, which handles the runtime batch natively
    src = m._canon(m.inputs(node)[0])
    v = m.vars[src]
    shp = m.sd._infer(v.name, "shape", mark_dynamic=True) \
        if v.vtype.name == "ARRAY" else v.shape
    if shp is None or any(s is None for s in shp):
        raise UnsupportedOpError("Shape of dynamically-shaped tensor")
    arr = np.asarray(shp, np.int32)
    cvar = m.sd.constant(arr, name=node.name)
    m.set(node.name, cvar, const_val=arr)
    if (arr == -1).any():
        m.dyn_vars.add(cvar.name)


# ---------------------------------------------------------------------------
# Control flow — TF1 dataflow frames (Enter/Merge/Switch/NextIteration/Exit/
# LoopCond) and TF2 functional ops (While/If/PartitionedCall + FunctionDefs).
#
# Reference parity: TFGraphMapper.java maps these ops and AbstractSession
# interprets them op-at-a-time on the JVM (SURVEY.md §3.3). Here a whole
# while-frame becomes ONE serializable __cf_while__ node (the body/cond
# subgraphs are re-imported into scratch SameDiff graphs), and V1 conds
# lower to predicated selects.
# ---------------------------------------------------------------------------

_FRAME_CONTROL = {"Enter", "Merge", "Switch", "NextIteration", "Exit",
                  "LoopCond"}


def _prod(name: str) -> str:
    return name.lstrip("^").split(":")[0]


class _Frame:
    def __init__(self, name):
        self.name = name
        self.enters: list = []       # Enter nodes, graph order
        self.members: set = set()    # node names (incl. control + Exit)
        self.merges: list = []       # Merge nodes = loop-carried vars
        self.enter_of: Dict[str, object] = {}      # merge name -> Enter node
        self.nextiter_of: Dict[str, object] = {}   # merge name -> NextIteration
        self.switch_of: Dict[str, object] = {}     # merge name -> Switch node
        self.exits_of: Dict[str, list] = {}        # merge name -> [Exit nodes]
        self.loopcond = None
        self.parent: Optional[str] = None          # enclosing frame name
        self.emitted = False


def _detect_frames(m):
    """Group TF1 while-loop dataflow nodes into frames (arbitrarily nested).

    Each node lands in its innermost frame (cross-frame data edges always
    pass an Enter on the way in and an Exit on the way out — the TF1 frame
    invariant); ``parent`` links record nesting so emission can recurse."""
    frames: Dict[str, _Frame] = {}
    owner: Dict[str, str] = {}
    for n in m.gd.node:
        if n.op == "Enter":
            fname = n.attr["frame_name"].s.decode()
            fr = frames.setdefault(fname, _Frame(fname))
            fr.enters.append(n)
            owner[n.name] = fname
            fr.members.add(n.name)
    if not frames:
        return frames, owner
    # Nesting: an Enter input produced inside frame P means this frame is
    # nested in P. A producer that is itself an Exit of frame G lives in G's
    # PARENT context (the value has left G) — resolved recursively so
    # sequential sibling loops are not mistaken for nesting.
    def _context_of(p, _seen=frozenset()):
        if p not in owner:
            return None
        f = owner[p]
        if m.nodes[p].op == "Exit" and f not in _seen:
            return _parent_of(f, _seen | {f})
        return f

    def _parent_of(fname, _seen=frozenset(), strict=False):
        fr = frames[fname]
        parents = {_context_of(_prod(e.input[0]), _seen) for e in fr.enters}
        parents.discard(None)
        if len(parents) > 1:
            if strict:
                raise UnsupportedOpError(
                    f"while frame {fname!r} enters from two different frames "
                    f"{sorted(parents)} (unstructured nesting)")
            return None
        return parents.pop() if parents else None

    changed = True
    while changed:  # fixpoint over membership + nesting
        changed = False
        # (a) propagate along ordinary data/control edges (stop at Exit:
        # an Exit output lives OUTSIDE the frame that produced it)
        for n in m.gd.node:
            if n.name in owner or n.op == "Enter":
                continue
            for i in n.input:
                p = _prod(i)
                if p in owner and m.nodes[p].op != "Exit":
                    owner[n.name] = owner[p]
                    frames[owner[p]].members.add(n.name)
                    changed = True
                    break
        for fname, fr in frames.items():
            fr.parent = _parent_of(fname)
        # (b) a node reading frame G's Exit belongs to G's parent frame
        # (for a top-level G the consumer is frameless, which (a) encodes
        # by never crossing the Exit)
        for n in m.gd.node:
            if n.name in owner or n.op == "Enter":
                continue
            for i in n.input:
                p = _prod(i)
                if p in owner and m.nodes[p].op == "Exit":
                    parent = frames[owner[p]].parent
                    if parent is not None:
                        owner[n.name] = parent
                        frames[parent].members.add(n.name)
                        changed = True
                        break
    for fname, fr in frames.items():
        fr.parent = _parent_of(fname, strict=True)
    for fr in frames.values():
        enter_names = {e.name for e in fr.enters}
        for n in m.gd.node:
            if n.name not in fr.members:
                continue
            if n.op == "LoopCond":
                fr.loopcond = n
            elif n.op == "Merge":
                ins = [_prod(i) for i in n.input]
                ent = [i for i in ins if i in enter_names]
                ni = [i for i in ins if m.nodes[i].op == "NextIteration"]
                if len(ent) != 1 or len(ni) != 1:
                    raise UnsupportedOpError(
                        f"unrecognized Merge {n.name!r} in while frame")
                fr.merges.append(n)
                fr.enter_of[n.name] = m.nodes[ent[0]]
                fr.nextiter_of[n.name] = m.nodes[ni[0]]
            elif n.op == "Switch":
                fr.switch_of[_prod(n.input[0])] = n
        for n in m.gd.node:
            if n.name in fr.members and n.op == "Exit":
                sw = _prod(n.input[0])
                for mg in fr.merges:
                    s = fr.switch_of.get(mg.name)
                    if s is not None and s.name == sw:
                        fr.exits_of.setdefault(mg.name, []).append(n)
        if fr.loopcond is None:
            raise UnsupportedOpError(f"while frame {fr.name!r} has no LoopCond")
    return frames, owner


def _subgraph_callable(m, member_names, seeds, targets, frame_name=None):
    """Compile frame member nodes into a scratch SameDiff:
    returns (sub_sd, placeholder_names, target_names).

    ``seeds``: tensor keys pre-bound to the subgraph's array arguments;
    ``targets``: tensor keys to return. Member nodes are re-imported into a
    scratch SameDiff via the ordinary rules; the caller serializes it into
    a __cf_while__ spec (round 4 — the closure form could not save).
    ``frame_name``: the frame whose body/cond this is — frames nested
    directly inside it are recursively emitted as __cf_while__ nodes of
    the scratch graph when a member reads one of their Exit tensors."""
    sub = TFGraphMapper(type(m.gd)(), device="cpu")
    sub.functions = m.functions
    ph_names = []
    for idx, key in enumerate(seeds):
        ph = sub.sd.placeholder(f"__seed{idx}")
        sub.vars[m._canon(key)] = ph
        ph_names.append(ph.name)

    frames = getattr(m, "frames", {})
    owner = getattr(m, "owner", {})
    needed, seen, scheduled_frames = [], set(), set()

    def visit_tensor(i, consumer):
        if m._canon(i) in sub.vars:
            return
        p = _prod(i)
        pnode = m.nodes.get(p)
        if pnode is None:
            raise UnsupportedOpError(f"unknown input {i!r} in while frame")
        if pnode.op == "Exit" and owner.get(p) is not None \
                and frames[owner[p]].parent == frame_name:
            schedule_frame(frames[owner[p]])
            return
        if pnode.op in _FRAME_CONTROL:
            raise UnsupportedOpError(
                f"frame node {consumer!r} reads unsupported control tensor "
                f"{i!r} (only loop vars and invariants are seeded)")
        if p in member_names or pnode.op == "Const":
            visit(p)  # outer Consts are pulled into the subgraph
        else:
            raise UnsupportedOpError(
                f"while-frame node {consumer!r} captures non-constant outer "
                f"tensor {i!r}; only constants and Enter-ed values can "
                "cross the frame boundary")

    def schedule_frame(g):
        if g.name in scheduled_frames:
            return
        scheduled_frames.add(g.name)
        for e in g.enters:  # init values live in THIS subgraph's context
            visit_tensor(e.input[0], g.name)
        needed.append(("__frame__", g.name))

    def visit(name):
        if name in seen:
            return
        seen.add(name)
        node = m.nodes[name]
        for i in node.input:
            if i.startswith("^"):
                continue
            visit_tensor(i, name)
        needed.append(name)

    for t in targets:
        visit_tensor(t, "<target>")
    for item in needed:  # post-order append == topological order
        if isinstance(item, tuple):
            _emit_frame(m, sub, frames[item[1]])
            continue
        node = m.nodes[item]
        fn = _RULES.get(node.op)
        if fn is None:
            raise UnsupportedOpError(
                f"no import rule for TF op {node.op!r} inside while frame")
        fn(sub, node)
    tnames = [sub.get(t).name for t in targets]
    return sub.sd, ph_names, tnames


def _emit_frame(defs, ctx, fr):
    """Lower one TF1 while frame to a ``__cf_while__`` node.

    ``defs`` is the original graph mapper (node definitions, frame table);
    ``ctx`` is where values are read and the loop node is emitted — the
    top-level mapper, or the parent frame's scratch mapper when nested."""
    init_vars, seeds_cond, seeds_body = [], [], []
    for mg in fr.merges:
        sw = fr.switch_of.get(mg.name)
        if sw is None:
            raise UnsupportedOpError(
                f"while frame {fr.name!r}: loop var {mg.name!r} has no Switch")
        init_vars.append(ctx.get(fr.enter_of[mg.name].input[0]))
        seeds_cond.append(mg.name + ":0")
        seeds_body.append(sw.name + ":1")
    merge_enters = {fr.enter_of[mg.name].name for mg in fr.merges}
    for e in fr.enters:  # loop invariants: carried through unchanged
        if e.name not in merge_enters:
            init_vars.append(ctx.get(e.input[0]))
            seeds_cond.append(e.name + ":0")
            seeds_body.append(e.name + ":0")
    n_merge = len(fr.merges)
    n_carry = len(init_vars)

    cond_sd, cond_phs, cond_ts = _subgraph_callable(
        defs, fr.members, seeds_cond, [fr.loopcond.input[0]],
        frame_name=fr.name)
    cond_spec = make_subgraph_spec(cond_sd, cond_phs, cond_ts)
    body_targets = [fr.nextiter_of[mg.name].input[0] for mg in fr.merges]
    body_sd, body_phs, body_ts = _subgraph_callable(
        defs, fr.members, seeds_body, body_targets, frame_name=fr.name)
    # loop invariants pass through: the body outputs its own seed
    # placeholders for them, keeping the carry arity uniform
    body_spec = make_subgraph_spec(body_sd, body_phs,
                                   body_ts + body_phs[n_merge:])
    out = ctx.sd._op("__cf_while__", init_vars, attrs=dict(
        cond_spec=cond_spec, body_spec=body_spec, n_carried=n_carry),
        n_out=n_carry, name=f"while_{fr.name.rsplit('/', 1)[-1]}")
    outs = (out,) if n_carry == 1 else out
    for i, mg in enumerate(fr.merges):
        for ex in fr.exits_of.get(mg.name, ()):
            ctx.set(ex.name, outs[i])
    fr.emitted = True


def _import_nodes(m):
    """Main import loop: frame-aware, branch-tag-propagating."""
    frames, owner = _detect_frames(m)
    m.frames, m.owner = frames, owner
    for node in m.gd.node:
        if node.name in owner:
            fr = frames[owner[node.name]]
            # only top-level frames are emitted here; nested ones are emitted
            # recursively inside their parent frame's body subgraph
            if node.op == "Exit" and fr.parent is None and not fr.emitted:
                _emit_frame(m, m, fr)
            continue
        fn = _RULES.get(node.op)
        if fn is None:
            raise UnsupportedOpError(
                f"no import rule for TF op {node.op!r} (node {node.name!r}); "
                f"{len(_RULES)} op types supported")
        before = set(m.vars) if m.branch_tag else None
        fn(m, node)
        if before is not None and node.op not in ("Switch", "Merge"):
            # V1 cond: propagate which branch a tensor belongs to
            tags = {m.branch_tag[k]
                    for k in (m._canon(i) for i in m.inputs(node))
                    if k in m.branch_tag}
            if tags:
                preds = {id(t[0]) for t in tags}
                if len(preds) > 1:
                    raise UnsupportedOpError(
                        f"node {node.name!r} mixes tensors from two different "
                        "Switch predicates (unstructured cond)")
                tag = next(iter(tags))
                for k in set(m.vars) - before:
                    m.branch_tag[k] = tag


@rule("Enter", "Exit", "NextIteration", "LoopCond")
def _frame_only(m, node):  # reached only when frame detection missed it
    raise UnsupportedOpError(
        f"{node.op} outside a recognized while frame (node {node.name!r})")


@rule("Switch")
def _switch(m, node):
    """V1 cond lowering: both branches are computed (graphs are pure), the
    Merge selects — the standard predication of Switch/Merge dataflow."""
    data = m.get(node.input[0])
    pred = m.get(node.input[1])
    m.set(node.name, data, slot=0)
    m.set(node.name, data, slot=1)
    m.branch_tag[node.name + ":0"] = (pred, False)
    m.branch_tag[node.name + ":1"] = (pred, True)


@rule("Merge")
def _merge(m, node):
    ins = [m._canon(i) for i in m.inputs(node)]
    if len(ins) != 2:
        raise UnsupportedOpError(
            f"Merge {node.name!r} with {len(ins)} inputs outside a while frame")
    tags = [m.branch_tag.get(k) for k in ins]
    preds = {id(t[0]) for t in tags if t is not None}
    if len(preds) != 1:
        raise UnsupportedOpError(
            f"cannot determine the predicate of Merge {node.name!r} "
            "(unstructured cond)")
    if (tags[0] and tags[0][1]) or (tags[1] and not tags[1][1]):
        pred, t_key, f_key = (tags[0] or tags[1])[0], ins[0], ins[1]
    else:
        pred, t_key, f_key = (tags[0] or tags[1])[0], ins[1], ins[0]
    out = m.sd._op("where", [pred, m.vars[t_key], m.vars[f_key]],
                   name=node.name)
    m.set(node.name, out)
    # value_index output (slot 1): 0 if true branch produced the value
    idx = m.sd._op("where", [pred, m.sd.constant(np.int32(0), name="vi0"),
                             m.sd.constant(np.int32(1), name="vi1")],
                   name=node.name + "_value_index")
    m.set(node.name, idx, slot=1)


# -- TF2 functional control flow --------------------------------------------


def _fdef_graph(m, func_attr):
    fname = func_attr.func.name
    fdef = m.functions.get(fname)
    if fdef is None:
        raise UnsupportedOpError(f"function {fname!r} not in graph library")
    sub_gd, nested_to_flat = tf_proto.function_def_to_graph_def(
        fdef, m.functions)
    return fdef, sub_gd, nested_to_flat


def _set_multi(m, node, outs):
    for i, v in enumerate(outs):
        m.set(node.name, v, slot=i)


def _func_spec(m, func_attr):
    """FunctionDef → (serializable subgraph spec, n_outputs) — the
    structured-control-flow form of _func_callable (round 4: TF While/If
    nodes serialize like the ONNX Loop/If/Scan ones)."""
    fdef, sub_gd, nested_to_flat = _fdef_graph(m, func_attr)
    sub = TFGraphMapper(sub_gd, device="cpu")
    sub.functions = dict(m.functions)
    sub.functions.update({f.signature.name: f
                          for f in sub_gd.library.function})
    sub_sd = sub.build()
    ph_names = [sub.get(a.name).name for a in fdef.signature.input_arg]
    rets = [nested_to_flat[fdef.ret[o.name]]
            for o in fdef.signature.output_arg]
    tnames = [sub.get(r).name for r in rets]
    return make_subgraph_spec(sub_sd, ph_names, tnames), len(tnames)


@rule("While", "StatelessWhile")
def _while_v2(m, node):
    ops = [m.get(i) for i in m.inputs(node)]
    cond_spec, _ = _func_spec(m, node.attr["cond"])
    body_spec, n_body = _func_spec(m, node.attr["body"])
    if n_body != len(ops):
        raise UnsupportedOpError(
            f"While {node.name!r}: body returns {n_body} values for "
            f"{len(ops)} loop vars")
    n = len(ops)
    out = m.sd._op("__cf_while__", ops, attrs=dict(
        cond_spec=cond_spec, body_spec=body_spec, n_carried=n), n_out=n,
        name=node.name)
    _set_multi(m, node, (out,) if n == 1 else out)


@rule("If", "StatelessIf")
def _if_v2(m, node):
    ins = m.inputs(node)
    pred = m.get(ins[0])
    ops = [m.get(i) for i in ins[1:]]
    then_spec, n_t = _func_spec(m, node.attr["then_branch"])
    else_spec, n_e = _func_spec(m, node.attr["else_branch"])
    if n_t != n_e:
        raise UnsupportedOpError(f"If {node.name!r}: branch arity mismatch")
    idx = list(range(len(ops)))  # TF branches take the SAME explicit args
    out = m.sd._op("__cf_if__", [pred] + ops, attrs=dict(
        then_spec=then_spec, else_spec=else_spec, t_idx=idx, e_idx=idx,
        n_out=n_t), n_out=n_t, name=node.name)
    _set_multi(m, node, (out,) if n_t == 1 else out)


@rule("PartitionedCall", "StatefulPartitionedCall")
def _partitioned_call(m, node):
    """Function calls are INLINED into the enclosing graph (the reference
    importer flattens functions too): ops stay visible/serializable and
    gradients flow."""
    fdef, sub_gd, nested_to_flat = _fdef_graph(m, node.attr["f"])
    input_vars = [m.get(i) for i in m.inputs(node)]
    sub = TFGraphMapper(sub_gd, device="cpu")
    sub.sd = m.sd  # shared graph: true inlining
    sub.functions = dict(m.functions)
    sub.functions.update({f.signature.name: f
                          for f in sub_gd.library.function})
    skip = set()
    for arg, v in zip(fdef.signature.input_arg, input_vars):
        sub.vars[arg.name + ":0"] = v
        skip.add(arg.name)
    # placeholders for the args were materialized by function_def_to_graph_def;
    # drop them (the call's inputs take their place) and import the rest
    del_nodes = [n for n in sub_gd.node if n.name in skip]
    for n in del_nodes:
        sub_gd.node.remove(n)
    sub.nodes = {n.name: n for n in sub_gd.node}
    _import_nodes(sub)
    for i, o in enumerate(fdef.signature.output_arg):
        m.set(node.name, sub.get(nested_to_flat[fdef.ret[o.name]]), slot=i)


# -- TensorList ops (TF2 loop-carried accumulators; Keras RNN exports) -------


@rule("TensorListReserve", "EmptyTensorList")
def _tensorlist_reserve(m, node):
    num = int(np.asarray(m.const(m.inputs(node)[1])))
    dt = _tf_dtype(node.attr["element_dtype"].type)
    m.set(node.name, m.sd._op(
        "tensorlist_reserve", [],
        attrs=dict(num_elements=num, dtype=np.dtype(dt).name),
        name=node.name))


@rule("TensorListFromTensor")
def _tensorlist_from_tensor(m, node):
    m.set(node.name, m.sd._op("tensorlist_from_tensor",
                              [m.get(m.inputs(node)[0])], name=node.name))


@rule("TensorListGetItem")
def _tensorlist_get_item(m, node):
    ins = m.inputs(node)
    m.set(node.name, m.sd._op("tensorlist_get_item",
                              [m.get(ins[0]), m.get(ins[1])], name=node.name))


@rule("TensorListSetItem")
def _tensorlist_set_item(m, node):
    ins = m.inputs(node)
    m.set(node.name, m.sd._op(
        "tensorlist_set_item",
        [m.get(ins[0]), m.get(ins[1]), m.get(ins[2])], name=node.name))


@rule("TensorListStack")
def _tensorlist_stack(m, node):
    m.set(node.name, m.sd._op("tensorlist_stack", [m.get(m.inputs(node)[0])],
                              name=node.name))


@rule("TensorListLength")
def _tensorlist_length(m, node):
    m.set(node.name, m.sd._op("tensorlist_length", [m.get(m.inputs(node)[0])],
                              name=node.name))


@rule("Range")
def _range(m, node):
    ins = m.inputs(node)
    # provenance guard on ALL THREE bounds (a sentinel -1 start/delta would
    # bake a wrong constant just as silently as a -1 limit) — negative
    # LITERALS stay legal (countdown ranges)
    if any(m._derives_dynamic(m._canon(i)) for i in ins):
        raise UnsupportedOpError(
            f"Range {node.name!r} bounds derived from a dynamic dim")
    try:  # static limits → constant (shape math stays static)
        start, limit, delta = (int(np.asarray(m.const(i))) for i in ins)
    except UnsupportedOpError:
        raise UnsupportedOpError(
            f"Range {node.name!r} with non-constant bounds (dynamic shapes "
            "are not XLA-traceable)")
    arr = np.arange(start, limit, delta,
                    dtype=_tf_dtype(node.attr["Tidx"].type))
    m.set(node.name, m.sd.constant(arr, name=node.name), const_val=arr)


# ---------------------------------------------------------------------------
# Round-3 rule tail: cumulative/scatter/segment/image ops common in real
# TF graphs (TFGraphMapper op coverage, path-cite).
# ---------------------------------------------------------------------------


@rule("Cumsum", "Cumprod")
def _tf_cumulative(m, node):
    x = m.get(m.inputs(node)[0])
    axis = int(m.const(m.inputs(node)[1]))
    if node.attr["exclusive"].b or node.attr["reverse"].b:
        raise UnsupportedOpError(f"{node.op} exclusive/reverse")
    opname = "cumsum" if node.op == "Cumsum" else "cumprod"
    m.set(node.name, m.sd._op(opname, [x], attrs=dict(axis=axis),
                              name=node.name))


@rule("ArgMin")
def _tf_argmin(m, node):
    x = m.get(m.inputs(node)[0])
    axis = int(m.const(m.inputs(node)[1]))
    m.set(node.name, m.sd._op("argmin", [x], attrs=dict(axis=axis),
                              name=node.name))


@rule("TopKV2")
def _tf_topk(m, node):
    x = m.get(m.inputs(node)[0])
    k = int(m.const(m.inputs(node)[1]))
    vals, idx = m.sd._op("top_k", [x], attrs=dict(k=k), n_out=2,
                         name=node.name)
    m.set(node.name, vals, slot=0)
    m.set(node.name, idx, slot=1)


@rule("ZerosLike")
def _tf_zeros_like(m, node):
    m.set(node.name, m.sd._op("zeros_like", [m.get(m.inputs(node)[0])],
                              name=node.name))


@rule("OnesLike")
def _tf_ones_like(m, node):
    m.set(node.name, m.sd._op("ones_like", [m.get(m.inputs(node)[0])],
                              name=node.name))


@rule("Rank", "Size")
def _tf_rank_size(m, node):
    src = m._canon(m.inputs(node)[0])
    shp = m.vars[src].shape
    if shp is None or any(s is None or s < 0 for s in shp):
        raise UnsupportedOpError(f"{node.op} of dynamically-shaped tensor")
    v = len(shp) if node.op == "Rank" else int(np.prod(shp))
    arr = np.asarray(v, np.int32)
    m.set(node.name, m.sd.constant(arr, name=node.name), const_val=arr)


@rule("BroadcastTo")
def _tf_broadcast_to(m, node):
    x = m.get(m.inputs(node)[0])
    shape = tuple(int(s) for s in m.const(m.inputs(node)[1]))
    m.set(node.name, m.sd._op("broadcast_to", [x], attrs=dict(shape=shape),
                              name=node.name))


@rule("InvertPermutation")
def _tf_invert_permutation(m, node):
    m.set(node.name, m.sd._op("invert_permutation",
                              [m.get(m.inputs(node)[0])], name=node.name))


@rule("MatrixBandPart")
def _tf_band_part(m, node):
    ins = m.inputs(node)
    x = m.get(ins[0])
    lo, hi = int(m.const(ins[1])), int(m.const(ins[2]))
    m.set(node.name, m.sd._op("matrix_band_part", [x],
                              attrs=dict(num_lower=lo, num_upper=hi),
                              name=node.name))


@rule("Bincount")
def _tf_bincount(m, node):
    ins = m.inputs(node)
    arr = m.get(ins[0])
    size = int(m.const(ins[1]))
    # TF DROPS values >= size (the registered op clamps into the last bin)
    # and rejects negatives (the op clamps them into bin 0): gate BOTH via
    # weights — out-of-range entries contribute 0. User weights (input 3,
    # empty tensor when unweighted) multiply in.
    in_range = m.sd._op("and", [
        m.sd._op("greaterequal", [arr, m.sd.constant(
            np.asarray(0, np.int32), name=f"{node.name}_zero")]),
        m.sd._op("less", [arr, m.sd.constant(
            np.asarray(size, np.int32), name=f"{node.name}_size")])])
    w = m.sd._op("cast", [in_range], attrs=dict(dtype=np.float32))
    unweighted = True
    if len(ins) > 2:
        wconst = m.const_vals.get(m._canon(ins[2]))
        if wconst is None or wconst.size:
            w = m.sd._op("multiply", [w, m.get(ins[2])])
            unweighted = False
    out = m.sd._op("bincount", [arr, w],
                   attrs=dict(minlength=size, maxlength=size))
    if unweighted:  # TF returns int32 counts when weights are empty
        out = m.sd._op("cast", [out], attrs=dict(dtype=np.int32))
    m.set(node.name, m.sd._op("identity", [out], name=node.name))


@rule("SegmentSum", "UnsortedSegmentSum")
def _tf_segment_sum(m, node):
    ins = m.inputs(node)
    data, ids = m.get(ins[0]), m.get(ins[1])
    if node.op == "UnsortedSegmentSum":
        n = int(m.const(ins[2]))
    else:
        # sorted SegmentSum carries no num_segments input: static ids only
        n = int(np.asarray(m.const(ins[1])).max()) + 1
    m.set(node.name, m.sd._op("segment_sum", [data, ids],
                              attrs=dict(num_segments=n), name=node.name))


@rule("TensorScatterUpdate")
def _tf_tensor_scatter(m, node):
    ins = [m.get(i) for i in m.inputs(node)]
    m.set(node.name, m.sd._op("tensor_scatter_update", ins, name=node.name))


@rule("ScatterNd")
def _tf_scatter_nd(m, node):
    ins = m.inputs(node)
    idx, upd = m.get(ins[0]), m.get(ins[1])
    shape = tuple(int(s) for s in m.const(ins[2]))
    m.set(node.name, m.sd._op("scatter_nd", [idx, upd],
                              attrs=dict(shape=shape), name=node.name))


@rule("GatherNd")
def _tf_gather_nd(m, node):
    ins = [m.get(i) for i in m.inputs(node)]
    m.set(node.name, m.sd._op("gather_nd", ins, name=node.name))


@rule("ReverseV2")
def _tf_reverse(m, node):
    x = m.get(m.inputs(node)[0])
    axes = tuple(int(a) for a in np.atleast_1d(m.const(m.inputs(node)[1])))
    m.set(node.name, m.sd._op("flip", [x], attrs=dict(axis=axes),
                              name=node.name))


@rule("ReverseSequence")
def _tf_reverse_sequence(m, node):
    ins = m.inputs(node)
    x, lens = m.get(ins[0]), m.get(ins[1])
    m.set(node.name, m.sd._op(
        "reverse_sequence", [x, lens],
        attrs=dict(seq_axis=int(node.attr["seq_dim"].i),
                   batch_axis=int(node.attr["batch_dim"].i)),
        name=node.name))


@rule("Roll")
def _tf_roll(m, node):
    ins = m.inputs(node)
    x = m.get(ins[0])
    shift = [int(s) for s in np.atleast_1d(m.const(ins[1]))]
    axis = [int(a) for a in np.atleast_1d(m.const(ins[2]))]
    m.set(node.name, m.sd._op(
        "roll", [x], attrs=dict(shift=tuple(shift) if len(shift) > 1
                                else shift[0],
                                axis=tuple(axis) if len(axis) > 1
                                else axis[0]),
        name=node.name))


@rule("LinSpace")
def _tf_linspace(m, node):
    ins = m.inputs(node)
    start = float(np.asarray(m.const(ins[0])))
    stop = float(np.asarray(m.const(ins[1])))
    num = int(m.const(ins[2]))
    arr = np.linspace(start, stop, num, dtype=np.float32)
    m.set(node.name, m.sd.constant(arr, name=node.name), const_val=arr)


@rule("DepthToSpace", "SpaceToDepth")
def _tf_depth_space(m, node):
    if not _nhwc(node):
        raise UnsupportedOpError(f"{node.op} NCHW")
    x = m.get(m.inputs(node)[0])
    bs = int(node.attr["block_size"].i)
    opname = ("depth_to_space" if node.op == "DepthToSpace"
              else "space_to_depth")
    m.set(node.name, m.sd._op(opname, [x], attrs=dict(block_size=bs),
                              name=node.name))


@rule("ExtractImagePatches")
def _tf_extract_patches(m, node):
    x = m.get(m.inputs(node)[0])
    ks = list(node.attr["ksizes"].list.i)
    st = list(node.attr["strides"].list.i)
    rates = list(node.attr["rates"].list.i)
    pad = node.attr["padding"].s.decode()
    m.set(node.name, m.sd._op(
        "extract_image_patches", [x],
        attrs=dict(ksizes=(ks[1], ks[2]), strides=(st[1], st[2]),
                   rates=(rates[1], rates[2]), padding=pad),
        name=node.name))


def _attr_or(node, name, kind, default):
    """Attr value honoring explicit zeros (0 and 0.0 are meaningful — no
    falsy-default collapse; see the FusedBatchNorm exponential_avg_factor
    review finding)."""
    if name not in node.attr:
        return default
    return getattr(node.attr[name], kind)


@rule("LRN")
def _tf_lrn(m, node):
    x = m.get(m.inputs(node)[0])
    m.set(node.name, m.sd._op(
        "lrn", [x],
        attrs=dict(depth_radius=int(_attr_or(node, "depth_radius", "i", 5)),
                   bias=float(_attr_or(node, "bias", "f", 1.0)),
                   alpha=float(_attr_or(node, "alpha", "f", 1.0)),
                   beta=float(_attr_or(node, "beta", "f", 0.5))),
        name=node.name))


@rule("LeakyRelu")
def _tf_leaky_relu(m, node):
    m.set(node.name, m.sd._op(
        "leakyrelu", [m.get(m.inputs(node)[0])],
        attrs=dict(alpha=float(_attr_or(node, "alpha", "f", 0.2))),
        name=node.name))


# ---------------------------------------------------------------- grad ops
# tf.gradients-exported TRAINING graphs (VERDICT r3 missing #2): TF emits
# explicit *Grad kernels; TFGraphMapper maps them (path-cite, mount empty).
# Each lowers to the matching registry grad op (ops/nn.py) — serializable,
# and the conv backprops compile to the same transposed-conv HLO XLA's own
# autodiff would emit.


@rule("ReluGrad")
def _relu_grad(m, node):
    ins = m.inputs(node)
    m.set(node.name, m.sd._op("relu_grad", [m.get(ins[0]), m.get(ins[1])],
                              name=node.name))


@rule("Relu6Grad")
def _relu6_grad(m, node):
    ins = m.inputs(node)
    m.set(node.name, m.sd._op("relu6_grad", [m.get(ins[0]), m.get(ins[1])],
                              name=node.name))


@rule("TanhGrad")
def _tanh_grad(m, node):
    ins = m.inputs(node)  # (y, dy)
    m.set(node.name, m.sd._op("tanh_grad", [m.get(ins[0]), m.get(ins[1])],
                              name=node.name))


@rule("SigmoidGrad")
def _sigmoid_grad(m, node):
    ins = m.inputs(node)  # (y, dy)
    m.set(node.name, m.sd._op("sigmoid_grad", [m.get(ins[0]), m.get(ins[1])],
                              name=node.name))


@rule("BiasAddGrad")
def _bias_add_grad(m, node):
    df = node.attr["data_format"].s.decode() if "data_format" in node.attr \
        else "NHWC"
    m.set(node.name, m.sd._op("bias_add_grad", [m.get(m.inputs(node)[0])],
                              attrs=dict(data_format=df), name=node.name))


def _conv_grad_attrs(m, node):
    nhwc = _nhwc(node)
    dil = list(node.attr["dilations"].list.i) or [1, 1, 1, 1]
    return nhwc, dict(
        strides=_strides_2d(node, nhwc),
        padding=node.attr["padding"].s.decode(),
        dilation=(dil[1], dil[2]) if nhwc else (dil[2], dil[3]))


@rule("Conv2DBackpropInput")
def _conv2d_backprop_input(m, node):
    ins = m.inputs(node)  # (input_sizes, filter, out_backprop)
    sizes = tuple(int(s) for s in m.const(ins[0], allow_dynamic=True))
    if any(s < 0 for s in sizes):
        raise UnsupportedOpError(
            "Conv2DBackpropInput with dynamic input_sizes")
    w, dy = m.get(ins[1]), m.get(ins[2])
    nhwc, attrs = _conv_grad_attrs(m, node)
    dy, back = _to_nhwc(m, node, dy)
    if not nhwc:  # sizes arrive in NCHW order; the op works in NHWC
        sizes = (sizes[0], sizes[2], sizes[3], sizes[1])
    y = m.sd._op("conv2d_backprop_input", [w, dy],
                 attrs=dict(input_sizes=sizes, **attrs), name=node.name)
    m.set(node.name, back(y))


@rule("Conv2DBackpropFilter")
def _conv2d_backprop_filter(m, node):
    ins = m.inputs(node)  # (input, filter_sizes, out_backprop)
    sizes = tuple(int(s) for s in m.const(ins[1]))
    x, dy = m.get(ins[0]), m.get(ins[2])
    nhwc, attrs = _conv_grad_attrs(m, node)
    x, _ = _to_nhwc(m, node, x)
    dy, _ = _to_nhwc(m, node, dy)
    m.set(node.name, m.sd._op(
        "conv2d_backprop_filter", [x, dy],
        attrs=dict(filter_sizes=sizes, **attrs), name=node.name))


def _pool_grad_dims(node, nhwc):
    k = list(node.attr["ksize"].list.i)
    s = list(node.attr["strides"].list.i)
    if nhwc:
        return (k[1], k[2]), (s[1], s[2])
    return (k[2], k[3]), (s[2], s[3])


@rule("MaxPoolGrad")
def _max_pool_grad(m, node):
    ins = m.inputs(node)  # (orig_input, orig_output, grad)
    x, dy = m.get(ins[0]), m.get(ins[2])
    nhwc = _nhwc(node)
    x, _ = _to_nhwc(m, node, x)
    dy, back = _to_nhwc(m, node, dy)
    kernel, strides = _pool_grad_dims(node, nhwc)
    y = m.sd._op("maxpool2d_grad", [x, dy], attrs=dict(
        kernel=kernel, strides=strides,
        padding=node.attr["padding"].s.decode()), name=node.name)
    m.set(node.name, back(y))


@rule("AvgPoolGrad")
def _avg_pool_grad(m, node):
    ins = m.inputs(node)  # (orig_input_shape, grad)
    sizes = tuple(int(s) for s in m.const(ins[0], allow_dynamic=True))
    if any(s < 0 for s in sizes):
        raise UnsupportedOpError("AvgPoolGrad with dynamic input shape")
    dy = m.get(ins[1])
    nhwc = _nhwc(node)
    dy, back = _to_nhwc(m, node, dy)
    if not nhwc:
        sizes = (sizes[0], sizes[2], sizes[3], sizes[1])
    kernel, strides = _pool_grad_dims(node, nhwc)
    zeros = m.sd.constant(np.zeros(sizes, np.float32),
                          name=f"{node.name}_xref")
    y = m.sd._op("avgpool2d_grad", [zeros, dy], attrs=dict(
        kernel=kernel, strides=strides,
        padding=node.attr["padding"].s.decode()), name=node.name)
    m.set(node.name, back(y))


@rule("FusedBatchNormGrad", "FusedBatchNormGradV2", "FusedBatchNormGradV3")
def _fused_bn_grad(m, node):
    ins = m.inputs(node)  # (dy, x, scale, reserve_1, reserve_2, [reserve_3])
    dy, x, scale, r1, r2 = (m.get(i) for i in ins[:5])
    dy, back = _to_nhwc(m, node, dy)
    x, _ = _to_nhwc(m, node, x)
    eps = float(node.attr["epsilon"].f)
    training = bool(node.attr["is_training"].b) \
        if "is_training" in node.attr else True
    dx, dscale, doffset = m.sd._op(
        "fused_batch_norm_grad", [dy, x, scale, r1, r2],
        attrs=dict(epsilon=eps, is_training=training), n_out=3,
        name=node.name)
    m.set(node.name, back(dx), slot=0)
    m.set(node.name, dscale, slot=1)
    m.set(node.name, doffset, slot=2)
    # reserve_space_4/5 outputs exist only to be unused
    m.set(node.name, dscale, slot=3)
    m.set(node.name, doffset, slot=4)


@rule("SoftmaxCrossEntropyWithLogits")
def _softmax_ce_grad(m, node):
    ins = m.inputs(node)  # (features, labels) → (loss, backprop)
    loss, backprop = m.sd._op(
        "softmax_cross_entropy_with_logits_grad",
        [m.get(ins[0]), m.get(ins[1])], n_out=2, name=node.name)
    m.set(node.name, loss, slot=0)
    m.set(node.name, backprop, slot=1)


@rule("ShapeN")
def _shape_n(m, node):
    for i, inp in enumerate(m.inputs(node)):
        src = m._canon(inp)
        v = m.vars[src]
        shp = m.sd._infer(v.name, "shape", mark_dynamic=True) \
            if v.vtype.name == "ARRAY" else v.shape
        if shp is None or any(s is None for s in shp):
            raise UnsupportedOpError("ShapeN of dynamically-shaped tensor")
        arr = np.asarray(shp, np.int32)
        cvar = m.sd.constant(arr, name=f"{node.name}_{i}")
        m.set(node.name, cvar, slot=i, const_val=arr)
        if (arr == -1).any():  # same dynamic-dim taint as the Shape rule
            m.dyn_vars.add(cvar.name)


@rule("DynamicStitch", "ParallelDynamicStitch")
def _dynamic_stitch(m, node):
    # appears in Mean/Prod gradient shape math; with static shapes all
    # operands are const — fold the stitch
    ins = m.inputs(node)
    n = len(ins) // 2
    idxs = [np.asarray(m.const(i)) for i in ins[:n]]
    datas = [np.asarray(m.const(i)) for i in ins[n:]]
    size = max(int(ix.max()) for ix in idxs if ix.size) + 1
    inner = datas[0].shape[idxs[0].ndim:]
    out = np.zeros((size,) + inner, datas[0].dtype)
    for ix, d in zip(idxs, datas):
        out[ix.reshape(-1)] = d.reshape((-1,) + inner)
    m.set(node.name, m.sd.constant(out, name=node.name), const_val=out)


def _strided_spec(m, node, begin, end, strides):
    masks = {k: int(node.attr[k].i) for k in
             ("begin_mask", "end_mask", "ellipsis_mask", "new_axis_mask",
              "shrink_axis_mask")}
    spec = []
    for d in range(len(begin)):
        if masks["ellipsis_mask"] & (1 << d):
            spec.append(("e",))
        elif masks["new_axis_mask"] & (1 << d):
            spec.append(("n",))
        elif masks["shrink_axis_mask"] & (1 << d):
            spec.append(("i", begin[d]))
        else:
            b = None if masks["begin_mask"] & (1 << d) else begin[d]
            e = None if masks["end_mask"] & (1 << d) else end[d]
            spec.append(("s", b, e, strides[d]))
    return tuple(spec)


@rule("StridedSliceGrad")
def _strided_slice_grad(m, node):
    ins = m.inputs(node)  # (shape, begin, end, strides, dy)
    shape = tuple(int(v) for v in m.const(ins[0], allow_dynamic=True))
    if any(s < 0 for s in shape):
        raise UnsupportedOpError("StridedSliceGrad with dynamic shape")
    begin = [int(v) for v in m.const(ins[1])]
    end = [int(v) for v in m.const(ins[2])]
    strides = [int(v) for v in m.const(ins[3])]
    dy = m.get(ins[4])
    spec = _strided_spec(m, node, begin, end, strides)
    m.set(node.name, m.sd._op(
        "strided_slice_grad", [dy],
        attrs=dict(shape=shape, spec=spec), name=node.name))


@rule("BlockLSTM", "BlockLSTMV2")
def _block_lstm(m, node):
    # fused whole-sequence LSTM kernel (tf.raw_ops.BlockLSTM; the
    # reference's lstmBlock op family — VERDICT r3 registry-tail item).
    # V2 has no forget_bias attr (folded into b by the exporter).
    ins = m.inputs(node)
    vs = [m.get(i) for i in ins]  # seq_len_max, x, cs_prev, h_prev, w,
    #                               wci, wcf, wco, b
    fb = float(node.attr["forget_bias"].f) if "forget_bias" in node.attr \
        and node.op == "BlockLSTM" else 0.0
    clip = float(node.attr["cell_clip"].f) if "cell_clip" in node.attr \
        else -1.0
    peep = bool(node.attr["use_peephole"].b) \
        if "use_peephole" in node.attr else False
    outs = m.sd._op("lstm_block", vs, attrs=dict(
        forget_bias=fb, cell_clip=clip, use_peephole=peep), n_out=7,
        name=node.name)
    for i, v in enumerate(outs):
        m.set(node.name, v, slot=i)


@rule("LSTMBlockCell")
def _lstm_block_cell(m, node):
    ins = m.inputs(node)  # x, cs_prev, h_prev, w, wci, wcf, wco, b
    vs = [m.get(i) for i in ins]
    fb = float(node.attr["forget_bias"].f) if "forget_bias" in node.attr \
        else 1.0
    clip = float(node.attr["cell_clip"].f) if "cell_clip" in node.attr \
        else -1.0
    peep = bool(node.attr["use_peephole"].b) \
        if "use_peephole" in node.attr else False
    outs = m.sd._op("lstm_block_cell", vs, attrs=dict(
        forget_bias=fb, cell_clip=clip, use_peephole=peep), n_out=7,
        name=node.name)
    for i, v in enumerate(outs):
        m.set(node.name, v, slot=i)


@rule("SparseSoftmaxCrossEntropyWithLogits")
def _sparse_softmax_ce_grad(m, node):
    # (features, int labels) → (loss, backprop); lower via onehot + the
    # dense kernel so both outputs stay a single fused pair
    ins = m.inputs(node)
    logits = m.get(ins[0])
    labels = m.get(ins[1])
    depth = logits.shape[-1] if logits.shape else None
    if depth is None or depth < 0:
        raise UnsupportedOpError(
            "SparseSoftmaxCrossEntropyWithLogits with unknown class count")
    onehot = m.sd._op("onehot", [labels], attrs=dict(
        depth=int(depth), on_value=1.0, off_value=0.0, axis=-1))
    loss, backprop = m.sd._op(
        "softmax_cross_entropy_with_logits_grad", [logits, onehot],
        n_out=2, name=node.name)
    m.set(node.name, loss, slot=0)
    m.set(node.name, backprop, slot=1)


# ---------------------------------------------------------------------------
# Round-5 rules: linalg tail, image tail, 3-D conv/pool, bitwise, FFT,
# fake-quant, random family, scatter tail, misc.
# ---------------------------------------------------------------------------

@rule("Betainc")
def _tf_betainc(m, node):
    a, b, x = (m.get(i) for i in m.inputs(node)[:3])
    m.set(node.name, m.sd._op("betainc", [a, b, x], name=node.name))


@rule("Polygamma")
def _tf_polygamma(m, node):
    n, x = (m.get(i) for i in m.inputs(node)[:2])
    m.set(node.name, m.sd._op("polygamma", [n, x], name=node.name))


@rule("Zeta")
def _tf_zeta(m, node):
    x, q = (m.get(i) for i in m.inputs(node)[:2])
    m.set(node.name, m.sd._op("zeta", [x, q], name=node.name))


@rule("SelfAdjointEigV2")
def _tf_eigh(m, node):
    if not _attr_or(node, "compute_v", "b", True):
        raise UnsupportedOpError("SelfAdjointEigV2 compute_v=False")
    e, v = m.sd._op("eigh", [m.get(m.inputs(node)[0])], n_out=2,
                    name=node.name)
    m.set(node.name, e, slot=0)
    m.set(node.name, v, slot=1)


@rule("Svd")
def _tf_svd(m, node):
    # TF output order (s, u, v) with v — not the vh our op returns
    if not _attr_or(node, "compute_uv", "b", True):
        s = m.sd._op("svd", [m.get(m.inputs(node)[0])],
                     attrs=dict(compute_uv=False), name=node.name)
        m.set(node.name, s, slot=0)
        return
    full = bool(_attr_or(node, "full_matrices", "b", False))
    u, s, vh = m.sd._op("svd", [m.get(m.inputs(node)[0])],
                        attrs=dict(full_matrices=full), n_out=3,
                        name=node.name)
    m.set(node.name, s, slot=0)
    m.set(node.name, u, slot=1)
    m.set(node.name, m.sd._op("swapaxes", [vh],
                              attrs=dict(axis1=-2, axis2=-1)), slot=2)


@rule("Qr")
def _tf_qr(m, node):
    if _attr_or(node, "full_matrices", "b", False):
        raise UnsupportedOpError("Qr full_matrices")
    q, r = m.sd._op("qr", [m.get(m.inputs(node)[0])], n_out=2,
                    name=node.name)
    m.set(node.name, q, slot=0)
    m.set(node.name, r, slot=1)


@rule("Cholesky")
def _tf_cholesky(m, node):
    m.set(node.name, m.sd._op("cholesky", [m.get(m.inputs(node)[0])],
                              name=node.name))


@rule("MatrixInverse")
def _tf_matrix_inverse(m, node):
    if _attr_or(node, "adjoint", "b", False):
        raise UnsupportedOpError("MatrixInverse adjoint")
    m.set(node.name, m.sd._op("matrix_inverse",
                              [m.get(m.inputs(node)[0])], name=node.name))


@rule("MatrixSolve")
def _tf_matrix_solve(m, node):
    if _attr_or(node, "adjoint", "b", False):
        raise UnsupportedOpError("MatrixSolve adjoint")
    a, b = (m.get(i) for i in m.inputs(node)[:2])
    m.set(node.name, m.sd._op("solve", [a, b], name=node.name))


@rule("MatrixTriangularSolve")
def _tf_tri_solve(m, node):
    if _attr_or(node, "adjoint", "b", False):
        raise UnsupportedOpError("MatrixTriangularSolve adjoint")
    a, b = (m.get(i) for i in m.inputs(node)[:2])
    m.set(node.name, m.sd._op(
        "triangular_solve", [a, b],
        attrs=dict(lower=bool(_attr_or(node, "lower", "b", True))),
        name=node.name))


@rule("Lu")
def _tf_lu(m, node):
    lu_p, _, perm = m.sd._op("lu", [m.get(m.inputs(node)[0])], n_out=3,
                             name=node.name)
    m.set(node.name, lu_p, slot=0)
    m.set(node.name, perm, slot=1)


@rule("Cross")
def _tf_cross(m, node):
    a, b = (m.get(i) for i in m.inputs(node)[:2])
    m.set(node.name, m.sd._op("cross", [a, b], name=node.name))


@rule("Diag")
def _tf_diag(m, node):
    # TF Diag of a rank-1 input = matrix_diag; higher ranks unsupported
    x = m.get(m.inputs(node)[0])
    if x.shape is not None and len(x.shape) != 1:
        raise UnsupportedOpError("Diag of rank > 1")
    m.set(node.name, m.sd._op("matrix_diag", [x], name=node.name))


@rule("DiagPart", "MatrixDiagPartV3")
def _tf_diag_part(m, node):
    x = m.get(m.inputs(node)[0])
    if node.op == "MatrixDiagPartV3":
        k = m.const(m.inputs(node)[1])
        if np.any(np.asarray(k) != 0):
            raise UnsupportedOpError("MatrixDiagPartV3 k != 0")
    elif x.shape is not None and len(x.shape) != 2:
        # TF DiagPart is rank-2k -> rank-k (out[i,j] = in[i,j,i,j]);
        # matrix_diag_part only coincides at rank 2
        raise UnsupportedOpError("DiagPart of rank != 2")
    m.set(node.name, m.sd._op("matrix_diag_part", [x], name=node.name))


@rule("MatrixDiagV3")
def _tf_matrix_diag_v3(m, node):
    ins = m.inputs(node)
    k = m.const(ins[1])
    if np.any(np.asarray(k) != 0):
        raise UnsupportedOpError("MatrixDiagV3 k != 0")
    # inputs 2-4 (num_rows, num_cols, padding_value) shape the output: the
    # lowering only implements the square/default form, so non-default
    # values must fail loudly instead of yielding a silently wrong square
    # matrix (ADVICE r5 #4)
    for idx, name, default in ((2, "num_rows", -1), (3, "num_cols", -1)):
        if len(ins) > idx:
            v = np.asarray(m.const(ins[idx]))
            if np.any(v != default):
                raise UnsupportedOpError(
                    f"MatrixDiagV3 {name}={v.tolist()} (only the default "
                    f"{default} square form is supported)")
    if len(ins) > 4:
        pv = np.asarray(m.const(ins[4]))
        if np.any(pv != 0):
            raise UnsupportedOpError(
                f"MatrixDiagV3 padding_value={pv.tolist()} (only 0 "
                "is supported)")
    m.set(node.name, m.sd._op("matrix_diag", [m.get(ins[0])],
                              name=node.name))


@rule("MatrixSetDiagV3")
def _tf_matrix_set_diag(m, node):
    k = m.const(m.inputs(node)[2])
    if np.any(np.asarray(k) != 0):
        raise UnsupportedOpError("MatrixSetDiagV3 k != 0")
    x, d = (m.get(i) for i in m.inputs(node)[:2])
    m.set(node.name, m.sd._op("matrix_set_diag", [x, d], name=node.name))


@rule("Trace")
def _tf_trace(m, node):
    m.set(node.name, m.sd._op("trace", [m.get(m.inputs(node)[0])],
                              name=node.name))


@rule("L2Loss")
def _tf_l2_loss(m, node):
    m.set(node.name, m.sd._op("l2_loss", [m.get(m.inputs(node)[0])],
                              name=node.name))


@rule("InTopKV2")
def _tf_in_top_k(m, node):
    preds, targets = (m.get(i) for i in m.inputs(node)[:2])
    k = int(m.const(m.inputs(node)[2]))
    m.set(node.name, m.sd._op("in_top_k", [preds, targets],
                              attrs=dict(k=k), name=node.name))


@rule("HistogramFixedWidth")
def _tf_histogram(m, node):
    x = m.get(m.inputs(node)[0])
    vr = [float(v) for v in m.const(m.inputs(node)[1])]
    nbins = int(m.const(m.inputs(node)[2]))
    m.set(node.name, m.sd._op(
        "histogram_fixed_width", [x],
        attrs=dict(value_range=tuple(vr), nbins=nbins), name=node.name))


@rule("SegmentMax", "SegmentMin", "SegmentProd")
def _tf_segment_extra(m, node):
    data, seg = (m.get(i) for i in m.inputs(node)[:2])
    seg_val = m.const(m.inputs(node)[1])
    ns = int(np.asarray(seg_val).max()) + 1
    opn = {"SegmentMax": "segment_max", "SegmentMin": "segment_min",
           "SegmentProd": "segment_prod"}[node.op]
    attrs = dict(num_segments=ns)
    if node.op in ("SegmentMax", "SegmentMin"):
        # SORTED SegmentMax/Min document a 0 fill for empty segments; the
        # unsorted kernels these lower to fill with dtype ±lowest/highest
        # instead (ADVICE r5 #5). SegmentProd's identity fill (1) already
        # matches TF.
        attrs["empty_fill"] = 0
    m.set(node.name, m.sd._op(opn, [data, seg], attrs=attrs, name=node.name))


@rule("TensorScatterAdd")
def _tf_tensor_scatter_add(m, node):
    t, idx, upd = (m.get(i) for i in m.inputs(node)[:3])
    m.set(node.name, m.sd._op("scatter_nd_add", [t, idx, upd],
                              name=node.name))


@rule("Bitcast")
def _tf_bitcast(m, node):
    dt = _tf_dtype(node.attr["type"].type)
    m.set(node.name, m.sd._op("bitcast", [m.get(m.inputs(node)[0])],
                              attrs=dict(dtype=dt), name=node.name))


@rule("BroadcastArgs")
def _tf_broadcast_args(m, node):
    a = m.const(m.inputs(node)[0])
    b = m.const(m.inputs(node)[1])
    out = np.broadcast_shapes(tuple(int(v) for v in a),
                              tuple(int(v) for v in b))
    arr = np.asarray(out, np.int32)
    m.set(node.name, m.sd.constant(arr, name=node.name), const_val=arr)


@rule("DataFormatVecPermute")
def _tf_df_vec_permute(m, node):
    src = _attr_or(node, "src_format", "s", b"NHWC").decode()
    dst = _attr_or(node, "dst_format", "s", b"NCHW").decode()
    val = np.asarray(m.const(m.inputs(node)[0]))
    if val.shape[0] == 2:
        # TF size-2 form: spatial dims only — strip N and C from formats
        src = "".join(c for c in src if c not in "NC")
        dst = "".join(c for c in dst if c not in "NC")
    perm = [src.index(c) for c in dst]
    out = val[perm]
    m.set(node.name, m.sd.constant(out, name=node.name), const_val=out)


@rule("EnsureShape")
def _tf_ensure_shape(m, node):
    # static shapes by construction: verify now, then identity
    x = m.get(m.inputs(node)[0])
    want = tuple(d.size for d in node.attr["shape"].shape.dim) \
        if "shape" in node.attr else None
    if want is not None and x.shape is not None:
        for got, exp in zip(x.shape, want):
            if exp >= 0 and got is not None and got >= 0 and got != exp:
                raise UnsupportedOpError(
                    f"EnsureShape mismatch: {x.shape} vs {want}")
    m.set(node.name, m.sd._op("identity", [x], name=node.name))


# -- image tail --------------------------------------------------------------

@rule("RGBToHSV")
def _tf_rgb_to_hsv(m, node):
    m.set(node.name, m.sd._op("rgb_to_hsv", [m.get(m.inputs(node)[0])],
                              name=node.name))


@rule("HSVToRGB")
def _tf_hsv_to_rgb(m, node):
    m.set(node.name, m.sd._op("hsv_to_rgb", [m.get(m.inputs(node)[0])],
                              name=node.name))


@rule("AdjustHue")
def _tf_adjust_hue(m, node):
    x = m.get(m.inputs(node)[0])
    delta = float(m.const(m.inputs(node)[1]))
    m.set(node.name, m.sd._op("adjust_hue", [x], attrs=dict(delta=delta),
                              name=node.name))


@rule("AdjustSaturation")
def _tf_adjust_saturation(m, node):
    x = m.get(m.inputs(node)[0])
    factor = float(m.const(m.inputs(node)[1]))
    m.set(node.name, m.sd._op("adjust_saturation", [x],
                              attrs=dict(factor=factor), name=node.name))


@rule("AdjustContrastv2")
def _tf_adjust_contrast(m, node):
    x = m.get(m.inputs(node)[0])
    factor = float(m.const(m.inputs(node)[1]))
    m.set(node.name, m.sd._op("adjust_contrast", [x],
                              attrs=dict(factor=factor), name=node.name))


@rule("CropAndResize")
def _tf_crop_and_resize(m, node):
    img, boxes, bidx = (m.get(i) for i in m.inputs(node)[:3])
    crop_size = tuple(int(v) for v in m.const(m.inputs(node)[3]))
    method = _attr_or(node, "method", "s", b"bilinear").decode()
    if float(_attr_or(node, "extrapolation_value", "f", 0.0)) != 0.0:
        raise UnsupportedOpError("CropAndResize extrapolation_value != 0")
    m.set(node.name, m.sd._op(
        "crop_and_resize", [img, boxes, bidx],
        attrs=dict(crop_size=crop_size, method=method), name=node.name))


@rule("Dilation2D")
def _tf_dilation2d(m, node):
    x, f = (m.get(i) for i in m.inputs(node)[:2])
    strides = list(node.attr["strides"].list.i)
    rates = list(node.attr["rates"].list.i)
    padding = node.attr["padding"].s.decode()
    m.set(node.name, m.sd._op(
        "dilation2d", [x, f],
        attrs=dict(strides=(strides[1], strides[2]),
                   rates=(rates[1], rates[2]), padding=padding),
        name=node.name))


@rule("NonMaxSuppressionV3", "NonMaxSuppressionV4", "NonMaxSuppressionV5")
def _tf_nms(m, node):
    ins = m.inputs(node)
    boxes, scores = m.get(ins[0]), m.get(ins[1])
    max_out = int(m.const(ins[2]))
    iou = float(m.const(ins[3]))
    score_th = float(m.const(ins[4])) if len(ins) > 4 else float("-inf")
    if node.op == "NonMaxSuppressionV5" and len(ins) > 5 \
            and float(m.const(ins[5])) != 0.0:
        raise UnsupportedOpError("soft-NMS sigma != 0")
    if node.op == "NonMaxSuppressionV4" \
            and _attr_or(node, "pad_to_max_output_size", "b", False):
        raise UnsupportedOpError("NMS pad_to_max_output_size")
    sel = m.sd._op("non_max_suppression", [boxes, scores],
                   attrs=dict(max_output_size=max_out, iou_threshold=iou,
                              score_threshold=score_th), name=node.name)
    m.set(node.name, sel, slot=0)
    # valid_outputs = count of non-pad entries (our op pads with -1);
    # V4 emits it at slot 1, V5 at slot 2 (after selected_scores)
    valid = m.sd._op("cast", [m.sd._op("sum", [m.sd._op("cast", [
        m.sd._op("greaterequal", [sel, 0])], attrs=dict(dtype=np.int32))])],
        attrs=dict(dtype=np.int32))
    if node.op == "NonMaxSuppressionV4":
        m.set(node.name, valid, slot=1)
    elif node.op == "NonMaxSuppressionV5":
        m.set(node.name, m.sd._op("gather", [scores, sel],
                                  attrs=dict(axis=0)), slot=1)
        m.set(node.name, valid, slot=2)


# -- 3-D conv/pool (NDHWC — TF's native 3-D layout) --------------------------

@rule("Conv3D")
def _tf_conv3d(m, node):
    df = _attr_or(node, "data_format", "s", b"NDHWC").decode()
    if df != "NDHWC":
        raise UnsupportedOpError(f"Conv3D data_format {df}")
    x, w = (m.get(i) for i in m.inputs(node)[:2])
    strides = list(node.attr["strides"].list.i)
    padding = node.attr["padding"].s.decode()
    dil = list(node.attr["dilations"].list.i) if "dilations" in node.attr \
        else [1] * 5
    m.set(node.name, m.sd._op(
        "conv3d", [x, w],
        attrs=dict(strides=tuple(strides[1:4]), padding=padding,
                   dilation=tuple(dil[1:4])),
        name=node.name))


@rule("MaxPool3D", "AvgPool3D")
def _tf_pool3d(m, node):
    df = _attr_or(node, "data_format", "s", b"NDHWC").decode()
    if df != "NDHWC":
        raise UnsupportedOpError(f"{node.op} data_format {df}")
    x = m.get(m.inputs(node)[0])
    ksize = list(node.attr["ksize"].list.i)
    strides = list(node.attr["strides"].list.i)
    padding = node.attr["padding"].s.decode()
    opn = "maxpool3d" if node.op == "MaxPool3D" else "avgpool3d"
    m.set(node.name, m.sd._op(
        opn, [x], attrs=dict(kernel=tuple(ksize[1:4]),
                             strides=tuple(strides[1:4]),
                             padding=padding), name=node.name))


# -- bitwise -----------------------------------------------------------------

@rule("LeftShift")
def _tf_left_shift(m, node):
    a, b = (m.get(i) for i in m.inputs(node)[:2])
    m.set(node.name, m.sd._op("shift_left", [a, b], name=node.name))


@rule("RightShift")
def _tf_right_shift(m, node):
    a, b = (m.get(i) for i in m.inputs(node)[:2])
    m.set(node.name, m.sd._op("shift_right", [a, b], name=node.name))


@rule("Invert")
def _tf_invert(m, node):
    m.set(node.name, m.sd._op("toggle_bits", [m.get(m.inputs(node)[0])],
                              name=node.name))


@rule("PopulationCount")
def _tf_popcount(m, node):
    # TF outputs uint8; int32 here feeds the same consumers (Cast follows)
    m.set(node.name, m.sd._op("popcount", [m.get(m.inputs(node)[0])],
                              name=node.name))


# -- FFT (TF complex tensors are native complex64 in JAX) --------------------

@rule("FFT", "IFFT", "RFFT", "IRFFT")
def _tf_fft(m, node):
    x = m.get(m.inputs(node)[0])
    opn = {"FFT": "fft", "IFFT": "ifft", "RFFT": "rfft",
           "IRFFT": "irfft"}[node.op]
    attrs = dict(axis=-1)
    if node.op in ("RFFT", "IRFFT"):
        fft_length = int(np.asarray(m.const(m.inputs(node)[1])).reshape(-1)[0])
        attrs["n"] = fft_length
    m.set(node.name, m.sd._op(opn, [x], attrs=attrs, name=node.name))


# -- fake quantization -------------------------------------------------------

@rule("FakeQuantWithMinMaxArgs")
def _tf_fake_quant_args(m, node):
    x = m.get(m.inputs(node)[0])
    m.set(node.name, m.sd._op(
        "fake_quant_with_min_max_vars", [x],
        attrs=dict(min=float(_attr_or(node, "min", "f", -6.0)),
                   max=float(_attr_or(node, "max", "f", 6.0)),
                   num_bits=int(_attr_or(node, "num_bits", "i", 8)),
                   narrow_range=bool(_attr_or(node, "narrow_range", "b",
                                              False))),
        name=node.name))


@rule("FakeQuantWithMinMaxVars", "FakeQuantWithMinMaxVarsPerChannel")
def _tf_fake_quant_vars(m, node):
    # min/max are tensors (constants in frozen graphs) — pass them as graph
    # INPUTS, not attrs: arrays in attrs would break save/load
    x, mn, mx = (m.get(i) for i in m.inputs(node)[:3])
    opn = "fake_quant_with_min_max_vars" if node.op.endswith("Vars") \
        else "fake_quant_with_min_max_vars_per_channel"
    m.set(node.name, m.sd._op(
        opn, [x, mn, mx],
        attrs=dict(num_bits=int(_attr_or(node, "num_bits", "i", 8)),
                   narrow_range=bool(_attr_or(node, "narrow_range", "b",
                                              False))),
        name=node.name))


# -- random family -----------------------------------------------------------

def _tf_seed_key(m, node, tag):
    import zlib

    s1 = int(_attr_or(node, "seed", "i", 0))
    s2 = int(_attr_or(node, "seed2", "i", 0))
    mix = zlib.crc32(f"{tag}:{node.name}".encode()) & 0x7FFFFFFF
    key = prng_key((s1 * 2654435761 + s2) % (2**31) ^ mix)
    return m.sd.constant(key, name=f"{node.name}__key")


@rule("RandomStandardNormal", "RandomUniform")
def _tf_random(m, node):
    shape = tuple(int(v) for v in m.const(m.inputs(node)[0]))
    dt = _tf_dtype(node.attr["dtype"].type)
    key = _tf_seed_key(m, node, node.op)
    opn = "random_normal" if node.op == "RandomStandardNormal" \
        else "random_uniform"
    m.set(node.name, m.sd._op(opn, [key],
                              attrs=dict(shape=shape, dtype=dt),
                              name=node.name))


def _stateless_emit(m, node, shape, seed):
    """Shared stateless-random lowering: seed vector -> PRNGKey constant ->
    registry random op (one recipe for V1/V2 — keep them in lockstep)."""
    seed = np.asarray(seed).reshape(-1)
    key = m.sd.constant(
        prng_key(int(seed[0]) % (2**31) ^ (int(seed[-1]) % (2**31))),
        name=f"{node.name}__key")
    dt = _tf_dtype(node.attr["dtype"].type)
    opn = "random_normal" if "Normal" in node.op else "random_uniform"
    m.set(node.name, m.sd._op(opn, [key],
                              attrs=dict(shape=shape, dtype=dt),
                              name=node.name))


@rule("StatelessRandomNormal", "StatelessRandomUniform")
def _tf_stateless_random(m, node):
    shape = tuple(int(v) for v in m.const(m.inputs(node)[0]))
    _stateless_emit(m, node, shape, m.const(m.inputs(node)[1]))


@rule("Multinomial")
def _tf_multinomial(m, node):
    logits = m.get(m.inputs(node)[0])
    num = int(m.const(m.inputs(node)[1]))
    key = _tf_seed_key(m, node, "multinomial")
    samples = m.sd._op("random_categorical", [key, logits],
                       attrs=dict(num_samples=num))
    dt = _tf_dtype(node.attr["output_dtype"].type) \
        if "output_dtype" in node.attr else np.int64
    m.set(node.name, m.sd._op("cast", [samples],
                              attrs=dict(dtype=dt), name=node.name))


@rule("UniqueV2")
def _tf_unique_v2(m, node):
    # output length is data-dependent: const-fold only (XLA-static rule)
    val = np.asarray(m.const(m.inputs(node)[0]))
    axis = np.asarray(m.const(m.inputs(node)[1])).reshape(-1)
    if axis.size and int(axis[0]) != 0:
        raise UnsupportedOpError("UniqueV2 axis != 0")
    # axis=0 keeps unique SLICES for rank>1 (TF semantics) — plain
    # np.unique would silently flatten
    uniq, first_idx, inverse = np.unique(val, axis=0, return_index=True,
                                         return_inverse=True)
    inverse = inverse.reshape(-1)
    order = np.argsort(first_idx, kind="stable")
    remap = np.empty_like(order)
    remap[order] = np.arange(order.size)
    uniq = uniq[order]
    inverse = remap[inverse]
    m.set(node.name, m.sd.constant(uniq, name=node.name), slot=0,
          const_val=uniq)
    inv = inverse.astype(np.int32)
    m.set(node.name, m.sd.constant(inv, name=f"{node.name}_idx"), slot=1,
          const_val=inv)


@rule("SparseTensorDenseMatMul")
def _tf_sparse_dense_matmul(m, node):
    if _attr_or(node, "adjoint_a", "b", False) \
            or _attr_or(node, "adjoint_b", "b", False):
        raise UnsupportedOpError("SparseTensorDenseMatMul adjoint")
    ins = m.inputs(node)
    a_idx, a_vals = m.get(ins[0]), m.get(ins[1])
    a_shape = tuple(int(v) for v in m.const(ins[2]))
    b = m.get(ins[3])
    dense_a = m.sd._op("scatter_nd", [a_idx, a_vals],
                       attrs=dict(shape=a_shape))
    m.set(node.name, m.sd._op("matmul", [dense_a, b], name=node.name))


@rule("StatelessRandomGetKeyCounter", "StatelessRandomGetAlg")
def _tf_stateless_key_counter(m, node):
    # V2 stateless-random plumbing: fold the seed through — the V2 sampling
    # rule below derives its PRNGKey from this folded value
    if node.op == "StatelessRandomGetAlg":
        alg = np.asarray(1, np.int32)
        m.set(node.name, m.sd.constant(alg, name=node.name), const_val=alg)
        return
    seed = np.asarray(m.const(m.inputs(node)[0])).reshape(-1)
    key = seed.astype(np.int64)
    counter = np.zeros(2, np.int64)
    m.set(node.name, m.sd.constant(key, name=node.name), slot=0,
          const_val=key)
    m.set(node.name, m.sd.constant(counter, name=f"{node.name}_ctr"),
          slot=1, const_val=counter)


@rule("StatelessRandomNormalV2", "StatelessRandomUniformV2")
def _tf_stateless_random_v2(m, node):
    shape = tuple(int(v) for v in m.const(m.inputs(node)[0]))
    # input 1 is the folded key from StatelessRandomGetKeyCounter (the
    # original user seed, passed through by that rule)
    _stateless_emit(m, node, shape, m.const(m.inputs(node)[1]))
