"""TF's GraphDef messages on the ``protomini`` codec (no counterpart in the
reference, which decodes with ``tf.compat.v1.GraphDef``,
``tf.make_ndarray``, ``tf.dtypes.as_dtype`` and
``function_def_to_graph_def``: ``tf_import.py:132-152``, ``:199-201``,
``:1066-1069``).

The classes are read-only views of the decoded messages with the field
names of TF's ``.proto`` files (``graph.proto``, ``node_def.proto``,
``attr_value.proto``, ``tensor.proto``, ``tensor_shape.proto``,
``function.proto``, ``op_def.proto``), so the import rules read a node as
they read TF's: ``node.attr["x"].b / .i / .f / .s / .type / .shape /
.tensor / .list / .func``, ``HasField``, ``"x" in node.attr``. As in
protobuf, reading a missing map key gives the default message (and adds
it).

:func:`make_ndarray` decodes a TensorProto: ``tensor_content`` by
``np.frombuffer`` on a view of the graph's bytes (one copy, into the
array), or the typed ``*_val`` fields, a single value broadcast to the
shape. :func:`function_def_to_graph_def` flattens a FunctionDef's
``node:out_arg:idx`` tensor names to ``node:slot`` as TF's does, from the
output-argument table of the op types the importer knows (:data:`OUTPUT_ARGS`).

The encoder half (``enc_*``) writes GraphDefs from numpy arrays
(``graph_cases.py``, the tests).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.imports import protomini as pm

# DataType enum (types.proto) -> numpy; bfloat16 has no numpy type
DT_NUMPY = {1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8,
            5: np.int16, 6: np.int8, 7: np.object_, 8: np.complex64,
            9: np.int64, 10: np.bool_, 11: np.int8, 12: np.uint8,
            13: np.int32, 15: np.int16, 16: np.uint16, 17: np.uint16,
            18: np.complex128, 19: np.float16, 22: np.uint32,
            23: np.uint64}
NUMPY_DT = {np.dtype(np.float32): 1, np.dtype(np.float64): 2,
            np.dtype(np.int32): 3, np.dtype(np.uint8): 4,
            np.dtype(np.int16): 5, np.dtype(np.int8): 6,
            np.dtype(np.complex64): 8, np.dtype(np.int64): 9,
            np.dtype(np.bool_): 10, np.dtype(np.uint16): 17,
            np.dtype(np.complex128): 18, np.dtype(np.float16): 19,
            np.dtype(np.uint32): 22, np.dtype(np.uint64): 23}


def numpy_dtype(dt: int) -> np.dtype:
    """``tf.dtypes.as_dtype(dt).as_numpy_dtype`` (reference types too)."""
    dt = int(dt)
    if dt > 100:
        dt -= 100
    if dt not in DT_NUMPY:
        raise TypeError(f"TF DataType {dt} has no numpy type here")
    return np.dtype(DT_NUMPY[dt])


class _Map(dict):
    """A proto map: a missing key reads as (and becomes) its default."""

    def __init__(self, default_type, items=()):
        super().__init__(items)
        self._default_type = default_type

    def __missing__(self, key):
        v = self[key] = self._default_type()
        return v


def _map_entries(fields, num, value_type) -> List[Tuple[str, object]]:
    out = []
    for buf in pm.get_messages(fields, num):
        f = pm.decode(buf)
        key = pm.get_str(f, 1)
        vb = pm.get_bytes(f, 2, None)
        out.append((key, value_type(vb) if value_type is not str
                    else (bytes(vb).decode() if vb is not None else "")))
    return out


class _Message:
    _has: frozenset = frozenset()

    def HasField(self, name: str) -> bool:
        return name in self._has


class TensorShapeProto(_Message):
    class Dim:
        def __init__(self, size=0, name=""):
            self.size = size
            self.name = name

    def __init__(self, buf=None):
        self.dim: List[TensorShapeProto.Dim] = []
        self.unknown_rank = False
        if buf is None:
            return
        f = pm.decode(buf)
        for db in pm.get_messages(f, 2):
            df = pm.decode(db)
            self.dim.append(TensorShapeProto.Dim(pm.get_int(df, 1),
                                                 pm.get_str(df, 2)))
        self.unknown_rank = bool(pm.get_int(f, 3))


class TensorProto(_Message):
    def __init__(self, buf=None):
        self.dtype = 0
        self.tensor_shape = TensorShapeProto()
        self._fields: Dict[int, list] = {}
        if buf is None:
            return
        f = self._fields = pm.decode(buf)
        self.dtype = pm.get_int(f, 1)
        sb = pm.get_bytes(f, 2, None)
        if sb is not None:
            self.tensor_shape = TensorShapeProto(sb)

    @property
    def tensor_content(self):
        return pm.get_bytes(self._fields, 4)


def make_ndarray(t: TensorProto) -> np.ndarray:
    """``tf.make_ndarray``: the tensor's value as a numpy array."""
    shape = tuple(int(d.size) for d in t.tensor_shape.dim)
    dt = int(t.dtype)
    if dt in (14, 114):
        raise TypeError("bfloat16 tensors have no numpy type here")
    npdt = numpy_dtype(dt)
    n = int(np.prod(shape)) if shape else 1
    f = t._fields
    raw = pm.get_bytes(f, 4, None)
    if raw is not None and npdt != np.object_:
        arr = np.frombuffer(raw, dtype=npdt).copy()
        return arr.reshape(shape)
    if npdt == np.object_:  # DT_STRING: string_val
        vals = [bytes(v) for wt, v in f.get(8, []) if wt == 2]
    elif npdt == np.float32:
        vals = pm.get_floats(f, 5)
    elif npdt == np.float64:
        vals = pm.get_doubles(f, 6)
    elif npdt == np.float16:  # half_val holds the 16 bits in an int32
        vals = np.asarray(pm.get_ints(f, 13), np.uint16).view(np.float16)
    elif npdt == np.int64:
        vals = pm.get_ints(f, 10)
    elif npdt == np.bool_:
        vals = pm.get_ints(f, 11)
    elif npdt == np.uint32:
        vals = pm.get_ints(f, 16)
    elif npdt == np.uint64:
        vals = [v & 0xFFFFFFFFFFFFFFFF for v in pm.get_ints(f, 17)]
    elif npdt in (np.complex64, np.complex128):
        fl = pm.get_floats(f, 9) if npdt == np.complex64 \
            else pm.get_doubles(f, 12)
        vals = np.asarray(fl[0::2]) + 1j * np.asarray(fl[1::2])
    else:  # int32, int16, int8, uint8, uint16 and the quantized types
        vals = pm.get_ints(f, 7)
    arr = np.asarray(vals, dtype=npdt)
    if arr.size == n:
        return arr.reshape(shape)
    if arr.size == 0:
        return np.zeros(shape, npdt)
    # TF stores a repeated trailing value once: pad with the last value
    out = np.empty(n, npdt)
    out[:arr.size] = arr
    out[arr.size:] = arr[-1]
    return out.reshape(shape)


class NameAttrList(_Message):
    def __init__(self, buf=None):
        self.name = ""
        self.attr = _Map(AttrValue)
        if buf is None:
            return
        f = pm.decode(buf)
        self.name = pm.get_str(f, 1)
        self.attr = _Map(AttrValue, _map_entries(f, 2, AttrValue))


class ListValue(_Message):
    def __init__(self, buf=None):
        self.s: List[bytes] = []
        self.i: List[int] = []
        self.f: List[float] = []
        self.b: List[bool] = []
        self.type: List[int] = []
        self.shape: List[TensorShapeProto] = []
        self.tensor: List[TensorProto] = []
        self.func: List[NameAttrList] = []
        if buf is None:
            return
        f = pm.decode(buf)
        self.s = [bytes(v) for wt, v in f.get(2, []) if wt == 2]
        self.i = pm.get_ints(f, 3)
        self.f = pm.get_floats(f, 4)
        self.b = [bool(v) for v in pm.get_ints(f, 5)]
        self.type = pm.get_ints(f, 6)
        self.shape = [TensorShapeProto(b) for b in pm.get_messages(f, 7)]
        self.tensor = [TensorProto(b) for b in pm.get_messages(f, 8)]
        self.func = [NameAttrList(b) for b in pm.get_messages(f, 9)]


class AttrValue(_Message):
    """One attr value; ``WhichOneof("value")`` names the field it holds."""

    _ONEOF = {2: "s", 3: "i", 4: "f", 5: "b", 6: "type", 7: "shape",
              8: "tensor", 1: "list", 10: "func", 9: "placeholder"}

    def __init__(self, buf=None):
        self._f: Dict[int, list] = pm.decode(buf) if buf is not None else {}
        self._which = next((self._ONEOF[k] for k in self._ONEOF
                            if k in self._f), None)
        self._has = frozenset(self._ONEOF[k] for k in self._ONEOF
                              if k in self._f)
        self._cache: Dict[str, object] = {}

    def WhichOneof(self, name):
        return self._which

    @property
    def s(self) -> bytes:
        return bytes(pm.get_bytes(self._f, 2))

    @property
    def i(self) -> int:
        return pm.get_int(self._f, 3)

    @property
    def f(self) -> float:
        return pm.get_float(self._f, 4)

    @property
    def b(self) -> bool:
        return bool(pm.get_int(self._f, 5))

    @property
    def type(self) -> int:
        return pm.get_int(self._f, 6)

    def _sub(self, key, num, cls):
        if key not in self._cache:
            b = pm.get_bytes(self._f, num, None)
            self._cache[key] = cls(b)
        return self._cache[key]

    @property
    def shape(self) -> TensorShapeProto:
        return self._sub("shape", 7, TensorShapeProto)

    @property
    def tensor(self) -> TensorProto:
        return self._sub("tensor", 8, TensorProto)

    @property
    def list(self) -> ListValue:
        return self._sub("list", 1, ListValue)

    @property
    def func(self) -> NameAttrList:
        return self._sub("func", 10, NameAttrList)


class NodeDef(_Message):
    def __init__(self, buf=None, *, name="", op="", input=(), attr=None):
        self.name, self.op = name, op
        self.input: List[str] = list(input)
        self.device = ""
        self.attr = _Map(AttrValue, (attr or {}).items())
        if buf is None:
            return
        f = pm.decode(buf)
        self.name = pm.get_str(f, 1)
        self.op = pm.get_str(f, 2)
        self.input = pm.get_strs(f, 3)
        self.device = pm.get_str(f, 4)
        self.attr = _Map(AttrValue, _map_entries(f, 5, AttrValue))


class ArgDef(_Message):
    def __init__(self, buf=None):
        self.name = ""
        self.type = 0
        self.type_attr = self.number_attr = self.type_list_attr = ""
        if buf is None:
            return
        f = pm.decode(buf)
        self.name = pm.get_str(f, 1)
        self.type = pm.get_int(f, 3)
        self.type_attr = pm.get_str(f, 4)
        self.number_attr = pm.get_str(f, 5)
        self.type_list_attr = pm.get_str(f, 6)


class OpDef(_Message):
    def __init__(self, buf=None):
        self.name = ""
        self.input_arg: List[ArgDef] = []
        self.output_arg: List[ArgDef] = []
        if buf is None:
            return
        f = pm.decode(buf)
        self.name = pm.get_str(f, 1)
        self.input_arg = [ArgDef(b) for b in pm.get_messages(f, 2)]
        self.output_arg = [ArgDef(b) for b in pm.get_messages(f, 3)]


class _ArgAttrs(_Message):
    def __init__(self, buf=None):
        self.attr = _Map(AttrValue)
        if buf is not None:
            f = pm.decode(buf)
            self.attr = _Map(AttrValue, _map_entries(f, 1, AttrValue))


class FunctionDef(_Message):
    def __init__(self, buf=None):
        self.signature = OpDef()
        self.node_def: List[NodeDef] = []
        self.ret: Dict[str, str] = {}
        self.attr = _Map(AttrValue)
        self.arg_attr: Dict[int, _ArgAttrs] = {}
        if buf is None:
            return
        f = pm.decode(buf)
        self.signature = OpDef(pm.get_bytes(f, 1, None))
        self.node_def = [NodeDef(b) for b in pm.get_messages(f, 3)]
        self.ret = dict(_map_entries(f, 4, str))
        self.attr = _Map(AttrValue, _map_entries(f, 5, AttrValue))
        for b in pm.get_messages(f, 7):
            ef = pm.decode(b)
            vb = pm.get_bytes(ef, 2, None)
            self.arg_attr[pm.get_int(ef, 1)] = _ArgAttrs(vb)


class FunctionDefLibrary(_Message):
    def __init__(self, buf=None):
        self.function: List[FunctionDef] = []
        if buf is not None:
            f = pm.decode(buf)
            self.function = [FunctionDef(b) for b in pm.get_messages(f, 1)]


class GraphDef(_Message):
    def __init__(self, buf=None):
        self.node: List[NodeDef] = []
        self.library = FunctionDefLibrary()
        self._has = frozenset()
        if buf is None:
            return
        f = pm.decode(memoryview(buf) if isinstance(buf, (bytes, bytearray))
                      else buf)
        self.node = [NodeDef(b) for b in pm.get_messages(f, 1)]
        lib = pm.get_bytes(f, 2, None)
        if lib is not None:
            self.library = FunctionDefLibrary(lib)
            self._has = frozenset({"library"})


def parse_graph_def(graph_def) -> GraphDef:
    """bytes, a path, an object with ``SerializeToString()`` (TF's own
    GraphDef), or a :class:`GraphDef` -> :class:`GraphDef`."""
    if isinstance(graph_def, GraphDef):
        return graph_def
    if isinstance(graph_def, str):
        with open(graph_def, "rb") as fh:
            graph_def = fh.read()
    elif hasattr(graph_def, "SerializeToString"):
        graph_def = graph_def.SerializeToString()
    return GraphDef(graph_def)


# --------------------------------------------------------------- functions

#: output arguments of the multi-output op types the importer reads:
#: (name, count) with count 1, or the attr that holds it (an int attr, or
#: a type-list attr whose length it is)
OUTPUT_ARGS: Dict[str, List[Tuple[str, object]]] = {
    "FusedBatchNorm": [(n, 1) for n in ("y", "batch_mean", "batch_variance",
                                        "reserve_space_1", "reserve_space_2")],
    "Switch": [("output_false", 1), ("output_true", 1)],
    "Merge": [("output", 1), ("value_index", 1)],
    "TopKV2": [("values", 1), ("indices", 1)],
    "FusedBatchNormGrad": [(n, 1) for n in (
        "x_backprop", "scale_backprop", "offset_backprop", "reserve_space_3",
        "reserve_space_4")],
    "FusedBatchNormGradV3": [(n, 1) for n in (
        "x_backprop", "scale_backprop", "offset_backprop", "reserve_space_4",
        "reserve_space_5")],
    "SoftmaxCrossEntropyWithLogits": [("loss", 1), ("backprop", 1)],
    "BlockLSTM": [(n, 1) for n in ("i", "cs", "f", "o", "ci", "co", "h")],
    "SelfAdjointEigV2": [("e", 1), ("v", 1)],
    "Svd": [("s", 1), ("u", 1), ("v", 1)],
    "Qr": [("q", 1), ("r", 1)],
    "Lu": [("lu", 1), ("p", 1)],
    "NonMaxSuppressionV4": [("selected_indices", 1), ("valid_outputs", 1)],
    "NonMaxSuppressionV5": [("selected_indices", 1), ("selected_scores", 1),
                            ("valid_outputs", 1)],
    "UniqueV2": [("y", 1), ("idx", 1)],
    "Unique": [("y", 1), ("idx", 1)],
    "StatelessRandomGetKeyCounter": [("key", 1), ("counter", 1)],
    "TensorListPopBack": [("output_handle", 1), ("tensor", 1)],
    "MaxPoolWithArgmax": [("output", 1), ("argmax", 1)],
}
for _a, _b in (("FusedBatchNormV2", "FusedBatchNorm"),
               ("FusedBatchNormGradV2", "FusedBatchNormGrad"),
               ("SparseSoftmaxCrossEntropyWithLogits",
                "SoftmaxCrossEntropyWithLogits"),
               ("BlockLSTMV2", "BlockLSTM"), ("LSTMBlockCell", "BlockLSTM")):
    OUTPUT_ARGS[_a] = OUTPUT_ARGS[_b]
OUTPUT_ARGS["FusedBatchNormV3"] = OUTPUT_ARGS["FusedBatchNorm"] + [
    ("reserve_space_3", 1)]


def _flat_name(name: str, producers: Dict[str, NodeDef],
               functions: Dict[str, FunctionDef]) -> str:
    """``node:out_arg:idx`` -> ``node:slot``; an input argument's name ->
    ``arg:0``; ``^node`` stays."""
    if name.startswith("^"):
        return name
    parts = name.split(":")
    if len(parts) == 1:
        return name + ":0"
    if len(parts) == 2:
        return name
    node, arg, idx = parts[0], parts[1], int(parts[2])
    nd = producers.get(node)
    args = None
    if nd is not None:
        if nd.op in functions:
            args = [(a.name, 1) for a in functions[nd.op].signature.output_arg]
        else:
            args = OUTPUT_ARGS.get(nd.op)
    if not args:
        return f"{node}:{idx}"
    off = 0
    for a_name, count in args:
        if a_name == arg:
            return f"{node}:{off + idx}"
        off += count if isinstance(count, int) else _arg_count(nd, count)
    return f"{node}:{idx}"


def _arg_count(nd: NodeDef, attr: str) -> int:
    v = nd.attr[attr]
    return len(v.list.type) if v.WhichOneof("value") == "list" else int(v.i)


def function_def_to_graph_def(fdef: FunctionDef, functions=None):
    """TF's ``function_def_to_graph_def``: a Placeholder per input
    argument (its dtype, and the shape of its ``_output_shapes`` arg
    attr), then the body's nodes with their inputs flattened. Returns
    (GraphDef, nested_to_flat)."""
    functions = functions or {}
    gd = GraphDef()
    for i, arg in enumerate(fdef.signature.input_arg):
        attrs = {"dtype": _attr_type(arg.type)}
        shapes = fdef.arg_attr.get(i)
        if shapes is not None and "_output_shapes" in shapes.attr:
            v = shapes.attr["_output_shapes"]
            shp = v.list.shape[0] if v.WhichOneof("value") == "list" \
                and v.list.shape else v.shape
            attrs["shape"] = _attr_shape_proto(shp)
        gd.node.append(NodeDef(name=arg.name, op="Placeholder", attr=attrs))
    producers = {n.name: n for n in fdef.node_def}
    nested_to_flat: Dict[str, str] = {}
    for arg in fdef.signature.input_arg:
        nested_to_flat[arg.name] = f"{arg.name}:0"
    for nd in fdef.node_def:
        node = NodeDef(name=nd.name, op=nd.op,
                       input=[_flat_name(i, producers, functions)
                              for i in nd.input],
                       attr=dict(nd.attr))
        gd.node.append(node)
    for ret in fdef.ret.values():
        nested_to_flat[ret] = _flat_name(ret, producers, functions)
    return gd, nested_to_flat


def _attr_type(dt: int) -> AttrValue:
    return AttrValue(pm.f_varint(6, int(dt)))


def _attr_shape_proto(shape: TensorShapeProto) -> AttrValue:
    return AttrValue(pm.f_bytes(7, enc_shape(
        None if shape.unknown_rank else [d.size for d in shape.dim])))


# ----------------------------------------------------------------- encoding


def enc_shape(dims: Optional[List[int]]) -> bytes:
    """TensorShapeProto; None: unknown rank; -1: unknown dim."""
    if dims is None:
        return pm.f_varint(3, 1)
    return b"".join(pm.f_bytes(2, pm.f_varint(1, int(d))) for d in dims)


def enc_tensor(arr) -> bytes:
    """TensorProto of a numpy array (``tensor_content`` little-endian)."""
    arr = np.asarray(arr)
    out = pm.f_varint(1, NUMPY_DT[arr.dtype]) + pm.f_bytes(
        2, enc_shape(list(arr.shape)))
    if arr.size:
        out += pm.f_bytes(4, np.ascontiguousarray(arr).astype(
            arr.dtype.newbyteorder("<"), copy=False).tobytes())
    return out


def attr_s(v: str) -> bytes:
    return pm.f_bytes(2, v.encode() if isinstance(v, str) else v)


def attr_i(v: int) -> bytes:
    return pm.f_varint(3, int(v))


def attr_f(v: float) -> bytes:
    return pm.f_float(4, float(v))


def attr_b(v: bool) -> bytes:
    return pm.f_varint(5, int(bool(v)))


def attr_type(dt) -> bytes:
    return pm.f_varint(6, NUMPY_DT[np.dtype(dt)])


def attr_shape(dims) -> bytes:
    return pm.f_bytes(7, enc_shape(dims))


def attr_tensor(arr) -> bytes:
    return pm.f_bytes(8, enc_tensor(arr))


def attr_list_i(vals) -> bytes:
    return pm.f_bytes(1, pm.f_packed_ints(3, vals) if len(vals) else b"")


def enc_node(name: str, op: str, inputs=(), attrs=None) -> bytes:
    """NodeDef; ``attrs``: name -> AttrValue bytes (``attr_*``)."""
    out = pm.f_str(1, name) + pm.f_str(2, op)
    for i in inputs:
        out += pm.f_str(3, i)
    for k, v in (attrs or {}).items():
        out += pm.f_bytes(5, pm.f_str(1, k) + pm.f_bytes(2, v))
    return out


def enc_graph(nodes) -> bytes:
    """GraphDef of NodeDef bytes, with TF 2's producer version."""
    out = b"".join(pm.f_bytes(1, n) for n in nodes)
    return out + pm.f_bytes(4, pm.f_varint(1, 1205))
