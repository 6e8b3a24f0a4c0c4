"""Seeded graphs for the importers (no counterpart in the reference, whose
tests make their graphs with TensorFlow and ``torch.onnx``): the machine
with the card has neither, so the tests and ``chip_smoke.py`` take these.

- :func:`bert_graph_def`: a frozen TF GraphDef of a BERT classifier in the
  form a frozen BERT classifier takes (GatherV2 embeddings, MatMul +
  BiasAdd, Reshape/Transpose, BatchMatMulV2, Softmax with the additive
  padding mask, the layer norm as Mean/SquaredDifference/Rsqrt, the erf
  gelu, the tanh pooler, the classifier), written from the parameters of
  a ``zoo.Bert`` network: the same gelu and the same layer-norm epsilon
  (1e-12, reference ``nn/transformer.py:35``), so the imported graph and
  ``net.output`` compute the same probabilities.
- :func:`resnet50_graph_def`: a frozen TF GraphDef of ResNet-50 in the
  form ``tf.keras.applications.ResNet50`` freezes to (Pad + VALID Conv2D
  stem, Conv2D + BiasAdd, FusedBatchNormV3 with is_training false, Relu,
  AddV2, MaxPool, Mean, MatMul + BiasAdd, Softmax), seeded numpy weights:
  53 convolutions.
- :func:`lstm_onnx`: an ONNX model of a batch-first LSTM in the form
  ``torch.onnx.export`` writes for ``nn.LSTM`` (Transpose, LSTM with W/R/B
  initializers in ONNX's IOFC gate order, Squeeze, Transpose).

Each writes bytes with the port's encoders (``tf_proto``, ``protomini``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.imports import protomini as pm
from deeplearning4j_tpu_torch.imports import tf_proto as tp

F32 = np.float32


class _GraphWriter:
    """NodeDefs in order, each named once."""

    def __init__(self):
        self.nodes: List[bytes] = []

    def const(self, name: str, arr) -> str:
        arr = np.asarray(arr)
        self.nodes.append(tp.enc_node(name, "Const", attrs={
            "value": tp.attr_tensor(arr), "dtype": tp.attr_type(arr.dtype)}))
        return name

    def op(self, op: str, name: str, inputs, t=F32, **attrs) -> str:
        a = {"T": tp.attr_type(t)} if t is not None else {}
        a.update(attrs)
        self.nodes.append(tp.enc_node(name, op, inputs, a))
        return name

    def placeholder(self, name: str, shape, dtype) -> str:
        self.nodes.append(tp.enc_node(name, "Placeholder", attrs={
            "dtype": tp.attr_type(dtype), "shape": tp.attr_shape(shape)}))
        return name

    def to_bytes(self) -> bytes:
        return tp.enc_graph(self.nodes)

    # composite forms
    def dense(self, name, x, w, b, w_arr, b_arr) -> str:
        self.const(w, w_arr)
        self.const(b, b_arr)
        y = self.op("MatMul", f"{name}/MatMul", [x, w],
                    transpose_a=tp.attr_b(False), transpose_b=tp.attr_b(False))
        return self.op("BiasAdd", f"{name}/BiasAdd", [y, b],
                       data_format=tp.attr_s("NHWC"))

    def layer_norm(self, name, x, gamma, beta, eps) -> str:
        axes = self.const(f"{name}/axes", np.asarray([-1], np.int32))
        self.const(f"{name}/gamma", gamma)
        self.const(f"{name}/beta", beta)
        keep = {"keep_dims": tp.attr_b(True),
                "Tidx": tp.attr_type(np.int32)}
        mean = self.op("Mean", f"{name}/mean", [x, axes], **keep)
        sq = self.op("SquaredDifference", f"{name}/sqdiff", [x, mean])
        var = self.op("Mean", f"{name}/variance", [sq, axes], **keep)
        self.const(f"{name}/eps", np.asarray(eps, F32))
        ve = self.op("AddV2", f"{name}/add", [var, f"{name}/eps"])
        inv = self.op("Rsqrt", f"{name}/Rsqrt", [ve])
        xc = self.op("Sub", f"{name}/sub", [x, mean])
        y = self.op("Mul", f"{name}/mul", [xc, inv])
        y = self.op("Mul", f"{name}/mul_1", [y, f"{name}/gamma"])
        return self.op("AddV2", f"{name}/add_1", [y, f"{name}/beta"])


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().float().cpu().numpy()
    return np.asarray(t, F32)


def bert_graph_def(net, seq_len: int, eps: float = 1e-12) -> Tuple[bytes, Dict[str, str]]:
    """A frozen TF GraphDef of ``net`` (a ``zoo.Bert`` classification
    network): placeholders ``input_ids``, ``input_mask`` and
    ``segment_ids`` (batch x ``seq_len`` int32, the batch dynamic); outputs
    ``logits`` and ``probabilities``. Returns (bytes, names) with the
    placeholder and output node names."""
    from deeplearning4j_tpu_torch.nn.transformer import (
        BertEmbeddingLayer, TransformerEncoderBlock)

    layers, params = net.layers, net.params
    emb = params[0]
    assert isinstance(layers[0], BertEmbeddingLayer)
    blocks = [(lyr, p) for lyr, p in zip(layers, params)
              if isinstance(lyr, TransformerEncoderBlock)]
    pooler, cls = params[-2], params[-1]
    S = int(seq_len)
    H = int(_np(emb["word"]).shape[1])
    g = _GraphWriter()
    ids = g.placeholder("input_ids", [-1, S], np.int32)
    mask = g.placeholder("input_mask", [-1, S], np.int32)
    seg = g.placeholder("segment_ids", [-1, S], np.int32)
    zero = g.const("bert/embeddings/axis", np.asarray(0, np.int32))
    gather = {"Tparams": tp.attr_type(F32), "Tindices": tp.attr_type(np.int32),
              "Taxis": tp.attr_type(np.int32), "batch_dims": tp.attr_i(0)}
    g.const("bert/embeddings/word_embeddings", _np(emb["word"]))
    we = g.op("GatherV2", "bert/embeddings/GatherV2",
              ["bert/embeddings/word_embeddings", ids, zero], t=None, **gather)
    g.const("bert/embeddings/token_type_embeddings", _np(emb["type"]))
    te = g.op("GatherV2", "bert/embeddings/GatherV2_1",
              ["bert/embeddings/token_type_embeddings", seg, zero], t=None,
              **gather)
    g.const("bert/embeddings/position_embeddings", _np(emb["pos"]))
    g.const("bert/embeddings/Slice/begin", np.asarray([0, 0], np.int32))
    g.const("bert/embeddings/Slice/size", np.asarray([S, H], np.int32))
    pe = g.op("Slice", "bert/embeddings/Slice",
              ["bert/embeddings/position_embeddings",
               "bert/embeddings/Slice/begin", "bert/embeddings/Slice/size"],
              Index=tp.attr_type(np.int32))
    g.const("bert/embeddings/Reshape/shape", np.asarray([1, S, H], np.int32))
    pe = g.op("Reshape", "bert/embeddings/Reshape",
              [pe, "bert/embeddings/Reshape/shape"],
              Tshape=tp.attr_type(np.int32))
    h = g.op("AddV2", "bert/embeddings/add", [we, te])
    h = g.op("AddV2", "bert/embeddings/add_1", [h, pe])
    h = g.layer_norm("bert/embeddings/LayerNorm", h, _np(emb["gamma"]),
                     _np(emb["beta"]), eps)
    g.const("bert/encoder/Reshape/shape", np.asarray([-1, H], np.int32))
    x = g.op("Reshape", "bert/encoder/Reshape", [h, "bert/encoder/Reshape/shape"],
             Tshape=tp.attr_type(np.int32))
    # the additive mask: (1 - mask) * -10000 as (B, 1, 1, S)
    g.const("bert/encoder/mask/shape", np.asarray([-1, 1, 1, S], np.int32))
    mk = g.op("Reshape", "bert/encoder/mask/Reshape",
              [mask, "bert/encoder/mask/shape"], t=np.int32,
              Tshape=tp.attr_type(np.int32))
    mk = g.op("Cast", "bert/encoder/mask/Cast", [mk], t=None,
              SrcT=tp.attr_type(np.int32), DstT=tp.attr_type(F32),
              Truncate=tp.attr_b(False))
    g.const("bert/encoder/mask/one", np.asarray(1.0, F32))
    g.const("bert/encoder/mask/neg", np.asarray(-10000.0, F32))
    mk = g.op("Sub", "bert/encoder/mask/sub", ["bert/encoder/mask/one", mk])
    adder = g.op("Mul", "bert/encoder/mask/mul", [mk, "bert/encoder/mask/neg"])
    for li, (lyr, p) in enumerate(blocks):
        pre = f"bert/encoder/layer_{li}"
        nh = int(lyr.n_heads)
        dh = H // nh
        split = g.const(f"{pre}/attention/split_shape",
                        np.asarray([-1, S, nh, dh], np.int32))
        perm = g.const(f"{pre}/attention/perm", np.asarray([0, 2, 1, 3],
                                                           np.int32))
        heads = {}
        for k in ("q", "k", "v"):
            y = g.dense(f"{pre}/attention/self/{k}", x,
                        f"{pre}/attention/self/{k}/kernel",
                        f"{pre}/attention/self/{k}/bias",
                        _np(p[f"W{k}"]), _np(p[f"b{k}"]))
            y = g.op("Reshape", f"{pre}/attention/self/{k}/Reshape",
                     [y, split], Tshape=tp.attr_type(np.int32))
            heads[k] = g.op("Transpose", f"{pre}/attention/self/{k}/transpose",
                            [y, perm], Tperm=tp.attr_type(np.int32))
        s = g.op("BatchMatMulV2", f"{pre}/attention/self/MatMul",
                 [heads["q"], heads["k"]], adj_x=tp.attr_b(False),
                 adj_y=tp.attr_b(True))
        g.const(f"{pre}/attention/self/scale", np.asarray(1.0 / np.sqrt(dh),
                                                          F32))
        s = g.op("Mul", f"{pre}/attention/self/Mul",
                 [s, f"{pre}/attention/self/scale"])
        s = g.op("AddV2", f"{pre}/attention/self/add", [s, adder])
        w = g.op("Softmax", f"{pre}/attention/self/Softmax", [s])
        o = g.op("BatchMatMulV2", f"{pre}/attention/self/MatMul_1",
                 [w, heads["v"]], adj_x=tp.attr_b(False),
                 adj_y=tp.attr_b(False))
        o = g.op("Transpose", f"{pre}/attention/self/transpose_o", [o, perm],
                 Tperm=tp.attr_type(np.int32))
        o = g.op("Reshape", f"{pre}/attention/self/Reshape_o",
                 [o, "bert/encoder/Reshape/shape"],
                 Tshape=tp.attr_type(np.int32))
        a = g.dense(f"{pre}/attention/output/dense", o,
                    f"{pre}/attention/output/dense/kernel",
                    f"{pre}/attention/output/dense/bias",
                    _np(p["Wo"]), _np(p["bo"]))
        a = g.op("AddV2", f"{pre}/attention/output/add", [a, x])
        hh = g.layer_norm(f"{pre}/attention/output/LayerNorm", a,
                          _np(p["ln1_g"]), _np(p["ln1_b"]), eps)
        f = g.dense(f"{pre}/intermediate/dense", hh,
                    f"{pre}/intermediate/dense/kernel",
                    f"{pre}/intermediate/dense/bias",
                    _np(p["W1"]), _np(p["b1"]))
        # gelu: x * 0.5 * (1 + erf(x / sqrt(2)))
        g.const(f"{pre}/intermediate/half", np.asarray(0.5, F32))
        g.const(f"{pre}/intermediate/one", np.asarray(1.0, F32))
        g.const(f"{pre}/intermediate/sqrt2", np.asarray(np.sqrt(2.0), F32))
        e = g.op("RealDiv", f"{pre}/intermediate/truediv",
                 [f, f"{pre}/intermediate/sqrt2"])
        e = g.op("Erf", f"{pre}/intermediate/Erf", [e])
        e = g.op("AddV2", f"{pre}/intermediate/add",
                 [f"{pre}/intermediate/one", e])
        e = g.op("Mul", f"{pre}/intermediate/mul",
                 [f"{pre}/intermediate/half", e])
        f = g.op("Mul", f"{pre}/intermediate/mul_1", [f, e])
        f = g.dense(f"{pre}/output/dense", f, f"{pre}/output/dense/kernel",
                    f"{pre}/output/dense/bias", _np(p["W2"]), _np(p["b2"]))
        f = g.op("AddV2", f"{pre}/output/add", [f, hh])
        x = g.layer_norm(f"{pre}/output/LayerNorm", f, _np(p["ln2_g"]),
                         _np(p["ln2_b"]), eps)
    g.const("bert/pooler/shape", np.asarray([-1, S, H], np.int32))
    seq = g.op("Reshape", "bert/pooler/Reshape", [x, "bert/pooler/shape"],
               Tshape=tp.attr_type(np.int32))
    g.const("bert/pooler/begin", np.asarray([0, 0, 0], np.int32))
    g.const("bert/pooler/end", np.asarray([0, 1, 0], np.int32))
    g.const("bert/pooler/strides", np.asarray([1, 1, 1], np.int32))
    first = g.op("StridedSlice", "bert/pooler/strided_slice",
                 [seq, "bert/pooler/begin", "bert/pooler/end",
                  "bert/pooler/strides"], Index=tp.attr_type(np.int32),
                 begin_mask=tp.attr_i(5), end_mask=tp.attr_i(5),
                 ellipsis_mask=tp.attr_i(0), new_axis_mask=tp.attr_i(0),
                 shrink_axis_mask=tp.attr_i(0))
    first = g.op("Squeeze", "bert/pooler/Squeeze", [first],
                 squeeze_dims=tp.attr_list_i([1]))
    pooled = g.dense("bert/pooler/dense", first, "bert/pooler/dense/kernel",
                     "bert/pooler/dense/bias", _np(pooler["W"]),
                     _np(pooler["b"]))
    pooled = g.op("Tanh", "bert/pooler/Tanh", [pooled])
    logits = g.dense("output", pooled, "output_weights", "output_bias",
                     _np(cls["W"]), _np(cls["b"]))
    g.op("Identity", "logits", [logits])
    g.op("Softmax", "probabilities", ["logits"])
    names = {"input_ids": ids, "input_mask": mask, "segment_ids": seg,
             "logits": "logits", "probabilities": "probabilities"}
    return g.to_bytes(), names


#: ResNet-50's stages: (blocks, filters, first stride)
RESNET50_STAGES = ((3, 64, 1), (4, 128, 2), (6, 256, 2), (3, 512, 2))


def resnet50_graph_def(seed: int = 12345, image_size: int = 224,
                       classes: int = 1000) -> Tuple[bytes, Dict[str, str]]:
    """A frozen TF GraphDef of ResNet-50 (keras ``ResNet50``'s layer names
    and form) with seeded weights: He-normal conv kernels and biases of 0,
    batchnorm statistics near (0, 1) and the last batchnorm of each
    residual branch scaled by 0.3 so activations stay in range at random
    init. Input ``input_1`` (batch x size x size x 3, batch dynamic);
    outputs ``predictions/BiasAdd`` (logits) and ``predictions/Softmax``.
    53 Conv2D nodes."""
    rng = np.random.default_rng(seed)
    g = _GraphWriter()
    x = g.placeholder("input_1", [-1, image_size, image_size, 3], F32)
    eps = 1.001e-5

    def conv(name, x, k, cin, cout, stride, padding, gamma=1.0):
        w = (rng.standard_normal((k, k, cin, cout))
             * np.sqrt(2.0 / (k * k * cin))).astype(F32)
        g.const(f"{name}_conv/kernel", w)
        y = g.op("Conv2D", f"{name}_conv/Conv2D", [x, f"{name}_conv/kernel"],
                 strides=tp.attr_list_i([1, stride, stride, 1]),
                 padding=tp.attr_s(padding), data_format=tp.attr_s("NHWC"),
                 dilations=tp.attr_list_i([1, 1, 1, 1]),
                 use_cudnn_on_gpu=tp.attr_b(True),
                 explicit_paddings=tp.attr_list_i([]))
        g.const(f"{name}_conv/bias", np.zeros(cout, F32))
        y = g.op("BiasAdd", f"{name}_conv/BiasAdd", [y, f"{name}_conv/bias"],
                 data_format=tp.attr_s("NHWC"))
        g.const(f"{name}_bn/gamma", np.full(cout, gamma, F32))
        g.const(f"{name}_bn/beta", (rng.standard_normal(cout) * 0.05)
                .astype(F32))
        g.const(f"{name}_bn/moving_mean", (rng.standard_normal(cout) * 0.05)
                .astype(F32))
        g.const(f"{name}_bn/moving_variance",
                rng.uniform(0.8, 1.2, cout).astype(F32))
        return g.op("FusedBatchNormV3", f"{name}_bn/FusedBatchNormV3",
                    [y, f"{name}_bn/gamma", f"{name}_bn/beta",
                     f"{name}_bn/moving_mean", f"{name}_bn/moving_variance"],
                    U=tp.attr_type(F32), epsilon=tp.attr_f(eps),
                    exponential_avg_factor=tp.attr_f(1.0),
                    data_format=tp.attr_s("NHWC"),
                    is_training=tp.attr_b(False))

    g.const("conv1_pad/paddings",
            np.asarray([[0, 0], [3, 3], [3, 3], [0, 0]], np.int32))
    y = g.op("Pad", "conv1_pad/Pad", [x, "conv1_pad/paddings"],
             Tpaddings=tp.attr_type(np.int32))
    y = conv("conv1", y, 7, 3, 64, 2, "VALID")
    y = g.op("Relu", "conv1_relu/Relu", [y])
    g.const("pool1_pad/paddings",
            np.asarray([[0, 0], [1, 1], [1, 1], [0, 0]], np.int32))
    y = g.op("Pad", "pool1_pad/Pad", [y, "pool1_pad/paddings"],
             Tpaddings=tp.attr_type(np.int32))
    y = g.op("MaxPool", "pool1_pool/MaxPool", [y],
             ksize=tp.attr_list_i([1, 3, 3, 1]),
             strides=tp.attr_list_i([1, 2, 2, 1]), padding=tp.attr_s("VALID"),
             data_format=tp.attr_s("NHWC"))
    cin = 64
    for si, (n_blocks, f, stride) in enumerate(RESNET50_STAGES):
        for bi in range(n_blocks):
            name = f"conv{si + 2}_block{bi + 1}"
            s = stride if bi == 0 else 1
            if bi == 0:
                sc = conv(f"{name}_0", y, 1, cin, 4 * f, s, "VALID")
            else:
                sc = y
            h = conv(f"{name}_1", y, 1, cin, f, s, "VALID")
            h = g.op("Relu", f"{name}_1_relu/Relu", [h])
            h = conv(f"{name}_2", h, 3, f, f, 1, "SAME")
            h = g.op("Relu", f"{name}_2_relu/Relu", [h])
            h = conv(f"{name}_3", h, 1, f, 4 * f, 1, "VALID", gamma=0.3)
            y = g.op("AddV2", f"{name}_add/add", [sc, h])
            y = g.op("Relu", f"{name}_out/Relu", [y])
            cin = 4 * f
    g.const("avg_pool/reduction_indices", np.asarray([1, 2], np.int32))
    y = g.op("Mean", "avg_pool/Mean", [y, "avg_pool/reduction_indices"],
             keep_dims=tp.attr_b(False), Tidx=tp.attr_type(np.int32))
    w = (rng.standard_normal((cin, classes)) * np.sqrt(1.0 / cin)).astype(F32)
    logits = g.dense("predictions", y, "predictions/kernel",
                     "predictions/bias", w, np.zeros(classes, F32))
    g.op("Softmax", "predictions/Softmax", [logits])
    names = {"input": x, "logits": logits, "probabilities": "predictions/Softmax"}
    return g.to_bytes(), names


# ---------------------------------------------------------------- ONNX


def _onnx_tensor(name: str, arr) -> bytes:
    arr = np.asarray(arr)
    dt = {np.dtype(np.float32): 1, np.dtype(np.int64): 7,
          np.dtype(np.int32): 6}[arr.dtype]
    return (pm.f_packed_ints(1, arr.shape) + pm.f_varint(2, dt)
            + pm.f_str(8, name) + pm.f_bytes(9, arr.tobytes()))


def _onnx_value(name: str, shape, elem: int = 1) -> bytes:
    dims = b"".join(pm.f_bytes(1, pm.f_varint(1, d)) for d in shape)
    tensor_type = pm.f_varint(1, elem) + pm.f_bytes(2, dims)
    return pm.f_str(1, name) + pm.f_bytes(2, pm.f_bytes(1, tensor_type))


def _onnx_node(op_type: str, inputs, outputs, name: str, *attrs) -> bytes:
    b = b"".join(pm.f_str(1, i) for i in inputs)
    b += b"".join(pm.f_str(2, o) for o in outputs)
    b += pm.f_str(3, name) + pm.f_str(4, op_type)
    return b + b"".join(pm.f_bytes(5, a) for a in attrs)


def _onnx_attr_i(name: str, v: int) -> bytes:
    return pm.f_str(1, name) + pm.f_varint(3, v) + pm.f_varint(20, 2)


def _onnx_attr_ints(name: str, vals) -> bytes:
    return pm.f_str(1, name) + pm.f_packed_ints(8, vals) + pm.f_varint(20, 7)


def lstm_onnx(seed: int = 12345, input_size: int = 47, hidden: int = 256,
              batch: int = 32, seq_len: int = 50,
              weights: Optional[Dict[str, np.ndarray]] = None) -> bytes:
    """An ONNX model (opset 14) of ``nn.LSTM(input_size, hidden,
    batch_first=True)`` as ``torch.onnx.export`` writes it: ``x`` (batch,
    seq, input) -> Transpose -> LSTM (W, R, B initializers, IOFC gates)
    -> Squeeze(axis 1) -> Transpose -> ``y`` (batch, seq, hidden), with
    ``y_h``/``y_c`` the last states. ``weights``: W (1, 4H, I), R (1, 4H,
    H), B (1, 8H); else uniform(-1/sqrt(H), 1/sqrt(H)) from ``seed``, as
    torch initializes."""
    H = int(hidden)
    if weights is None:
        rng = np.random.default_rng(seed)
        k = 1.0 / np.sqrt(H)
        weights = {
            "W": rng.uniform(-k, k, (1, 4 * H, input_size)).astype(F32),
            "R": rng.uniform(-k, k, (1, 4 * H, H)).astype(F32),
            "B": rng.uniform(-k, k, (1, 8 * H)).astype(F32)}
    nodes = [
        _onnx_node("Transpose", ["x"], ["x_tbi"], "/Transpose",
                   _onnx_attr_ints("perm", [1, 0, 2])),
        _onnx_node("LSTM", ["x_tbi", "W", "R", "B"], ["y4", "y_h", "y_c"],
                   "/lstm/LSTM", _onnx_attr_i("hidden_size", H)),
        _onnx_node("Squeeze", ["y4", "axes1"], ["y3"], "/lstm/Squeeze"),
        _onnx_node("Transpose", ["y3"], ["y"], "/Transpose_1",
                   _onnx_attr_ints("perm", [1, 0, 2])),
    ]
    inits = [_onnx_tensor(n, weights[n]) for n in ("W", "R", "B")]
    inits.append(_onnx_tensor("axes1", np.asarray([1], np.int64)))
    g = b"".join(pm.f_bytes(1, n) for n in nodes)
    g += pm.f_str(2, "main_graph")
    g += b"".join(pm.f_bytes(5, i) for i in inits)
    g += pm.f_bytes(11, _onnx_value("x", (batch, seq_len, input_size)))
    for o, shp in (("y", (batch, seq_len, H)), ("y_h", (1, batch, H)),
                   ("y_c", (1, batch, H))):
        g += pm.f_bytes(12, _onnx_value(o, shp))
    opset = pm.f_str(1, "") + pm.f_varint(2, 14)
    return (pm.f_varint(1, 8) + pm.f_str(2, "pytorch")
            + pm.f_bytes(7, g) + pm.f_bytes(8, opset))
