"""Zoo models (counterpart of deeplearning4j_tpu/zoo/models.py), each the
reference's conf layer for layer and node for node, NHWC: on
MultiLayerNetwork LeNet-5, SimpleCNN, AlexNet, VGG16/VGG19, Darknet19 and
the char-RNN TextGenerationLSTM; on ComputationGraph ResNet-50,
SqueezeNet, Xception (SeparableConvolution2D: the conv kernel with one
group per channel), InceptionResNetV1 and FaceNetNN4Small2. UNet,
TinyYOLO and YOLO2 come with ROADMAP Queue 1 item 13.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from deeplearning4j_tpu_torch.nn import (ComputationGraph, InputType,
                                         MultiLayerNetwork,
                                         NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.layers import (ActivationLayer,
                                                BatchNormalization,
                                                ConvolutionLayer,
                                                DenseLayer, DropoutLayer,
                                                GlobalPoolingLayer,
                                                LocalResponseNormalization,
                                                OutputLayer,
                                                SeparableConvolution2D,
                                                SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.recurrent import LSTM, RnnOutputLayer
from deeplearning4j_tpu_torch.nn.vertices import (ElementWiseVertex,
                                                  L2NormalizeVertex,
                                                  MergeVertex, ScaleVertex)

#: the reference zoo's default updater, Adam(1e-3), as its JSON dict
ADAM_DEFAULT = {"learning_rate": 1e-3, "beta1": 0.9, "beta2": 0.999,
                "epsilon": 1e-8, "@updater": "Adam"}


@dataclasses.dataclass
class ZooModel:
    """Base (org/deeplearning4j/zoo/ZooModel.java parity)."""

    num_classes: int = 1000
    seed: int = 12345
    input_shape: Tuple[int, int, int] = (224, 224, 3)  # HWC
    compute_dtype: str = "float32"
    updater: object = None

    def conf(self):
        raise NotImplementedError

    def init(self, device=None):
        """Build and initialize the network on ``device`` (CUDA unless
        named otherwise): a ComputationGraph for a graph conf, a
        MultiLayerNetwork for a layer stack (ZooModel.init parity)."""
        conf = self.conf()
        if hasattr(conf, "nodes"):
            return ComputationGraph(conf).init(device=device)
        return MultiLayerNetwork(conf).init(device=device)

    def _builder(self):
        return (NeuralNetConfiguration.builder()
                .seed(self.seed)
                .updater(self.updater or dict(ADAM_DEFAULT))
                .compute_dtype(self.compute_dtype))


@dataclasses.dataclass
class LeNet(ZooModel):
    """zoo/model/LeNet.java (reference ``zoo/models.py:76``), BASELINE
    config #1: conv 5x5 -> 20 and 5x5 -> 50 (VALID, relu), each followed by
    a 2x2 max-pool, dense 500 (relu), softmax over the classes; 28x28x1
    NHWC input."""

    num_classes: int = 10
    input_shape: Tuple[int, int, int] = (28, 28, 1)

    def conf(self):
        h, w, c = self.input_shape
        return (self._builder().list()
                .layer(ConvolutionLayer(n_out=20, kernel_size=(5, 5),
                                        padding="VALID", activation="relu"))
                .layer(SubsamplingLayer(kernel_size=(2, 2)))
                .layer(ConvolutionLayer(n_out=50, kernel_size=(5, 5),
                                        padding="VALID", activation="relu"))
                .layer(SubsamplingLayer(kernel_size=(2, 2)))
                .layer(DenseLayer(n_out=500, activation="relu"))
                .layer(OutputLayer(n_in=500, n_out=self.num_classes))
                .set_input_type(InputType.convolutional(h, w, c))
                .build())


@dataclasses.dataclass
class SimpleCNN(ZooModel):
    """zoo/model/SimpleCNN.java (reference ``zoo/models.py:101``): four 3x3
    convs (relu) each followed by batchnorm, two 2x2 max-pools, dropout
    0.5, global average pooling, softmax; 48x48x3 input, 10 classes."""

    num_classes: int = 10
    input_shape: Tuple[int, int, int] = (48, 48, 3)

    def conf(self):
        h, w, c = self.input_shape
        lb = self._builder().list()
        for n_out in (16, 16, None, 32, 32, None):
            if n_out is None:
                lb.layer(SubsamplingLayer(kernel_size=(2, 2)))
                continue
            lb.layer(ConvolutionLayer(n_out=n_out, kernel_size=(3, 3),
                                      activation="relu"))
            lb.layer(BatchNormalization())
        return (lb.layer(DropoutLayer(rate=0.5))
                .layer(GlobalPoolingLayer())
                .layer(OutputLayer(n_in=32, n_out=self.num_classes))
                .set_input_type(InputType.convolutional(h, w, c))
                .build())


@dataclasses.dataclass
class AlexNet(ZooModel):
    """zoo/model/AlexNet.java, the one-tower variant (reference ``:131``):
    11x11/4, 5x5 and three 3x3 convs, LRN after the first two, 3x3/2
    max-pools, two dense 4096 with input dropout 0.5, softmax."""

    def conf(self):
        h, w, c = self.input_shape
        return (self._builder().list()
                .layer(ConvolutionLayer(n_out=96, kernel_size=(11, 11),
                                        stride=(4, 4), padding="VALID",
                                        activation="relu"))
                .layer(LocalResponseNormalization())
                .layer(SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)))
                .layer(ConvolutionLayer(n_out=256, kernel_size=(5, 5),
                                        activation="relu"))
                .layer(LocalResponseNormalization())
                .layer(SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)))
                .layer(ConvolutionLayer(n_out=384, kernel_size=(3, 3),
                                        activation="relu"))
                .layer(ConvolutionLayer(n_out=384, kernel_size=(3, 3),
                                        activation="relu"))
                .layer(ConvolutionLayer(n_out=256, kernel_size=(3, 3),
                                        activation="relu"))
                .layer(SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)))
                .layer(DenseLayer(n_out=4096, activation="relu",
                                  dropout=0.5))
                .layer(DenseLayer(n_in=4096, n_out=4096, activation="relu",
                                  dropout=0.5))
                .layer(OutputLayer(n_in=4096, n_out=self.num_classes))
                .set_input_type(InputType.convolutional(h, w, c))
                .build())


def _vgg_blocks(lb, spec):
    """VGG's conv blocks (reference ``:157``): per (convs, channels), that
    many 3x3 relu convs, then a 2x2/2 max-pool."""
    for n_convs, channels in spec:
        for _ in range(n_convs):
            lb.layer(ConvolutionLayer(n_out=channels, kernel_size=(3, 3),
                                      activation="relu"))
        lb.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
    return lb


@dataclasses.dataclass
class VGG16(ZooModel):
    """zoo/model/VGG16.java (reference ``:166``): 13 convs in five blocks,
    two dense 4096 with input dropout 0.5, softmax."""

    spec = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))

    def conf(self):
        h, w, c = self.input_shape
        lb = _vgg_blocks(self._builder().list(), self.spec)
        return (lb.layer(DenseLayer(n_out=4096, activation="relu",
                                    dropout=0.5))
                .layer(DenseLayer(n_in=4096, n_out=4096, activation="relu",
                                  dropout=0.5))
                .layer(OutputLayer(n_in=4096, n_out=self.num_classes))
                .set_input_type(InputType.convolutional(h, w, c))
                .build())


@dataclasses.dataclass
class VGG19(VGG16):
    """zoo/model/VGG19.java (reference ``:185``): 16 convs."""

    spec = ((2, 64), (2, 128), (4, 256), (4, 512), (4, 512))


@dataclasses.dataclass
class Darknet19(ZooModel):
    """zoo/model/Darknet19.java (reference ``:192``): 3x3/1x1 conv,
    batchnorm, leaky-relu triples with 2x2/2 max-pools, a 1x1 conv to the
    classes, global average pooling, softmax."""

    def conf(self):
        h, w, c = self.input_shape
        lb = self._builder().list()

        def conv_bn(n_out, k):
            lb.layer(ConvolutionLayer(n_out=n_out, kernel_size=(k, k),
                                      has_bias=False))
            lb.layer(BatchNormalization())
            lb.layer(ActivationLayer(activation="leakyrelu"))

        def pool():
            lb.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))

        conv_bn(32, 3)
        pool()
        conv_bn(64, 3)
        pool()
        for a, b_ in ((128, 64), (256, 128)):
            conv_bn(a, 3)
            conv_bn(b_, 1)
            conv_bn(a, 3)
            pool()
        for a, b_ in ((512, 256), (1024, 512)):
            conv_bn(a, 3)
            conv_bn(b_, 1)
            conv_bn(a, 3)
            conv_bn(b_, 1)
            conv_bn(a, 3)
            if a == 512:
                pool()
        lb.layer(ConvolutionLayer(n_out=self.num_classes, kernel_size=(1, 1)))
        lb.layer(GlobalPoolingLayer())
        return (lb.layer(OutputLayer(n_in=self.num_classes,
                                     n_out=self.num_classes))
                .set_input_type(InputType.convolutional(h, w, c))
                .build())


@dataclasses.dataclass
class ResNet50(ZooModel):
    """zoo/model/ResNet50.java — the repo's flagship model. ResNet-v1
    bottleneck layout (stride on the first 1x1, as in the reference/Keras),
    NHWC. ``remat_policy``/``stage_barriers`` turn on the remat stages,
    whose boundaries are the stem and each residual stage (res2-res5):
    the training step recomputes each stage under the policy
    (``util/xla_tuning.py``)."""

    updater: object = None
    remat_policy: Optional[str] = None
    stage_barriers: bool = False

    def conf(self):
        h, w, c = self.input_shape
        b = self._builder()
        if self.remat_policy is not None:
            b.remat_policy(self.remat_policy)
        if self.stage_barriers:
            b.stage_barriers(True)
        gb = b.graph_builder().add_inputs("input")

        def conv_bn(name, inp, n_out, k, stride=(1, 1), relu=True,
                    pad="SAME"):
            gb.add_layer(f"{name}_conv",
                         ConvolutionLayer(n_out=n_out, kernel_size=(k, k),
                                          stride=stride, padding=pad,
                                          has_bias=False), inp)
            gb.add_layer(f"{name}_bn", BatchNormalization(), f"{name}_conv")
            if relu:
                gb.add_layer(f"{name}_relu",
                             ActivationLayer(activation="relu"),
                             f"{name}_bn")
                return f"{name}_relu"
            return f"{name}_bn"

        def bottleneck(name, inp, filters, stride, project):
            f1, f2, f3 = filters
            x = conv_bn(f"{name}_a", inp, f1, 1, stride=stride)
            x = conv_bn(f"{name}_b", x, f2, 3)
            x = conv_bn(f"{name}_c", x, f3, 1, relu=False)
            sc = (conv_bn(f"{name}_sc", inp, f3, 1, stride=stride,
                          relu=False) if project else inp)
            gb.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), x, sc)
            gb.add_layer(f"{name}_out", ActivationLayer(activation="relu"),
                         f"{name}_add")
            return f"{name}_out"

        x = conv_bn("stem", "input", 64, 7, stride=(2, 2))
        gb.add_layer("stem_pool",
                     SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2),
                                      padding="SAME"), x)
        x = "stem_pool"
        gb.stage_boundary("stem_pool")
        stages = [
            ("res2", 3, (64, 64, 256), (1, 1)),
            ("res3", 4, (128, 128, 512), (2, 2)),
            ("res4", 6, (256, 256, 1024), (2, 2)),
            ("res5", 3, (512, 512, 2048), (2, 2)),
        ]
        for sname, blocks, filters, stride in stages:
            x = bottleneck(f"{sname}a", x, filters, stride, project=True)
            for i in range(1, blocks):
                x = bottleneck(f"{sname}{chr(ord('a') + i)}", x, filters,
                               (1, 1), project=False)
            gb.stage_boundary(x)  # stage end (res2c_out ... res5c_out)
        gb.add_layer("avgpool", GlobalPoolingLayer(), x)
        gb.add_layer("output", OutputLayer(n_in=2048,
                                           n_out=self.num_classes), "avgpool")
        gb.set_outputs("output")
        gb.set_input_types(InputType.convolutional(h, w, c))
        return gb.build()


@dataclasses.dataclass
class SqueezeNet(ZooModel):
    """zoo/model/SqueezeNet.java (reference ``:311``): fire modules (1x1
    squeeze, 1x1 and 3x3 expands merged on the channel axis) on
    ComputationGraph, dropout 0.5, a 1x1 conv to the classes, global
    average pooling, softmax."""

    def conf(self):
        h, w, c = self.input_shape
        gb = self._builder().graph_builder().add_inputs("input")

        def conv(n_out, k, **kw):
            return ConvolutionLayer(n_out=n_out, kernel_size=(k, k),
                                    activation="relu", **kw)

        def fire(name, inp, squeeze, expand):
            gb.add_layer(f"{name}_sq", conv(squeeze, 1), inp)
            gb.add_layer(f"{name}_e1", conv(expand, 1), f"{name}_sq")
            gb.add_layer(f"{name}_e3", conv(expand, 3), f"{name}_sq")
            gb.add_vertex(f"{name}_cat", MergeVertex(), f"{name}_e1",
                          f"{name}_e3")
            return f"{name}_cat"

        def pool(name, inp):
            gb.add_layer(name, SubsamplingLayer(kernel_size=(3, 3),
                                                stride=(2, 2)), inp)
            return name

        gb.add_layer("conv1", conv(64, 3, stride=(2, 2), padding="VALID"),
                     "input")
        x = pool("pool1", "conv1")
        x = fire("fire2", x, 16, 64)
        x = fire("fire3", x, 16, 64)
        x = pool("pool3", x)
        x = fire("fire4", x, 32, 128)
        x = fire("fire5", x, 32, 128)
        x = pool("pool5", x)
        x = fire("fire6", x, 48, 192)
        x = fire("fire7", x, 48, 192)
        x = fire("fire8", x, 64, 256)
        x = fire("fire9", x, 64, 256)
        gb.add_layer("drop9", DropoutLayer(rate=0.5), x)
        gb.add_layer("conv10", conv(self.num_classes, 1), "drop9")
        gb.add_layer("gap", GlobalPoolingLayer(), "conv10")
        gb.add_layer("output", OutputLayer(n_in=self.num_classes,
                                           n_out=self.num_classes), "gap")
        gb.set_outputs("output")
        gb.set_input_types(InputType.convolutional(h, w, c))
        return gb.build()


@dataclasses.dataclass
class Xception(ZooModel):
    """zoo/model/Xception.java (reference ``:389``): entry flow (two convs,
    three residual blocks of two separable convs and a 3x3/2 max-pool
    beside a 1x1/2 projection), ``middle_repeats`` residual blocks of three
    separable convs at 728 channels, exit flow; batchnorm after every conv,
    global average pooling, softmax. The input defaults to the zoo's
    224x224x3, as in the reference; the published form is 299x299x3
    (``input_shape=(299, 299, 3)``). With 8 middle repeats: 34
    SeparableConvolution2D and 6 ConvolutionLayer nodes, 74 conv launches
    a forward, 22,855,952 params at 1000 classes."""

    middle_repeats: int = 8

    def conf(self):
        h, w, c = self.input_shape
        gb = self._builder().graph_builder().add_inputs("input")

        def conv_bn(name, inp, n_out, k, stride=(1, 1), relu=True):
            gb.add_layer(f"{name}_conv",
                         ConvolutionLayer(n_out=n_out, kernel_size=(k, k),
                                          stride=stride, has_bias=False),
                         inp)
            gb.add_layer(f"{name}_bn", BatchNormalization(), f"{name}_conv")
            if relu:
                gb.add_layer(f"{name}_relu",
                             ActivationLayer(activation="relu"),
                             f"{name}_bn")
                return f"{name}_relu"
            return f"{name}_bn"

        def sep_bn(name, inp, n_out, relu_before=True):
            src = inp
            if relu_before:
                gb.add_layer(f"{name}_prerelu",
                             ActivationLayer(activation="relu"), inp)
                src = f"{name}_prerelu"
            gb.add_layer(f"{name}_sep",
                         SeparableConvolution2D(n_out=n_out,
                                                kernel_size=(3, 3),
                                                has_bias=False), src)
            gb.add_layer(f"{name}_bn", BatchNormalization(), f"{name}_sep")
            return f"{name}_bn"

        def pool_add(name, b, sc):
            gb.add_layer(f"{name}_pool",
                         SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2),
                                          padding="SAME"), b)
            gb.add_vertex(f"{name}_add", ElementWiseVertex(op="add"),
                          f"{name}_pool", sc)
            return f"{name}_add"

        x = conv_bn("stem1", "input", 32, 3, stride=(2, 2))
        x = conv_bn("stem2", x, 64, 3)
        for i, n_out in enumerate((128, 256, 728)):  # entry flow
            sc = conv_bn(f"entry{i}_sc", x, n_out, 1, stride=(2, 2),
                         relu=False)
            b = sep_bn(f"entry{i}_s1", x, n_out, relu_before=i > 0)
            b = sep_bn(f"entry{i}_s2", b, n_out)
            x = pool_add(f"entry{i}", b, sc)
        for r in range(self.middle_repeats):  # middle flow
            b = x
            for j in range(3):
                b = sep_bn(f"mid{r}_s{j}", b, 728)
            gb.add_vertex(f"mid{r}_add", ElementWiseVertex(op="add"), b, x)
            x = f"mid{r}_add"
        sc = conv_bn("exit_sc", x, 1024, 1, stride=(2, 2), relu=False)
        b = sep_bn("exit_s1", x, 728)
        b = sep_bn("exit_s2", b, 1024)
        x = pool_add("exit", b, sc)
        b = sep_bn("exit_s3", x, 1536, relu_before=False)
        gb.add_layer("exit_relu3", ActivationLayer(activation="relu"), b)
        b = sep_bn("exit_s4", "exit_relu3", 2048, relu_before=False)
        gb.add_layer("exit_relu4", ActivationLayer(activation="relu"), b)
        gb.add_layer("gap", GlobalPoolingLayer(), "exit_relu4")
        gb.add_layer("output", OutputLayer(n_in=2048,
                                           n_out=self.num_classes), "gap")
        gb.set_outputs("output")
        gb.set_input_types(InputType.convolutional(h, w, c))
        return gb.build()


@dataclasses.dataclass
class InceptionResNetV1(ZooModel):
    """zoo/model/InceptionResNetV1.java (reference ``:559``), the FaceNet
    embedding network: stem, 5 x block35, reduction A, 10 x block17,
    reduction B, 5 x block8 (each a merge of branches, a 1x1 up-projection
    scaled and added to its input), global average pooling, a 128-d
    L2-normalized embedding and a softmax head; 160x160x3 input."""

    input_shape: Tuple[int, int, int] = (160, 160, 3)
    embedding_size: int = 128

    def conf(self):
        h, w, c = self.input_shape
        gb = self._builder().graph_builder().add_inputs("input")
        uid = [0]

        def conv_bn(inp, n_out, k, stride=(1, 1), pad="SAME", relu=True):
            uid[0] += 1
            name = f"cb{uid[0]}"
            gb.add_layer(f"{name}_c", ConvolutionLayer(
                n_out=n_out, kernel_size=(k, k) if isinstance(k, int) else k,
                stride=stride, padding=pad, has_bias=False), inp)
            gb.add_layer(f"{name}_b", BatchNormalization(), f"{name}_c")
            if not relu:
                return f"{name}_b"
            gb.add_layer(f"{name}_r", ActivationLayer(activation="relu"),
                         f"{name}_b")
            return f"{name}_r"

        def residual(prefix, inp, branches, up, scale):
            uid[0] += 1
            name = f"{prefix}{uid[0]}"
            gb.add_vertex(f"{name}_cat", MergeVertex(), *branches(inp))
            u = conv_bn(f"{name}_cat", up, 1, relu=False)
            gb.add_vertex(f"{name}_scale", ScaleVertex(scale=scale), u)
            gb.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), inp,
                          f"{name}_scale")
            gb.add_layer(f"{name}_relu", ActivationLayer(activation="relu"),
                         f"{name}_add")
            return f"{name}_relu"

        def block35(inp):  # Inception-ResNet-A
            return residual("a", inp, lambda i: (
                conv_bn(i, 32, 1),
                conv_bn(conv_bn(i, 32, 1), 32, 3),
                conv_bn(conv_bn(conv_bn(i, 32, 1), 32, 3), 32, 3)),
                256, 0.17)

        def block17(inp):  # Inception-ResNet-B
            return residual("b", inp, lambda i: (
                conv_bn(i, 128, 1),
                conv_bn(conv_bn(conv_bn(i, 128, 1), 128, (1, 7)), 128,
                        (7, 1))), 896, 0.10)

        def block8(inp):  # Inception-ResNet-C
            return residual("c", inp, lambda i: (
                conv_bn(i, 192, 1),
                conv_bn(conv_bn(conv_bn(i, 192, 1), 192, (1, 3)), 192,
                        (3, 1))), 1792, 0.20)

        def pool(name, inp):
            gb.add_layer(name, SubsamplingLayer(kernel_size=(3, 3),
                                                stride=(2, 2)), inp)
            return name

        x = conv_bn("input", 32, 3, stride=(2, 2))  # stem
        x = conv_bn(x, 32, 3, pad="VALID")
        x = conv_bn(x, 64, 3)
        x = conv_bn(pool("stem_pool", x), 80, 1)
        x = conv_bn(x, 192, 3, pad="VALID")
        x = conv_bn(x, 256, 3, stride=(2, 2))
        for _ in range(5):
            x = block35(x)
        ra0 = conv_bn(x, 384, 3, stride=(2, 2), pad="VALID")  # reduction A
        ra1 = conv_bn(conv_bn(conv_bn(x, 192, 1), 192, 3), 256, 3,
                      stride=(2, 2), pad="VALID")
        gb.add_vertex("redA", MergeVertex(), ra0, ra1, pool("redA_pool", x))
        x = "redA"
        for _ in range(10):
            x = block17(x)
        rb0 = conv_bn(conv_bn(x, 256, 1), 384, 3, stride=(2, 2),
                      pad="VALID")  # reduction B
        rb1 = conv_bn(conv_bn(x, 256, 1), 256, 3, stride=(2, 2), pad="VALID")
        rb2 = conv_bn(conv_bn(conv_bn(x, 256, 1), 256, 3), 256, 3,
                      stride=(2, 2), pad="VALID")
        gb.add_vertex("redB", MergeVertex(), rb0, rb1, rb2,
                      pool("redB_pool", x))
        x = "redB"
        for _ in range(5):
            x = block8(x)
        gb.add_layer("gap", GlobalPoolingLayer(), x)
        gb.add_layer("embedding", DenseLayer(n_in=1792,
                                             n_out=self.embedding_size),
                     "gap")
        gb.add_vertex("embed_norm", L2NormalizeVertex(), "embedding")
        gb.add_layer("output", OutputLayer(n_in=self.embedding_size,
                                           n_out=self.num_classes),
                     "embed_norm")
        gb.set_outputs("output")
        gb.set_input_types(InputType.convolutional(h, w, c))
        return gb.build()


@dataclasses.dataclass
class FaceNetNN4Small2(ZooModel):
    """zoo/model/FaceNetNN4Small2.java (reference ``:665``), OpenFace's
    nn4.small2: a 7x7/2 stem, the inception modules 3a/3b/3c/4a/4e/5a/5b
    (1x1, reduced 3x3, reduced 5x5 and pool-projection branches merged; a
    branch of 0 channels left out), global average pooling, a 128-d
    L2-normalized embedding and a softmax head; 96x96x3 input."""

    input_shape: Tuple[int, int, int] = (96, 96, 3)
    embedding_size: int = 128

    def conf(self):
        h, w, c = self.input_shape
        gb = self._builder().graph_builder().add_inputs("input")
        uid = [0]

        def conv_bn(inp, n_out, k, stride=(1, 1), pad="SAME"):
            uid[0] += 1
            name = f"f{uid[0]}"
            gb.add_layer(f"{name}_c", ConvolutionLayer(
                n_out=n_out, kernel_size=(k, k) if isinstance(k, int) else k,
                stride=stride, padding=pad, has_bias=False), inp)
            gb.add_layer(f"{name}_b", BatchNormalization(), f"{name}_c")
            gb.add_layer(f"{name}_r", ActivationLayer(activation="relu"),
                         f"{name}_b")
            return f"{name}_r"

        def inception(inp, c1, r3, c3, r5, c5, pool_proj, stride=(1, 1)):
            uid[0] += 1
            name = f"inc{uid[0]}"
            branches = []
            if c1:
                branches.append(conv_bn(inp, c1, 1))
            if c3:
                branches.append(conv_bn(conv_bn(inp, r3, 1), c3, 3,
                                        stride=stride))
            if c5:
                branches.append(conv_bn(conv_bn(inp, r5, 1), c5, 5,
                                        stride=stride))
            pname = f"{name}_pool"
            gb.add_layer(pname, SubsamplingLayer(
                kernel_size=(3, 3), stride=stride, padding="SAME"), inp)
            branches.append(conv_bn(pname, pool_proj, 1)
                            if pool_proj else pname)
            gb.add_vertex(name, MergeVertex(), *branches)
            return name

        def pool(name, inp):
            gb.add_layer(name, SubsamplingLayer(
                kernel_size=(3, 3), stride=(2, 2), padding="SAME"), inp)
            return name

        x = conv_bn("input", 64, 7, stride=(2, 2))
        x = conv_bn(pool("p1", x), 64, 1)
        x = conv_bn(x, 192, 3)
        x = inception(pool("p2", x), 64, 96, 128, 16, 32, 32)   # 3a
        x = inception(x, 64, 96, 128, 32, 64, 64)              # 3b
        x = inception(x, 0, 128, 256, 32, 64, 0, stride=(2, 2))  # 3c
        x = inception(x, 256, 96, 192, 32, 64, 128)            # 4a
        x = inception(x, 0, 160, 256, 64, 128, 0, stride=(2, 2))  # 4e
        x = inception(x, 256, 96, 384, 0, 0, 96)               # 5a
        x = inception(x, 256, 96, 384, 0, 0, 96)               # 5b
        gb.add_layer("gap", GlobalPoolingLayer(pooling_type="avg"), x)
        gb.add_layer("embedding", DenseLayer(n_in=736,
                                             n_out=self.embedding_size),
                     "gap")
        gb.add_vertex("embed_norm", L2NormalizeVertex(), "embedding")
        gb.add_layer("output", OutputLayer(n_in=self.embedding_size,
                                           n_out=self.num_classes),
                     "embed_norm")
        gb.set_outputs("output")
        gb.set_input_types(InputType.convolutional(h, w, c))
        return gb.build()


@dataclasses.dataclass
class TextGenerationLSTM(ZooModel):
    """zoo/model/TextGenerationLSTM.java, the char-RNN (reference
    ``zoo/models.py:451``): two stacked LSTMs and a per-timestep softmax
    over the characters, dropout on the second LSTM's and the output
    layer's inputs. Input (B, T, vocab) one-hot; output the per-step
    distribution."""

    total_unique_characters: int = 47
    units: int = 256
    dropout: float = 0.2
    max_length: int = 40

    def conf(self):
        v = self.total_unique_characters
        lb = self._builder().list()
        lb.layer(LSTM(n_in=v, n_out=self.units))
        lb.layer(LSTM(n_in=self.units, n_out=self.units,
                      dropout=self.dropout))
        lb.layer(RnnOutputLayer(n_in=self.units, n_out=v, loss="mcxent",
                                activation="softmax", dropout=self.dropout))
        lb.set_input_type(InputType.recurrent(v, self.max_length))
        return lb.build()
