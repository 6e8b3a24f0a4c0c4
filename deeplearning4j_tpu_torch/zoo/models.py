"""Zoo models (counterpart of deeplearning4j_tpu/zoo/models.py): ResNet-50
on ComputationGraph, the same graph node for node, with NHWC layout, and
LeNet-5 and the char-RNN TextGenerationLSTM on MultiLayerNetwork.
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
                                                DenseLayer,
                                                GlobalPoolingLayer,
                                                OutputLayer, SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.recurrent import LSTM, RnnOutputLayer
from deeplearning4j_tpu_torch.nn.vertices import ElementWiseVertex

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
class ResNet50(ZooModel):
    """zoo/model/ResNet50.java — the repo's flagship model. ResNet-v1
    bottleneck layout (stride on the first 1x1, as in the reference/Keras),
    NHWC. ``remat_policy``/``stage_barriers`` and the residual-stage
    boundaries (stem, res2-res5) are recorded in the config for the
    training slice."""

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
