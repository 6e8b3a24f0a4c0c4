"""deeplearning4j_tpu_torch — the PyTorch/CUDA port of ``deeplearning4j_tpu``.

The JAX package beside it is the reference; this package mirrors its module
paths and class names (``nn/computation_graph.py::ComputationGraph``,
``zoo/models.py::ResNet50``, ``serving/server.py::ModelServer``, ...) so a
reader finds each counterpart, and keeps the reference's layouts at every
public function: NHWC activations, HWIO conv weights, and the same
param/state dict keys per node.

Every TPU kernel on a ported path is a hand-written Hopper kernel here
(``csrc/``, built with ``nvcc`` on first use by ``ops/kernels/_build.py``)
with a plain PyTorch version beside it. Entry points run on CUDA unless the
caller passes ``device="cpu"``; with no GPU and no explicit device they
raise instead of drifting to the CPU.

This package imports ``torch``, numpy and the standard library only — never
``jax`` and nothing of ``deeplearning4j_tpu``.

Ported so far: ResNet-50 classify serving (ops, layers, conf JSON,
ComputationGraph inference, bucketing, the batching scheduler, router and
HTTP server) on the conv forward kernel, and ResNet-50 training
(``ComputationGraph.fit``: training batchnorm, softmax cross-entropy, the
updaters and schedules, the conv backward on the dgrad and wgrad kernels),
BERT-base classify serving (the attention ops on the flash-attention
forward kernel, the transformer layers, MultiLayerNetwork inference and
its conf JSON, ``zoo.Bert``), and the char-RNN (``zoo.TextGenerationLSTM``:
the LSTM layer on the fused LSTM cell kernel, ``RnnOutputLayer``, dropout,
``MultiLayerNetwork.fit`` with truncated BPTT and ``rnn_time_step``), and
LeNet-5's training and evaluation loop (``zoo.LeNet`` on the conv kernels;
``data``'s iterators, MNIST and normalizers; ``score``, ``evaluate`` and
``evaluate_regression``; ``eval``; ``nn.listeners`` with the coalescing
dispatcher; ``earlystopping``; every loss of the reference), and BERT-base
training (the flash-attention backward as an autograd Function around the
forward kernel, the encoder's dropout, ``nlp``'s tokenizers and
``BertIterator``, ``nn.transfer``'s frozen layers and transfer builder,
``nn.attention``'s attention layers), the recurrent slice, and the
compiled step (``nn/capture.py``: each train step, TBPTT segment and
forward captured as a CUDA graph per shape signature, ``warmup``,
``util/compile_watcher.py``). See ROADMAP.md for what is next.
"""

__version__ = "0.1.0"
