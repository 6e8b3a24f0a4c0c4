"""Single-process data parallelism (counterpart of
deeplearning4j_tpu/parallel, ROADMAP Queue 1 item 10a): ``TrainingMesh``,
the lane half of ``gspmd``, ``EncodedGradientsAccumulator`` with the
threshold algorithms, ``GradCompressor``, ``ParallelWrapper`` and
``ParallelInference``, the training masters and the Spark facade.

The reference runs its worker axis as a vmapped lane axis of one program;
on one device that axis runs unpartitioned. The port keeps that one-device
form: R lanes, one after another on the device's stream, each the
network's own training forward and backward on its slice of the padded
batch, combined by a deterministic pairwise tree (or an encoded,
error-feedback exchange), then one update.

Not here: ``distributed``, ``elastic``, ``pipeline``, ``pipelined`` and
``ring`` (process groups and NCCL/gloo ranks, the elastic trainer, the
GPipe pipeline, ring attention), and ZeRO placement and tensor sharding:
everything that needs more than one device or process is ROADMAP item
10b; a mesh of more than one device raises ``NotImplementedError`` naming
it.
"""

from deeplearning4j_tpu_torch.parallel import gspmd  # noqa: F401
from deeplearning4j_tpu_torch.parallel.accumulator import (  # noqa: F401
    AdaptiveThresholdAlgorithm, EncodedGradientsAccumulator,
    FixedThresholdAlgorithm, ResidualClippingPostProcessor,
    TargetSparsityThresholdAlgorithm)
from deeplearning4j_tpu_torch.parallel.compression import \
    GradCompressor  # noqa: F401
from deeplearning4j_tpu_torch.parallel.masters import (  # noqa: F401
    ParameterAveragingTrainingMaster, SharedTrainingMaster,
    SparkComputationGraph, SparkDl4jMultiLayer)
from deeplearning4j_tpu_torch.parallel.mesh import TrainingMesh  # noqa: F401
from deeplearning4j_tpu_torch.parallel.wrapper import (  # noqa: F401
    ParallelInference, ParallelWrapper)
