"""Parallel training and inference (counterpart of
deeplearning4j_tpu/parallel, ROADMAP Queue 1 items 10a and 10b's one-card
half): ``TrainingMesh``, the lane half of ``gspmd``,
``EncodedGradientsAccumulator`` with the threshold algorithms,
``GradCompressor``, ``ParallelWrapper`` and ``ParallelInference``, the
training masters and the Spark facade; the GPipe schedule (``pipeline``)
and ``PipelinedTrainer`` (``pipelined``); the elastic runtime
(``ElasticTrainer``, ``FileMembership``) and the ``torch.distributed``
bootstrap (``distributed``).

The reference runs its worker axis as a vmapped lane axis of one program;
on one device that axis runs unpartitioned. The port keeps that one-device
form: R lanes, one after another on the device's stream, each the
network's own training forward and backward on its slice of the padded
batch, combined by a deterministic pairwise tree (or an encoded,
error-feedback exchange), then one update. A pipelined step runs each
lane's stages over microbatches in the GPipe schedule, on one device.

Not here: ``ring`` (ring attention), ZeRO placement, tensor sharding, a
mesh of several devices and ranks as lanes over ``torch.distributed``:
everything that needs more than one device is ROADMAP item 10c; a mesh of
more than one device raises ``NotImplementedError`` naming it.
"""

from deeplearning4j_tpu_torch.parallel import distributed  # noqa: F401
from deeplearning4j_tpu_torch.parallel import gspmd  # noqa: F401
from deeplearning4j_tpu_torch.parallel.accumulator import (  # noqa: F401
    AdaptiveThresholdAlgorithm, EncodedGradientsAccumulator,
    FixedThresholdAlgorithm, ResidualClippingPostProcessor,
    TargetSparsityThresholdAlgorithm)
from deeplearning4j_tpu_torch.parallel.compression import \
    GradCompressor  # noqa: F401
from deeplearning4j_tpu_torch.parallel.elastic import (  # noqa: F401
    ElasticTrainer, FileMembership, MembershipError, MembershipView,
    bootstrap_elastic)
from deeplearning4j_tpu_torch.parallel.masters import (  # noqa: F401
    ParameterAveragingTrainingMaster, SharedTrainingMaster,
    SparkComputationGraph, SparkDl4jMultiLayer)
from deeplearning4j_tpu_torch.parallel.mesh import TrainingMesh  # noqa: F401
from deeplearning4j_tpu_torch.parallel.pipeline import (  # noqa: F401
    bubble_fraction, gpipe_scan, pipeline_forward, stack_stage_params)
from deeplearning4j_tpu_torch.parallel.pipelined import (  # noqa: F401
    PipelinedTrainer, stage_partition)
from deeplearning4j_tpu_torch.parallel.wrapper import (  # noqa: F401
    ParallelInference, ParallelWrapper)
