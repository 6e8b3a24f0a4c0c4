"""Cross-cutting utilities (counterpart of deeplearning4j_tpu/util): the
compile watcher, ModelSerializer archives and sharded checkpoints."""

from deeplearning4j_tpu_torch.util.checkpoint import (FaultTolerantTrainer,
                                                      ShardedCheckpointer,
                                                      ShardedCheckpointListener)
from deeplearning4j_tpu_torch.util.compile_watcher import (CompileScope,
                                                           CompileWatcher,
                                                           get_watcher,
                                                           note_trace)
from deeplearning4j_tpu_torch.util.model_serializer import ModelSerializer

__all__ = ["CompileWatcher", "CompileScope", "FaultTolerantTrainer",
           "ModelSerializer", "ShardedCheckpointListener",
           "ShardedCheckpointer", "get_watcher", "note_trace"]
