"""Cross-cutting utilities (counterpart of deeplearning4j_tpu/util); so far
the compile watcher."""

from deeplearning4j_tpu_torch.util.compile_watcher import (CompileScope,
                                                           CompileWatcher,
                                                           get_watcher,
                                                           note_trace)

__all__ = ["CompileWatcher", "CompileScope", "get_watcher", "note_trace"]
