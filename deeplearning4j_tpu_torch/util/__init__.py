"""Cross-cutting utilities (counterpart of deeplearning4j_tpu/util): the
compile watcher, the persistent compile cache and the AOT store, remat
policies (``xla_tuning``), ModelSerializer archives and sharded
checkpoints, the profiler, health monitors, stats storage, cost model,
telemetry and fault injection. Not here yet: ``packed`` (item 13)."""

from deeplearning4j_tpu_torch.util.checkpoint import (FaultTolerantTrainer,
                                                      ShardedCheckpointer,
                                                      ShardedCheckpointListener)
from deeplearning4j_tpu_torch.util import xla_tuning  # noqa: F401
from deeplearning4j_tpu_torch.util.aot_store import AotStore
from deeplearning4j_tpu_torch.util.compile_cache import (
    cache_entries, clear_persistent_cache, disable_persistent_cache,
    enable_persistent_cache)
from deeplearning4j_tpu_torch.util.compile_watcher import (CompileScope,
                                                           CompileWatcher,
                                                           get_watcher,
                                                           note_trace)
from deeplearning4j_tpu_torch.util.model_serializer import ModelSerializer
from deeplearning4j_tpu_torch.util.profiler import (NaNPanicError,
                                                    OpProfiler,
                                                    ProfilerConfig,
                                                    StepTimer,
                                                    check_numerics,
                                                    device_trace)
from deeplearning4j_tpu_torch.util.stats import (CrashReportingUtil,
                                                 FileStatsStorage,
                                                 InMemoryStatsStorage,
                                                 StatsListener, to_csv)
from deeplearning4j_tpu_torch.util import cost_model  # noqa: F401
from deeplearning4j_tpu_torch.util import telemetry  # noqa: F401
from deeplearning4j_tpu_torch.util.cost_model import CostReport, CostRow
from deeplearning4j_tpu_torch.util.faults import (FaultInjector,
                                                  RetryExhaustedError,
                                                  RetryPolicy, get_injector)
from deeplearning4j_tpu_torch.util.telemetry import Telemetry, get_telemetry



def __getattr__(name):
    # util/health.py subclasses nn.listeners' TrainingListener, so importing
    # it imports the nn package; done lazily, so the op modules that import
    # util.cost_model leave the op table's registration order as it was
    if name in ("RollbackSignal", "TrainingHealthMonitor"):
        from deeplearning4j_tpu_torch.util import health

        return getattr(health, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ModelSerializer", "ShardedCheckpointer", "ShardedCheckpointListener",
    "FaultTolerantTrainer", "OpProfiler", "ProfilerConfig", "StepTimer",
    "NaNPanicError", "check_numerics", "device_trace", "CrashReportingUtil",
    "FileStatsStorage", "InMemoryStatsStorage", "StatsListener", "to_csv",
    "xla_tuning", "CompileWatcher", "CompileScope", "get_watcher",
    "note_trace", "enable_persistent_cache", "disable_persistent_cache",
    "clear_persistent_cache", "cache_entries", "AotStore", "telemetry", "Telemetry", "get_telemetry", "TrainingHealthMonitor",
    "cost_model", "CostReport", "CostRow",
    "RetryPolicy", "RetryExhaustedError", "FaultInjector", "get_injector",
    "RollbackSignal",
]
