"""Runtime environment flags (Nd4jEnvironmentVars / native Environment
parity): the port's copy of the part of deeplearning4j_tpu/config.py that
the port acts on.

Recognized variables:

- ``DL4J_TPU_DEBUG``, ``DL4J_TPU_VERBOSE`` — DEBUG-level logging on the
  'deeplearning4j_tpu_torch' logger (SD_DEBUG / SD_VERBOSE).
- ``DL4J_TPU_ETL_WORKERS`` — worker-process count of the multiprocess
  TransformProcess executor (``datavec/executor.py``); 0/unset = one per
  host core, capped at 8.
- ``DL4J_TPU_BUCKETS`` — default shape-bucketing spec of new configs
  (``"pow2"`` | ``"batch=8,16,32;seq=pow2"``; ``data/bucketing.py``
  ``BucketingPolicy.from_spec``, read by ``nn/conf.py``'s builder).
- ``DL4J_TPU_TELEMETRY`` — the telemetry registry's switch
  (``util/telemetry.py``); default on, 0/false strips every recording hook.
- ``DL4J_TPU_FAULTS`` — armed injectable faults, ``"kind[@step][:arg]"``
  pairs (``util/faults.py`` parses it; kept here so a dump shows it).
- ``DL4J_TPU_TRACE_SAMPLE`` — the serving tier's request-trace
  head-sampling keep fraction in [0, 1] (``serving/scheduler.py``
  ``trace_sample_rate`` parses it): the share of healthy requests whose
  queue-wait, batch-fill and compute spans land on the merged trace;
  slow, shed and failed requests are always kept, ``0`` turns request
  tracing off. Unset = 0.02. The flight recorder records every request
  whatever it says.
- ``DL4J_TPU_AFFINITY_HEAD`` — the prompt-head length (tokens) the fleet
  router hashes for prefix affinity (``serving/fleet.py``
  ``default_affinity_head`` reads it); unset = 16, 0 turns affinity off.
- ``DL4J_TPU_PROFILING`` — install the OpProfiler (``util/profiler.py``)
  on ``exec_op`` when the package is imported (profiling mode).
- ``DL4J_TPU_NAN_PANIC`` — the same hook raises ``NaNPanicError`` on a NaN
  or Inf op output (ProfilerConfig.nanPanic).
- ``DL4J_TPU_TUNING_DB`` — directory of the tuning database
  (``tuning/database.py``): measured winners keyed by (op, shape
  signature, dtype, backend, topology), consulted by ``auto`` kernel
  dispatch on CUDA tensors. Unset = off: ``auto`` takes the kernel on a
  CUDA tensor and the plain version on a CPU one.
- ``DL4J_TPU_REMAT_POLICY`` — default ``remat_policy`` of new configs (a
  policy registered in ``util/xla_tuning.py``). Unset: an armed tuning
  database's conf-default winner, else none.
- ``DL4J_TPU_COMPUTE_DTYPE`` — default ``compute_dtype`` of new configs
  (``float32`` | ``bfloat16``; unset = float32).
- ``DL4J_TPU_SYNC_EVERY`` — default listener window ``sync_every`` of new
  configs (>= 1; unset = 1).
- ``DL4J_TPU_FUSED_UPDATE`` — default ``fused_update`` of new configs (the
  fused optimizer step, ``nn/updaters.py`` ``FusedUpdateEngine``).
- ``DL4J_TPU_GRAD_COMPRESSION`` — default ``grad_compression`` of new
  configs ("none" | "threshold" | "bitmap" | "onebit";
  ``parallel/compression.py``), validated by the conf builder: a
  ``ParallelWrapper`` fit then runs the encoded gradient exchange.
- ``DL4J_TPU_PIPE_STAGES`` — default ``pipe_stages`` of new configs
  (``parallel/pipelined.py``): ``PipelinedTrainer`` partitions the network
  into that many stages at its ``stage_boundary()`` marks. 0/unset = off;
  a network's own ``fit`` ignores it.
- ``DL4J_TPU_COMPILE_CACHE`` — directory of the persistent kernel-library
  cache (``util/compile_cache.py``), applied once when the environment is
  first read: a process loads the kernel library built there by an
  earlier one instead of running nvcc.
- ``DL4J_TPU_PEAK_FLOPS`` — the card's peak FLOP/s, a bare number or a
  per-dtype table (``bf16=9.89e14,fp32=6.7e13``); enables MFU in
  ``net.cost_report()``, the ``/costs`` route and the
  ``train.model_flops_utilization`` gauge (``util/cost_model.py``). Unset =
  no MFU: no peak is ever assumed.

The reference's kernel-dispatch variable has no counterpart here: the
port's kernel dispatch reads its own ``DL4J_TORCH_KERNEL_IMPL``.
"""

from __future__ import annotations

import os
from typing import Optional


def _env_bool(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


def _env_int(name: str, default: int, floor: int = 0) -> int:
    v = os.environ.get(name)
    if v is None or not v.strip():
        return default
    try:
        n = int(v.strip())
    except ValueError:
        raise ValueError(f"{name} must be an integer, got {v!r}") from None
    if n < floor:
        raise ValueError(f"{name} must be >= {floor}, got {n}")
    return n


class Environment:
    """Mutable runtime-flag singleton (Nd4j.getEnvironment() parity)."""

    _instance: Optional["Environment"] = None

    def __init__(self):
        self.debug = _env_bool("DL4J_TPU_DEBUG")
        self.verbose = _env_bool("DL4J_TPU_VERBOSE")
        self.etl_workers = _env_int("DL4J_TPU_ETL_WORKERS", 0, floor=0)
        self.default_buckets = os.environ.get("DL4J_TPU_BUCKETS") or None
        self.telemetry = _env_bool("DL4J_TPU_TELEMETRY", default=True)
        self.fault_spec = os.environ.get("DL4J_TPU_FAULTS") or None
        # the authoritative parses are serving.scheduler.trace_sample_rate
        # and serving.fleet.default_affinity_head (read live, per request
        # and per router); kept here so a dump shows them
        self.trace_sample = os.environ.get("DL4J_TPU_TRACE_SAMPLE") or None
        self.affinity_head = os.environ.get("DL4J_TPU_AFFINITY_HEAD") or None
        self.profiling = _env_bool("DL4J_TPU_PROFILING")
        self.nan_panic = _env_bool("DL4J_TPU_NAN_PANIC")
        # the authoritative read is tuning.database.database_dir(); kept
        # here so a crash dump shows the knob
        self.tuning_db_dir = os.environ.get("DL4J_TPU_TUNING_DB") or None
        self.default_remat_policy = (
            os.environ.get("DL4J_TPU_REMAT_POLICY") or None)
        if self.default_remat_policy == "none":
            self.default_remat_policy = None
        self.default_compute_dtype = os.environ.get(
            "DL4J_TPU_COMPUTE_DTYPE", "float32")
        self.default_sync_every = _env_int("DL4J_TPU_SYNC_EVERY", 1, floor=1)
        self.default_fused_update = _env_bool("DL4J_TPU_FUSED_UPDATE")
        # validated by the conf builder, so a typo fails at config build
        self.default_grad_compression = (
            os.environ.get("DL4J_TPU_GRAD_COMPRESSION") or None)
        # pipeline parallelism (parallel/pipelined.py): stage count of new
        # configs; 0 = off
        self.default_pipe_stages = _env_int("DL4J_TPU_PIPE_STAGES", 0,
                                            floor=0)
        self.compile_cache_dir = (
            os.environ.get("DL4J_TPU_COMPILE_CACHE") or None)
        self._compile_cache_applied = False
        self._profiler = None

    @classmethod
    def get_instance(cls) -> "Environment":
        if cls._instance is None:
            cls._instance = Environment()
            cls._instance._apply()
        return cls._instance

    # -- setters mirroring Nd4j.getEnvironment().setDebug/setVerbose ---------
    def set_debug(self, v: bool) -> "Environment":
        self.debug = v
        return self._apply()

    def set_verbose(self, v: bool) -> "Environment":
        self.verbose = v
        return self._apply()

    def set_telemetry(self, v: bool) -> "Environment":
        self.telemetry = v
        return self._apply()

    def set_profiling(self, v: bool) -> "Environment":
        self.profiling = v
        return self._apply()

    def set_nan_panic(self, v: bool) -> "Environment":
        self.nan_panic = v
        return self._apply()

    def _apply(self) -> "Environment":
        """Set the logger level, the telemetry switch and the OpProfiler
        hook to match the flags."""
        import logging

        # only drive the logger level while a verbosity flag is ON; never
        # clobber an application's own configuration otherwise
        logger = logging.getLogger("deeplearning4j_tpu_torch")
        if self.verbose or self.debug:
            logger.setLevel(logging.DEBUG)
            self._set_logger_level = True
        elif getattr(self, "_set_logger_level", False):
            logger.setLevel(logging.NOTSET)
            self._set_logger_level = False

        # the persistent kernel-library cache, pointed at once (a later
        # enable_persistent_cache() call may re-point it)
        if self.compile_cache_dir and not self._compile_cache_applied:
            from deeplearning4j_tpu_torch.util.compile_cache import \
                enable_persistent_cache

            enable_persistent_cache(self.compile_cache_dir)
            self._compile_cache_applied = True

        # unified telemetry switch: the module reads DL4J_TPU_TELEMETRY
        # itself at singleton creation; the setter keeps them in sync at
        # runtime. Only push when THIS flag changed — an unrelated setter
        # (set_debug etc.) must not clobber a direct telemetry.set_enabled()
        if self.telemetry != getattr(self, "_telemetry_applied", None):
            from deeplearning4j_tpu_torch.util import telemetry as _telemetry

            _telemetry.set_enabled(self.telemetry)
            self._telemetry_applied = self.telemetry

        # the OpProfiler singleton: the flags own its hook only while one
        # of them asks for it, so a user-started profiler is never stopped
        # by an unrelated setter
        want_hook = self.profiling or self.nan_panic or self.debug
        if want_hook or self._profiler is not None:
            from deeplearning4j_tpu_torch.util.profiler import OpProfiler

            prof = OpProfiler.get_instance()
            if want_hook:
                prof.config.profile_ops = self.profiling or self.debug
                prof.config.check_for_nan = self.nan_panic
                prof.config.check_for_inf = self.nan_panic
                prof.start()
                self._profiler = prof
            else:
                prof.stop()
                self._profiler = None
        return self

    def profiler(self):
        return self._profiler


def get_environment() -> Environment:
    """``Nd4j.getEnvironment()`` parity."""
    return Environment.get_instance()
