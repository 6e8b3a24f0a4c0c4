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

The reference's other variables (compute dtype, remat policy, sync_every,
kernel dispatch, fused update, gradient compression, pipeline stages,
tuning database, compilation cache, OpProfiler and NaN panic) are added
with the ROADMAP items that port the code reading them; the port's kernel
dispatch reads its own ``DL4J_TORCH_KERNEL_IMPL``.
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

    def _apply(self) -> "Environment":
        """Set the logger level and the telemetry switch to match the
        flags."""
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

        # unified telemetry switch: the module reads DL4J_TPU_TELEMETRY
        # itself at singleton creation; the setter keeps them in sync at
        # runtime. Only push when THIS flag changed — an unrelated setter
        # (set_debug etc.) must not clobber a direct telemetry.set_enabled()
        if self.telemetry != getattr(self, "_telemetry_applied", None):
            from deeplearning4j_tpu_torch.util import telemetry as _telemetry

            _telemetry.set_enabled(self.telemetry)
            self._telemetry_applied = self.telemetry
        return self


def get_environment() -> Environment:
    """``Nd4j.getEnvironment()`` parity."""
    return Environment.get_instance()
