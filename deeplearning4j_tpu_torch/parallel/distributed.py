"""Multi-process bootstrap (counterpart of
deeplearning4j_tpu/parallel/distributed.py).

The reference wraps ``jax.distributed.initialize``: every process finds the
coordinator, learns its process id and sees the global device set. The
port's control plane is ``torch.distributed``: :func:`initialize` joins a
process group over ``tcp://<coordinator>`` with the ``gloo`` backend on the
CPU and ``nccl`` for CUDA, under :data:`BOOTSTRAP_RETRY`, so a worker that
the elastic supervisor restarts while the coordinator is still coming up
backs off instead of crash-looping.

    from deeplearning4j_tpu_torch.parallel import distributed
    distributed.initialize(coordinator="10.0.0.1:8476", num_processes=4,
                           process_id=host_idx)

On one process with no coordinator :func:`initialize` is a no-op, as in the
reference. :func:`global_mesh` over more than one process (ranks as lanes,
NCCL collectives) is ROADMAP item 10c; until then each process of an
elastic run steps its own replica (``parallel/elastic.py``).
"""

from __future__ import annotations

from datetime import timedelta
from typing import Optional

import torch

from deeplearning4j_tpu_torch.parallel.mesh import (TrainingMesh,
                                                    multi_device_error)
from deeplearning4j_tpu_torch.util.faults import RetryPolicy

_initialized = False

#: default handshake policy (reference ``:42``): workers racing the
#: coordinator's store coming up back off and retry, jittered so N
#: restarted workers do not re-dial in lockstep
BOOTSTRAP_RETRY = RetryPolicy(max_attempts=5, base_delay=1.0, max_delay=10.0,
                              deadline=120.0)

#: seconds one handshake waits for the coordinator's store
HANDSHAKE_TIMEOUT_S = 60.0


def default_backend(device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` otherwise."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, local_device_ids=None,
               retry: Optional[RetryPolicy] = BOOTSTRAP_RETRY) -> None:
    """Join the process group (reference ``:48``). ``coordinator``:
    ``"host:port"`` of process 0's store. No-op when already initialised,
    or single-process with no coordinator. The backend is
    :func:`default_backend` of ``local_device_ids[0]`` (a CUDA index), or
    gloo without one. Each handshake waits :data:`HANDSHAKE_TIMEOUT_S`
    and runs under ``retry``; ``retry=None`` tries once."""
    global _initialized
    if _initialized:
        return
    if coordinator is None and (num_processes is None or num_processes <= 1):
        return  # single process: nothing to bootstrap
    if coordinator is None:
        raise ValueError(f"num_processes={num_processes} needs a "
                         "coordinator address")
    world = int(num_processes or 1)
    rank = int(process_id or 0)
    backend = default_backend(f"cuda:{local_device_ids[0]}"
                              if local_device_ids else "cpu")
    dist = torch.distributed

    def handshake():
        if dist.is_initialized():
            return
        dist.init_process_group(
            backend=backend, init_method=f"tcp://{coordinator}",
            world_size=world, rank=rank,
            timeout=timedelta(seconds=HANDSHAKE_TIMEOUT_S))

    if retry is not None:
        retry.run(handshake, name="dcn_bootstrap",
                  retry_on=(RuntimeError, ConnectionError, OSError))
    else:
        handshake()
    _initialized = True


def shutdown() -> None:
    global _initialized
    if _initialized:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        _initialized = False


def _group_up() -> bool:
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return torch.distributed.get_rank() if _group_up() else 0


def process_count() -> int:
    return torch.distributed.get_world_size() if _group_up() else 1


def global_mesh(data: int = -1, model: int = 1, seq: int = 1,
                device=None) -> TrainingMesh:
    """The mesh over every process's devices (reference ``:104``): one
    process holds a one-device mesh on ``device``; more processes are
    ROADMAP item 10c."""
    n = process_count()
    if n > 1:
        raise multi_device_error(f"a global mesh over {n} processes")
    return TrainingMesh(data=1 if data <= 0 else data, model=model, seq=seq,
                        devices=None if device is None else [device])


def host_count() -> int:
    """The process count, 1 without a group (reference ``:113``)."""
    return process_count()


def is_coordinator() -> bool:
    """True on the process that writes checkpoints and logs (reference
    ``:122``)."""
    return process_index() == 0
