"""Device resolution for the port's entry points (no counterpart in the
JAX package, where the backend is process-global).

Entry points (``ComputationGraph.init``, ``ZooModel.init``,
``interop.from_reference_json``) take ``device=``. ``None`` means the
current CUDA device; without one they raise rather than fall back to the
CPU, so a run on the wrong machine fails loudly. The CPU is reached only
by asking for it (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device (raises without one); anything
    else is taken as given, and a CUDA device must exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: pass device='cpu' to run on the "
                "CPU explicitly")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


def as_tensor(x, device) -> torch.Tensor:
    """numpy or tensor -> tensor on ``device``; float64 becomes float32,
    as ``jnp.asarray`` does with x64 off."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    if t.dtype == torch.float64:
        t = t.to(torch.float32)
    return t.to(device)
