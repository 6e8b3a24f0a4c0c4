"""Random ops of the port (counterpart of deeplearning4j_tpu/ops/random.py):
dropout, the one on the ported training paths.

The reference draws from explicit JAX keys; the port draws from an explicit
``torch.Generator`` the caller owns (a network makes one at ``init``,
seeded from ``conf.seed`` on its device). The two give different bits from
the same seed, so a test compares statistics, never masks.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.ops.registry import op


@op("dropout", "random")
def dropout(x, gen, rate, training=True):
    """Inverted dropout (the reference's ``dropout``, ``:89``): each element
    kept with probability ``1 - rate`` and scaled by ``1 / (1 - rate)``,
    the rest set to 0, so the expectation is kept; identity when not
    training or at rate 0. ``gen`` is a ``torch.Generator`` on x's
    device."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=gen, device=x.device)
    return torch.where(u < keep, x / keep, 0.0).to(x.dtype)
