"""Loss functions by DL4J name (counterpart of deeplearning4j_tpu/nn/losses.py,
the ``LossFunctions.LossFunction`` enum).

Each entry is ``(loss_from_logits_fn | None, loss_from_activations_fn,
fused_activation | None)``: an output layer whose activation matches the
fused pair computes the loss from its logits (softmax + MCXENT in one
log-softmax), else from its activations.

Ported: the softmax + cross-entropy pair (``mcxent``,
``negativeloglikelihood``), the losses of the ResNet-50 training slice. The
reference's other losses (xent, mse, l1/l2, kl_divergence, cosine, hinge,
poisson, huber, sparse_mcxent) need loss ops the port has not registered
yet; :func:`resolve` raises for them, naming the slice that brings them.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.ops import nn as nnops

#: the reference's losses the port does not have yet
_LATER = ("xent", "mse", "l2", "l1", "mean_absolute_error", "kl_divergence",
          "cosine_proximity", "hinge", "squared_hinge", "poisson", "huber",
          "sparse_mcxent")


def mcxent_logits(logits, labels, weights=None):
    return nnops.softmax_cross_entropy(logits, labels, weights)


def mcxent_probs(probs, labels, eps=1e-7, weights=None):
    """MCXENT on probabilities clipped to [eps, 1]; the weighted form
    multiplies by the reciprocal weight sum, as ``_weighted_mean``."""
    p = torch.clamp(probs, eps, 1.0)
    per = -(labels * torch.log(p)).sum(dim=-1)
    return nnops._weighted_mean(per, weights)


_LOSSES = {
    "mcxent": (mcxent_logits, mcxent_probs, "softmax"),
    "negativeloglikelihood": (mcxent_logits, mcxent_probs, "softmax"),
}


def resolve(name: str):
    """-> (logits_fn | None, activations_fn | None, fused_activation | None)."""
    key = name.lower()
    if key in _LATER:
        raise NotImplementedError(
            f"loss {name!r} is not ported yet: it comes with the "
            "MultiLayerNetwork/LeNet slice and the rest of the conv zoo "
            "(ROADMAP Queue 1 items 3-4), with the loss ops it needs")
    if key not in _LOSSES:
        raise ValueError(f"Unknown loss function: {name!r} "
                         f"(have {sorted(_LOSSES)})")
    return _LOSSES[key]


def available() -> list:
    return sorted(_LOSSES)
