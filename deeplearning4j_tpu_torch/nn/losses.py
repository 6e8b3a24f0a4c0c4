"""Loss functions by DL4J name (counterpart of deeplearning4j_tpu/nn/losses.py,
the ``LossFunctions.LossFunction`` enum).

Each entry is ``(loss_from_logits_fn | None, loss_from_activations_fn |
None, fused_activation | None)``: an output layer whose activation matches
the fused pair computes the loss from its logits (softmax + MCXENT in one
log-softmax, sigmoid + XENT from the logits), else from its activations.
The loss ops are ``ops/nn.py``'s; every one takes ``weights`` by keyword.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.ops import nn as nnops


def mcxent_logits(logits, labels, weights=None):
    return nnops.softmax_cross_entropy(logits, labels, weights)


def mcxent_probs(probs, labels, eps=1e-7, weights=None):
    """MCXENT on probabilities clipped to [eps, 1]; the weighted form
    multiplies by the reciprocal weight sum, as ``_weighted_mean``."""
    p = torch.clamp(probs, eps, 1.0)
    per = -(labels * torch.log(p)).sum(dim=-1)
    return nnops._weighted_mean(per, weights)


def xent_logits(logits, labels, weights=None):
    return nnops.sigmoid_cross_entropy(logits, labels, weights)


def xent_probs(probs, labels, eps=1e-7, weights=None):
    return nnops.log_loss(probs, labels, eps, weights)


def sparse_mcxent_logits(logits, labels, weights=None):
    return nnops.sparse_softmax_cross_entropy(logits, labels, weights)


_LOSSES = {
    "mcxent": (mcxent_logits, mcxent_probs, "softmax"),
    "negativeloglikelihood": (mcxent_logits, mcxent_probs, "softmax"),
    "xent": (xent_logits, xent_probs, "sigmoid"),
    "mse": (None, nnops.mse_loss, None),
    "l2": (None, nnops.mse_loss, None),
    "l1": (None, nnops.mae_loss, None),
    "mean_absolute_error": (None, nnops.mae_loss, None),
    "kl_divergence": (None, nnops.kl_divergence, None),
    "cosine_proximity": (None, nnops.cosine_distance_loss, None),
    "hinge": (None, nnops.hinge_loss, None),
    "squared_hinge": (None, nnops.squared_hinge_loss, None),
    "poisson": (None, nnops.poisson_loss, None),
    "huber": (None, nnops.huber_loss, None),
    "sparse_mcxent": (sparse_mcxent_logits, None, "softmax"),
}


def resolve(name: str):
    """-> (logits_fn | None, activations_fn | None, fused_activation | None)."""
    key = name.lower()
    if key not in _LOSSES:
        raise ValueError(f"Unknown loss function: {name!r} "
                         f"(have {sorted(_LOSSES)})")
    return _LOSSES[key]


def available() -> list:
    return sorted(_LOSSES)
