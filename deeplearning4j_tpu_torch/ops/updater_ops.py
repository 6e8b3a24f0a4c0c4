"""Updater (learning-rule) ops, libnd4j's ``generic/updaters`` family
(counterpart of deeplearning4j_tpu/ops/updater_ops.py).

Each op runs the same rule as ``nn/updaters.py`` on one tensor, so the op
table and the training loop cannot disagree. Signature:
``<name>_updater(gradient, *state, lr=..., ...hyperparams, iteration=0)``
returns ``(update, *new_state)``; the caller applies ``param -= update``.
``apply_sgd`` takes the parameter and returns it updated. (The
reference module's fused flat-buffer helpers serve its FusedUpdateEngine,
which the port does not have; see ``nn/updaters.py``.)
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn import updaters as U
from deeplearning4j_tpu_torch.ops import _compat as C
from deeplearning4j_tpu_torch.ops.registry import op


def _single(updater, grad, state, iteration):
    """One rule on one tensor: the step sizes the training loop writes,
    as fp32 0-d tensors, then ``apply``."""
    grad = C.t(grad)
    sizes = [torch.tensor(v, dtype=torch.float32, device=grad.device)
             for v in updater.step_sizes(iteration)]
    slots = {k: [C.t(v, grad)] for k, v in state.items()}
    upd, new = updater.apply([grad], slots, sizes, [torch.zeros_like(grad)])
    return upd[0], {k: v[0] for k, v in new.items()}


@op("sgd_updater", "updater", aliases=("sgdUpdater",))
def sgd_updater(gradient, lr=1e-3):
    """update = lr * g."""
    g = C.t(gradient)
    return torch.tensor(lr, dtype=g.dtype, device=g.device) * g


@op("apply_sgd", "updater", aliases=("applyGradientDescent",))
def apply_sgd(parameters, gradient, lr=1e-3):
    p = C.t(parameters)
    return p - torch.tensor(lr, dtype=p.dtype, device=p.device) * C.t(
        gradient, p)


@op("nesterovs_updater", "updater", aliases=("nesterovsUpdater",))
def nesterovs_updater(gradient, state_v, lr=0.1, momentum=0.9, iteration=0):
    upd, st = _single(U.Nesterovs(learning_rate=lr, momentum=momentum),
                      gradient, {"v": state_v}, iteration)
    return upd, st["v"]


@op("ada_grad_updater", "updater", aliases=("adaGradUpdater",))
def ada_grad_updater(gradient, state_h, lr=0.1, epsilon=1e-6, iteration=0):
    upd, st = _single(U.AdaGrad(learning_rate=lr, epsilon=epsilon),
                      gradient, {"h": state_h}, iteration)
    return upd, st["h"]


@op("rms_prop_updater", "updater", aliases=("rmsPropUpdater",))
def rms_prop_updater(gradient, state_g, lr=0.1, rms_decay=0.95, epsilon=1e-8,
                     iteration=0):
    upd, st = _single(U.RmsProp(learning_rate=lr, rms_decay=rms_decay,
                                epsilon=epsilon), gradient,
                      {"g2": state_g}, iteration)
    return upd, st["g2"]


@op("ada_delta_updater", "updater", aliases=("adaDeltaUpdater",))
def ada_delta_updater(gradient, state_msg, state_msdx, rho=0.95,
                      epsilon=1e-6, iteration=0):
    upd, st = _single(U.AdaDelta(rho=rho, epsilon=epsilon), gradient,
                      {"g2": state_msg, "dx2": state_msdx}, iteration)
    return upd, st["g2"], st["dx2"]


@op("adam_updater", "updater", aliases=("adamUpdater",))
def adam_updater(gradient, state_m, state_v, lr=1e-3, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, iteration=0):
    upd, st = _single(U.Adam(learning_rate=lr, beta1=beta1, beta2=beta2,
                             epsilon=epsilon), gradient,
                      {"m": state_m, "v": state_v}, iteration)
    return upd, st["m"], st["v"]


@op("ada_max_updater", "updater", aliases=("adaMaxUpdater",))
def ada_max_updater(gradient, state_m, state_u, lr=1e-3, beta1=0.9,
                    beta2=0.999, epsilon=1e-8, iteration=0):
    upd, st = _single(U.AdaMax(learning_rate=lr, beta1=beta1, beta2=beta2,
                               epsilon=epsilon), gradient,
                      {"m": state_m, "v": state_u}, iteration)
    return upd, st["m"], st["v"]


@op("ams_grad_updater", "updater", aliases=("amsGradUpdater",))
def ams_grad_updater(gradient, state_m, state_v, state_vhat, lr=1e-3,
                     beta1=0.9, beta2=0.999, epsilon=1e-8, iteration=0):
    upd, st = _single(U.AMSGrad(learning_rate=lr, beta1=beta1, beta2=beta2,
                                epsilon=epsilon), gradient,
                      {"m": state_m, "v": state_v, "vhat": state_vhat},
                      iteration)
    return upd, st["m"], st["v"], st["vhat"]


@op("nadam_updater", "updater", aliases=("nadamUpdater",))
def nadam_updater(gradient, state_m, state_v, lr=1e-3, beta1=0.9,
                  beta2=0.999, epsilon=1e-8, iteration=0):
    upd, st = _single(U.Nadam(learning_rate=lr, beta1=beta1, beta2=beta2,
                              epsilon=epsilon), gradient,
                      {"m": state_m, "v": state_v}, iteration)
    return upd, st["m"], st["v"]
