"""Gradient checking (counterpart of deeplearning4j_tpu/autodiff/
gradcheck.py; DL4J's GradientCheckUtil): central finite differences in
float64, compared entry by entry with autograd's gradient by relative
error.

The analytic gradient is ``torch.autograd.grad`` of the function on fp64
copies of its arguments, so a wrong backward (a custom autograd Function's,
an adjoint written by hand) shows. The reference module enters JAX's x64
mode at import (``:25``), which fails under JAX 0.9.0; here fp64 is just
the arguments' dtype, and nothing global changes.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

DEFAULT_EPS = 1e-6
DEFAULT_MAX_REL_ERROR = 1e-5
DEFAULT_MIN_ABS_ERROR = 1e-8


class GradCheckResult:
    def __init__(self):
        self.failures: list[str] = []
        self.n_params = 0
        self.max_rel_error = 0.0

    @property
    def passed(self) -> bool:
        return not self.failures

    def __repr__(self):
        status = "PASS" if self.passed else "FAIL"
        msg = (f"GradCheck {status}: {self.n_params} params, "
               f"max_rel_error={self.max_rel_error:.3e}")
        if self.failures:
            msg += "\n" + "\n".join(self.failures[:20])
        return msg


def _compare_array(result: GradCheckResult, label: str, array: np.ndarray,
                   analytic: np.ndarray, eval_at: Callable[[np.ndarray], float],
                   *, eps: float, max_rel_error: float, min_abs_error: float,
                   max_params_per_array: int,
                   rng: np.random.Generator) -> None:
    """Perturb entries of ``array`` by ±eps, compare
    (f(x+eps)-f(x-eps))/2eps with ``analytic``; record failures."""
    flat = array.reshape(-1)
    idxs = np.arange(flat.size)
    if flat.size > max_params_per_array:
        idxs = rng.choice(flat.size, size=max_params_per_array, replace=False)
    for j in idxs:
        plus = flat.copy()
        plus[j] += eps
        minus = flat.copy()
        minus[j] -= eps
        numeric = (eval_at(plus.reshape(array.shape))
                   - eval_at(minus.reshape(array.shape))) / (2 * eps)
        ana = analytic.reshape(-1)[j]
        abs_err = abs(numeric - ana)
        denom = max(abs(numeric), abs(ana))
        rel_err = abs_err / denom if denom > 0 else 0.0
        result.n_params += 1
        result.max_rel_error = max(result.max_rel_error, rel_err)
        if rel_err > max_rel_error and abs_err > min_abs_error:
            result.failures.append(
                f"  {label}[{j}]: analytic={ana:.8e} numeric={numeric:.8e} "
                f"rel_err={rel_err:.3e}")


def _is_float(a) -> bool:
    if isinstance(a, torch.Tensor):
        return a.is_floating_point()
    return isinstance(a, np.ndarray) and np.issubdtype(a.dtype, np.floating)


def _fp64(a, device=None):
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    return t.detach().to(device=device or t.device, dtype=torch.float64)


def _scalar(out) -> float:
    return float(out.detach().cpu()) if isinstance(out, torch.Tensor) \
        else float(out)


def check_gradients(fn: Callable, args: Sequence, *, argnums=None,
                    eps: float = DEFAULT_EPS,
                    max_rel_error: float = DEFAULT_MAX_REL_ERROR,
                    min_abs_error: float = DEFAULT_MIN_ABS_ERROR,
                    max_params_per_array: int = 64,
                    seed: int = 0) -> GradCheckResult:
    """Compare autograd's gradient of the scalar ``fn(*args)`` with fp64
    central differences (GradientCheckUtil.checkGradients): each checked
    entry is moved ±eps; its relative error must stay below
    ``max_rel_error`` unless the absolute error is below
    ``min_abs_error``. Arrays larger than ``max_params_per_array`` are
    checked on a seeded random subset. ``argnums`` defaults to every
    floating tensor or array argument."""
    if argnums is None:
        argnums = tuple(i for i, a in enumerate(args) if _is_float(a))
    elif isinstance(argnums, int):
        argnums = (argnums,)
    args64 = [_fp64(a) if i in argnums else a for i, a in enumerate(args)]
    for i in argnums:
        args64[i].requires_grad_(True)
    out = fn(*args64)
    if not isinstance(out, torch.Tensor) or out.dim() != 0:
        raise ValueError("gradcheck requires a scalar-valued function")
    analytic = torch.autograd.grad(out, [args64[i] for i in argnums],
                                   allow_unused=True)
    result = GradCheckResult()
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for gi, ai in enumerate(argnums):
            a = args64[ai].detach()
            g = analytic[gi]
            g = torch.zeros_like(a) if g is None else g

            def eval_at(v, ai=ai, like=a):
                new_args = list(args64)
                new_args[ai] = torch.from_numpy(v).to(like.device)
                return _scalar(fn(*new_args))

            _compare_array(result, f"arg{ai}", a.cpu().numpy(),
                           g.detach().cpu().numpy(), eval_at, eps=eps,
                           max_rel_error=max_rel_error,
                           min_abs_error=min_abs_error,
                           max_params_per_array=max_params_per_array,
                           rng=rng)
    return result


def check_model_gradients(loss_fn: Callable, params, *,
                          eps: float = DEFAULT_EPS,
                          max_rel_error: float = 1e-4,
                          min_abs_error: float = 1e-7,
                          max_params_per_array: int = 32,
                          seed: int = 0) -> GradCheckResult:
    """Gradcheck over a param tree (dicts, lists, tuples of tensors):
    ``loss_fn(params) -> scalar``, the shape DL4J's layer gradchecks take,
    with the tree kept structured. Its defaults are looser than
    :func:`check_gradients` (deep compositions accumulate more truncation
    error)."""
    from deeplearning4j_tpu_torch.tree import tree_leaves, tree_map

    params64 = tree_map(lambda p: _fp64(p).requires_grad_(True), params)
    leaves = tree_leaves(params64)
    out = loss_fn(params64)
    grads = torch.autograd.grad(out, leaves, allow_unused=True)
    result = GradCheckResult()
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for li, (leaf, g) in enumerate(zip(leaves, grads)):
            g = torch.zeros_like(leaf) if g is None else g

            def eval_at(v, li=li, like=leaf):
                swap = iter([torch.from_numpy(v).to(like.device)
                             if k == li else x.detach()
                             for k, x in enumerate(leaves)])
                return _scalar(loss_fn(tree_map(lambda _: next(swap),
                                                params64)))

            _compare_array(result, f"leaf{li}", leaf.detach().cpu().numpy(),
                           g.detach().cpu().numpy(), eval_at, eps=eps,
                           max_rel_error=max_rel_error,
                           min_abs_error=min_abs_error,
                           max_params_per_array=max_params_per_array,
                           rng=rng)
    return result
