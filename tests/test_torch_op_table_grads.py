"""Gradients of a sample of every family of the op table against
``jax.grad`` of the reference's op: d(sum(out * ct))/d(first float input)
for seeded cotangents, on each op's case (``ops/op_cases.py``), to 2e-4
relative."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deeplearning4j_tpu.ops as ref_ops  # noqa: E402
import deeplearning4j_tpu_torch.ops as port_ops  # noqa: E402
from deeplearning4j_tpu_torch.ops import op_cases as oc  # noqa: E402
from deeplearning4j_tpu_torch.ops import registry  # noqa: E402

CASES = oc.build(0)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


GRAD_SAMPLE = [
    "exp", "gelu_tanh", "atan2", "cumlogsumexp",
    "fake_quant_with_min_max_vars", "logsumexp", "var", "median",
    "gather", "pad", "take_along_axis", "conv2d", "conv3d", "deconv2d",
    "layernorm", "ctc_loss", "dot_product_attention", "dilation2d",
    "lstm_layer", "gru_layer", "sru", "matmul", "cholesky", "solve",
    "image_resize", "grid_sample", "barnes_edge_forces", "flash_attention",
]


def _first_float(case):
    for i, a in enumerate(case.args):
        if isinstance(a, np.ndarray) and a.dtype == np.float32:
            return i
    raise AssertionError("no float argument")


def _call(exec_op, name, case, tensor, i=None, xi=None):
    args = [oc.materialize(a, tensor, None) for a in case.args]
    if i is not None:
        args[i] = xi
    return exec_op(name, *args, **{k: oc.materialize(v, tensor, None)
                                   for k, v in case.kwargs.items()})


def _float_leaves(out, is_float):
    if isinstance(out, (tuple, list)):
        return [leaf for o in out for leaf in _float_leaves(o, is_float)]
    return [out] if is_float(out) else []


@pytest.mark.parametrize("name", GRAD_SAMPLE)
def test_gradient_matches_jax_grad(name):
    """d(sum(out * ct))/d(first float input) against jax.grad, with the
    same seeded cotangents for every float output."""
    case = CASES[name]
    i = _first_float(case)
    assert registry.get_op(name).differentiable

    def jfloat(o):
        return hasattr(o, "dtype") and jnp.issubdtype(o.dtype, jnp.floating)

    rng = np.random.default_rng(7)
    cts = [rng.standard_normal(np.shape(o)).astype(np.float32)
           for o in _float_leaves(_call(ref_ops.exec_op, name, case,
                                        jnp.asarray), jfloat)]

    def ref_loss(xi):
        outs = _float_leaves(_call(ref_ops.exec_op, name, case, jnp.asarray,
                                   i, xi), jfloat)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cts))

    want = np.asarray(jax.grad(ref_loss)(jnp.asarray(case.args[i])))
    xi = _t(case.args[i]).requires_grad_(True)
    outs = _float_leaves(_call(port_ops.exec_op, name, case, _t, i, xi),
                         lambda o: isinstance(o, torch.Tensor)
                         and o.is_floating_point())
    loss = sum(torch.sum(o * _t(c)) for o, c in zip(outs, cts))
    got = torch.autograd.grad(loss, xi)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
