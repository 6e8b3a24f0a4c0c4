"""The port's ``ops/nn.py`` ops on the ResNet-50 path against the JAX
package's, on the CPU, at 1e-6 (the same fp32 arithmetic in a different
order): max pooling with reduce_window SAME padding (asymmetric, -inf
fill) on odd and even sizes, average pooling with SAME counts, global
average pooling, inference batchnorm, the dense product and softmax.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.ops import nn as jnn  # noqa: E402
from deeplearning4j_tpu.ops import registry as jreg  # noqa: E402
from deeplearning4j_tpu_torch.ops import nn as tnn  # noqa: E402
from deeplearning4j_tpu_torch.ops import registry  # noqa: E402

TOL = dict(atol=1e-6, rtol=1e-6)


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(t, ref):
    np.testing.assert_allclose(t.numpy(), np.asarray(ref), **TOL)


# (spatial size, kernel, stride, padding): the stem pool (3x3/s2 SAME,
# asymmetric (0, 1) on even sizes), odd sizes, VALID and numeric pads
_POOLS = [
    (8, 3, 2, "SAME"),
    (7, 3, 2, "SAME"),
    (112, 3, 2, "SAME"),
    (9, 2, 2, "SAME"),
    (8, 2, 2, "VALID"),
    (9, 3, 1, (1, 1)),
]


@pytest.mark.parametrize("size,k,s,pad", _POOLS,
                         ids=[f"{c[0]}k{c[1]}s{c[2]}p{c[3]}" for c in _POOLS])
@pytest.mark.parametrize("kind", ["max", "avg"])
def test_pool2d_matches_reduce_window(kind, size, k, s, pad):
    x = _x((2, size, size + 1, 3), seed=size)
    jop, top = ((jnn.max_pool2d, tnn.max_pool2d) if kind == "max"
                else (jnn.avg_pool2d, tnn.avg_pool2d))
    ref = jop(jnp.asarray(x), (k, k), (s, s), pad)
    out = top(torch.from_numpy(x), (k, k), (s, s), pad)
    assert tuple(out.shape) == ref.shape and out.is_contiguous()
    _close(out, ref)


def test_max_pool_pads_with_minus_inf():
    x = -np.abs(_x((1, 4, 4, 2), seed=5)) - 10.0  # all below the 0 fill
    ref = jnn.max_pool2d(jnp.asarray(x), (3, 3), (2, 2), "SAME")
    _close(tnn.max_pool2d(torch.from_numpy(x), (3, 3), (2, 2), "SAME"), ref)


@pytest.mark.parametrize("keepdims", [False, True])
def test_global_avg_pool(keepdims):
    x = _x((3, 5, 7, 4), seed=1)
    _close(tnn.global_avg_pool(torch.from_numpy(x), keepdims=keepdims),
           jnn.global_avg_pool(jnp.asarray(x), keepdims=keepdims))


@pytest.mark.parametrize("affine", [True, False])
def test_batchnorm_inference(affine):
    x = _x((2, 5, 5, 6), seed=2)
    mean, gamma, beta = (_x((6,), seed=s) for s in (3, 4, 5))
    var = np.abs(_x((6,), seed=6)) + 0.1
    args = [mean, var] + ([gamma, beta] if affine else [])
    ref = jnn.batchnorm(jnp.asarray(x), *map(jnp.asarray, args), eps=1e-3)
    out = tnn.batchnorm(torch.from_numpy(x), *map(torch.from_numpy, args),
                        eps=1e-3)
    _close(out, ref)


def test_batchnorm_bf16_keeps_dtype():
    x = torch.from_numpy(_x((2, 3, 3, 4))).to(torch.bfloat16)
    stats = [torch.zeros(4), torch.ones(4)]
    assert tnn.batchnorm(x, *stats).dtype == torch.bfloat16


def test_xw_plus_b_and_softmax():
    x, w, b = _x((4, 16), 7), _x((16, 10), 8), _x((10,), 9)
    ref = jnn.xw_plus_b(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    out = tnn.xw_plus_b(*map(torch.from_numpy, (x, w, b)))
    _close(out, ref)
    _close(registry.exec_op("softmax", out), jreg.exec_op("softmax", ref))


def test_registry_by_name_and_aliases():
    for name in ("conv2d", "max_pool2d", "avgpool", "batch_norm", "relu",
                 "identity", "linear_layer", "globalavgpool"):
        assert registry.has_op(name)
    assert "conv2d" in registry.list_ops("conv")
    with pytest.raises(registry.OpNotFoundError):
        registry.get_op("no_such_op")
