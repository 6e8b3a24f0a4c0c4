"""The wgrad kernel's host side and its numbers, on the CPU
(deeplearning4j_tpu_torch/ops/kernels/conv.py: ``wgrad_body``, the Python
mirror of ``csrc/conv2d_wgrad.cu``'s ``pick_body``; ``conv2d_wgrad`` on a
CPU tensor takes its plain version):

- the body gate on every wgrad launch of a ResNet-50 train step, as
  ``chip_smoke.py`` enumerates them: 52 ``wgmma`` and the stem's
  ``mma_sync`` in bf16, all ``fma`` in fp32 (the card test
  ``test_conv_wgrad_kernel_matches_plain`` holds the library's plan to it);
- why fp32 conv weight gradients sit far from the fp64 step on a batchnorm
  net: batchnorm's backward makes the conv output's gradient dy zero-mean
  per channel, so dW = sum over positions of x * dy cancels, and any fp32
  sum of it is off by some unit roundoffs times the cancellation ratio
  kappa = sum |x * dy| / |sum x * dy|. On a conv -> batchnorm -> loss stack
  the JAX package's fp32 gradient and the port's plain one both stand at a
  distance from the port's fp64 gradient that grows with kappa (a post-relu
  input shifted up), the port's never the farther;
- ``tools/wgrad_ablation.py``'s text edits of the kernel source still find
  their anchors.
"""

import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.ops import nn as jnn  # noqa: E402
from deeplearning4j_tpu_torch.ops import nn as tnn  # noqa: E402
from deeplearning4j_tpu_torch.ops.kernels import conv as tconv  # noqa: E402

# fp32 unit roundoff
_U = 2.0 ** -24


def _smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _body(dtype, n, h, w, cin, k, stride, cout, padding="SAME", dil=(1, 1),
          groups=1):
    """``wgrad_body`` on the shapes of one conv, as ``conv2d_wgrad`` calls
    the plan."""
    strides = (stride, stride) if isinstance(stride, int) else tuple(stride)
    pads = tconv.resolve_padding(padding, (h, w), k, strides, dil)
    oh, ow = (tconv._out_size(s, p, kk, st, d) for s, p, kk, st, d in
              zip((h, w), pads, k, strides, dil))
    return tconv.wgrad_body(dtype, (n, h, w, cin), (n, oh, ow, cout), k,
                            strides, pads, dil, groups)


@pytest.mark.parametrize("dtype,want", [
    (torch.bfloat16, {"wgmma": 52, "mma_sync": 1}),
    (torch.float32, {"fma": 53}),
], ids=["bf16", "fp32"])
def test_wgrad_body_on_every_resnet50_launch(dtype, want):
    from deeplearning4j_tpu_torch.zoo.models import ResNet50

    geoms = _smoke().conv_geometries(ResNet50().conf(), batch=8)
    got = {}
    for key, count in geoms.items():
        n, h, w, cin, kh, kw, cout, stride, padding, dil, groups = key
        body = _body(dtype, n, h, w, cin, (kh, kw), stride, cout, padding,
                     dil, groups)
        got[body] = got.get(body, 0) + count
    assert got == want
    stem = (8, 224, 224, 3, 7, 7, 64, (2, 2), "SAME", (1, 1), 1)
    assert geoms[stem] == 1
    assert _body(dtype, 8, 224, 224, 3, (7, 7), 2, 64) == (
        "fma" if dtype == torch.float32 else "mma_sync")


@pytest.mark.parametrize("case,body", [
    (dict(cin=64, cout=64), "wgmma"),
    (dict(cin=2048, cout=512), "wgmma"),
    (dict(cin=128, cout=128, groups=2), "mma_sync"),
    (dict(cin=96, cout=64), "mma_sync"),
    (dict(cin=64, cout=96), "mma_sync"),
    (dict(cin=3, cout=64), "mma_sync"),
    (dict(cin=64, cout=64, k=(3, 3), dil=(64, 1), padding="VALID", h=200),
     "mma_sync"),
    (dict(cin=64, cout=64, k=(3, 3), dil=(63, 1), padding="VALID", h=200),
     "wgmma"),
    (dict(cin=64, cout=64, stride=9), "mma_sync"),
    (dict(cin=64, cout=64, k=(3, 3), padding=(2, 2)), "wgmma"),
    (dict(cin=64, cout=64, padding=(200, 0)), "mma_sync"),
], ids=["64-64", "2048-512", "groups2", "cin96", "cout96", "cin3",
        "window-129", "window-127", "stride9", "pads2", "pad200"])
def test_wgrad_body_gate(case, body):
    """bf16 wgmma needs one group, Cin and Cout multiples of 64, and a
    window x's im2col tensor map holds: strides up to 8, (k - 1) * dilation
    and the bounding box's corners within 127."""
    args = dict(n=2, h=16, w=16, k=(1, 1), stride=1, padding="SAME",
                dil=(1, 1), groups=1)
    args.update(case)
    assert _body(torch.bfloat16, **args) == body
    assert _body(torch.float32, **args) == "fma"


def _stack_grads(shift, seed=0, n=8, hw=28, cin=32, cout=16, s=2):
    """dW of sum(batchnorm_train(conv(x, w)) * r) for a 1x1 stride-s conv
    on a post-relu input shifted by ``shift`` (ResNet-50's res3a_a_conv
    shape, cut to size): the JAX package's fp32, the port's plain fp32 and
    fp64 gradients, and the cancellation ratio kappa of the fp64 one."""
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.normal(size=(n, hw, hw, cin)) + shift,
                   0).astype(np.float32)
    w = (rng.normal(size=(1, 1, cin, cout)) / np.sqrt(cin)).astype(np.float32)
    oh = -(-hw // s)
    r = rng.normal(size=(n, oh, oh, cout)).astype(np.float32)
    gamma = (1 + 0.1 * rng.normal(size=cout)).astype(np.float32)
    beta = (0.1 * rng.normal(size=cout)).astype(np.float32)

    def jloss(wj):
        y = jnn.conv2d(jnp.asarray(x), wj, None, strides=(s, s),
                       padding="SAME")
        o, _, _ = jnn.batchnorm_train(y, jnp.asarray(gamma),
                                      jnp.asarray(beta), jnp.zeros(cout),
                                      jnp.ones(cout))
        return jnp.sum(o * jnp.asarray(r))

    g_jax = np.asarray(jax.grad(jloss)(jnp.asarray(w)), np.float64)

    def port(dt):
        tw = torch.from_numpy(w).to(dt).requires_grad_()
        y = tnn.conv2d(torch.from_numpy(x).to(dt), tw, strides=(s, s),
                       padding="SAME")
        y.retain_grad()
        o, _, _ = tnn.batchnorm_train(
            y, torch.from_numpy(gamma).to(dt), torch.from_numpy(beta).to(dt),
            torch.zeros(cout, dtype=dt), torch.ones(cout, dtype=dt))
        (o * torch.from_numpy(r).to(dt)).sum().backward()
        return tw.grad.double().numpy(), y.grad.double().numpy()

    g32, _ = port(torch.float32)
    g64, dy64 = port(torch.float64)
    xs = x.astype(np.float64)[:, ::s, ::s, :].reshape(-1, cin)
    terms = np.abs(xs).T @ np.abs(dy64.reshape(-1, cout))
    kappa = np.linalg.norm(terms) / np.linalg.norm(g64)
    dist = [float(np.linalg.norm(g - g64) / np.linalg.norm(g64))
            for g in (g_jax, g32)]
    return kappa, dist[0], dist[1]


def test_fp32_conv_weight_grad_distance_follows_cancellation():
    """Both fp32 paths stand within 4 unit roundoffs times kappa of the
    fp64 gradient (the port's within 2), the port's never the farther; the
    shift raises kappa more than tenfold, and the distances with it."""
    rows = [_stack_grads(shift) for shift in (0.0, 3.0, 10.0)]
    for kappa, d_jax, d_port in rows:
        assert d_port <= d_jax
        assert d_port <= 2 * _U * kappa
        assert d_jax <= 4 * _U * kappa
    (k0, j0, p0), (k2, j2, p2) = rows[0], rows[-1]
    assert k2 > 10 * k0
    assert j2 > 10 * j0 and p2 > 10 * p0


def test_wgrad_ablation_variants_apply_to_the_kernel_source():
    """tools/wgrad_ablation.py makes its variants by editing
    csrc/conv2d_wgrad.cu's text: every edit still finds its anchor, and
    every variant but the source as built differs from it."""
    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / \
        "wgrad_ablation.py"
    spec = importlib.util.spec_from_file_location("wgrad_ablation", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src = pathlib.Path(tool.SOURCE).read_text()
    variants = tool.variant_sources(src)
    assert set(variants) == set(tool.VARIANTS)
    assert variants["built"] == src
    assert all(text != src for name, text in variants.items()
               if name != "built")
