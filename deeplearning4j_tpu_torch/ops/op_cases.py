"""Seeded example calls for every op of the table, one per name, with the
tolerance of its family and how its result is checked.

The inputs are numpy arrays made from one seed, so the same call can go
through the reference's ``exec_op`` (as jnp arrays), through the port on
the CPU, and through the port on the card, and the results compare leaf by
leaf. A random op takes :class:`Key` where it takes its key or generator;
its results are checked by shape, type and moments, never by value.

``check`` says how a result is held to the one it is compared with:

- ``value``: every leaf equal in shape and type and within ``tol`` (rtol,
  atol), the tolerance of the op's family (:data:`TOLERANCES`);
- ``moments``: shape and type equal, and the means and standard deviations
  of the two draws within :func:`moment_bounds`;
- ``split``: a list of the same length of independent streams;
- ``shuffle`` / ``crop``: a permutation of the input / a window of it;
- ``qr``, ``svd``, ``eig``, ``eigh``, ``lu``, ``lup``: a decomposition,
  unique only up to signs and order, checked by its reconstruction, its
  orthogonality and its sorted spectrum.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np

#: (rtol, atol) by family (the reference module that defines the op)
TOLERANCES: Dict[str, Tuple[float, float]] = {
    "elementwise": (1e-5, 1e-6), "reduce": (1e-5, 1e-5),
    "shape_ops": (0.0, 0.0), "nn": (1e-4, 1e-5), "rnn": (1e-4, 1e-5),
    "linalg": (1e-4, 1e-4), "random": (0.0, 0.0), "image": (1e-4, 1e-5),
    "signal": (1e-4, 1e-4), "updater_ops": (1e-5, 1e-7),
    "compression": (0.0, 0.0), "nlp_ops": (1e-5, 1e-6),
    "attention": (1e-4, 1e-5),
}

#: launches of one call of each kernel-backed op's case, by kernel, worked
#: out from the code: conv1d, depthwise_conv2d and separable_conv2d reach
#: K1 through ops.nn.conv2d (separable: the depthwise then the 1x1
#: pointwise, two launches), conv_lstm_2d launches K1 once on its B*T
#: input images and once a step (T = 3 in its case), the TF grad ops
#: launch dgrad and K3 once, lstm_layer K4 once a direction (its case is
#: bidirectional), flash_attention K5 once. multi_head_dot_product_attention's
#: case (S 5) is below FLASH_MIN_SEQ and takes no kernel.
KERNEL_LAUNCHES: Dict[str, Dict[str, int]] = {
    "conv2d": {"conv2d_fwd": 1}, "conv1d": {"conv2d_fwd": 1},
    "depthwise_conv2d": {"conv2d_fwd": 1},
    "separable_conv2d": {"conv2d_fwd": 2},
    "conv_lstm_2d": {"conv2d_fwd": 4},
    "conv2d_backprop_input": {"conv2d_dgrad": 1},
    "conv2d_backprop_filter": {"conv2d_wgrad": 1},
    "lstm_layer": {"lstm_seq_fwd": 2},
    "flash_attention": {"flash_attention_fwd": 1}}


@dataclasses.dataclass(frozen=True)
class Key:
    """Stands where a random op takes its key (reference) or its
    ``torch.Generator`` (port), seeded with ``seed``."""

    seed: int = 0


@dataclasses.dataclass
class Case:
    family: str
    args: tuple
    kwargs: dict
    check: str = "value"
    tol: Tuple[float, float] = None

    def tolerance(self):
        return self.tol if self.tol is not None else TOLERANCES[self.family]


def moment_bounds(ref_std: float, n: int):
    """(mean bound, std bound) for two independent draws of n samples:
    six standard errors of a difference of means, and ten percent of the
    standard deviation (plus 1e-6 for degenerate draws)."""
    return (6.0 * ref_std * (2.0 / n) ** 0.5 + 1e-6,
            0.1 * ref_std + 1e-6)


def _pack_codes(codes: np.ndarray) -> np.ndarray:
    c = np.pad(codes, (0, (-codes.size) % 16)).reshape(-1, 16)
    return (c.astype(np.uint64) << (2 * np.arange(16, dtype=np.uint64))
            ).sum(axis=1).astype(np.uint32)


def build(seed: int = 0) -> Dict[str, Case]:
    """Every op's case, by name."""
    r = np.random.default_rng(seed)

    def f(*s):
        return r.standard_normal(s).astype(np.float32)

    def u(lo, hi, *s):
        return r.uniform(lo, hi, s).astype(np.float32)

    def pos(*s):
        return u(0.5, 2.5, *s)

    def ints(lo, hi, *s):
        return r.integers(lo, hi, s).astype(np.int32)

    def bools(*s):
        return r.random(s) > 0.5

    def spd(n):
        a = f(n, n)
        return (a @ a.T + n * np.eye(n)).astype(np.float32)

    cases: Dict[str, Case] = {}

    def family(fam):
        def add(name, *args, check="value", tol=None, **kwargs):
            cases[name] = Case(fam, args, kwargs, check, tol)
        return add

    # ------------------------------------------------------------ elementwise
    add = family("elementwise")
    x = f(4, 5)
    for name in ("exp", "expm1", "sin", "cos", "atan", "sinh", "cosh", "tanh",
                 "asinh", "erf", "erfc", "sigmoid", "log_sigmoid", "softplus",
                 "softsign", "gelu", "gelu_tanh", "gelu_sigmoid", "elu",
                 "selu", "swish", "mish", "hard_sigmoid", "hardswish",
                 "hard_tanh", "rationaltanh", "rectifiedtanh",
                 "sigmoid_derivative", "tanh_derivative", "abs", "neg",
                 "sign", "square", "cube", "floor", "ceil", "trunc", "relu",
                 "identity", "stop_gradient", "oneslike", "zeroslike", "i0",
                 "i1", "expit", "check_numerics"):
        add(name, f(4, 5))
    for name in ("log", "log2", "log10", "log1p", "sqrt", "rsqrt",
                 "reciprocal", "lgamma", "digamma"):
        add(name, pos(4, 5))
    add("tan", u(-1.2, 1.2, 4, 5))
    add("asin", u(-0.95, 0.95, 4, 5))
    add("acos", u(-0.95, 0.95, 4, 5))
    add("acosh", u(1.1, 4.0, 4, 5))
    add("atanh", u(-0.9, 0.9, 4, 5))
    add("erfinv", u(-0.9, 0.9, 4, 5))
    add("logit", u(0.05, 0.95, 4, 5))
    halves = np.array([[0.5, 1.5, 2.5, -0.5, -1.5], [-2.5, 0.4, 3.5, 1.2,
                                                      -0.7]], np.float32)
    add("round", halves)
    add("rint", halves)
    add("relu6", f(4, 5) * 5)
    add("celu", f(4, 5), alpha=0.7)
    add("thresholded_relu", f(4, 5), alpha=0.5)
    add("shrink", f(4, 5), lambd=0.5, bias=0.1)
    add("leakyrelu", f(4, 5), alpha=0.2)
    add("prelu", f(4, 5), u(0.05, 0.5, 5))
    add("thresholdrelu", f(4, 5), theta=0.5)
    add("clipbyvalue", f(4, 5), -0.5, 0.5)
    add("clipbynorm", f(4, 5), 1.0, axes=(1,))
    nanx = f(3, 4)
    nanx[0, 1], nanx[1, 2], nanx[2, 0] = np.nan, np.inf, -np.inf
    add("isnan", nanx)
    add("isinf", nanx)
    add("isfinite", nanx)
    add("not", bools(3, 4))
    for name in ("add", "subtract", "multiply", "divide", "rsub", "maximum",
                 "minimum", "atan2", "squareddifference", "hypot",
                 "copysign", "mod", "fmod"):
        add(name, f(4, 5), f(1, 5))
    add("rdiv", pos(4, 5), f(4, 5))
    add("pow", pos(4, 5), f(4, 5))
    a_i, b_i = ints(-20, 20, 4, 5), ints(1, 7, 4, 5) * np.where(
        bools(4, 5), 1, -1).astype(np.int32)
    add("floordiv", a_i, b_i)
    add("truncatediv", a_i, b_i)
    eq_a, eq_b = ints(0, 3, 4, 5), ints(0, 3, 4, 5)
    for name in ("equals", "notequals", "greater", "greaterequal", "less",
                 "lessequal"):
        add(name, eq_a, eq_b)
    for name in ("and", "or", "xor"):
        add(name, bools(4, 5), bools(4, 5))
    add("where", bools(4, 5), f(4, 5), f(4, 5))
    add("axpy", f(4, 5), f(4, 5), alpha=0.3)
    for name in ("scalar_add", "scalar_sub", "scalar_mul", "scalar_div",
                 "scalar_rsub", "scalar_max", "scalar_min", "scalar_set"):
        add(name, f(4, 5), 1.5)
    add("scalar_rdiv", pos(4, 5), 1.5)
    add("scalar_pow", pos(4, 5), 1.5)
    add("step", f(4, 5), 0.2)
    shift_x = ints(-1000, 1000, 4, 5)
    add("shift_left", shift_x, ints(0, 8, 4, 5))
    add("shift_right", shift_x, ints(0, 8, 4, 5))
    add("igamma", pos(4, 5), pos(4, 5), tol=(1e-4, 1e-6))
    add("igammac", pos(4, 5), pos(4, 5), tol=(1e-4, 1e-6))
    add("polygamma", 1, pos(4, 5), tol=(1e-4, 1e-6))
    add("zeta", pos(4, 5) + 1.0, pos(4, 5), tol=(1e-4, 1e-6))
    add("betainc", pos(4, 5), pos(4, 5), u(0.02, 0.98, 4, 5),
        tol=(1e-4, 1e-6))
    den = f(4, 5)
    den[0, :2] = 0.0
    add("divide_no_nan", f(4, 5), den)
    add("toggle_bits", ints(-100, 100, 4, 5))
    add("cyclic_shift_bits", shift_x, ints(0, 40, 4, 5))
    add("cyclic_rshift_bits", shift_x, ints(0, 40, 4, 5))
    add("cumlogsumexp", f(3, 6), axis=1, exclusive=True, reverse=True)
    add("clip_by_global_norm", [f(3, 4), f(5)], 1.0)
    add("clipbyavgnorm", f(4, 5), 0.1)
    add("expint", np.concatenate([u(-4.0, -0.2, 10), u(0.2, 4.0, 10)]),
        tol=(1e-4, 1e-6))
    add("pow_derivative", pos(4, 5), p=3.0)
    add("fill_like", f(4, 5), 2.5)
    add("bits_hamming_distance", shift_x, ints(-1000, 1000, 4, 5))
    add("fake_quant_with_min_max_vars", f(4, 5) * 5, min=-3.0, max=4.0)
    add("fake_quant_with_min_max_vars_per_channel", f(4, 3) * 5,
        np.array([-3.0, -1.0, -6.0], np.float32),
        np.array([4.0, 2.0, 6.0], np.float32))
    add("compare_and_bitpack", f(3, 16), 0.1)
    zf = f(4, 5)
    zf[zf < 0.3] = 0.0
    add("zero_fraction", zf)
    add("popcount", ints(-1000, 1000, 4, 5))

    # ---------------------------------------------------------------- reduce
    add = family("reduce")
    x3 = f(3, 4, 5)
    add("sum", x3, axis=(0, 2))
    add("prod", u(0.5, 1.5, 3, 4), axis=1)
    add("mean", x3)
    add("max", x3, axis=1, keepdims=True)
    add("min", x3, axis=2)
    for name in ("amax", "amin", "asum", "amean", "norm1", "norm2",
                 "squarednorm", "normmax", "logsumexp"):
        add(name, x3, axis=1)
    cz = ints(-2, 3, 4, 5)
    add("countnonzero", cz, axis=1)
    add("countzero", cz)
    add("all", bools(4, 5), axis=0)
    add("any", bools(4, 5), axis=1)
    add("cumsum", x3, axis=1)
    add("cumprod", u(0.5, 1.5, 3, 4), axis=0)
    add("argmax", x3, axis=1)
    add("argmin", x3, axis=2)
    add("argamax", x3, axis=1)
    add("argamin", x3)
    add("var", x3, axis=0)
    add("std", x3, axis=(1, 2))
    for name in ("cosinesimilarity", "cosinedistance", "euclidean",
                 "manhattan", "dot"):
        add(name, f(4, 5), f(4, 5), axis=1)
    add("jaccarddistance", pos(4, 5), pos(4, 5), axis=1)
    add("hammingdistance", eq_a, eq_b, axis=1)
    add("histogram", f(60), nbins=7)
    add("histogram_fixed_width", f(60), [-1.0, 1.0], nbins=5)
    add("bincount", ints(0, 6, 20), minlength=8)
    add("median", f(4, 6), axis=1)
    add("percentile", f(5, 6), 30.0, axis=0)
    add("quantile", f(5, 6), 0.7)
    probs = pos(3, 5)
    probs /= probs.sum(axis=1, keepdims=True)
    probs[0, 0] = 0.0
    add("entropy", probs, axis=1)
    add("shannon_entropy", probs, axis=1)
    add("log_entropy", probs, axis=1)

    # ------------------------------------------------------------- shape_ops
    add = family("shape_ops")
    x = f(3, 4, 2)
    add("reshape", x, (4, 6))
    add("ravel", x)
    add("transpose", x, (1, 0, 2))
    add("permute", x, (2, 0, 1))
    add("swapaxes", x, 0, 2)
    add("moveaxis", x, 0, -1)
    add("expand_dims", x, 1)
    add("squeeze", f(3, 1, 4), axis=1)
    add("broadcast_to", f(1, 4), (3, 4))
    add("tile", f(2, 3), (2, 1))
    add("repeat", f(2, 3), 2, axis=1)
    add("concat", [f(2, 3), f(2, 4)], axis=1)
    add("concat_n", f(2, 3), f(1, 3), axis=0)
    add("stack_n", f(2, 3), f(2, 3), axis=1)
    add("stack", [f(2, 3), f(2, 3)], axis=0)
    add("unstack", x, axis=1)
    add("split", f(4, 3), 2, axis=0)
    add("split_v", f(2, 4), [1, 3], axis=1)
    add("flip", x, axis=0)
    add("roll", x, 2, axis=1)
    add("rot90", f(3, 4))
    add("slice", f(4, 5), [1, 0], [2, 3])
    add("strided_slice", f(4, 6), [0, 1], [4, 6], [2, 2])
    add("cast", f(3, 4) * 4, "int32")
    add("size", x)
    add("rank", x)
    add("shape_of", x)
    add("invert_permutation", r.permutation(6).astype(np.int32))
    add("pad", f(3, 4), [(1, 2), (2, 1)], mode="reflect")
    add("gather", f(3, 5), np.array([0, -1, 7, 2], np.int32), axis=1)
    add("gather_nd", f(4, 5, 2),
        np.array([[0, 1], [3, 4], [9, 1], [-1, 2]], np.int32))
    add("take", f(3, 5), np.array([[0, 14], [-2, 20]], np.int32))
    add("take_along_axis", f(3, 5),
        np.array([[0, 4], [-1, 9], [2, 2]], np.int32), 1)
    sidx_u = np.array([0, 4, -1, 9], np.int32)        # -1 -> 5, 9 dropped
    sidx_d = np.array([1, 3, 1, 9, 0, 1], np.int32)   # duplicates
    # sums over duplicate indices: the card adds them in another order
    # than the CPU (atomics), so those ops hold to an ulp, not the bit
    dup_sum = (1e-6, 1e-6)
    add("scatter_update", f(6, 3), sidx_u, f(4, 3))
    for name in ("scatter_add", "scatter_sub"):
        add(name, f(6, 3), sidx_d, f(6, 3), tol=dup_sum)
    for name in ("scatter_max", "scatter_min"):
        add(name, f(6, 3), sidx_d, f(6, 3))
    add("scatter_mul", u(0.5, 1.5, 6, 3), sidx_d, u(0.5, 1.5, 6, 3))
    add("scatter_div", u(0.5, 1.5, 6, 3), sidx_d, u(0.5, 1.5, 6, 3),
        tol=(1e-6, 0.0))
    nd_idx = np.array([[0, 1], [3, 4], [0, 1], [2, 0]], np.int32)
    add("scatter_nd", nd_idx, f(4), (4, 5), tol=dup_sum)
    add("onehot", ints(0, 5, 6), 5)
    add("dynamic_partition", f(6, 3), ints(0, 3, 6), 3)
    add("dynamic_stitch", [np.array([0, 2], np.int32),
                           np.array([1, 2, 4], np.int32)],
        [f(2, 3), f(3, 3)])
    add("sort", x, axis=1, descending=True)
    ties = np.round(f(3, 8) * 2).astype(np.float32)
    add("argsort", ties, axis=1, descending=False)
    add("top_k", ties, 3)
    add("in_top_k", f(4, 6), ints(0, 6, 4), 2)
    add("unique", ints(2, 6, 12), size=8)
    add("unique_with_counts", ints(2, 6, 12), size=3)
    add("listdiff", np.array([1, 5, 3, 5, 8, 2], np.int32),
        np.array([5, 2], np.int32))
    add("nth_element", f(3, 6), 2)
    add("searchsorted", np.sort(f(8)), f(5), side="right")
    # jnp.linspace steps in fp32, the port in fp64 rounded once
    add("linspace", 0.0, 1.0, 7, tol=(1e-6, 1e-7))
    add("logspace", 0.0, 2.0, 5, tol=(1e-6, 1e-7))
    add("arange", 0, 10, 3)
    add("eye", 3, 4)
    add("zeros", (2, 3))
    add("ones", (2, 3))
    add("full", (2, 3), 1.5)
    add("meshgrid", f(3), f(4))
    add("space_to_depth", f(2, 4, 4, 3), 2)
    add("depth_to_space", f(2, 2, 2, 12), 2)
    add("space_to_batch", f(2, 4, 6, 3), [2, 3], [[0, 0], [0, 0]])
    add("batch_to_space", f(12, 2, 2, 3), [2, 3], [[0, 1], [1, 0]])
    seg = np.array([0, 0, 1, 3, 3, 3], np.int32)
    add("segment_sum", f(6, 3), seg, 5)
    add("segment_max", f(6, 3), seg, 5)
    add("segment_min", f(6, 3), seg, 5, empty_fill=0.0)
    add("segment_mean", f(6, 3), seg, 5)
    add("segment_prod", f(6, 3), seg, 5)
    add("batch_gather", f(3, 5, 2), ints(0, 5, 3, 2))
    add("tensor_scatter_update", f(4, 5), np.array([[1], [3]], np.int32),
        f(2, 5))
    add("sparse_to_dense", np.array([[0, 1], [2, 3], [3, 0]], np.int32),
        (4, 5), f(3))
    add("confusion_matrix", ints(0, 4, 10), ints(0, 4, 10), 4)
    add("tensorlist_reserve", 3)
    add("tensorlist_from_tensor", f(3, 4))
    add("tensorlist_get_item", f(3, 4), 1)
    add("tensorlist_set_item", np.zeros((3, 0), np.float32), 1, f(4))
    add("tensorlist_stack", f(3, 4))
    add("tensorlist_length", f(3, 4))
    add("reverse_sequence", f(3, 5, 2), np.array([2, 5, 1], np.int32))
    add("matrix_band_part", f(4, 5), 1, 2)
    add("mergeadd", f(3, 4), f(3, 4), f(3, 4), tol=(1e-6, 1e-7))
    add("mergeavg", f(3, 4), f(3, 4), tol=(1e-6, 1e-7))
    add("mergemax", f(3, 4), f(3, 4), f(3, 4))
    add("scatter_nd_add", f(4, 5), nd_idx, f(4), tol=dup_sum)
    add("scatter_nd_sub", f(4, 5), nd_idx, f(4), tol=dup_sum)
    add("scatter_nd_update", f(4, 5), np.array([[0, 1], [3, 4]], np.int32),
        f(2))
    add("tear", x, axis=1)
    add("bitcast", f(3, 4), "int32")
    add("broadcast_dynamic_shape", np.array([3, 1], np.int32),
        np.array([1, 4], np.int32))
    add("put_along_axis", f(3, 5), np.array([[0, 2], [4, 4], [1, 3]],
                                            np.int32), f(3, 2), axis=1,
        reduction="add")

    # -------------------------------------------------------------------- nn
    add = family("nn")
    xi = f(2, 6, 6, 3)
    add("conv2d", xi, f(3, 3, 3, 4), f(4), strides=(2, 1), padding="SAME")
    add("conv1d", f(2, 9, 3), f(3, 3, 4), stride=2)
    add("conv3d", f(1, 4, 5, 5, 2), f(2, 3, 3, 2, 3))
    add("depthwise_conv2d", xi, f(3, 3, 3, 2))
    add("separable_conv2d", xi, f(3, 3, 3, 1), f(1, 1, 3, 5))
    add("deconv2d", f(2, 4, 4, 3), f(3, 3, 3, 5), strides=(2, 2))
    add("upsampling2d", f(1, 2, 3, 2), 2)
    add("im2col", f(1, 5, 5, 2), (3, 3), strides=(2, 2), padding=(1, 1))
    add("col2im", f(1, 18, 3, 3), (1, 5, 5, 2), (3, 3), strides=(2, 2),
        padding=(1, 1))
    add("maxpool2d", xi, (3, 3), (2, 2), "SAME")
    add("avgpool2d", xi, (3, 3), (2, 2), "SAME")
    add("pnormpool2d", xi, (2, 2), p=2)
    add("global_avg_pool", xi)
    add("global_max_pool", xi, keepdims=True)
    add("maxpool3d", f(1, 4, 4, 4, 2), (2, 2, 2))
    add("avgpool3d", f(1, 5, 5, 5, 2), (3, 3, 3), (2, 2, 2), "SAME")
    add("batchnorm", xi, f(3), pos(3), f(3), f(3))
    add("batchnorm_train", xi, pos(3), f(3), f(3), pos(3))
    add("layernorm", f(4, 6), pos(6), f(6))
    add("rmsnorm", f(4, 6), pos(6))
    add("standardize", f(4, 6))
    add("lrn", f(1, 2, 2, 8), depth_radius=2)
    add("l2_normalize", f(4, 6))
    add("moments", f(4, 5, 3), (0, 1))
    add("softmax", f(4, 6))
    add("log_softmax", f(4, 6))
    add("softmax_derivative", f(4, 6), f(4, 6))
    onehot = np.eye(5, dtype=np.float32)[ints(0, 5, 4)]
    add("softmax_cross_entropy", f(4, 5), onehot, label_smoothing=0.1)
    add("sparse_softmax_cross_entropy", f(4, 5), ints(0, 5, 4))
    add("sigmoid_cross_entropy", f(4, 5), u(0, 1, 4, 5))
    labels01 = (r.random((4, 5)) > 0.5).astype(np.float32)
    for name in ("mse_loss", "mae_loss", "huber_loss",
                 "cosine_distance_loss"):
        add(name, f(4, 5), f(4, 5))
    add("hinge_loss", f(4, 5), labels01)
    add("squared_hinge_loss", f(4, 5), labels01)
    add("log_loss", u(0.05, 0.95, 4, 5), labels01)
    add("poisson_loss", pos(4, 5), pos(4, 5))
    p_soft = np.exp(f(4, 5))
    p_soft /= p_soft.sum(axis=1, keepdims=True)
    q_soft = np.exp(f(4, 5))
    q_soft /= q_soft.sum(axis=1, keepdims=True)
    add("kl_divergence", p_soft.astype(np.float32), q_soft.astype(np.float32))
    add("l2_loss", f(4, 5))
    lp = f(2, 8, 5)
    lp = (lp - np.log(np.exp(lp).sum(-1, keepdims=True))).astype(np.float32)
    add("ctc_loss", lp, np.array([[1, 2, 2], [3, 4, 0]], np.int32),
        np.array([8, 6], np.int32), np.array([3, 2], np.int32),
        tol=(1e-5, 1e-5))
    add("dot_product_attention", f(2, 3, 5, 8), f(2, 3, 5, 8), f(2, 3, 5, 8),
        is_causal=True)
    add("multihead_attention", f(2, 4, 8), f(2, 5, 8), f(8, 8), f(8, 8),
        f(8, 8), f(8, 8), 2)
    add("embedding_lookup", f(10, 4), ints(0, 10, 3, 2))
    add("bias_add", xi, f(3))
    add("xw_plus_b", f(4, 6), f(6, 3), f(3))
    add("batch_dot", f(3, 4), f(3, 4))
    add("weighted_cross_entropy_with_logits", u(0, 1, 4, 5), f(4, 5), 2.0)
    add("relu_grad", f(4, 5), f(4, 5))
    add("relu6_grad", f(4, 5), f(4, 5) * 5)
    add("tanh_grad", u(-0.9, 0.9, 4, 5), f(4, 5))
    add("sigmoid_grad", u(0.1, 0.9, 4, 5), f(4, 5))
    add("bias_add_grad", f(2, 3, 3, 4))
    add("conv2d_backprop_input", f(3, 3, 3, 4), f(2, 3, 6, 4), (2, 6, 6, 3),
        strides=(2, 1))
    add("conv2d_backprop_filter", xi, f(2, 3, 6, 4), (3, 3, 3, 4),
        strides=(2, 1))
    add("maxpool2d_grad", f(1, 4, 4, 2), f(1, 2, 2, 2))
    add("avgpool2d_grad", f(1, 4, 4, 2), f(1, 2, 2, 2))
    add("fused_batch_norm_grad", f(2, 3, 3, 4), f(2, 3, 3, 4), pos(4), f(4),
        pos(4))
    add("softmax_cross_entropy_with_logits_grad", f(4, 5), onehot)
    add("strided_slice_grad", f(2, 3), (4, 5, 6),
        [("s", 0, 4, 2), ("i", 1), ("s", 1, 4, 1)])
    add("normalize_moments", np.float32(4.0), f(3), pos(3))
    add("log_poisson_loss", f(4, 5), pos(4, 5) * 2, True)
    add("dilation2d", f(1, 5, 5, 2), f(2, 2, 2))
    add("erosion2d", f(1, 5, 5, 2), f(2, 2, 2))
    add("max_pool_with_argmax", f(2, 4, 4, 3), (2, 2),
        include_batch_in_index=True)
    add("deconv3d", f(1, 2, 3, 3, 2), f(2, 2, 2, 2, 3), strides=(2, 2, 2))
    add("upsampling3d", f(1, 2, 2, 2, 2), 2)
    add("relu_layer", f(3, 4), f(4, 5), f(5))
    add("mean_pairwssqerr_loss", f(3, 4), f(3, 4))
    lp2 = f(2, 6, 4)
    lp2 = (lp2 - np.log(np.exp(lp2).sum(-1, keepdims=True))).astype(
        np.float32)
    add("ctc_beam_search_decoder", lp2, beam_width=4, top_paths=2)
    lp3 = f(3, 5)
    lp3 = (lp3 - np.log(np.exp(lp3).sum(-1, keepdims=True))).astype(
        np.float32)
    add("nll_loss", lp3, np.array([0, 2, 4], np.int32), pos(5),
        ignore_index=2)
    add("max_unpool2d", f(1, 2, 2, 1), np.array([0, 6, 9, 15], np.int32),
        (1, 4, 4, 1))

    # ------------------------------------------------------------------- rnn
    add = family("rnn")
    add("lstm_layer", f(5, 3, 4), f(2, 24, 4) * 0.4, f(2, 24, 6) * 0.4,
        f(2, 48) * 0.1, np.array([5, 3, 2], np.int32), hidden_size=6,
        direction="bidirectional")
    add("gru_layer", f(3, 5, 4), f(2, 18, 4) * 0.4, f(2, 18, 6) * 0.4,
        f(2, 36) * 0.1, np.array([5, 3, 2], np.int32), hidden_size=6,
        direction="bidirectional", layout=1, linear_before_reset=1)
    add("rnn_layer", f(5, 3, 4), f(1, 6, 4) * 0.4, f(1, 6, 6) * 0.4,
        f(1, 12) * 0.1, hidden_size=6, direction="reverse")
    add("lstm_cell", f(3, 4), f(3, 6), f(3, 6), f(24, 4) * 0.4,
        f(24, 6) * 0.4, f(48) * 0.1)
    add("gru_cell", f(3, 4), f(3, 6), f(18, 4) * 0.4, f(18, 6) * 0.4,
        f(36) * 0.1, linear_before_reset=0)
    add("sequence_mask", np.array([1, 3, 2], np.int32), maxlen=4)
    add("sru_cell", f(3, 4), f(3, 4), f(12, 4) * 0.4, f(8) * 0.1)
    add("sru", f(3, 5, 4), f(12, 4) * 0.4, f(8) * 0.1,
        mask=(r.random((3, 5)) > 0.3).astype(np.float32))
    add("conv_lstm_2d", f(2, 3, 5, 5, 2), f(3, 3, 2, 12) * 0.3,
        f(3, 3, 3, 12) * 0.3, f(12) * 0.1)
    add("lstm_block_cell", f(3, 4), f(3, 5), f(3, 5), f(9, 20) * 0.4, f(5),
        f(5), f(5), f(20) * 0.1, use_peephole=True, cell_clip=1.0)
    add("lstm_block", 3, f(4, 3, 4), f(3, 5), f(3, 5), f(9, 20) * 0.4, f(5),
        f(5), f(5), f(20) * 0.1)
    rnn_w = (f(2, 5) * 0.5, f(5, 5) * 0.4, f(5) * 0.1)
    add("static_rnn", f(4, 3, 2), *rnn_w,
        seq_lens=np.array([4, 2, 3], np.int32))
    add("dynamic_rnn", f(3, 4, 2), *rnn_w, time_major=False)
    add("static_bidirectional_rnn", f(4, 3, 2), *rnn_w, f(2, 5) * 0.5,
        f(5, 5) * 0.4, f(5) * 0.1, seq_lens=np.array([4, 2, 3], np.int32))
    add("dynamic_bidirectional_rnn", f(4, 3, 2), *rnn_w, f(2, 5) * 0.5,
        f(5, 5) * 0.4, f(5) * 0.1)
    add("sru_bi", f(4, 3, 6), f(2, 9, 3) * 0.4, f(2, 6) * 0.1)

    # ---------------------------------------------------------------- linalg
    add = family("linalg")
    add("matmul", f(2, 4, 3), f(2, 4, 5), transpose_a=True)
    add("tensormmul", f(3, 4, 5), f(4, 5, 2), [1, 2], [0, 1])
    add("einsum", "ij,jk->ik", f(3, 4), f(4, 2))
    add("einsum_apply", f(2, 3, 4), f(2, 4, 2), equation="bij,bjk->bik")
    add("mmul_vector", f(3, 4), f(4))
    add("vdot", f(3, 4), f(3, 4))
    add("outer", f(3), f(4))
    add("batched_gemm", f(2, 3, 4), f(2, 5, 4), transpose_b=True)
    add("matrix_diag", f(2, 3))
    add("matrix_diag_part", f(2, 3, 3))
    add("diag", f(4))
    add("trace", f(2, 3, 3))
    add("matrix_inverse", spd(4))
    add("matrix_determinant", f(3, 3))
    add("log_matrix_determinant", spd(3))
    add("cholesky", spd(4))
    add("qr", f(5, 3), check="qr")
    add("svd", f(4, 3), check="svd")
    add("lstsq", f(5, 3), f(5, 2))
    add("solve", spd(3), f(3, 2))
    add("triangular_solve", np.tril(f(3, 3)) + 3 * np.eye(3, dtype=np.float32),
        f(3, 2), lower=True)
    add("lu", f(4, 4), check="lu")
    add("eigh", (lambda a: (a + a.T) / 2)(f(4, 4)), check="eigh")
    add("eig", f(3, 3), check="eig")
    add("cross", f(4, 3), f(4, 3))
    add("tri", 3, 4, 1)
    add("triu", f(4, 4), 1)
    add("tril", f(4, 4), -1)
    add("kron", f(2, 2), f(2, 3))
    add("vander", f(4), n=3)
    add("toeplitz", f(3), f(4))
    add("pinv", f(4, 3))
    add("slogdet", f(3, 3))
    add("matrix_power", f(3, 3), 3)
    add("matrix_rank", f(4, 2) @ f(2, 4))
    add("expm", f(3, 3) * 0.5)
    add("sqrtm", spd(3))
    add("adjoint", f(3, 4))
    add("logdet", spd(3))
    add("cond_number", f(3, 3))
    add("lup", f(4, 4), check="lup")
    add("matrix_set_diag", f(3, 4), f(3))
    add("solve_ls", f(5, 3), f(5, 2), 0.1)
    add("sufficient_statistics", f(3, 4), (0,))

    # ---------------------------------------------------------------- random
    add = family("random")
    n = 20000
    add("random_split_key", Key(0), 3, check="split")
    add("random_uniform", Key(1), (n,), -1.0, 2.0, check="moments")
    add("random_normal", Key(2), (n,), 1.0, 2.0, check="moments")
    add("random_truncated_normal", Key(3), (n,), check="moments")
    add("random_lognormal", Key(4), (n,), 0.0, 0.5, check="moments")
    add("random_bernoulli", Key(5), (n,), 0.3, check="moments")
    add("random_binomial", Key(6), (n,), 10, 0.3, check="moments")
    add("random_exponential", Key(7), (n,), 2.0, check="moments")
    add("random_gamma", Key(8), (n,), 2.5, check="moments")
    add("random_poisson", Key(9), (n,), 3.0, check="moments")
    add("random_categorical", Key(10), f(5), num_samples=n, check="moments")
    add("random_shuffle", Key(11), np.arange(100, dtype=np.int32),
        check="shuffle")
    add("random_choice", Key(12), 10, (n,), check="moments")
    add("dropout", np.ones(n, np.float32), Key(13), 0.3, check="moments")
    add("dropout_inverted", np.ones(n, np.float32), Key(14), 0.7,
        check="moments")
    add("alpha_dropout", f(n), Key(15), 0.2, check="moments")

    # ----------------------------------------------------------------- image
    add = family("image")
    img = f(2, 5, 7, 3)
    add("image_resize", img, (8, 4), "bilinear")
    add("resize_bilinear", img, (3, 10))
    add("resize_nearest", img, (9, 4))
    add("resize_bicubic", img, (7, 5))
    add("crop_and_resize", f(2, 6, 7, 3),
        np.array([[0.1, 0.2, 0.8, 0.9], [0.0, 0.0, 1.0, 1.0],
                  [0.5, -0.1, 1.2, 0.7]], np.float32),
        np.array([0, 1, 1], np.int32), (4, 5))
    add("extract_image_patches", f(2, 6, 6, 3), (3, 2), (2, 1), (1, 2),
        "SAME")
    yx = u(0, 10, 8, 2)
    hw = u(2, 5, 8, 2)
    add("non_max_suppression", np.concatenate([yx, yx + hw], 1), u(0, 1, 8),
        5, 0.3)
    rgb = u(0, 1, 2, 4, 4, 3)
    for name in ("rgb_to_grayscale", "rgb_to_yuv", "yuv_to_rgb",
                 "rgb_to_hsv", "hsv_to_rgb", "flip_left_right",
                 "flip_up_down"):
        add(name, rgb)
    add("adjust_brightness", rgb, 0.1)
    add("adjust_contrast", rgb, 1.5)
    add("adjust_saturation", rgb, 0.7)
    add("adjust_hue", rgb, 0.2)
    add("random_crop", Key(16), f(2, 6, 7, 3), (3, 4), check="crop")
    add("ssim", u(0, 1, 2, 16, 16, 3), u(0, 1, 2, 16, 16, 3))
    add("grid_sample", f(2, 3, 5, 6), u(-1.2, 1.2, 2, 4, 3, 2))
    add("roi_align", f(2, 3, 8, 8),
        np.array([[1.0, 1.0, 6.0, 5.0], [0.0, 2.0, 7.0, 7.0]], np.float32),
        np.array([0, 1], np.int32), (3, 3))

    # ---------------------------------------------------------------- signal
    add = family("signal")
    add("fft", f(3, 8))
    add("ifft", f(3, 8))
    add("rfft", f(3, 8))
    add("irfft", np.fft.rfft(f(3, 8)).astype(np.complex64), n=8)
    add("hann_window", 8)
    add("hamming_window", 7, False)
    add("blackman_window", 9)
    add("stft", f(2, 64), np.hanning(16).astype(np.float32), frame_length=16,
        frame_step=8)
    add("mel_weight_matrix", 8, 64, 16000, 20.0, 8000.0)
    add("complex_pack", f(3, 4, 2))
    add("complex_unpack", (f(3, 4) + 1j * f(3, 4)).astype(np.complex64))

    # ----------------------------------------------------------- updater_ops
    add = family("updater_ops")
    g = f(4, 5)
    add("sgd_updater", g, lr=0.1)
    add("apply_sgd", f(4, 5), g, lr=0.1)
    add("nesterovs_updater", g, f(4, 5), lr=0.1, momentum=0.9, iteration=3)
    add("ada_grad_updater", g, pos(4, 5), lr=0.1)
    add("rms_prop_updater", g, pos(4, 5), lr=0.1)
    add("ada_delta_updater", g, pos(4, 5), pos(4, 5))
    add("adam_updater", g, f(4, 5), pos(4, 5), lr=0.01, iteration=4)
    add("ada_max_updater", g, f(4, 5), pos(4, 5), lr=0.01, iteration=2)
    add("ams_grad_updater", g, f(4, 5), pos(4, 5), pos(4, 5), lr=0.01,
        iteration=2)
    add("nadam_updater", g, f(4, 5), pos(4, 5), lr=0.01, iteration=2)

    # ----------------------------------------------------------- compression
    add = family("compression")
    add("pow2_floor", pos(10) * 3)
    add("threshold_encode", f(50), 0.5)
    add("threshold_encode_exact", f(50), 0.3)
    add("onebit_encode", f(50))
    add("threshold_decode", f(5), f(5))
    add("bitmap_encode", f(37), 0.5)
    add("bitmap_decode", _pack_codes(r.integers(0, 3, 37)), 0.5, (37,))
    add("quantize_per_channel", f(4, 3) * 3, u(0.01, 0.05, 1, 3))
    add("dequantize_per_channel",
        r.integers(-127, 128, (4, 3)).astype(np.int8), u(0.01, 0.05, 1, 3))

    # --------------------------------------------------------------- nlp_ops
    add = family("nlp_ops")
    samples = np.array([1, 5, 5, 2], np.int32)
    lab = np.array([1, 0, 0, 0], np.float32)
    add("skipgram", f(10, 4), f(12, 4), 3, samples, lab, 0.1)
    add("cbow", f(10, 4), f(12, 4), np.array([1, 2, 2, 7], np.int32),
        samples, lab, 0.1, context_mask=np.array([1, 1, 0, 1], np.float32))
    rows, cols = ints(0, 6, 8), ints(0, 6, 8)
    add("barnes_symmetrized", rows, cols, pos(8))
    add("barnes_edge_forces", rows, cols, pos(8), f(6, 2))
    add("barnes_gains", pos(6, 2), f(6, 2), f(6, 2))
    add("cell_contains", f(2), pos(2), f(2))
    add("knn_mindistance", f(3) * 2, -pos(3) * 0.3, pos(3) * 0.3)

    # ------------------------------------------------------------- attention
    add = family("attention")
    add("flash_attention", f(2, 2, 6, 8), f(2, 2, 6, 8), f(2, 2, 6, 8),
        causal=True)
    add("multi_head_dot_product_attention", f(2, 5, 8), f(2, 5, 8),
        f(2, 5, 8), f(8, 8), f(8, 8), f(8, 8), f(8, 6), 2)
    return cases



# ---------------------------------------------------------------------------
# Running a case and holding its result to another
# ---------------------------------------------------------------------------


def materialize(v, tensor: Callable, key: Callable):
    """A case argument for one framework: numpy arrays and scalars through
    ``tensor``, :class:`Key` through ``key``, lists and tuples element by
    element; Python values as they are."""
    if isinstance(v, (np.ndarray, np.generic)):
        return tensor(np.asarray(v))
    if isinstance(v, Key):
        return key(v)
    if isinstance(v, list):
        return [materialize(e, tensor, key) for e in v]
    if isinstance(v, tuple) and any(isinstance(e, (np.ndarray, Key))
                                    for e in v):
        return tuple(materialize(e, tensor, key) for e in v)
    return v


def run(exec_op: Callable, name: str, case: Case, tensor: Callable,
        key: Callable):
    """``exec_op(name, *args, **kwargs)`` on the case's inputs."""
    args = [materialize(a, tensor, key) for a in case.args]
    kwargs = {k: materialize(v, tensor, key) for k, v in case.kwargs.items()}
    return exec_op(name, *args, **kwargs)


def to_numpy(out):
    """A result as nested lists of numpy arrays and Python values (a torch
    bfloat16 tensor as float32)."""
    if isinstance(out, (list, tuple)):
        return [to_numpy(o) for o in out]
    if hasattr(out, "detach"):
        t = out.detach().cpu().resolve_conj()
        if str(t.dtype) == "torch.bfloat16":
            t = t.float()
        return t.numpy()
    if hasattr(out, "__array__") and not isinstance(out, (int, float, bool)):
        return np.asarray(out)
    return out


def _leaves(tree):
    if isinstance(tree, list):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


def _close(got, want, rtol, atol, what):
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {got.shape} != {want.shape}")
    if got.size == 0:
        return 0.0
    if got.dtype == np.bool_ or want.dtype == np.bool_ or (
            np.issubdtype(want.dtype, np.integer)):
        if not np.array_equal(got, want):
            raise AssertionError(f"{what}: {got} != {want}")
        return 0.0
    g, w = got.astype(np.complex128 if np.iscomplexobj(got)
                      else np.float64), want.astype(
        np.complex128 if np.iscomplexobj(want) else np.float64)
    same_nan = np.isnan(g) == np.isnan(w)
    if not same_nan.all():
        raise AssertionError(f"{what}: NaN at different places")
    ok = ~np.isnan(w)
    err = np.abs(g[ok] - w[ok]) if ok.any() else np.zeros(1)
    finite = np.isfinite(w[ok]) if ok.any() else np.ones(1, bool)
    if ok.any() and not np.array_equal(g[ok][~finite], w[ok][~finite]):
        raise AssertionError(f"{what}: infinities differ")
    err = np.where(finite, err, 0.0)
    bound = atol + rtol * np.abs(np.where(finite, w[ok], 0.0)) \
        if ok.any() else np.zeros(1)
    if (err > bound).any():
        raise AssertionError(f"{what}: max abs err {err.max()} beyond "
                             f"rtol {rtol}, atol {atol}")
    return float(err.max()) if err.size else 0.0


def _dtypes_equal(got, want, what):
    for g, w in zip(_leaves(got), _leaves(want)):
        if isinstance(w, np.ndarray) and isinstance(g, np.ndarray):
            if g.dtype != w.dtype:
                raise AssertionError(f"{what}: dtype {g.dtype} != {w.dtype}")


def _decomposition(check, a, got, rtol, atol):
    a = np.asarray(a, np.float64)
    g = [np.asarray(v) for v in got]
    eye = np.eye

    def near(x, y, what):
        return _close(x, y, rtol, atol * max(1.0, np.abs(a).max()), what)

    if check == "qr":
        q, r = g
        return max(near(q @ r, a, "Q R"),
                   near(q.T @ q, eye(q.shape[1]), "Q^T Q"),
                   near(np.tril(r, -1), 0 * np.tril(r, -1), "R lower"))
    if check == "svd":
        uu, s, vh = g
        return near((uu * s) @ vh, a, "U S Vh")
    if check == "eigh":
        w, v = g
        return max(near(a @ v, v * w, "A v"),
                   near(v.T @ v, eye(v.shape[1]), "V^T V"))
    if check == "eig":
        w, v = g
        return near(a.astype(np.complex128) @ v, v * w, "A v")
    if check in ("lu", "lup"):
        if check == "lu":
            lu, _, perm = g
            low = np.tril(lu, -1) + eye(lu.shape[0])
            up = np.triu(lu)
        else:
            low, up, perm = g
        return near(low @ up, a[np.asarray(perm)], "L U")
    raise ValueError(check)


def compare(case: Case, got, want) -> float:
    """Hold ``got`` to ``want`` (both :func:`to_numpy` trees) as
    ``case.check`` says; returns the largest abs error seen (0 where the
    check is structural) and raises AssertionError on a mismatch."""
    rtol, atol = case.tolerance()
    if case.check == "split":
        if len(got) != len(want):
            raise AssertionError(f"{len(got)} streams != {len(want)}")
        return 0.0
    if case.check in ("qr", "svd", "eig", "eigh", "lu", "lup"):
        a = case.args[0]
        err = _decomposition(case.check, a, got, 1e-4, 1e-4)
        if case.check == "svd":
            err = max(err, _close(got[1], want[1], 1e-4, 1e-4, "spectrum"))
        if case.check == "eigh":
            err = max(err, _close(got[0], want[0], 1e-4, 1e-4, "spectrum"))
        if case.check == "eig":
            key = (lambda w: np.lexsort((np.round(w.imag, 4),
                                         np.round(w.real, 4))))
            gw, ww = np.asarray(got[0]), np.asarray(want[0])
            err = max(err, _close(gw[key(gw)], ww[key(ww)], 1e-4, 1e-4,
                                  "spectrum"))
        if case.check == "lu":
            _close(got[1], want[1], 0, 0, "pivots")
        _dtypes_equal(got, want, "decomposition")
        return err
    gl, wl = _leaves(got), _leaves(want)
    if case.check in ("moments", "shuffle", "crop"):
        g, w = np.asarray(gl[0]), np.asarray(wl[0])
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"draw {g.shape} {g.dtype} != "
                                 f"{w.shape} {w.dtype}")
        if case.check == "shuffle":
            if not np.array_equal(np.sort(g, axis=0), np.sort(w, axis=0)):
                raise AssertionError("not a permutation of the input")
            return 0.0
        if case.check == "crop":
            src = np.asarray(case.args[1])
            hits = [(oy, ox) for oy in range(src.shape[1] - g.shape[1] + 1)
                    for ox in range(src.shape[2] - g.shape[2] + 1)
                    if np.array_equal(src[:, oy:oy + g.shape[1],
                                          ox:ox + g.shape[2]], g)]
            if not hits:
                raise AssertionError("the crop is no window of the input")
            return 0.0
        gd, wd = g.astype(np.float64), w.astype(np.float64)
        mb, sb = moment_bounds(float(wd.std()), wd.size)
        dm, ds = abs(gd.mean() - wd.mean()), abs(gd.std() - wd.std())
        if dm > mb or ds > sb:
            raise AssertionError(f"moments: mean {gd.mean()} vs {wd.mean()}"
                                 f" (bound {mb}), std {gd.std()} vs "
                                 f"{wd.std()} (bound {sb})")
        return float(max(dm, ds))
    if len(gl) != len(wl):
        raise AssertionError(f"{len(gl)} outputs != {len(wl)}")
    err = 0.0
    for i, (g, w) in enumerate(zip(gl, wl)):
        if isinstance(w, np.ndarray) or isinstance(g, np.ndarray):
            if isinstance(w, np.ndarray) and isinstance(g, np.ndarray) \
                    and g.dtype != w.dtype:
                raise AssertionError(f"output {i}: dtype {g.dtype} != "
                                     f"{w.dtype}")
            err = max(err, _close(g, w, rtol, atol, f"output {i}"))
        elif isinstance(w, float) or isinstance(g, float):
            err = max(err, _close(np.float64(g), np.float64(w), rtol, atol,
                                  f"output {i}"))
        elif g != w:
            raise AssertionError(f"output {i}: {g!r} != {w!r}")
    return err
