"""The port's op table against the reference's as a table: the same names,
aliases, categories and differentiability; a seeded case for every op;
the registry helpers; by-name ``dot_product_attention`` resolving to the
reference's ``ops/nn.py`` form (the registry's last registration of the
name); and the ops that reach the conv and LSTM kernels, on the CPU path their kernels'
plain versions take (no launches counted, ``cuda`` raising)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deeplearning4j_tpu.ops as ref_ops  # noqa: E402
import deeplearning4j_tpu_torch.ops as port_ops  # noqa: E402
from deeplearning4j_tpu.ops import registry as ref_registry  # noqa: E402
from deeplearning4j_tpu_torch.ops import kernels as TK  # noqa: E402
from deeplearning4j_tpu_torch.ops import nn as tnn  # noqa: E402
from deeplearning4j_tpu_torch.ops import op_cases as oc  # noqa: E402
from deeplearning4j_tpu_torch.ops import registry  # noqa: E402
from deeplearning4j_tpu_torch.ops import rnn as trnn  # noqa: E402

CASES = oc.build(0)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _table(ops, reg, pkg):
    """(names, categories, aliases) of an op table as its package's
    ``ops`` fills it: without what other modules of the package register
    when a test imports them (SameDiff's ``getitem``, item 8's) and the
    custom ops recorded SameDiff graphs add (``__custom__:...``)."""
    def own(n):
        mod = ops.get_op(n).fn.__module__ or ""
        return not n.startswith("__custom__") and (
            not mod.startswith(pkg + ".") or mod.startswith(pkg + ".ops"))

    names = [n for n in ops.list_ops() if own(n)]
    cats = {}
    for n in names:
        c = ops.get_op(n).category
        cats[c] = cats.get(c, 0) + 1
    aliases = {a: n for a, n in reg._ALIASES.items() if n in names}
    return names, cats, aliases


def _reference_table():
    return _table(ref_ops, ref_registry, "deeplearning4j_tpu")


def _port_table():
    return _table(port_ops, registry, "deeplearning4j_tpu_torch")


def test_names_aliases_categories_equal_reference():
    names, cats, aliases = _reference_table()
    mine, my_cats, my_aliases = _port_table()
    assert mine == names
    assert len(mine) == len(names) == 482
    assert my_cats == cats
    assert my_aliases == aliases
    for name in names:
        mine, theirs = registry.get_op(name), ref_ops.get_op(name)
        assert (mine.category, mine.aliases, mine.differentiable) == (
            theirs.category, theirs.aliases, theirs.differentiable), name


def test_every_op_has_a_case():
    assert set(CASES) == set(_port_table()[0])
    assert all(c.family in oc.TOLERANCES for c in CASES.values())


def test_registry_helpers():
    port_ops.add_alias("my_relu_alias", "relu")
    try:
        assert registry.get_op("my_relu_alias").name == "relu"
    finally:
        registry._ALIASES.pop("my_relu_alias")
    with pytest.raises(registry.OpNotFoundError):
        port_ops.add_alias("x", "no_such_op")
    with pytest.raises(registry.OpNotFoundError):
        port_ops.get_op("no_such_op")
    spec = port_ops.shape_of("matmul", port_ops.ShapeDtype((2, 3, 4),
                                                          torch.float32),
                             port_ops.ShapeDtype((2, 4, 5), torch.float32))
    assert spec == port_ops.ShapeDtype((2, 3, 5), torch.float32)
    ref = ref_ops.shape_of("matmul", jax.ShapeDtypeStruct((2, 3, 4),
                                                          jnp.float32),
                           jax.ShapeDtypeStruct((2, 4, 5), jnp.float32))
    assert tuple(ref.shape) == spec.shape


@pytest.mark.parametrize("masked", [False, True])
def test_dot_product_attention_by_name_is_the_nn_form(masked):
    """exec_op("dot_product_attention") takes ``is_causal`` and a boolean
    mask, as the reference's ops/nn.py:661 does, and agrees with the
    reference to 1e-6 in fp32."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 3, 5, 8)).astype(np.float32)
               for _ in range(3))
    kw = {"is_causal": True}
    if masked:
        kw = {"mask": rng.random((2, 1, 5, 5)) > 0.3}
    want = np.asarray(ref_ops.exec_op("dot_product_attention",
                                      *map(jnp.asarray, (q, k, v)),
                                      **{n: (jnp.asarray(a) if masked else a)
                                         for n, a in kw.items()}))
    got = port_ops.exec_op("dot_product_attention", *map(_t, (q, k, v)),
                           **{n: (_t(a) if masked else a)
                              for n, a in kw.items()})
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert registry.get_op("dotProductAttention").fn is \
        tnn.dot_product_attention


# --------------------------------------------- the ops behind the kernels

KERNEL_OPS = {"conv2d": "conv2d_fwd", "conv1d": "conv2d_fwd",
              "depthwise_conv2d": "conv2d_fwd",
              "separable_conv2d": "conv2d_fwd",
              "conv_lstm_2d": "conv2d_fwd",
              "conv2d_backprop_input": "conv2d_dgrad",
              "conv2d_backprop_filter": "conv2d_wgrad",
              "lstm_layer": "lstm_seq_fwd"}


@pytest.mark.parametrize("name", sorted(KERNEL_OPS))
def test_kernel_ops_take_the_plain_version_on_the_cpu(name):
    case = CASES[name]
    TK.reset_counts()
    with TK.impl_scope("auto"):
        oc.run(port_ops.exec_op, name, case, _t, None)
    assert TK.LAUNCHES == dict.fromkeys(TK.KERNELS, 0)
    with TK.impl_scope("cuda"), pytest.raises(RuntimeError, match="CUDA"):
        oc.run(port_ops.exec_op, name, case, _t, None)


def _lstm_case(direction, layout, seed):
    rng = np.random.default_rng(seed)
    d = 2 if direction == "bidirectional" else 1
    t_, b_, i_, h_ = 6, 4, 5, 7
    x = rng.standard_normal((t_, b_, i_)).astype(np.float32)
    if layout == 1:
        x = x.transpose(1, 0, 2).copy()
    w = (rng.standard_normal((d, 4 * h_, i_)) * 0.4).astype(np.float32)
    r = (rng.standard_normal((d, 4 * h_, h_)) * 0.4).astype(np.float32)
    b = (rng.standard_normal((d, 8 * h_)) * 0.1).astype(np.float32)
    lens = np.array([6, 2, 4, 5], np.int32)
    shape = (d, b_, h_) if layout == 0 else (b_, d, h_)
    h0 = rng.standard_normal(shape).astype(np.float32)
    c0 = rng.standard_normal(shape).astype(np.float32)
    return (x, w, r, b, lens, h0, c0), dict(hidden_size=h_,
                                             direction=direction,
                                             layout=layout)


@pytest.mark.parametrize("layout", [0, 1])
@pytest.mark.parametrize("direction", ["forward", "reverse",
                                       "bidirectional"])
def test_lstm_layer_kernel_route_matches_reference(direction, layout):
    """Both of the port's routes through ``lstm_layer`` (the plain step loop
    and the segment kernel's route, its launch replaced on the CPU by the
    kernel's plain version) against the reference, ragged seq_lens and
    initial states included."""
    args, kw = _lstm_case(direction, layout, 11)
    want = [np.asarray(o) for o in ref_ops.exec_op(
        "lstm_layer", *map(jnp.asarray, args), **kw)]
    got = [o.numpy() for o in port_ops.exec_op("lstm_layer",
                                               *map(_t, args), **kw)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    x, wt, rt, bt, lens, h0, c0 = map(_t, args)
    xs = x if layout == 0 else x.transpose(0, 1)
    h0s = h0 if layout == 0 else h0.transpose(0, 1)
    c0s = c0 if layout == 0 else c0.transpose(0, 1)
    h_ = kw["hidden_size"]
    for d, reverse in enumerate(trnn._directions(direction)):
        bias = bt[d, :4 * h_] + bt[d, 4 * h_:]
        xp = torch.matmul(xs, wt[d].t()) + bias
        ys, hf, cf = trnn._lstm_dir_kernel(xp, h0s[d], c0s[d],
                                           rt[d].t().contiguous(),
                                           lens.long(), reverse)
        y_ref = want[0][:, :, d] if layout == 1 else want[0][:, d]
        ys = ys if layout == 0 else ys.transpose(0, 1)
        np.testing.assert_allclose(ys.numpy(), y_ref, rtol=1e-5, atol=1e-5)
        h_ref = want[1][:, d] if layout == 1 else want[1][d]
        c_ref = want[2][:, d] if layout == 1 else want[2][d]
        np.testing.assert_allclose(hf.numpy(), h_ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(cf.numpy(), c_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layout", [0, 1])
@pytest.mark.parametrize("direction", ["forward", "reverse",
                                       "bidirectional"])
def test_lstm_layer_kernel_route_grads_match_jax_grad(direction, layout,
                                                      monkeypatch):
    """``lstm_layer``'s kernel route (each direction one
    ``LSTMSequenceFunction`` with its carries as Y; the launch replaced on
    the CPU by the kernel's plain version) is differentiable: the gradients
    of x, W, R, b, h0 and c0 against ``jax.grad`` of the reference, ragged
    seq_lens included (Y past a sequence's end is the frozen carry, so its
    cotangent passes through to the carry), within 1e-5."""
    args, kw = _lstm_case(direction, layout, 12)
    rng = np.random.default_rng(13)
    outs = ref_ops.exec_op("lstm_layer", *map(jnp.asarray, args), **kw)
    cts = [rng.standard_normal(np.shape(o)).astype(np.float32) for o in outs]
    diff = (0, 1, 2, 3, 5, 6)

    def ref_loss(*xs):
        full = list(map(jnp.asarray, args))
        for i, v in zip(diff, xs):
            full[i] = v
        return sum(jnp.sum(o * c) for o, c in zip(
            ref_ops.exec_op("lstm_layer", *full, **kw), cts))

    want = jax.grad(ref_loss, argnums=tuple(range(len(diff))))(
        *(jnp.asarray(args[i]) for i in diff))
    monkeypatch.setattr(TK, "dispatch", lambda *a: True)
    full = [_t(a) for a in args]
    for i in diff:
        full[i].requires_grad_(True)
    got = port_ops.exec_op("lstm_layer", *full, **kw)
    assert all(o.grad_fn is not None for o in got)
    sum((o * _t(c)).sum() for o, c in zip(got, cts)).backward()
    for i, w in zip(diff, want):
        np.testing.assert_allclose(full[i].grad.numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("data_format", ["NHWC", "NCHW"])
def test_conv_backprop_ops_match_reference(data_format):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 6, 3)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 4)).astype(np.float32)
    dy = rng.standard_normal((2, 4, 3, 4)).astype(np.float32)
    kw = dict(strides=(2, 2), padding="SAME", data_format=data_format)
    if data_format == "NCHW":
        x, dy = x.transpose(0, 3, 1, 2).copy(), dy.transpose(0, 3, 1, 2).copy()
    dx_ref = ref_ops.exec_op("conv2d_backprop_input", jnp.asarray(w),
                             jnp.asarray(dy), x.shape, **kw)
    dx = port_ops.exec_op("conv2d_backprop_input", _t(w), _t(dy), x.shape,
                          **kw)
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_ref), rtol=1e-5,
                               atol=1e-5)
    dw_ref = ref_ops.exec_op("conv2d_backprop_filter", jnp.asarray(x),
                             jnp.asarray(dy), w.shape, **kw)
    dw = port_ops.exec_op("conv2d_backprop_filter", _t(x), _t(dy), w.shape,
                          **kw)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_ref), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("size", [(9, 11), (3, 4), (5, 14)])
@pytest.mark.parametrize("method", ["bilinear", "cubic", "nearest"])
def test_resize_weights_match_jax_image_resize(method, size):
    """Up-, down- and mixed scaling of jax.image.resize (half-pixel
    centres, antialiasing when shrinking) by the port's own weights."""
    x = np.random.default_rng(2).standard_normal((2, 6, 7, 3)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2,) + size + (3,),
                                       method=method))
    got = port_ops.exec_op("image_resize", _t(x), size, method).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_random_ops_repeat_from_one_generator_state():
    for name, case in CASES.items():
        if case.family != "random" or case.check == "split":
            continue
        a, b = (oc.to_numpy(oc.run(
            port_ops.exec_op, name, case, _t,
            lambda k: torch.Generator().manual_seed(k.seed)))
            for _ in range(2))
        np.testing.assert_array_equal(np.asarray(a[0] if isinstance(a, list)
                                                 else a),
                                      np.asarray(b[0] if isinstance(b, list)
                                                 else b), err_msg=name)


def test_compression_buffers_equal_bit_for_bit():
    g = np.random.default_rng(9).standard_normal(1001).astype(np.float32)
    packed_ref, res_ref = ref_ops.exec_op("bitmap_encode", jnp.asarray(g),
                                          0.4)
    packed, res = port_ops.exec_op("bitmap_encode", _t(g), 0.4)
    assert packed.dtype == torch.uint32
    np.testing.assert_array_equal(packed.numpy(), np.asarray(packed_ref))
    np.testing.assert_array_equal(res.numpy(), np.asarray(res_ref))
    for name in ("threshold_encode_exact", "onebit_encode"):
        args = (0.25,) if name == "threshold_encode_exact" else ()
        want = ref_ops.exec_op(name, jnp.asarray(g), *args)
        got = port_ops.exec_op(name, _t(g), *args)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        np.testing.assert_array_equal((got[0] + got[1]).numpy(), g)


@pytest.mark.parametrize("name", ["floordiv", "mod", "fmod", "truncatediv"])
def test_integer_division_by_zero_matches_reference(name):
    """XLA's integer semantics, zero divisors included (torch raises on
    the CPU): x // 0 is -1 or -2, x % 0 is 0."""
    x = np.array([7, -7, 0, 5, -9, 9], np.int32)
    y = np.array([0, 0, 0, 2, 4, -4], np.int32)
    want = np.asarray(ref_ops.exec_op(name, jnp.asarray(x), jnp.asarray(y)))
    got = port_ops.exec_op(name, _t(x), _t(y)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["sort", "argsort", "top_k"])
def test_nan_orders_as_the_reference(name):
    x = np.array([[3.0, np.nan, 1.0, -np.inf, 1.0, np.inf]], np.float32)
    args = (3,) if name == "top_k" else ()
    want = ref_ops.exec_op(name, jnp.asarray(x), *args)
    got = port_ops.exec_op(name, _t(x), *args)
    for g, w in zip(got if name == "top_k" else [got],
                    want if name == "top_k" else [want]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# bf16 through both packages: each side rounds the same fp32 results to
# bf16, so a tie may round the other way: one bf16 ulp (2^-8 relative) of
# the largest output. jax.nn.softmax computes in bf16 where torch.softmax
# accumulates in fp32 (ROADMAP "known differences"): two ulps there.
BF16_OPS = [("gelu", (4, 16), 2.0 ** -8), ("tanh", (4, 16), 2.0 ** -8),
            ("softmax", (4, 16), 2.0 ** -7), ("layernorm", (4, 16), 2.0 ** -8),
            ("matmul", (16, 16), 2.0 ** -8)]


@pytest.mark.parametrize("name,shape,tol", BF16_OPS,
                         ids=[n for n, _, _ in BF16_OPS])
def test_bf16_matches_reference(name, shape, tol):
    rng = np.random.default_rng(4)
    args = [rng.standard_normal(shape).astype(np.float32)]
    if name == "matmul":
        args.append(rng.standard_normal(shape).astype(np.float32))
    want = np.asarray(ref_ops.exec_op(name, *(jnp.asarray(a, jnp.bfloat16)
                                              for a in args))
                      ).astype(np.float32)
    got = port_ops.exec_op(name, *(_t(a).to(torch.bfloat16) for a in args))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= tol, err


def test_sequence_mask_without_maxlen_works_where_the_reference_raises():
    """The reference's sequence_mask reads ``np`` it never imports
    (deeplearning4j_tpu/ops/rnn.py:296-310), so a call without
    ``maxlen`` raises NameError there; the port takes the largest length,
    as the reference's docstring says. With ``maxlen`` both agree."""
    lens = np.array([1, 3, 2], np.int32)
    with pytest.raises(NameError):
        ref_ops.exec_op("sequence_mask", jnp.asarray(lens))
    got = port_ops.exec_op("sequence_mask", _t(lens))
    want = np.asarray(ref_ops.exec_op("sequence_mask", jnp.asarray(lens),
                                      maxlen=3))
    np.testing.assert_array_equal(got.numpy(), want)
