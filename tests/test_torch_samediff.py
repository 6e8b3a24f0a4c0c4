"""SameDiff parity: the port (``deeplearning4j_tpu_torch.samediff``)
against the reference (``deeplearning4j_tpu.samediff``) on the CPU.

``DualSameDiff`` drives one graph in both packages at once: every call
goes to the reference's SameDiff and to the port's, and what comes back
is compared before the reference's answer is returned:

- outputs (``output``/``exec``/``eval``/``score``) within rtol 1e-4, atol
  1e-5 (the reference tests' own golden tolerance; 1e-6 for the graphs of
  ``tests/test_samediff.py`` before they train), of the same shape and
  type; a graph that draws random numbers by shape and type (JAX keys and
  torch generators never agree); sign-free decompositions by magnitude,
  fake quantization within one grid step (a tie may round either way);
- ``calculate_gradients`` within 1e-5 of the largest reference gradient;
- ``fit`` histories within 1e-4 relative, and the trained arrays after
  (``trained_close``, whose count of stray elements may reach 3x the
  reference's own repeat on inputs moved by one ulp);
- variable names and inferred shapes equal;
- ``save`` writes both packages' files, loads each in the OTHER package
  and holds every array bit-equal;
- an error raised by the reference must be raised by the port with the
  same class name.

So each reference test of ``tests/test_samediff.py`` runs here once with
both packages, through ``run_reference_case`` (``test_torch_tf_import.py``
and ``test_torch_onnx_import.py`` run the importers' tests the same way).
The explicit tests below add what the reference's cases do not pin:
3-step trajectories of Adam, Sgd and ``minimize=False`` at 1e-4 relative,
gradients against ``jax.grad``, save/load across the packages both ways
with the updater state, two instances sharing one program with different
weights, and the eager-by-design rule.
"""

import inspect
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import deeplearning4j_tpu.samediff as ref_sd_pkg  # noqa: E402
from deeplearning4j_tpu.samediff import core as ref_core  # noqa: E402
from deeplearning4j_tpu_torch.nn import updaters as port_upd  # noqa: E402
from deeplearning4j_tpu_torch.samediff import core as port_core  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
#: the outputs of tests/test_samediff.py's own graphs (no import, small
#: sums) before any training: within 1e-6 (after fit, a trajectory's
#: RTOL / ATOL)
SAMEDIFF_TOL = 1e-6


# ----------------------------------------------------------- the dual proxy


#: decompositions unique only up to the signs (phases) of their vectors:
#: compared by magnitude
SIGN_FREE = {"eigh", "eig", "svd", "qr"}


def _mode(port_sd) -> str:
    ops = {n.op for n in port_sd._nodes}
    if any(not o.startswith("__") and port_core._gen_positions(o)
           for o in ops):
        return "random"
    if any(o.startswith("fake_quant") for o in ops):
        return "grid"
    return "abs" if ops & SIGN_FREE else "value"


def compare_values(ref, port, random=False, what="output", tol=None):
    if random == "abs":
        ref, port, random = np.abs(ref), np.abs(port), False
    if random == "grid":
        # fake quantization: a value on a rounding tie may land on the
        # next grid point (the reference's own tests allow one quantum)
        ref, port = np.asarray(ref), np.asarray(port)
        grid = np.diff(np.unique(ref))
        step = float(grid[grid > 0].min()) if (grid > 0).any() else 0.0
        assert ref.shape == port.shape, what
        assert np.abs(port - ref).max() <= step * 1.001 + ATOL, what
        return
    random = random == "random" if isinstance(random, str) else random
    ref, port = np.asarray(ref), np.asarray(port)
    assert ref.shape == port.shape, f"{what}: shape {port.shape} != {ref.shape}"
    if ref.dtype.kind in "fc" or port.dtype.kind in "fc":
        assert port.dtype.kind == ref.dtype.kind, \
            f"{what}: type {port.dtype} != {ref.dtype}"
    if random or ref.dtype == object:
        return
    if ref.dtype.kind in "fc":
        rtol, atol = (RTOL, ATOL) if tol is None else (tol, tol)
        np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(port.astype(ref.dtype), ref,
                                      err_msg=what)


def trained_close(port, ref, before, what, repeat=None):
    """Trained arrays: within rtol 1e-4 / atol 1e-5 of the largest
    element, but for at most 0.1% of the elements or for no more than 3x
    as many as differ so between the reference and its own repeat of the
    training on inputs moved by one ulp (``repeat()``: that array of the
    repeat, or None; called only when the 0.1% gate fails), and the whole
    difference within 1% (L2) of the reference's own update (``before``:
    the array before training). Adam's m / (sqrt(v) + eps) on a gradient
    near zero turns float noise into a step of either sign, so a few
    elements of a large kernel may differ by up to one step; in a small
    head that can be more than 0.1% (one input feature moves a whole row:
    VGG16's fine-tune moves 2 of the 1,024 elements of its head so, in
    the reference's own repeat as in the port)."""
    port, ref = np.asarray(port), np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    bad = ~np.isclose(port, ref, rtol=RTOL, atol=ATOL * scale)
    if bad.mean() > 1e-3:
        rep = None if repeat is None else repeat()
        own = 0 if rep is None else int(
            (~np.isclose(rep, ref, rtol=RTOL, atol=ATOL * scale)).sum())
        assert bad.sum() <= 3 * own, \
            f"{what}: {bad.sum()} of {bad.size} differ (the reference's " \
            f"own repeat: {own})"
    if bad.any():
        moved = float(np.linalg.norm(ref - np.asarray(before)))
        assert np.linalg.norm(port - ref) <= 1e-2 * moved, what


def _nudged(data):
    """``data`` (a (features, labels) pair or a DataSet) with its float
    features moved by one ulp, or None for another kind of data."""
    def up(a):
        a = np.asarray(a)
        return np.nextafter(a, np.array(np.inf, a.dtype)) \
            if a.dtype.kind == "f" else a

    if isinstance(data, tuple) and len(data) == 2:
        return (up(data[0]), data[1])
    if hasattr(data, "features") and hasattr(data, "labels"):
        return type(data)(up(data.features), data.labels)
    return None


class _Repeat:
    """The reference's training repeated on nudged inputs (``_nudged``),
    from a copy taken before it trained; run at most once, on demand."""

    def __init__(self, ref, data, args, kw):
        import copy

        try:
            self.sd = copy.deepcopy(ref) if _nudged(data) is not None \
                else None
        except (TypeError, ValueError, AttributeError):  # not copyable
            self.sd = None
        self.data, self.args, self.kw, self.done = data, args, kw, False

    def array(self, name):
        if self.sd is None:
            return None
        if not self.done:
            self.sd.fit(_nudged(self.data), *self.args, **self.kw)
            self.done = True
        return np.asarray(self.sd._arrays[name])


def _port_config(cfg):
    return port_core.TrainingConfig.from_dict(cfg.to_dict())


def _side(x, side):
    """An argument for one side: duals split, reference configs and
    updaters translated for the port."""
    if isinstance(x, (DualSameDiff, DualVar, DualNS)):
        return x.ref if side == "ref" else x.port
    if isinstance(x, (list, tuple)):
        return type(x)(_side(v, side) for v in x)
    if isinstance(x, dict):
        return {k: _side(v, side) for k, v in x.items()}
    if side == "port" and isinstance(x, ref_core.TrainingConfig):
        return _port_config(x)
    return x


def _same_error(ref_call, port_call):
    """Run both; an error of the reference's must come from the port too
    (same class name)."""
    try:
        r = ref_call()
    except Exception as e:
        with pytest.raises(Exception) as pe:
            port_call()
        assert type(pe.value).__name__ == type(e).__name__, (
            f"reference raised {type(e).__name__}: {e}; port raised "
            f"{type(pe.value).__name__}: {pe.value}")
        raise
    return r, port_call()


class DualVar:
    __slots__ = ("ref", "port", "dsd")

    def __init__(self, ref, port, dsd):
        assert ref.name == port.name, f"var name {port.name} != {ref.name}"
        self.ref, self.port, self.dsd = ref, port, dsd

    @property
    def name(self):
        return self.ref.name

    @property
    def vtype(self):
        return self.ref.vtype

    @property
    def shape(self):
        r, p = self.ref.shape, self.port.shape
        assert (None if r is None else tuple(r)) == (
            None if p is None else tuple(p)), \
            f"shape of {self.name}: {p} != {r}"
        return r

    @property
    def dtype(self):
        return self.ref.dtype

    def __getattr__(self, name):
        r, p = getattr(self.ref, name), getattr(self.port, name)
        if not callable(r):
            return r

        def call(*args, **kw):
            out = _same_error(
                lambda: r(*_side(args, "ref"), **_side(kw, "ref")),
                lambda: p(*_side(args, "port"), **_side(kw, "port")))
            return self.dsd._wrap(*out, what=f"{self.name}.{name}")
        return call

    def _bin(self, op, other):
        return self.dsd._wrap(op(self.ref, _side(other, "ref")),
                              op(self.port, _side(other, "port")))

    def __add__(self, o): return self._bin(lambda a, b: a + b, o)
    def __radd__(self, o): return self._bin(lambda a, b: b + a, o)
    def __sub__(self, o): return self._bin(lambda a, b: a - b, o)
    def __rsub__(self, o): return self._bin(lambda a, b: b - a, o)
    def __mul__(self, o): return self._bin(lambda a, b: a * b, o)
    def __rmul__(self, o): return self._bin(lambda a, b: b * a, o)
    def __truediv__(self, o): return self._bin(lambda a, b: a / b, o)
    def __rtruediv__(self, o): return self._bin(lambda a, b: b / a, o)
    def __pow__(self, o): return self._bin(lambda a, b: a ** b, o)
    def __matmul__(self, o): return self._bin(lambda a, b: a @ b, o)
    def __gt__(self, o): return self._bin(lambda a, b: a > b, o)
    def __lt__(self, o): return self._bin(lambda a, b: a < b, o)
    def __ge__(self, o): return self._bin(lambda a, b: a >= b, o)
    def __le__(self, o): return self._bin(lambda a, b: a <= b, o)
    def __neg__(self): return self.dsd._wrap(-self.ref, -self.port)

    def __getitem__(self, idx):
        return self.dsd._wrap(self.ref[idx], self.port[idx])


class DualNS:
    def __init__(self, ref, port, dsd):
        self.ref, self.port, self.dsd = ref, port, dsd

    def __getattr__(self, name):
        r, p = getattr(self.ref, name), getattr(self.port, name)

        def call(*args, **kw):
            out = _same_error(
                lambda: r(*_side(args, "ref"), **_side(dict(kw), "ref")),
                lambda: p(*_side(args, "port"), **_side(dict(kw), "port")))
            return self.dsd._wrap(*out, what=name)
        return call


class DualSameDiff:
    """The reference's SameDiff and the port's, driven together (see the
    module doc)."""

    #: output tolerance (rtol = atol) in place of RTOL / ATOL, if set
    tol = None

    def __init__(self, ref=None, port=None):
        self.ref = ref if ref is not None else ref_core.SameDiff()
        self.port = port if port is not None else port_core.SameDiff(
            device="cpu")

    # -- results ------------------------------------------------------------
    def _tol(self):
        return self.tol if not self.port._it_count else None

    def _wrap(self, r, p, what="result"):
        if isinstance(r, ref_core.SDVariable):
            return DualVar(r, p, self)
        if isinstance(r, ref_core.SameDiff):
            return self
        if isinstance(r, (tuple, list)) and r and all(
                isinstance(v, ref_core.SDVariable) for v in r):
            return type(r)(DualVar(a, b, self) for a, b in zip(r, p))
        if isinstance(r, dict) and all(isinstance(v, np.ndarray)
                                       for v in r.values()):
            assert set(r) == set(p), f"{what}: keys {set(p)} != {set(r)}"
            rnd = _mode(self.port)
            for k in r:
                compare_values(r[k], p[k], rnd, f"{what}[{k}]", self._tol())
            return r
        if isinstance(r, (np.ndarray, np.generic, float, int)) and not \
                isinstance(r, bool):
            compare_values(r, p, _mode(self.port), what, self._tol())
            return r
        return r

    def __getattr__(self, name):
        r, p = getattr(self.ref, name), getattr(self.port, name)
        if isinstance(r, ref_core._OpNamespace):
            return DualNS(r, p, self)
        if name == "tf_name_map":
            assert r == p, "tf_name_map differs"
            return r
        if name == "onnx_outputs":
            assert list(r) == list(p)
            return r
        if not callable(r):
            return r

        def call(*args, **kw):
            out = _same_error(
                lambda: r(*_side(args, "ref"), **_side(kw, "ref")),
                lambda: p(*_side(args, "port"), **_side(kw, "port")))
            return self._wrap(*out, what=name)
        return call

    # -- calls with their own comparison --------------------------------------
    def output(self, feeds, outputs, **kw):
        r, p = _same_error(lambda: self.ref.output(feeds, outputs, **kw),
                           lambda: self.port.output(feeds, outputs, **kw))
        return self._wrap(r, p, "output")

    def calculate_gradients(self, feeds, *wrt):
        wrt_r, wrt_p = _side(wrt, "ref"), _side(wrt, "port")
        r, p = _same_error(lambda: self.ref.calculate_gradients(feeds, *wrt_r),
                           lambda: self.port.calculate_gradients(feeds, *wrt_p))
        for k in r:
            scale = max(1.0, float(np.abs(r[k]).max()) if r[k].size else 1.0)
            np.testing.assert_allclose(p[k], r[k], rtol=0, atol=1e-5 * scale,
                                       err_msg=f"grad {k}")
        return r

    def fit(self, data, *args, **kw):
        before = {n: np.array(self.ref._arrays[n])
                  for n in self.ref.trainable_names()}
        repeat = _Repeat(self.ref, data, args, kw)
        r, p = _same_error(lambda: self.ref.fit(data, *args, **kw),
                           lambda: self.port.fit(data, *args, **kw))
        np.testing.assert_allclose(p, r, rtol=RTOL, atol=ATOL,
                                   err_msg="fit history")
        for n in self.ref.trainable_names():
            trained_close(self.port._arrays[n], self.ref._arrays[n],
                          before[n], f"trained {n}",
                          lambda n=n: repeat.array(n))
        return r

    def save(self, path, save_updater_state=False):
        self.ref.save(path, save_updater_state=save_updater_state)
        port_path = str(path) + ".port"
        self.port.save(port_path, save_updater_state=save_updater_state)
        # each package's file loads in the other, arrays bit-equal
        p_from_r = port_core.SameDiff.load(path, device="cpu")
        r_from_p = ref_core.SameDiff.load(port_path)
        for a, b in ((self.ref, p_from_r), (self.port, r_from_p)):
            assert set(a._arrays) == set(b._arrays)
            for k in a._arrays:
                np.testing.assert_array_equal(np.asarray(b._arrays[k]),
                                              np.asarray(a._arrays[k]))
            assert [n.to_dict() for n in a._nodes] == \
                [n.to_dict() for n in b._nodes]
        os.remove(port_path)

    @classmethod
    def load(cls, path, *args, **kw):
        return cls(ref_core.SameDiff.load(path),
                   port_core.SameDiff.load(path, device="cpu"))

    def set_training_config(self, cfg):
        self.ref.set_training_config(cfg)
        self.port.set_training_config(_port_config(cfg))


# ------------------------------------------------------ reference test runner


def _param_sets(fn):
    """(kwargs, id) for each parametrize combination on ``fn``; None when
    a case carries the slow mark."""
    sets = [({}, "")]
    for mark in getattr(fn, "pytestmark", []):
        if mark.name == "slow":
            return []
        if mark.name != "parametrize":
            continue
        names, values = mark.args[0], mark.args[1]
        names = [n.strip() for n in names.split(",")] if isinstance(
            names, str) else list(names)
        ids = mark.kwargs.get("ids")
        new = []
        for base, bid in sets:
            for j, v in enumerate(values):
                marks = getattr(v, "marks", ())
                if any(m.name == "slow" for m in marks):
                    continue
                v = getattr(v, "values", v)
                v = v if len(names) > 1 else (v[0] if isinstance(
                    v, tuple) and len(v) == 1 and hasattr(
                    values[j], "values") else v,)
                kw = dict(base, **dict(zip(names, v)))
                tag = ids[j] if ids else "-".join(str(x) for x in v)
                new.append((kw, f"{bid}-{tag}" if bid else tag))
        sets = new
    return sets


def reference_cases(module, select=None):
    """pytest params (module, class name, test name, kwargs) for every test
    of a reference test module (``select(class_name, test_name)`` filters)."""
    out = []
    for name, obj in vars(module).items():
        if isinstance(obj, type) and name.startswith("Test"):
            fns = [(name, m, f) for m, f in vars(obj).items()
                   if m.startswith("test_") and callable(f)]
        elif name.startswith("test_") and callable(obj):
            fns = [(None, name, obj)]
        else:
            continue
        for cls, m, f in fns:
            if select is not None and not select(cls, m):
                continue
            for kw, pid in _param_sets(f):
                tid = f"{cls}.{m}" if cls else m
                out.append(pytest.param(module.__name__, cls, m, kw,
                                        id=f"{tid}[{pid}]" if pid else tid))
    return out


def run_reference_case(module_name, cls, name, kwargs, tmp_path, patches):
    """Run one reference test with ``patches`` ((module, attr, value)
    triples) applied, its fixtures made here."""
    mod = sys.modules[module_name]
    fn = getattr(getattr(mod, cls), name) if cls else getattr(mod, name)
    args = {}
    for p in inspect.signature(fn).parameters:
        if p == "self":
            continue
        if p == "rng":
            args[p] = np.random.default_rng(12345)
        elif p == "tmp_path":
            args[p] = tmp_path
        elif p in kwargs:
            args[p] = kwargs[p]
    saved = [(m, a, getattr(m, a)) for m, a, _ in patches]
    try:
        for m, a, v in patches:
            setattr(m, a, v)
        if cls:
            fn(getattr(mod, cls)(), **args)
        else:
            fn(**args)
    finally:
        for m, a, v in saved:
            setattr(m, a, v)


sys.path.insert(0, os.path.dirname(__file__))
import test_samediff as ref_tests  # noqa: E402


class _SameDiffAt1e6(DualSameDiff):
    tol = SAMEDIFF_TOL


@pytest.mark.parametrize("module_name,cls,name,kwargs",
                         reference_cases(ref_tests))
def test_reference_case_on_both(module_name, cls, name, kwargs, tmp_path):
    """Each case of tests/test_samediff.py, with SameDiff the dual and
    outputs within SAMEDIFF_TOL."""
    run_reference_case(module_name, cls, name, kwargs, tmp_path, [
        (ref_tests, "SameDiff", _SameDiffAt1e6),
        (ref_sd_pkg, "SameDiff", _SameDiffAt1e6)])


# ----------------------------------------------------------- explicit tests


def _regression(updater_ref, minimize=True):
    rng = np.random.default_rng(7)
    xs = rng.normal(size=(16, 3)).astype(np.float32)
    ys = rng.normal(size=(16, 2)).astype(np.float32)
    sd = DualSameDiff()
    x = sd.placeholder("x", shape=(-1, 3))
    y = sd.placeholder("y", shape=(-1, 2))
    w = sd.var("w", rng.normal(size=(3, 2)).astype(np.float32))
    b = sd.var("b", np.zeros((2,), np.float32))
    pred = sd.nn.tanh(x @ w + b)
    loss = sd.loss.meanSquaredError(pred, y)
    sd.set_loss_variables(loss)
    sd.set_training_config(ref_core.TrainingConfig(
        updater=updater_ref, data_set_feature_mapping=["x"],
        data_set_label_mapping=["y"], minimize=minimize, l2=1e-3))
    return sd, xs, ys


@pytest.mark.parametrize("rule,minimize", [("Adam", True), ("Sgd", True),
                                           ("Adam", False)])
def test_fit_trajectory_three_steps(rule, minimize):
    """3 steps (batch 4 x 3 ... one step a batch) at 1e-4 relative: the
    loss history and every trainable after each fit call."""
    from deeplearning4j_tpu.nn import updaters as ref_upd

    u = {"Adam": ref_upd.Adam(learning_rate=0.05),
         "Sgd": ref_upd.Sgd(learning_rate=0.2)}[rule]
    sd, xs, ys = _regression(u, minimize)
    for _ in range(3):
        sd.fit((xs, ys), epochs=1)
        for n in ("w", "b"):
            np.testing.assert_allclose(sd.port._arrays[n], sd.ref._arrays[n],
                                       rtol=1e-4, atol=1e-7)
    assert sd.ref._it_count == sd.port._it_count == 3
    hist = sd.fit((xs, ys), epochs=2, batch_size=8)
    assert len(hist) == 2


def test_gradients_against_jax_grad():
    """calculate_gradients of the port against jax.grad of the same loss
    written in jnp, at 1e-5 of the largest gradient."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    xv = rng.normal(size=(5, 4)).astype(np.float32)
    wv = rng.normal(size=(4, 3)).astype(np.float32)
    bv = rng.normal(size=(3,)).astype(np.float32)
    sd = port_core.SameDiff(device="cpu")
    x = sd.placeholder("x", shape=(-1, 4))
    w = sd.var("w", wv)
    b = sd.var("b", bv)
    h = sd.nn.softmax(sd.math.tanh(x @ w + b), axis=-1)
    loss = sd.math.sum(h * h) + sd.math.mean(w * w)
    sd.set_loss_variables(loss)
    got = sd.calculate_gradients({"x": xv}, "w", "b", "x")

    def f(w, b, x):
        h = jax.nn.softmax(jnp.tanh(x @ w + b), axis=-1)
        return jnp.sum(h * h) + jnp.mean(w * w)

    want = jax.grad(f, argnums=(0, 1, 2))(wv, bv, xv)
    for k, g in zip(("w", "b", "x"), want):
        g = np.asarray(g)
        np.testing.assert_allclose(got[k], g, rtol=0,
                                   atol=1e-5 * np.abs(g).max())


def _adam_graph(sd_cls, **kw):
    from deeplearning4j_tpu.nn import updaters as ref_upd

    sd = sd_cls(**kw)
    x = sd.placeholder("x", shape=(-1, 3))
    y = sd.placeholder("y", shape=(-1, 1))
    w = sd.var("w", np.full((3, 1), 0.1, np.float32))
    loss = sd.loss.meanSquaredError(x @ w, y)
    sd.set_loss_variables(loss)
    cfg = ref_core.TrainingConfig(
        updater=ref_upd.Adam(learning_rate=0.05),
        data_set_feature_mapping=["x"], data_set_label_mapping=["y"])
    sd.set_training_config(cfg if sd_cls is ref_core.SameDiff
                           else _port_config(cfg))
    return sd


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_resume_across_packages(writer, tmp_path):
    """save(updater) in one package, load and resume in the other: the
    arrays and Adam moments load bit-equal, and the resumed run matches
    an uninterrupted run of the writer at 1e-5."""
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(32, 3)).astype(np.float32)
    ys = (xs @ np.array([[1.0], [-2.0], [0.5]], np.float32))
    w_cls, r_cls = (ref_core.SameDiff, port_core.SameDiff) \
        if writer == "reference" else (port_core.SameDiff, ref_core.SameDiff)
    kw_w = {} if w_cls is ref_core.SameDiff else {"device": "cpu"}
    kw_r = {} if r_cls is ref_core.SameDiff else {"device": "cpu"}
    a = _adam_graph(w_cls, **kw_w)
    a.fit((xs, ys), epochs=3)
    path = str(tmp_path / "mid.sdz")
    a.save(path, save_updater_state=True)
    a.fit((xs, ys), epochs=3)
    b = r_cls.load(path, **kw_r)
    assert b._it_count == 3
    flat_a = _updater_leaves(path)
    flat_b = [np.asarray(v.detach().cpu() if hasattr(v, "detach") else v)
              for _, v in port_core.jax_items(b._opt_state)]
    assert len(flat_a) == len(flat_b) == 2
    for u, v in zip(flat_a, flat_b):
        np.testing.assert_array_equal(u, v)
    b.fit((xs, ys), epochs=3)
    np.testing.assert_allclose(np.asarray(b.get_variable("w").get_arr()),
                               np.asarray(a.get_variable("w").get_arr()),
                               rtol=1e-5, atol=1e-6)


def _updater_leaves(path):
    """The updater leaves of the file at ``path``, in its order."""
    import io
    import zipfile

    with zipfile.ZipFile(path) as zf:
        st = np.load(io.BytesIO(zf.read("updater.npz")))
        return [st[f"arr_{i}"] for i in range(len(st.files))]


def test_two_instances_share_one_program_with_their_own_weights():
    """Two graphs of one structure and different weights: the second
    reuses the first's output program (one trace), and each gets its own
    answer."""
    from deeplearning4j_tpu_torch.util.compile_watcher import get_watcher

    def build(wv):
        sd = port_core.SameDiff(device="cpu")
        x = sd.placeholder("x", shape=(-1, 3))
        w = sd.var("w", wv)
        sd.nn.relu(x @ w, name_out="y")
        return sd

    import gc

    gc.collect()  # no graph of this structure left from another test
    rng = np.random.default_rng(1)
    w1 = rng.normal(size=(3, 4)).astype(np.float32)
    w2 = rng.normal(size=(3, 4)).astype(np.float32)
    a, b = build(w1), build(w2)
    assert a.fingerprint() == b.fingerprint()
    xv = rng.normal(size=(5, 3)).astype(np.float32)
    watcher = get_watcher()
    before = watcher.traces.get("SameDiff.output", 0)
    ya = a.output({"x": xv}, ["y"])["y"]
    yb = b.output({"x": xv}, ["y"])["y"]
    ya2 = a.output({"x": xv}, ["y"])["y"]
    assert watcher.traces.get("SameDiff.output", 0) - before == 1
    assert list(a.programs().values())[0] is list(b.programs().values())[0]
    np.testing.assert_allclose(ya, np.maximum(xv @ w1, 0), rtol=1e-6)
    np.testing.assert_allclose(yb, np.maximum(xv @ w2, 0), rtol=1e-6)
    np.testing.assert_array_equal(ya, ya2)


def test_host_control_flow_runs_eagerly_by_rule():
    """A graph holding a __cf_while__ node builds its program with the
    eager reason; a graph without one has none."""
    cond_sd = port_core.SameDiff(device="cpu")
    ci = cond_sd.placeholder("i", shape=(), dtype=np.int32)
    cout = cond_sd._op("less", [ci, cond_sd.constant(np.int32(4), "lim")])
    body_sd = port_core.SameDiff(device="cpu")
    bi = body_sd.placeholder("i", shape=(), dtype=np.int32)
    bo = body_sd._op("add", [bi, body_sd.constant(np.int32(1), "one")])
    sd = port_core.SameDiff(device="cpu")
    i0 = sd.placeholder("i0", shape=(), dtype=np.int32)
    out = sd.while_loop_graph(cond_sd, [ci], cout, body_sd, [bi], [bo], i0)
    res = sd.output({"i0": np.int32(1)}, [out.name])[out.name]
    assert int(res) == 4
    (prog,) = sd.programs().values()
    assert prog.eager is not None and "__cf_while__" in prog.eager
    plain = port_core.SameDiff(device="cpu")
    p = plain.placeholder("p", shape=(2,))
    y = plain.math.exp(p)
    plain.output({"p": np.zeros(2, np.float32)}, [y.name])
    assert list(plain.programs().values())[0].eager is None


def test_random_op_moments_and_repeatability():
    """A random op of a graph: its draws' moments match the reference's
    (independent streams), and one seed gives the same values every call,
    as the reference's fixed key does."""
    key = port_core.prng_key(5)
    import jax

    assert np.array_equal(key, np.asarray(jax.random.PRNGKey(5)))
    n = 20000
    vals = {}
    for pkg, core in (("ref", ref_core), ("port", port_core)):
        sd = core.SameDiff() if pkg == "ref" else core.SameDiff(device="cpu")
        k = sd.constant(key, "key")
        r = sd.random.normal(k, shape=(n,), dtype=np.float32)
        a = sd.output({}, [r.name])[r.name]
        b = sd.output({}, [r.name])[r.name]
        np.testing.assert_array_equal(a, b)
        vals[pkg] = a
    assert vals["ref"].dtype == vals["port"].dtype
    for v in vals.values():
        assert abs(v.mean()) < 0.05 and abs(v.std() - 1) < 0.05


def test_updater_state_leaf_order_matches_jax():
    """The port's Adam state flattens in jax.tree_util order."""
    import jax

    tr = {"b": np.zeros(2, np.float32), "a": np.zeros((2, 2), np.float32)}
    st = port_upd.Adam().init_state({k: torch.from_numpy(v)
                                     for k, v in tr.items()})
    paths = [p for p, _ in port_core.jax_items(st)]
    ref = jax.tree_util.tree_flatten_with_path(
        {s: dict(tr) for s in ("m", "v")})[0]
    assert paths == [tuple(k.key for k in p) for p, _ in ref]
