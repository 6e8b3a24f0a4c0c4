"""TF import parity: the same GraphDef into the reference's importer and
the port's (``deeplearning4j_tpu_torch.imports.tf_import``), on the CPU.

The port decodes the GraphDef without TensorFlow (``imports/tf_proto.py``);
TensorFlow makes the graphs here, as ``tests/test_imports.py:21-34`` does.
Every TF case of ``tests/test_imports.py``, ``tests/test_tf_rules_r5.py``
and ``tests/test_import_rules_r8.py``, and the corpus' two fine-tune
cases (``tests/test_import_corpus.py:118-160``, ResNet50 and VGG16 at
32x32, 2 steps; ResNet50 marked slow) and its TF dynamic-batch cases,
runs with the importer returning a ``DualSameDiff``
(``test_torch_samediff.py``): outputs within rtol 1e-4 / atol 1e-5 of the
reference's, gradients within 1e-5 of the largest, fit histories within
1e-4 relative, inferred shapes and names equal, and the reference's
errors raised by the port with the same class.
"""

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")
torch = pytest.importorskip("torch")

import deeplearning4j_tpu.samediff as ref_sd_pkg  # noqa: E402
from deeplearning4j_tpu.imports import tf_import as ref_tf  # noqa: E402
from deeplearning4j_tpu_torch.imports import graph_cases  # noqa: E402
from deeplearning4j_tpu_torch.imports import tf_import as port_tf  # noqa: E402

from test_torch_samediff import (DualSameDiff, _same_error,  # noqa: E402
                                 reference_cases, run_reference_case)

import test_imports  # noqa: E402
import test_import_corpus  # noqa: E402
import test_import_rules_r8  # noqa: E402
import test_tf_rules_r5  # noqa: E402


def dual_import_graph_def(graph_def, **kw):
    r, p = _same_error(
        lambda: ref_tf.import_graph_def(graph_def, **kw),
        lambda: port_tf.import_graph_def(graph_def, device="cpu", **kw))
    return DualSameDiff(r, p)


def _is_onnx(cls, name):
    return cls is not None and ("Onnx" in cls or "ONNX" in cls
                                or cls == "TestQdqNonConstScale")


CASES = (
    reference_cases(test_imports, lambda c, n: not _is_onnx(c, n))
    + reference_cases(test_tf_rules_r5)
    + reference_cases(test_import_rules_r8, lambda c, n: not _is_onnx(c, n))
    + reference_cases(test_import_corpus,
                      lambda c, n: c == "TestTFDynamicBatch"
                      or (c == "TestTFFullModelCorpus"
                          and n == "test_finetune_one_step")))
# the ResNet50 fine-tune builds, freezes and trains keras' ResNet50 in
# both packages (~26 s): the one case heavy enough for the slow mark
CASES = [pytest.param(*p.values, id=p.id, marks=pytest.mark.slow)
         if p.id.endswith("[ResNet50]") else p for p in CASES]

PATCHES = [(m, "import_graph_def", dual_import_graph_def)
           for m in (test_imports, test_tf_rules_r5, test_import_rules_r8,
                     test_import_corpus)] + [
    (ref_sd_pkg, "SameDiff", DualSameDiff)]


@pytest.mark.parametrize("module_name,cls,name,kwargs", CASES)
def test_reference_case_on_both(module_name, cls, name, kwargs, tmp_path):
    run_reference_case(module_name, cls, name, kwargs, tmp_path, PATCHES)


def test_rule_tables_equal():
    assert len(port_tf._RULES) == len(ref_tf._RULES) == 251
    assert set(port_tf._RULES) == set(ref_tf._RULES)


def test_dynamic_batch_refusal_same_error_class():
    """A Shape fold of a dynamic batch reaching arithmetic: both importers
    refuse, with the same error class."""
    def fn(x):
        return x * tf.cast(tf.shape(x)[0], tf.float32)

    conc = tf.function(fn).get_concrete_function(
        tf.TensorSpec((None, 3), tf.float32))
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2)
    gd = convert_variables_to_constants_v2(conc).graph.as_graph_def()
    errs = []
    for imp in (lambda: ref_tf.import_graph_def(gd),
                lambda: port_tf.import_graph_def(gd, device="cpu")):
        try:
            sd = imp()
            out = [n for n in sd.tf_name_map.values()][-1]
            sd.output({"x": np.ones((2, 3), np.float32)}, [out])
        except Exception as e:  # noqa: BLE001  (compared below)
            errs.append(type(e).__name__)
        else:
            errs.append(None)
    assert errs[0] is not None and errs[0] == errs[1], errs


def _tf_run(gd_bytes, feeds, outputs):
    gd = tf.compat.v1.GraphDef()
    gd.ParseFromString(gd_bytes)
    g = tf.Graph()
    with g.as_default():
        tf.graph_util.import_graph_def(gd, name="")
    with tf.compat.v1.Session(graph=g) as s:
        return s.run([o + ":0" for o in outputs],
                     {k + ":0": v for k, v in feeds.items()})


def _both(gd_bytes, feeds, outputs):
    ref = ref_tf.import_graph_def(gd_bytes)
    port = port_tf.import_graph_def(gd_bytes, device="cpu")
    keys = [port.tf_name_map[o + ":0"] for o in outputs]
    assert keys == [ref.tf_name_map[o + ":0"] for o in outputs]
    r = ref.output(feeds, keys)
    p = port.output(feeds, keys)
    return ref, port, [r[k] for k in keys], [p[k] for k in keys]


def test_graph_cases_bert_tiny_three_ways():
    """graph_cases' BERT GraphDef at tiny width: TF itself, both importers
    within 1e-5, and the port's net.output on the same parameters; every
    variable's inferred shape equal across the packages."""
    from deeplearning4j_tpu_torch.zoo.bert import Bert

    net = Bert.tiny(max_length=16, flash=False, vocab_size=500).init(
        device="cpu")
    gd, names = graph_cases.bert_graph_def(net, 16)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 500, (3, 16)).astype(np.int32)
    seg = rng.integers(0, 2, (3, 16)).astype(np.int32)
    mask = np.ones((3, 16), np.int32)
    mask[1, 9:] = 0
    feeds = {"input_ids": ids, "input_mask": mask, "segment_ids": seg}
    outs = ["logits", "probabilities"]
    golden = _tf_run(gd, feeds, outs)
    ref, port, r, p = _both(gd, feeds, outs)
    for g, a, b in zip(golden, r, p):
        np.testing.assert_allclose(b, g, rtol=0, atol=1e-5)
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
    x = torch.tensor(np.stack([ids, seg], -1), dtype=torch.float32)
    want = net.output(x, mask=torch.tensor(mask, dtype=torch.float32))
    np.testing.assert_allclose(p[1], want.numpy(), rtol=0, atol=1e-5)
    for name, v in port._vars.items():
        if v.vtype.name == "ARRAY":
            assert port._infer(name, "shape") == \
                ref._infer(name, "shape"), name


def test_graph_cases_resnet50_small_three_ways():
    """graph_cases' ResNet-50 GraphDef at 32x32 with 10 classes: 53
    conv2d nodes; TF, both importers within 1e-5 of the largest logit."""
    gd, names = graph_cases.resnet50_graph_def(image_size=32, classes=10)
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    outs = [names["logits"], names["probabilities"]]
    golden = _tf_run(gd, {"input_1": x}, outs)
    ref, port, r, p = _both(gd, {"input_1": x}, outs)
    assert sum(n.op == "conv2d" for n in port._nodes) == 53
    for g, a, b in zip(golden, r, p):
        scale = max(1.0, float(np.abs(g).max()))
        np.testing.assert_allclose(b, g, rtol=0, atol=1e-5 * scale)
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5 * scale)


def test_graph_def_sources(tmp_path):
    """bytes, a path, TF's GraphDef object and the port's parsed GraphDef
    import alike; the decode keeps tensors bit-exact."""
    from deeplearning4j_tpu_torch.imports import tf_proto

    def fn(x):
        return tf.matmul(x, tf.constant(np.arange(6, dtype=np.float32)
                                        .reshape(3, 2))) + 0.5

    gd, golden, in_names, out_names = test_imports._freeze(
        fn, [np.ones((2, 3), np.float32)])
    blob = gd.SerializeToString()
    parsed = tf_proto.parse_graph_def(blob)
    consts = [n for n in parsed.node if n.op == "Const"]
    for n in consts:
        want = tf.make_ndarray(
            next(m for m in gd.node if m.name == n.name).attr["value"].tensor)
        np.testing.assert_array_equal(
            tf_proto.make_ndarray(n.attr["value"].tensor), want)
    path = tmp_path / "graph.pb"
    path.write_bytes(blob)
    for src in (blob, gd, parsed, str(path)):
        sd = port_tf.import_graph_def(src, device="cpu")
        key = sd.tf_name_map[out_names[0]]
        out = sd.output({in_names[0]: np.ones((2, 3), np.float32)}, [key])
        np.testing.assert_allclose(out[key], golden[0], rtol=1e-6)
