"""ONNX import parity: the same ModelProto bytes into the reference's
importer and the port's (``deeplearning4j_tpu_torch.imports.onnx_import``),
on the CPU.

Every ONNX case of ``tests/test_imports.py`` (protomini-authored models,
LSTM/GRU/RNN against torch, Loop/If/Scan, QDQ),
``tests/test_onnx_rules_r5.py``, ``tests/test_onnx_rules_r7.py`` and
``tests/test_import_rules_r8.py``, and of ``tests/test_import_corpus.py``
the ``torch.onnx.export`` forwards of ResNet-18, the LSTM and the GRU
sequence models (through the corpus' exporter patch,
``tests/test_import_corpus.py:166-181``), its Loop/If control-flow nets,
their save/load and the dynamic-batch cases, runs with ``import_onnx``
returning a ``DualSameDiff`` (``test_torch_samediff.py``): outputs within
rtol 1e-4 / atol 1e-5 of the reference's, gradients within 1e-5 of the
largest, fit histories within 1e-4 relative, the reference's errors
raised by the port with the same class.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import deeplearning4j_tpu.samediff as ref_sd_pkg  # noqa: E402
from deeplearning4j_tpu.imports import onnx_import as ref_onnx  # noqa: E402
from deeplearning4j_tpu_torch.imports import graph_cases  # noqa: E402
from deeplearning4j_tpu_torch.imports import onnx_import as port_onnx  # noqa: E402

from test_torch_samediff import (DualSameDiff, _same_error,  # noqa: E402
                                 reference_cases, run_reference_case)

tf = pytest.importorskip("tensorflow")  # test_imports needs it to load

import test_imports  # noqa: E402
import test_import_corpus  # noqa: E402
import test_import_rules_r8  # noqa: E402
import test_onnx_rules_r5  # noqa: E402
import test_onnx_rules_r7  # noqa: E402


def dual_import_onnx(model, **kw):
    r, p = _same_error(lambda: ref_onnx.import_onnx(model, **kw),
                       lambda: port_onnx.import_onnx(model, device="cpu", **kw))
    return DualSameDiff(r, p)


def _is_onnx(cls, name):
    return cls is not None and ("Onnx" in cls or "ONNX" in cls
                                or cls == "TestQdqNonConstScale")


_CORPUS = {"TestONNXControlFlow", "TestControlFlowSerialization",
           "TestONNXDynamicBatch"}


def _corpus(cls, name):
    if cls == "TestONNXFullModelCorpus":
        return name == "test_forward_golden"
    return cls in _CORPUS


def _corpus_cases():
    out = []
    for p in reference_cases(test_import_corpus, _corpus):
        _, cls, name, kw = p.values
        if cls == "TestONNXFullModelCorpus" and kw.get("name") not in (
                "resnet18", "lstm_seq", "gru_seq"):
            continue
        out.append(p)
    return out


CASES = (reference_cases(test_imports, _is_onnx)
         + reference_cases(test_onnx_rules_r5)
         + reference_cases(test_onnx_rules_r7)
         + reference_cases(test_import_rules_r8, _is_onnx)
         + _corpus_cases())

PATCHES = [(m, "import_onnx", dual_import_onnx)
           for m in (test_imports, test_onnx_rules_r5, test_onnx_rules_r7,
                     test_import_rules_r8, test_import_corpus)] + [
    (ref_sd_pkg, "SameDiff", DualSameDiff)]


@pytest.mark.parametrize("module_name,cls,name,kwargs", CASES)
def test_reference_case_on_both(module_name, cls, name, kwargs, tmp_path):
    run_reference_case(module_name, cls, name, kwargs, tmp_path, PATCHES)


def test_rule_tables_equal():
    assert len(port_onnx._ORULES) == len(ref_onnx._ORULES) == 161
    assert set(port_onnx._ORULES) == set(ref_onnx._ORULES)


def test_graph_cases_lstm_both_importers_and_grads():
    """graph_cases' LSTM ONNX at small width: both importers' outputs
    within 1e-5, and the gradients wrt the converted W/R/B within 1e-5 of
    the largest (the port's through lstm_layer's autograd)."""
    blob = graph_cases.lstm_onnx(input_size=7, hidden=16, batch=4, seq_len=6)
    x = np.random.default_rng(2).standard_normal((4, 6, 7)).astype(np.float32)
    sd = DualSameDiff(ref_onnx.import_onnx(blob),
                      port_onnx.import_onnx(blob, device="cpu"))
    out = sd.output({"x": x}, ["y", "y_h", "y_c"])
    assert out["y"].shape == (4, 6, 16)
    sd.convert_to_variable("W", "R", "B")
    y = sd.get_variable("y")
    loss = sd.math.sum(y * y)
    sd.set_loss_variables(loss)
    sd.calculate_gradients({"x": x}, "W", "R", "B")
