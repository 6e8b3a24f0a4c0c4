"""The Keras corpus of tests/test_keras_import.py (ResNet50, MobileNetV2,
Xception and DenseNet121 from tf.keras.applications, saved as ``.keras``
zips at the reference's own sizes, forward at batch 2) through both
importers, as tests/test_torch_keras_import.py runs the file's other
cases: equal conf JSON and params, outputs within rtol 1e-4 / atol 1e-5 of
the reference's, and the port's against tf.keras's at the test's own
tolerance."""

import pytest

tf = pytest.importorskip("tensorflow")
torch = pytest.importorskip("torch")

from test_torch_keras_import import PATCHES  # noqa: E402
from test_torch_samediff import (reference_cases,  # noqa: E402
                                 run_reference_case)

import test_keras_import  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread while this module runs (the suite runs six
    workers on eight cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("module_name,cls,name,kwargs", reference_cases(
    test_keras_import, lambda c, n: c == "TestKerasFullModelCorpus"))
def test_corpus_case_on_both(module_name, cls, name, kwargs, tmp_path):
    tf.keras.backend.clear_session()
    run_reference_case(module_name, cls, name, kwargs, tmp_path, PATCHES)
