"""The port's evaluation classes against the JAX package's, on the CPU: the
same numpy data fed to the reference and, to the port, as numpy arrays and
as float32 tensors (one bf16 case too). Both accumulate in numpy, so every
number must be equal to the bit on the float32 feeds."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning4j_tpu import eval as jev  # noqa: E402
from deeplearning4j_tpu_torch import eval as tev  # noqa: E402

FEEDS = ["numpy", "tensor"]


def _feed(a, how):
    return torch.from_numpy(np.ascontiguousarray(a)) if how == "tensor" else a


def _probs(rng, n, k):
    z = rng.normal(size=(n, k)) * 2
    e = np.exp(z - z.max(axis=1, keepdims=True))
    return (e / e.sum(axis=1, keepdims=True)).astype(np.float32)


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("how", FEEDS)
def test_evaluation_matches_reference(how):
    """Two batches of one-hot labels, then a batch of class indices that
    grows the matrix from 4 to 5 classes."""
    rng = np.random.default_rng(1)
    mine, ref = tev.Evaluation(), jev.Evaluation()
    for n in (30, 17):
        y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]
        p = _probs(rng, n, 4)
        mine.eval(_feed(y, how), _feed(p, how))
        ref.eval(y, p)
    idx = rng.integers(0, 5, 9).astype(np.int64)
    p = _probs(rng, 9, 5)
    mine.eval(_feed(idx, how), _feed(p, how))
    ref.eval(idx, p)
    _same(mine.confusion_matrix(), ref.confusion_matrix())
    assert mine.num_classes == ref.num_classes == 5
    assert mine.accuracy() == ref.accuracy()
    for m in ("precision", "recall", "f1"):
        assert getattr(mine, m)() == getattr(ref, m)()
        assert getattr(mine, m)(2) == getattr(ref, m)(2)
    assert mine.false_positive_rate(1) == ref.false_positive_rate(1)
    assert mine.stats() == ref.stats()


def test_evaluation_takes_bf16_tensors():
    """bf16 predictions are widened to float32 on their one copy."""
    rng = np.random.default_rng(2)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 20)]
    p = torch.from_numpy(_probs(rng, 20, 3)).bfloat16()
    mine, ref = tev.Evaluation(), jev.Evaluation()
    mine.eval(torch.from_numpy(y), p)
    ref.eval(y, p.float().numpy())
    _same(mine.confusion_matrix(), ref.confusion_matrix())


@pytest.mark.parametrize("how", FEEDS)
def test_roc_matches_reference(how):
    """Two-column one-hot labels and scores, then 1-D ones, with ties."""
    rng = np.random.default_rng(3)
    mine, ref = tev.ROC(), jev.ROC()
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 25)]
    s = _probs(rng, 25, 2)
    mine.eval(_feed(y, how), _feed(s, how))
    ref.eval(y, s)
    y1 = rng.integers(0, 2, 15).astype(np.float32)
    s1 = np.round(rng.random(15), 1).astype(np.float32)
    mine.eval(_feed(y1, how), _feed(s1, how))
    ref.eval(y1, s1)
    assert mine.calculate_auc() == ref.calculate_auc()
    assert mine.calculate_auprc() == ref.calculate_auprc()


@pytest.mark.parametrize("how", FEEDS)
def test_roc_multiclass_matches_reference(how):
    rng = np.random.default_rng(4)
    mine, ref = tev.ROCMultiClass(), jev.ROCMultiClass()
    for n in (20, 11):
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
        p = _probs(rng, n, 3)
        mine.eval(_feed(y, how), _feed(p, how))
        ref.eval(y, p)
    for c in range(3):
        assert mine.calculate_auc(c) == ref.calculate_auc(c)
    assert mine.calculate_average_auc() == ref.calculate_average_auc()


@pytest.mark.parametrize("how", FEEDS)
def test_evaluation_calibration_matches_reference(how):
    rng = np.random.default_rng(5)
    mine, ref = tev.EvaluationCalibration(5), jev.EvaluationCalibration(5)
    for n in (40, 13):
        y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]
        p = _probs(rng, n, 4)
        mine.eval(_feed(y, how), _feed(p, how))
        ref.eval(y, p)
    for a, b in zip(mine.reliability_diagram(), ref.reliability_diagram()):
        _same(a, b)
    assert mine.expected_calibration_error() == \
        ref.expected_calibration_error()
    _same(mine.probability_histogram(), ref.probability_histogram())


@pytest.mark.parametrize("how", FEEDS)
def test_evaluation_binary_matches_reference(how):
    """Multi-label (n, 3) sigmoid outputs with a (n, 3) mask, then a 1-D
    batch on a one-output evaluator."""
    rng = np.random.default_rng(6)
    mine, ref = tev.EvaluationBinary(0.4), jev.EvaluationBinary(0.4)
    y = (rng.random((22, 3)) > 0.5).astype(np.float32)
    p = rng.random((22, 3)).astype(np.float32)
    m = (rng.random((22, 3)) > 0.2).astype(np.float32)
    mine.eval(_feed(y, how), _feed(p, how), _feed(m, how))
    ref.eval(y, p, m)
    for i in range(3):
        for metric in ("accuracy", "precision", "recall", "f1"):
            assert getattr(mine, metric)(i) == getattr(ref, metric)(i)
    assert mine.average_f1() == ref.average_f1()
    assert mine.stats() == ref.stats()
    one, jone = tev.EvaluationBinary(), jev.EvaluationBinary()
    y1 = (rng.random(9) > 0.5).astype(np.float32)
    p1 = rng.random(9).astype(np.float32)
    one.eval(_feed(y1, how), _feed(p1, how))
    jone.eval(y1, p1)
    assert one.average_accuracy() == jone.average_accuracy()


@pytest.mark.parametrize("how", FEEDS)
def test_roc_binary_matches_reference(how):
    """Per-output ROC with a per-entry mask, then a per-example mask."""
    rng = np.random.default_rng(7)
    mine, ref = tev.ROCBinary(), jev.ROCBinary()
    y = (rng.random((18, 2)) > 0.5).astype(np.float32)
    s = rng.random((18, 2)).astype(np.float32)
    m = (rng.random((18, 2)) > 0.3).astype(np.float32)
    mine.eval(_feed(y, how), _feed(s, how), _feed(m, how))
    ref.eval(y, s, m)
    m1 = (rng.random(18) > 0.5).astype(np.float32)
    mine.eval(_feed(y, how), _feed(s, how), _feed(m1, how))
    ref.eval(y, s, m1)
    for i in range(2):
        assert mine.calculate_auc(i) == ref.calculate_auc(i)
        assert mine.calculate_auprc(i) == ref.calculate_auprc(i)
    assert mine.calculate_average_auc() == ref.calculate_average_auc()
    assert mine.stats() == ref.stats()


@pytest.mark.parametrize("how", FEEDS)
def test_regression_evaluation_matches_reference(how):
    rng = np.random.default_rng(8)
    mine, ref = tev.RegressionEvaluation(), jev.RegressionEvaluation()
    for n in (12, 5):
        y = rng.normal(size=(n, 3)).astype(np.float32)
        p = (y + rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
        mine.eval(_feed(y, how), _feed(p, how))
        ref.eval(y, p)
    for m in ("mean_squared_error", "mean_absolute_error",
              "root_mean_squared_error", "r_squared"):
        assert getattr(mine, m)() == getattr(ref, m)()
        assert getattr(mine, m)(1) == getattr(ref, m)(1)
    assert mine.pearson_correlation(2) == ref.pearson_correlation(2)
    assert mine.stats() == ref.stats()
