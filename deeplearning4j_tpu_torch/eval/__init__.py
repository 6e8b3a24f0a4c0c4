"""Evaluation of the port (counterpart of deeplearning4j_tpu/eval):
classification and regression metrics and ROC, accumulated on the host."""

from deeplearning4j_tpu_torch.eval.classification import (
    ROC, Evaluation, EvaluationBinary, EvaluationCalibration, ROCBinary,
    ROCMultiClass)
from deeplearning4j_tpu_torch.eval.regression import RegressionEvaluation

__all__ = ["Evaluation", "EvaluationBinary", "EvaluationCalibration", "ROC",
           "ROCBinary", "ROCMultiClass", "RegressionEvaluation"]
