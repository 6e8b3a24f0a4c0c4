"""Regression evaluation (counterpart of deeplearning4j_tpu/eval/regression.py;
RegressionEvaluation.java): per-column MSE, MAE, RMSE, R² and Pearson
correlation over everything ``eval`` saw, in numpy on the host. Labels and
predictions come as numpy arrays or as tensors on any device, each copied
to the host once per ``eval`` call.
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.eval.classification import _host


class RegressionEvaluation:
    def __init__(self):
        self._preds: list[np.ndarray] = []
        self._labels: list[np.ndarray] = []

    def eval(self, labels, predictions):
        labels = np.atleast_2d(_host(labels).astype(np.float64))
        predictions = np.atleast_2d(_host(predictions).astype(np.float64))
        self._labels.append(labels)
        self._preds.append(predictions)

    def _stacked(self):
        return np.concatenate(self._labels), np.concatenate(self._preds)

    def mean_squared_error(self, col: int | None = None):
        y, p = self._stacked()
        mse = np.mean((y - p) ** 2, axis=0)
        return float(mse[col]) if col is not None else float(mse.mean())

    def mean_absolute_error(self, col: int | None = None):
        y, p = self._stacked()
        mae = np.mean(np.abs(y - p), axis=0)
        return float(mae[col]) if col is not None else float(mae.mean())

    def root_mean_squared_error(self, col: int | None = None):
        return self.mean_squared_error(col) ** 0.5

    def r_squared(self, col: int | None = None):
        y, p = self._stacked()
        ss_res = np.sum((y - p) ** 2, axis=0)
        ss_tot = np.maximum(np.sum((y - y.mean(axis=0)) ** 2, axis=0), 1e-12)
        r2 = 1.0 - ss_res / ss_tot
        return float(r2[col]) if col is not None else float(r2.mean())

    def pearson_correlation(self, col: int = 0):
        y, p = self._stacked()
        return float(np.corrcoef(y[:, col], p[:, col])[0, 1])

    def stats(self) -> str:
        return (
            f"RegressionEvaluation: MSE={self.mean_squared_error():.6f} "
            f"MAE={self.mean_absolute_error():.6f} "
            f"RMSE={self.root_mean_squared_error():.6f} "
            f"R2={self.r_squared():.6f}"
        )
