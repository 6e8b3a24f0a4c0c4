"""Classification evaluation (counterpart of
deeplearning4j_tpu/eval/classification.py; Evaluation.java, ROC.java and
their kin): accuracy, precision, recall, F1 and the confusion matrix,
binary and one-vs-all ROC/AUC, calibration, and per-output binary metrics.

As in the reference the counts accumulate on the host in numpy. Labels
and predictions come as numpy arrays or as tensors on any device; a
tensor is copied to the host once per ``eval`` call (bf16 and fp16 as
fp32), so the forward that made it stays on its device.
"""

from __future__ import annotations

import numpy as np
import torch

_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def _host(a) -> np.ndarray:
    """A numpy view of ``a``: a tensor copied to the host once (half types
    widened to fp32, which numpy holds), anything else by ``np.asarray``."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype in (torch.bfloat16, torch.float16):
            a = a.float()
        return a.cpu().numpy()
    return np.asarray(a)


class Evaluation:
    """Accuracy / precision / recall / F1 / confusion matrix.

    Reference: org/nd4j/evaluation/classification/Evaluation.java. Labels and
    predictions are one-hot/probability arrays [batch, classes] (or index
    vectors)."""

    def __init__(self, num_classes: int | None = None, labels: list[str] | None = None):
        self.num_classes = num_classes
        self.label_names = labels
        self.confusion: np.ndarray | None = None

    def _ensure(self, n: int):
        if self.confusion is None:
            self.num_classes = self.num_classes or n
            self.confusion = np.zeros((self.num_classes, self.num_classes), dtype=np.int64)
        elif n > self.num_classes:
            grown = np.zeros((n, n), dtype=np.int64)
            grown[: self.num_classes, : self.num_classes] = self.confusion
            self.confusion = grown
            self.num_classes = n

    def eval(self, labels, predictions):
        labels, predictions = _host(labels), _host(predictions)
        if labels.ndim > 1:
            true_idx = labels.argmax(axis=-1)
            n = labels.shape[-1]
        else:
            true_idx = labels.astype(np.int64)
            n = int(true_idx.max()) + 1 if self.num_classes is None else self.num_classes
        pred_idx = predictions.argmax(axis=-1) if predictions.ndim > 1 else predictions.astype(np.int64)
        needed = int(
            max(
                predictions.shape[-1] if predictions.ndim > 1 else n,
                int(pred_idx.max()) + 1,
                int(true_idx.max()) + 1,
            )
        )
        self._ensure(needed)
        np.add.at(self.confusion, (true_idx.reshape(-1), pred_idx.reshape(-1)), 1)

    # ---- metrics (ND4J naming) -------------------------------------------
    def accuracy(self) -> float:
        c = self.confusion
        return float(np.trace(c) / max(c.sum(), 1))

    def precision(self, cls: int | None = None) -> float:
        c = self.confusion
        col = c.sum(axis=0)
        tp = np.diag(c)
        with np.errstate(invalid="ignore", divide="ignore"):
            per = np.where(col > 0, tp / col, np.nan)
        if cls is not None:
            return float(per[cls])
        return float(np.nanmean(per))

    def recall(self, cls: int | None = None) -> float:
        c = self.confusion
        row = c.sum(axis=1)
        tp = np.diag(c)
        with np.errstate(invalid="ignore", divide="ignore"):
            per = np.where(row > 0, tp / row, np.nan)
        if cls is not None:
            return float(per[cls])
        return float(np.nanmean(per))

    def f1(self, cls: int | None = None) -> float:
        p, r = self.precision(cls), self.recall(cls)
        return 0.0 if p + r == 0 else 2 * p * r / (p + r)

    def false_positive_rate(self, cls: int) -> float:
        c = self.confusion
        fp = c[:, cls].sum() - c[cls, cls]
        tn = c.sum() - c[cls, :].sum() - c[:, cls].sum() + c[cls, cls]
        return float(fp / max(fp + tn, 1))

    def confusion_matrix(self) -> np.ndarray:
        return self.confusion.copy()

    def stats(self) -> str:
        """Human-readable summary (Evaluation.stats() parity)."""
        lines = [
            "========================Evaluation Metrics========================",
            f" # of classes:    {self.num_classes}",
            f" Accuracy:        {self.accuracy():.4f}",
            f" Precision:       {self.precision():.4f}",
            f" Recall:          {self.recall():.4f}",
            f" F1 Score:        {self.f1():.4f}",
            "",
            "=========================Confusion Matrix=========================",
            str(self.confusion),
            "==================================================================",
        ]
        return "\n".join(lines)


class ROC:
    """Binary ROC/AUC via thresholded counts (ROC.java parity; exact mode)."""

    def __init__(self):
        self.scores: list[np.ndarray] = []
        self.labels: list[np.ndarray] = []

    def eval(self, labels, scores):
        labels = _host(labels)
        if labels.ndim > 1 and labels.shape[-1] == 2:
            labels = labels.argmax(axis=-1)  # one-hot -> class index
        labels = labels.reshape(-1)
        scores = _host(scores)
        if scores.ndim > 1 and scores.shape[-1] == 2:
            scores = scores[..., 1]
        self.labels.append(labels)
        self.scores.append(scores.reshape(-1))

    def calculate_auc(self) -> float:
        y = np.concatenate(self.labels)
        s = np.concatenate(self.scores)
        order = np.argsort(-s, kind="stable")
        y, s = y[order], s[order]
        tps = np.cumsum(y)
        fps = np.cumsum(1 - y)
        # collapse tied scores into one threshold point (ties form a single
        # ROC segment, giving AUC 0.5 for constant scores)
        last_of_group = np.r_[s[1:] != s[:-1], True]
        tps, fps = tps[last_of_group], fps[last_of_group]
        P, N = max(tps[-1], 1), max(fps[-1], 1)
        tpr = np.concatenate([[0.0], tps / P])
        fpr = np.concatenate([[0.0], fps / N])
        return float(_trapezoid(tpr, fpr))

    def calculate_auprc(self) -> float:
        y = np.concatenate(self.labels)
        s = np.concatenate(self.scores)
        order = np.argsort(-s, kind="stable")
        y = y[order]
        tps = np.cumsum(y)
        precision = tps / np.arange(1, len(y) + 1)
        recall = tps / max(tps[-1], 1)
        return float(_trapezoid(precision, recall))


class ROCMultiClass:
    """org/nd4j/evaluation/classification/ROCMultiClass.java parity:
    one-vs-all ROC per class over probability outputs."""

    def __init__(self, num_classes: int | None = None):
        self.num_classes = num_classes
        self._rocs: list[ROC] | None = None

    def eval(self, labels, predictions):
        labels, predictions = _host(labels), _host(predictions)
        n = labels.shape[-1]
        if self.num_classes is not None and self.num_classes != n:
            raise ValueError(
                f"num_classes={self.num_classes} but labels have {n} columns")
        if self._rocs is None:
            self._rocs = [ROC() for _ in range(n)]
        for c, roc in enumerate(self._rocs):
            roc.eval(labels[:, c], predictions[:, c])
        return self

    def calculate_auc(self, cls: int) -> float:
        if self._rocs is None:
            raise ValueError("no data: call eval() first")
        return self._rocs[cls].calculate_auc()

    def calculate_average_auc(self) -> float:
        if self._rocs is None:
            raise ValueError("no data: call eval() first")
        return float(np.mean([r.calculate_auc() for r in self._rocs]))


class EvaluationCalibration:
    """org/nd4j/evaluation/classification/EvaluationCalibration.java parity:
    reliability diagram (confidence bins vs empirical accuracy), expected
    calibration error, and probability histograms."""

    def __init__(self, n_bins: int = 10):
        self.n_bins = n_bins
        self._bin_counts = np.zeros(n_bins, np.int64)
        self._bin_correct = np.zeros(n_bins, np.int64)
        self._bin_conf_sum = np.zeros(n_bins, np.float64)
        self._prob_hist = np.zeros(n_bins, np.int64)  # all predicted probs

    def eval(self, labels, predictions):
        labels = _host(labels)
        p = _host(predictions).astype(np.float64)
        conf = p.max(axis=-1)
        pred_cls = p.argmax(axis=-1)
        true_cls = labels.argmax(axis=-1)
        bins = np.clip((conf * self.n_bins).astype(int), 0, self.n_bins - 1)
        np.add.at(self._bin_counts, bins, 1)
        np.add.at(self._bin_correct, bins, pred_cls == true_cls)
        np.add.at(self._bin_conf_sum, bins, conf)
        all_bins = np.clip((p.ravel() * self.n_bins).astype(int), 0,
                           self.n_bins - 1)
        np.add.at(self._prob_hist, all_bins, 1)
        return self

    def reliability_diagram(self):
        """→ (bin_centers, empirical_accuracy, mean_confidence, counts)."""
        centers = (np.arange(self.n_bins) + 0.5) / self.n_bins
        with np.errstate(invalid="ignore"):
            acc = np.where(self._bin_counts > 0,
                           self._bin_correct / np.maximum(self._bin_counts, 1),
                           np.nan)
            conf = np.where(self._bin_counts > 0,
                            self._bin_conf_sum / np.maximum(self._bin_counts, 1),
                            np.nan)
        return centers, acc, conf, self._bin_counts.copy()

    def expected_calibration_error(self) -> float:
        total = self._bin_counts.sum()
        if total == 0:
            return float("nan")
        _, acc, conf, counts = self.reliability_diagram()
        valid = counts > 0
        return float(np.sum(counts[valid] / total
                            * np.abs(acc[valid] - conf[valid])))

    def probability_histogram(self):
        return self._prob_hist.copy()


class EvaluationBinary:
    """Per-output binary metrics on multi-label sigmoid outputs
    (org/nd4j/evaluation/classification/EvaluationBinary.java, path-cite).

    Labels/predictions are [batch, n_outputs] with independent {0,1} labels
    per column; an optional (batch, n_outputs) mask excludes entries."""

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold
        self.tp = self.fp = self.tn = self.fn = None

    def _ensure(self, n: int):
        if self.tp is None:
            self.tp = np.zeros(n)
            self.fp = np.zeros(n)
            self.tn = np.zeros(n)
            self.fn = np.zeros(n)
        elif len(self.tp) != n:
            raise ValueError(
                f"EvaluationBinary was accumulated with {len(self.tp)} "
                f"outputs; this batch has {n}")

    def eval(self, labels, predictions, mask=None):
        labels, preds = _host(labels), _host(predictions)
        if labels.ndim == 1:
            labels = labels[:, None]
            if preds.shape not in ((labels.shape[0],), labels.shape):
                raise ValueError(
                    f"predictions shape {preds.shape} != labels shape "
                    f"({labels.shape[0]},)")
            preds = preds.reshape(labels.shape)
        elif preds.shape != labels.shape:
            raise ValueError(
                f"predictions shape {preds.shape} != labels shape "
                f"{labels.shape}")
        self._ensure(labels.shape[1])
        pos = preds >= self.threshold
        lab = labels >= 0.5
        w = np.ones_like(labels, dtype=np.float64) if mask is None \
            else _host(mask).astype(np.float64).reshape(labels.shape)
        self.tp += np.sum(w * (pos & lab), axis=0)
        self.fp += np.sum(w * (pos & ~lab), axis=0)
        self.tn += np.sum(w * (~pos & ~lab), axis=0)
        self.fn += np.sum(w * (~pos & lab), axis=0)
        return self

    def num_outputs(self) -> int:
        if self.tp is None:
            raise ValueError("no data: call eval() first")
        return len(self.tp)

    def accuracy(self, i: int) -> float:
        self.num_outputs()  # no-data guard
        t = self.tp[i] + self.fp[i] + self.tn[i] + self.fn[i]
        return float((self.tp[i] + self.tn[i]) / t) if t else 0.0

    def precision(self, i: int) -> float:
        self.num_outputs()  # no-data guard
        d = self.tp[i] + self.fp[i]
        return float(self.tp[i] / d) if d else 0.0

    def recall(self, i: int) -> float:
        self.num_outputs()  # no-data guard
        d = self.tp[i] + self.fn[i]
        return float(self.tp[i] / d) if d else 0.0

    def f1(self, i: int) -> float:
        p, r = self.precision(i), self.recall(i)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def average_accuracy(self) -> float:
        return float(np.mean([self.accuracy(i)
                              for i in range(self.num_outputs())]))

    def average_f1(self) -> float:
        return float(np.mean([self.f1(i) for i in range(self.num_outputs())]))

    def stats(self) -> str:
        rows = [f"  out {i}: acc={self.accuracy(i):.4f} "
                f"precision={self.precision(i):.4f} "
                f"recall={self.recall(i):.4f} f1={self.f1(i):.4f}"
                for i in range(self.num_outputs())]
        return "EvaluationBinary ({} outputs)\n{}".format(
            self.num_outputs(), "\n".join(rows))


class ROCBinary:
    """Per-output binary ROC/AUC for multi-label sigmoid outputs
    (org/nd4j/evaluation/classification/ROCBinary.java, path-cite, mount
    empty) — the ROC companion to EvaluationBinary. Labels/scores are
    [batch, n_outputs]; an optional same-shape mask excludes entries."""

    def __init__(self):
        self._rocs: "list[ROC]" = []

    def _ensure(self, n: int):
        if not self._rocs:
            self._rocs = [ROC() for _ in range(n)]
        elif len(self._rocs) != n:
            raise ValueError(
                f"ROCBinary was accumulated with {len(self._rocs)} outputs; "
                f"this batch has {n}")

    def eval(self, labels, scores, mask=None):
        labels, scores = _host(labels), _host(scores)
        if mask is not None:
            mask = _host(mask)
        if labels.ndim == 1:
            labels = labels[:, None]
            scores = scores[:, None]
        if mask is not None and mask.ndim == 1:
            # per-example mask: applies to every output column
            mask = np.broadcast_to(mask[:, None], labels.shape)
        self._ensure(labels.shape[-1])
        for i, roc in enumerate(self._rocs):
            li, si = labels[:, i], scores[:, i]
            if mask is not None:
                keep = mask[:, i] > 0
                li, si = li[keep], si[keep]
            if li.size:
                roc.eval(li, si)

    def num_outputs(self) -> int:
        return len(self._rocs)

    def calculate_auc(self, output: int) -> float:
        return self._rocs[output].calculate_auc()

    def calculate_auprc(self, output: int) -> float:
        return self._rocs[output].calculate_auprc()

    def calculate_average_auc(self) -> float:
        return float(np.mean([r.calculate_auc() for r in self._rocs]))

    def stats(self) -> str:
        rows = [f"ROCBinary ({len(self._rocs)} outputs)"]
        for i, r in enumerate(self._rocs):
            rows.append(f"  output {i}: AUC {r.calculate_auc():.4f}  "
                        f"AUPRC {r.calculate_auprc():.4f}")
        return "\n".join(rows)
