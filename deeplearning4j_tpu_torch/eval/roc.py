"""ROC / AUC evaluation (a copy of the numpy-only
``deeplearning4j_tpu/eval/roc.py``).

Parity: eval/ROC.java (720 LoC), ROCBinary.java, ROCMultiClass.java and the
curve classes in eval/curves/. Like the reference's thresholded mode, scores
are histogrammed into a fixed number of probability bins so memory is O(bins)
regardless of dataset size and merge across workers is exact; ``num_bins=0``
is the exact mode (stores all scores).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class ROC:
    """Binary ROC: accumulate (probability-of-positive, label) pairs.

    With ``num_bins > 0`` counts land in uniform probability bins
    (thresholded mode, like the reference's thresholdSteps); AUC is computed
    by trapezoid over the binned ROC curve.
    """

    def __init__(self, num_bins: int = 200):
        self.num_bins = num_bins
        if num_bins > 0:
            self.pos_hist = np.zeros(num_bins, dtype=np.int64)
            self.neg_hist = np.zeros(num_bins, dtype=np.int64)
        else:
            self._scores = []
            self._labels = []

    def eval(self, labels, predictions):
        """labels: [n] {0,1} or [n,2] one-hot; predictions: [n] P(pos) or
        [n,2] probabilities (column 1 = positive, DL4J convention)."""
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim == 2:
            # [n,1] is a single sigmoid column (values ARE the labels);
            # argmax would map every row to class 0
            labels = labels[:, 0] if labels.shape[1] == 1 else labels.argmax(axis=-1)
        if predictions.ndim == 2:
            if predictions.shape[1] > 2:
                raise ValueError(
                    f"ROC is binary-only but predictions have {predictions.shape[1]} "
                    "columns; use ROCMultiClass for multi-class outputs"
                )
            predictions = predictions[:, 1] if predictions.shape[1] == 2 else predictions[:, 0]
        labels = labels.astype(bool)
        p = np.clip(predictions.astype(np.float64), 0.0, 1.0)
        if self.num_bins > 0:
            bins = np.minimum((p * self.num_bins).astype(np.int64), self.num_bins - 1)
            self.pos_hist += np.bincount(bins[labels], minlength=self.num_bins)
            self.neg_hist += np.bincount(bins[~labels], minlength=self.num_bins)
        else:
            self._scores.append(p)
            self._labels.append(labels)

    def _counts(self):
        """Exact mode: raw concatenated (scores, labels) — callers sort."""
        if self.num_bins > 0:
            return self.pos_hist, self.neg_hist
        scores = np.concatenate(self._scores) if self._scores else np.zeros(0)
        labels = np.concatenate(self._labels) if self._labels else np.zeros(0, bool)
        return scores, labels

    def roc_curve(self):
        """Returns (fpr, tpr) arrays from highest threshold to lowest."""
        if self.num_bins > 0:
            # cumulative from the top bin down
            pos = self.pos_hist[::-1].cumsum().astype(np.float64)
            neg = self.neg_hist[::-1].cumsum().astype(np.float64)
            tp_total = max(pos[-1], 1.0)
            fp_total = max(neg[-1], 1.0)
            tpr = np.concatenate([[0.0], pos / tp_total])
            fpr = np.concatenate([[0.0], neg / fp_total])
            return fpr, tpr
        scores, labels = self._counts()
        order = np.argsort(-scores)
        labels = labels[order]
        tps = np.cumsum(labels).astype(np.float64)
        fps = np.cumsum(~labels).astype(np.float64)
        tp_total = max(tps[-1] if len(tps) else 0.0, 1.0)
        fp_total = max(fps[-1] if len(fps) else 0.0, 1.0)
        tpr = np.concatenate([[0.0], tps / tp_total])
        fpr = np.concatenate([[0.0], fps / fp_total])
        return fpr, tpr

    def calculate_auc(self) -> float:
        fpr, tpr = self.roc_curve()
        return float(np.trapezoid(tpr, fpr))

    def precision_recall_curve(self):
        if self.num_bins > 0:
            pos = self.pos_hist[::-1].cumsum().astype(np.float64)
            neg = self.neg_hist[::-1].cumsum().astype(np.float64)
            tp_total = max(pos[-1], 1.0)
            precision = pos / np.maximum(pos + neg, 1.0)
            recall = pos / tp_total
            return recall, precision
        scores, labels = self._counts()
        order = np.argsort(-scores)
        labels = labels[order]
        tps = np.cumsum(labels).astype(np.float64)
        fps = np.cumsum(~labels).astype(np.float64)
        tp_total = max(tps[-1] if len(tps) else 0.0, 1.0)
        precision = tps / np.maximum(tps + fps, 1.0)
        recall = tps / tp_total
        return recall, precision

    def calculate_auprc(self) -> float:
        recall, precision = self.precision_recall_curve()
        return float(np.trapezoid(precision, recall))

    def merge(self, other: "ROC"):
        if self.num_bins > 0 and other.num_bins == self.num_bins:
            self.pos_hist += other.pos_hist
            self.neg_hist += other.neg_hist
        elif self.num_bins == 0 and other.num_bins == 0:
            self._scores.extend(other._scores)
            self._labels.extend(other._labels)
        else:
            raise ValueError("Cannot merge ROC with different num_bins")
        return self


class ROCBinary:
    """Per-output-column independent binary ROC (ROCBinary.java): for
    multi-label sigmoid outputs [n, k]."""

    def __init__(self, num_bins: int = 200):
        self.num_bins = num_bins
        self.per_column = None

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim == 1:
            labels = labels[:, None]
            predictions = predictions[:, None]
        k = labels.shape[-1]
        if self.per_column is None:
            self.per_column = [ROC(self.num_bins) for _ in range(k)]
        for c in range(k):
            lab, pred = labels[:, c], predictions[:, c]
            if mask is not None:
                keep = np.asarray(mask)[:, c] > 0 if np.asarray(mask).ndim == 2 else np.asarray(mask) > 0
                lab, pred = lab[keep], pred[keep]
            self.per_column[c].eval(lab, pred)

    def calculate_auc(self, column: int = 0) -> float:
        return self.per_column[column].calculate_auc()

    def calculate_average_auc(self) -> float:
        return float(np.mean([r.calculate_auc() for r in self.per_column]))

    def merge(self, other: "ROCBinary"):
        if other.per_column is None:
            return self
        if self.per_column is None:
            self.per_column = [ROC(self.num_bins) for _ in other.per_column]
        for a, b in zip(self.per_column, other.per_column):
            a.merge(b)
        return self


class ROCMultiClass:
    """One-vs-all ROC per class (ROCMultiClass.java): softmax outputs [n, k]."""

    def __init__(self, num_bins: int = 200):
        self.num_bins = num_bins
        self.per_class = None

    def eval(self, labels, predictions):
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim == 1:
            k = predictions.shape[-1]
            onehot = np.zeros((len(labels), k))
            onehot[np.arange(len(labels)), labels.astype(int)] = 1.0
            labels = onehot
        k = labels.shape[-1]
        if self.per_class is None:
            self.per_class = [ROC(self.num_bins) for _ in range(k)]
        for c in range(k):
            self.per_class[c].eval(labels[:, c], predictions[:, c])

    def calculate_auc(self, cls: int) -> float:
        return self.per_class[cls].calculate_auc()

    def calculate_average_auc(self) -> float:
        return float(np.mean([r.calculate_auc() for r in self.per_class]))

    def merge(self, other: "ROCMultiClass"):
        if other.per_class is None:
            return self
        if self.per_class is None:
            self.per_class = [ROC(self.num_bins) for _ in other.per_class]
        for a, b in zip(self.per_class, other.per_class):
            a.merge(b)
        return self
