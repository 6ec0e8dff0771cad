"""Classification evaluation + confusion matrix (a copy of the numpy-only
``deeplearning4j_tpu/eval/evaluation.py``).

Parity: eval/Evaluation.java:72 (``eval``:288, ``accuracy``:1141, ``f1``:1034,
top-N:566) and eval/ConfusionMatrix.java. Batch-vectorised: one numpy
bincount per batch instead of the reference's per-example loop.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


class ConfusionMatrix:
    """Dense class-by-class count matrix; rows = actual, cols = predicted."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.matrix = np.zeros((num_classes, num_classes), dtype=np.int64)

    def add(self, actual: np.ndarray, predicted: np.ndarray, weight: int = 1):
        idx = actual.astype(np.int64) * self.num_classes + predicted.astype(np.int64)
        counts = np.bincount(idx, minlength=self.num_classes**2)
        self.matrix += weight * counts.reshape(self.num_classes, self.num_classes)

    def count(self, actual: int, predicted: int) -> int:
        return int(self.matrix[actual, predicted])

    def actual_total(self, cls: int) -> int:
        return int(self.matrix[cls].sum())

    def predicted_total(self, cls: int) -> int:
        return int(self.matrix[:, cls].sum())

    def total(self) -> int:
        return int(self.matrix.sum())

    def merge(self, other: "ConfusionMatrix"):
        assert self.num_classes == other.num_classes
        self.matrix += other.matrix

    def __str__(self):
        return str(self.matrix)


class Evaluation:
    """Multi-class classification metrics accumulated over batches.

    ``eval(labels, predictions)`` accepts one-hot / probability labels of
    shape [batch, classes] (or class-index vectors) and prediction
    probabilities; rank-3 time series [batch, time, classes] are flattened
    with an optional [batch, time] mask, matching the reference's
    ``evalTimeSeries``.
    """

    def __init__(self, num_classes: Optional[int] = None, labels: Optional[Sequence[str]] = None,
                 top_n: int = 1):
        self.label_names = list(labels) if labels else None
        if num_classes is None and labels is not None:
            num_classes = len(labels)
        self.num_classes = num_classes
        self.confusion: Optional[ConfusionMatrix] = (
            ConfusionMatrix(num_classes) if num_classes else None
        )
        self.top_n = top_n
        self.top_n_correct = 0
        self.top_n_total = 0
        self.examples = 0

    # -- accumulation ------------------------------------------------------
    def _ensure(self, n: int):
        if self.confusion is None:
            self.num_classes = n
            self.confusion = ConfusionMatrix(n)
        elif self.num_classes != n:
            raise ValueError(f"Evaluation built for {self.num_classes} classes, got {n}")

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if (labels.dtype.kind in "iu"
                and labels.ndim == predictions.ndim - 1):
            # sparse integer class labels ([B] or [B,T]) — same convention
            # the softmax+mcxent loss head accepts
            n = predictions.shape[-1]
            actual = labels.reshape(-1).astype(np.int64)
            predictions = predictions.reshape(-1, n)
            if mask is not None:
                keep = np.asarray(mask).reshape(-1) > 0
                actual, predictions = actual[keep], predictions[keep]
            self._ensure(n)
            predicted = predictions.argmax(axis=-1)
            self.confusion.add(actual, predicted)
            self.examples += len(actual)
            if self.top_n > 1:
                top = np.argsort(-predictions, axis=-1)[:, : self.top_n]
                self.top_n_correct += int(
                    (top == actual[:, None]).any(axis=-1).sum())
                self.top_n_total += len(actual)
            return
        if labels.ndim == 3:  # time series: flatten (+ mask)
            n = labels.shape[-1]
            labels = labels.reshape(-1, n)
            predictions = predictions.reshape(-1, n)
            if mask is not None:
                keep = np.asarray(mask).reshape(-1) > 0
                labels, predictions = labels[keep], predictions[keep]
        elif mask is not None:
            keep = np.asarray(mask).reshape(-1) > 0
            labels, predictions = labels[keep], predictions[keep]

        if labels.ndim == 2:
            n = labels.shape[-1]
            actual = labels.argmax(axis=-1)
        else:
            actual = labels.astype(np.int64)
            n = predictions.shape[-1]
        self._ensure(n)
        predicted = predictions.argmax(axis=-1)
        self.confusion.add(actual, predicted)
        self.examples += len(actual)

        if self.top_n > 1:
            top = np.argsort(-predictions, axis=-1)[:, : self.top_n]
            self.top_n_correct += int((top == actual[:, None]).any(axis=-1).sum())
            self.top_n_total += len(actual)

    # -- metrics -----------------------------------------------------------
    def _tp(self, c):
        return self.confusion.count(c, c)

    def _fp(self, c):
        return self.confusion.predicted_total(c) - self._tp(c)

    def _fn(self, c):
        return self.confusion.actual_total(c) - self._tp(c)

    def accuracy(self) -> float:
        tot = self.confusion.total()
        return float(np.trace(self.confusion.matrix)) / tot if tot else 0.0

    def top_n_accuracy(self) -> float:
        return self.top_n_correct / self.top_n_total if self.top_n_total else 0.0

    def precision(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            denom = self._tp(cls) + self._fp(cls)
            return self._tp(cls) / denom if denom else 0.0
        vals = [self.precision(c) for c in range(self.num_classes)
                if self.confusion.actual_total(c) > 0 or self.confusion.predicted_total(c) > 0]
        return float(np.mean(vals)) if vals else 0.0

    def recall(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            denom = self._tp(cls) + self._fn(cls)
            return self._tp(cls) / denom if denom else 0.0
        vals = [self.recall(c) for c in range(self.num_classes)
                if self.confusion.actual_total(c) > 0]
        return float(np.mean(vals)) if vals else 0.0

    def f1(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            p, r = self.precision(cls), self.recall(cls)
            return 2 * p * r / (p + r) if (p + r) else 0.0
        p, r = self.precision(), self.recall()
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def matthews_correlation(self, cls: int) -> float:
        tp, fp, fn = self._tp(cls), self._fp(cls), self._fn(cls)
        tn = self.confusion.total() - tp - fp - fn
        denom = np.sqrt(float((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)))
        return ((tp * tn - fp * fn) / denom) if denom else 0.0

    def false_positive_rate(self, cls: int) -> float:
        fp = self._fp(cls)
        tn = self.confusion.total() - self._tp(cls) - fp - self._fn(cls)
        return fp / (fp + tn) if (fp + tn) else 0.0

    def false_negative_rate(self, cls: int) -> float:
        fn = self._fn(cls)
        denom = fn + self._tp(cls)
        return fn / denom if denom else 0.0

    # -- merge / report ----------------------------------------------------
    def merge(self, other: "Evaluation"):
        """Combine another Evaluation (Spark-worker merge semantics,
        eval/Evaluation merge in the reference)."""
        if other.confusion is None:
            return self
        if self.confusion is None:
            self.num_classes = other.num_classes
            self.confusion = ConfusionMatrix(other.num_classes)
        self.confusion.merge(other.confusion)
        self.examples += other.examples
        self.top_n_correct += other.top_n_correct
        self.top_n_total += other.top_n_total
        return self

    def _name(self, c):
        return self.label_names[c] if self.label_names else str(c)

    def stats(self) -> str:
        lines = [
            "========================Evaluation Metrics========================",
            f" # of classes:    {self.num_classes}",
            f" Examples:        {self.examples}",
            f" Accuracy:        {self.accuracy():.4f}",
            f" Precision:       {self.precision():.4f}",
            f" Recall:          {self.recall():.4f}",
            f" F1 Score:        {self.f1():.4f}",
        ]
        if self.top_n > 1:
            lines.append(f" Top-{self.top_n} Accuracy: {self.top_n_accuracy():.4f}")
        lines.append("")
        lines.append("=========================Confusion Matrix=========================")
        header = "     " + " ".join(f"{self._name(c):>6}" for c in range(self.num_classes))
        lines.append(header)
        for c in range(self.num_classes):
            row = " ".join(f"{self.confusion.count(c, p):>6}" for p in range(self.num_classes))
            lines.append(f"{self._name(c):>4} {row}")
        return "\n".join(lines)

    def __str__(self):
        return self.stats()
