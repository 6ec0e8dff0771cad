"""Multi-label binary evaluation (a copy of the numpy-only
``deeplearning4j_tpu/eval/binary.py``).

Parity: eval/EvaluationBinary.java — per-output-column binary counts
(TP/FP/TN/FN at threshold 0.5) for sigmoid multi-label heads.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


class EvaluationBinary:
    def __init__(self, num_columns: Optional[int] = None, threshold: float = 0.5,
                 column_names: Optional[Sequence[str]] = None):
        self.threshold = threshold
        self.column_names = list(column_names) if column_names else None
        self.tp = self.fp = self.tn = self.fn = None
        if num_columns:
            self._alloc(num_columns)

    def _alloc(self, k: int):
        self.tp = np.zeros(k, dtype=np.int64)
        self.fp = np.zeros(k, dtype=np.int64)
        self.tn = np.zeros(k, dtype=np.int64)
        self.fn = np.zeros(k, dtype=np.int64)

    @property
    def num_columns(self):
        return len(self.tp) if self.tp is not None else 0

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim == 1:
            labels = labels[:, None]
            predictions = predictions[:, None]
        if labels.ndim == 3:
            k = labels.shape[-1]
            labels = labels.reshape(-1, k)
            predictions = predictions.reshape(-1, k)
            if mask is not None and np.asarray(mask).ndim == 2:
                keep = np.asarray(mask).reshape(-1) > 0
                labels, predictions = labels[keep], predictions[keep]
                mask = None
        if self.tp is None:
            self._alloc(labels.shape[-1])
        pred = predictions >= self.threshold
        lab = labels >= 0.5
        w = np.ones(labels.shape, dtype=bool)
        if mask is not None:
            m = np.asarray(mask)
            w = (m if m.ndim == 2 else m[:, None] * np.ones_like(labels)) > 0
        self.tp += (pred & lab & w).sum(axis=0)
        self.fp += (pred & ~lab & w).sum(axis=0)
        self.tn += (~pred & ~lab & w).sum(axis=0)
        self.fn += (~pred & lab & w).sum(axis=0)

    def accuracy(self, col: int) -> float:
        tot = self.tp[col] + self.fp[col] + self.tn[col] + self.fn[col]
        return float(self.tp[col] + self.tn[col]) / tot if tot else 0.0

    def precision(self, col: int) -> float:
        d = self.tp[col] + self.fp[col]
        return float(self.tp[col]) / d if d else 0.0

    def recall(self, col: int) -> float:
        d = self.tp[col] + self.fn[col]
        return float(self.tp[col]) / d if d else 0.0

    def f1(self, col: int) -> float:
        p, r = self.precision(col), self.recall(col)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def average_accuracy(self) -> float:
        return float(np.mean([self.accuracy(c) for c in range(self.num_columns)]))

    def average_f1(self) -> float:
        return float(np.mean([self.f1(c) for c in range(self.num_columns)]))

    def merge(self, other: "EvaluationBinary"):
        if other.tp is None:
            return self
        if self.tp is None:
            self._alloc(other.num_columns)
        self.tp += other.tp
        self.fp += other.fp
        self.tn += other.tn
        self.fn += other.fn
        return self

    def stats(self) -> str:
        names = self.column_names or [f"label_{i}" for i in range(self.num_columns)]
        lines = ["Label       Acc      Precision Recall   F1"]
        for i, nm in enumerate(names):
            lines.append(f"{nm:<11} {self.accuracy(i):<8.4f} {self.precision(i):<9.4f} "
                         f"{self.recall(i):<8.4f} {self.f1(i):<8.4f}")
        return "\n".join(lines)
