"""Regression evaluation (a copy of the numpy-only
``deeplearning4j_tpu/eval/regression.py``).

Parity: eval/RegressionEvaluation.java — per-column MSE, MAE, RMSE, RSE,
Pearson correlation, R²; mergeable across workers via sufficient statistics.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


class RegressionEvaluation:
    """Accumulates per-column sufficient statistics so metrics are exact over
    any number of batches and mergeable across shards."""

    def __init__(self, num_columns: Optional[int] = None,
                 column_names: Optional[Sequence[str]] = None):
        if num_columns is None and column_names is not None:
            num_columns = len(column_names)
        self.column_names = list(column_names) if column_names else None
        self.n_cols = num_columns
        self._initialized = False
        if num_columns:
            self._alloc(num_columns)

    def _alloc(self, n: int):
        self.n_cols = n
        z = lambda: np.zeros(n, dtype=np.float64)
        self.count = z()
        self.sum_err_sq = z()      # sum (y - p)^2
        self.sum_abs_err = z()     # sum |y - p|
        self.sum_label = z()
        self.sum_label_sq = z()
        self.sum_pred = z()
        self.sum_pred_sq = z()
        self.sum_label_pred = z()
        self._initialized = True

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels, dtype=np.float64)
        predictions = np.asarray(predictions, dtype=np.float64)
        if labels.ndim == 3:
            n = labels.shape[-1]
            labels = labels.reshape(-1, n)
            predictions = predictions.reshape(-1, n)
        if mask is not None:
            keep = np.asarray(mask).reshape(-1) > 0
            labels, predictions = labels[keep], predictions[keep]
        if labels.ndim == 1:
            labels = labels[:, None]
            predictions = predictions[:, None]
        if not self._initialized:
            self._alloc(labels.shape[-1])
        err = labels - predictions
        self.count += labels.shape[0]
        self.sum_err_sq += (err**2).sum(axis=0)
        self.sum_abs_err += np.abs(err).sum(axis=0)
        self.sum_label += labels.sum(axis=0)
        self.sum_label_sq += (labels**2).sum(axis=0)
        self.sum_pred += predictions.sum(axis=0)
        self.sum_pred_sq += (predictions**2).sum(axis=0)
        self.sum_label_pred += (labels * predictions).sum(axis=0)

    # -- metrics (per column or averaged) ---------------------------------
    def _percol(self, vals, column):
        if column is not None:
            return float(vals[column])
        return float(np.mean(vals))

    def mean_squared_error(self, column: Optional[int] = None) -> float:
        return self._percol(self.sum_err_sq / np.maximum(self.count, 1), column)

    def mean_absolute_error(self, column: Optional[int] = None) -> float:
        return self._percol(self.sum_abs_err / np.maximum(self.count, 1), column)

    def root_mean_squared_error(self, column: Optional[int] = None) -> float:
        return self._percol(np.sqrt(self.sum_err_sq / np.maximum(self.count, 1)), column)

    def relative_squared_error(self, column: Optional[int] = None) -> float:
        mean_label = self.sum_label / np.maximum(self.count, 1)
        ss_tot = self.sum_label_sq - self.count * mean_label**2
        return self._percol(self.sum_err_sq / np.maximum(ss_tot, 1e-12), column)

    def pearson_correlation(self, column: Optional[int] = None) -> float:
        n = np.maximum(self.count, 1)
        cov = self.sum_label_pred - self.sum_label * self.sum_pred / n
        var_l = self.sum_label_sq - self.sum_label**2 / n
        var_p = self.sum_pred_sq - self.sum_pred**2 / n
        denom = np.sqrt(np.maximum(var_l * var_p, 1e-12))
        return self._percol(cov / denom, column)

    def r_squared(self, column: Optional[int] = None) -> float:
        mean_label = self.sum_label / np.maximum(self.count, 1)
        ss_tot = self.sum_label_sq - self.count * mean_label**2
        return self._percol(1.0 - self.sum_err_sq / np.maximum(ss_tot, 1e-12), column)

    def merge(self, other: "RegressionEvaluation"):
        if not other._initialized:
            return self
        if not self._initialized:
            self._alloc(other.n_cols)
        for attr in ("count", "sum_err_sq", "sum_abs_err", "sum_label", "sum_label_sq",
                     "sum_pred", "sum_pred_sq", "sum_label_pred"):
            setattr(self, attr, getattr(self, attr) + getattr(other, attr))
        return self

    def stats(self) -> str:
        names = self.column_names or [f"col_{i}" for i in range(self.n_cols)]
        lines = ["Column      MSE          MAE          RMSE         RSE          R^2"]
        for i, nm in enumerate(names):
            lines.append(
                f"{nm:<10} {self.mean_squared_error(i):<12.5g} {self.mean_absolute_error(i):<12.5g} "
                f"{self.root_mean_squared_error(i):<12.5g} {self.relative_squared_error(i):<12.5g} "
                f"{self.r_squared(i):<12.5g}"
            )
        return "\n".join(lines)
