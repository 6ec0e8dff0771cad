"""Calibration evaluation (a copy of the numpy-only
``deeplearning4j_tpu/eval/calibration.py``).

Parity: eval/EvaluationCalibration.java — reliability diagram (per-bin mean
predicted probability vs observed fraction positive), residual-probability
histogram, and probability histograms per class.
"""

from __future__ import annotations

import numpy as np


class EvaluationCalibration:
    def __init__(self, reliability_bins: int = 10, histogram_bins: int = 50):
        self.rel_bins = reliability_bins
        self.hist_bins = histogram_bins
        self._alloc_done = False

    def _alloc(self, k: int):
        self.num_classes = k
        self.rel_count = np.zeros((k, self.rel_bins), dtype=np.int64)
        self.rel_pos = np.zeros((k, self.rel_bins), dtype=np.int64)
        self.rel_prob_sum = np.zeros((k, self.rel_bins), dtype=np.float64)
        self.residual_hist = np.zeros(self.hist_bins, dtype=np.int64)
        self.prob_hist = np.zeros((k, self.hist_bins), dtype=np.int64)
        self._alloc_done = True

    def eval(self, labels, predictions):
        labels = np.asarray(labels, dtype=np.float64)
        predictions = np.asarray(predictions, dtype=np.float64)
        if labels.ndim == 1:
            k = predictions.shape[-1]
            onehot = np.zeros((len(labels), k))
            onehot[np.arange(len(labels)), labels.astype(int)] = 1.0
            labels = onehot
        k = labels.shape[-1]
        if not self._alloc_done:
            self._alloc(k)
        p = np.clip(predictions, 0.0, 1.0)
        rel_idx = np.minimum((p * self.rel_bins).astype(int), self.rel_bins - 1)
        pos = labels >= 0.5
        for c in range(k):
            self.rel_count[c] += np.bincount(rel_idx[:, c], minlength=self.rel_bins)
            self.rel_pos[c] += np.bincount(rel_idx[:, c][pos[:, c]], minlength=self.rel_bins)
            self.rel_prob_sum[c] += np.bincount(
                rel_idx[:, c], weights=p[:, c], minlength=self.rel_bins
            )
            h_idx = np.minimum((p[:, c] * self.hist_bins).astype(int), self.hist_bins - 1)
            self.prob_hist[c] += np.bincount(h_idx, minlength=self.hist_bins)
        # residual = |label - p| summed over classes, per example, in [0, 2] -> clip to 1
        resid = np.clip(np.abs(labels - p).mean(axis=-1), 0.0, 1.0)
        r_idx = np.minimum((resid * self.hist_bins).astype(int), self.hist_bins - 1)
        self.residual_hist += np.bincount(r_idx, minlength=self.hist_bins)

    def reliability_diagram(self, cls: int):
        """Returns (mean_predicted_prob, observed_fraction_pos) per bin."""
        cnt = np.maximum(self.rel_count[cls], 1)
        return self.rel_prob_sum[cls] / cnt, self.rel_pos[cls] / cnt

    def expected_calibration_error(self, cls: int) -> float:
        mean_p, frac_pos = self.reliability_diagram(cls)
        weights = self.rel_count[cls] / max(self.rel_count[cls].sum(), 1)
        return float(np.sum(weights * np.abs(mean_p - frac_pos)))

    def merge(self, other: "EvaluationCalibration"):
        if not other._alloc_done:
            return self
        if not self._alloc_done:
            self._alloc(other.num_classes)
        self.rel_count += other.rel_count
        self.rel_pos += other.rel_pos
        self.rel_prob_sum += other.rel_prob_sum
        self.residual_hist += other.residual_hist
        self.prob_hist += other.prob_hist
        return self
