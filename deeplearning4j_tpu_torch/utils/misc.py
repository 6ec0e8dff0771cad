"""Misc reference utilities: Viterbi label smoother, MovingWindowMatrix.

Reference: deeplearning4j-nn util/Viterbi.java and util/MovingWindowMatrix.java
(§2.1 "misc util" tail). The reference Viterbi is a noisy-channel label
SMOOTHER: observed per-frame labels are treated as emissions of a hidden
state chain whose self-transitions are sticky (``meta_stability``) and whose
emissions are correct with ``p_correct`` — decoding yields a de-noised label
sequence. NOTE: the reference implementation never fills its backpointer
matrix (Viterbi.java:82-106), so its backtrace returns zeros; this
implementation is the intended, correct DP (documented divergence)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


class Viterbi:
    """``Viterbi(n_states).decode(labels)`` -> (best_log_prob, smoothed).

    ``labels``: [T] int outcomes or [T, K] one-hot/probability rows (argmax
    is taken, Viterbi.java's toOutcomesFromBinaryLabelMatrix)."""

    def __init__(self, states: int, meta_stability: float = 0.9,
                 p_correct: float = 0.99):
        if states < 2:
            raise ValueError("Viterbi needs >= 2 states")
        if not (0.5 < meta_stability < 1.0) or not (0.5 < p_correct < 1.0):
            raise ValueError("meta_stability and p_correct must be in (0.5, 1)")
        self.states = int(states)
        self.meta_stability = float(meta_stability)
        self.p_correct = float(p_correct)
        K = self.states
        self._log_trans = np.full((K, K), np.log((1.0 - meta_stability) / (K - 1)))
        np.fill_diagonal(self._log_trans, np.log(meta_stability))
        self._log_emit_hit = np.log(p_correct)
        self._log_emit_miss = np.log((1.0 - p_correct) / (K - 1))

    def _outcomes(self, labels) -> np.ndarray:
        a = np.asarray(labels)
        if a.ndim == 2:
            return np.argmax(a, axis=1).astype(np.int64)
        return a.astype(np.int64)

    def decode(self, labels) -> Tuple[float, np.ndarray]:
        obs = self._outcomes(labels)
        T, K = len(obs), self.states
        if T == 0:
            return 0.0, obs
        if (obs < 0).any() or (obs >= K).any():
            raise ValueError(f"labels out of range [0, {K})")
        emit = np.full((T, K), self._log_emit_miss)
        emit[np.arange(T), obs] = self._log_emit_hit
        V = np.empty((T, K))
        ptr = np.zeros((T, K), np.int64)
        V[0] = emit[0] - np.log(K)          # uniform prior
        for t in range(1, T):
            scores = V[t - 1][:, None] + self._log_trans   # [from, to]
            ptr[t] = np.argmax(scores, axis=0)
            V[t] = scores[ptr[t], np.arange(K)] + emit[t]
        path = np.empty(T, np.int64)
        path[-1] = int(np.argmax(V[-1]))
        for t in range(T - 2, -1, -1):
            path[t] = ptr[t + 1, path[t + 1]]
        return float(V[-1].max()), path


class MovingWindowMatrix:
    """Sliding sub-windows of a 2-D matrix (MovingWindowMatrix.java):
    ``window_list()`` returns every (rows x cols) window at stride 1, with
    optional 90/180/270-degree rotations appended (``add_rotate``)."""

    def __init__(self, to_slice, window_rows: int = 28, window_cols: int = 28,
                 add_rotate: bool = False):
        self.m = np.asarray(to_slice)
        if self.m.ndim != 2:
            raise ValueError("MovingWindowMatrix expects a 2-D matrix")
        if window_rows > self.m.shape[0] or window_cols > self.m.shape[1]:
            raise ValueError(
                f"window {window_rows}x{window_cols} exceeds matrix "
                f"{self.m.shape}")
        self.window_rows = int(window_rows)
        self.window_cols = int(window_cols)
        self.add_rotate = bool(add_rotate)

    def window_list(self):
        H, W = self.m.shape
        out = []
        for i in range(H - self.window_rows + 1):
            for j in range(W - self.window_cols + 1):
                w = self.m[i:i + self.window_rows, j:j + self.window_cols]
                out.append(w.copy())
                if self.add_rotate:
                    for k in (1, 2, 3):
                        out.append(np.rot90(w, k).copy())
        return out
