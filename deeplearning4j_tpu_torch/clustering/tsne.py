"""t-SNE embedding, exact on the device or Barnes-Hut on the host (PyTorch
port of the JAX package's ``clustering/tsne.py``).

Capability parity with the reference's plot/BarnesHutTsne.java:65 and
plot/Tsne.java (perplexity-calibrated input similarities, early
exaggeration, momentum gradient descent with gains). The exact method
keeps the dense [n, n] terms on the device: the perplexity bisection and
each gradient step are a few elementwise passes and two products, eager
torch ops in a host loop of ``n_iter`` steps. ``theta`` only acts with
``BarnesHutTsne(method="barnes_hut")`` (``clustering/sptree.py``, host).

Memory: the exact method holds about a dozen [n, n] float32 arrays at
its peak (distances, P, the kernel, Q, their products): 311 MB at
n = 2,500 on an H100 (~50·n² bytes; ``chip_smoke.py`` clustering phase),
so n = 10,000 takes ~5 GB and n ≈ 40,000 fills an 80 GB card. Past that
use ``method="barnes_hut"`` (O(n·k) memory).

Starting points and the sparse neighbourhoods come from the host's
``np.random.RandomState`` and ``knn.knn_search`` as in the JAX package, so
both packages start from the same ``y0``. t-SNE is chaotic in float32: one
flipped sign in ``gains`` moves every later step, so the two packages agree
over a few iterations, and over a full run only in what t-SNE is for (KL,
separated clusters). Products are IEEE float32 (``knn.f32_products``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.clustering.knn import (
    f32_products, knn_search, pairwise_distance)


def _binary_search_perplexity(sqd: torch.Tensor, perplexity: float,
                              max_iter: int = 50) -> torch.Tensor:
    """Per-row beta (precision) so each conditional distribution hits the
    target perplexity; standard bisection, vectorized over rows."""
    n = sqd.shape[0]
    log_u = torch.log(torch.tensor(perplexity, dtype=sqd.dtype, device=sqd.device))
    eye = torch.eye(n, dtype=torch.bool, device=sqd.device)

    def entropy_p(beta):
        p = torch.exp(-sqd * beta[:, None])
        p = torch.where(eye, 0.0, p)
        sum_p = p.sum(dim=1).clamp_min(1e-12)
        h = torch.log(sum_p) + beta * (sqd * p).sum(dim=1) / sum_p
        return h, p / sum_p[:, None]

    beta = torch.ones(n, dtype=sqd.dtype, device=sqd.device)
    lo = torch.full((n,), -torch.inf, dtype=sqd.dtype, device=sqd.device)
    hi = torch.full((n,), torch.inf, dtype=sqd.dtype, device=sqd.device)
    for _ in range(max_iter):
        h, _ = entropy_p(beta)
        too_high = h > log_u            # entropy too high -> increase beta
        lo = torch.where(too_high, beta, lo)
        hi = torch.where(too_high, hi, beta)
        beta = torch.where(
            torch.isinf(hi), beta * 2.0,
            torch.where(torch.isneginf(lo), beta / 2.0, (lo + hi) / 2.0))
    _, p = entropy_p(beta)
    return p


def _sparse_perplexity_rows(sqd: np.ndarray, perplexity: float,
                            max_iter: int = 50) -> np.ndarray:
    """Per-row precision calibration over SPARSE neighborhoods: ``sqd`` is
    [n, k] squared distances to each row's k nearest neighbors. Returns the
    conditional p_{j|i} over those k entries (rows sum to 1). Same bisection
    as `_binary_search_perplexity`, vectorized in numpy on [n, k]."""
    n = sqd.shape[0]
    log_u = np.log(perplexity)
    beta = np.ones(n)
    lo = np.full(n, -np.inf)
    hi = np.full(n, np.inf)
    p = np.zeros_like(sqd)
    for _ in range(max_iter):
        p = np.exp(-sqd * beta[:, None])
        sum_p = np.maximum(p.sum(axis=1), 1e-12)
        h = np.log(sum_p) + beta * (sqd * p).sum(axis=1) / sum_p
        too_high = h > log_u
        lo = np.where(too_high, beta, lo)
        hi = np.where(too_high, hi, beta)
        beta = np.where(
            np.isinf(hi), beta * 2.0,
            np.where(np.isneginf(lo), beta / 2.0, (lo + hi) / 2.0))
    p = np.exp(-sqd * beta[:, None])
    return p / np.maximum(p.sum(axis=1, keepdims=True), 1e-12)


def _tsne_optimize(p: torch.Tensor, y0: torch.Tensor, learning_rate: float,
                   momentum_init: float, momentum_final: float, n_iter: int,
                   stop_lying_iter: int, switch_momentum_iter: int = 20,
                   exaggeration: float = 4.0) -> torch.Tensor:
    n = p.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=p.device)

    def grad_kl(y, pmat):
        sqd = ((y * y).sum(dim=1, keepdim=True) - 2.0 * y @ y.T
               + (y * y).sum(dim=1)[None, :])
        num = 1.0 / (1.0 + sqd)                    # student-t kernel
        num = torch.where(eye, 0.0, num)
        q = (num / num.sum()).clamp_min(1e-12)
        pq = (pmat - q) * num                      # [n,n]
        # dY_i = 4 * sum_j pq_ij (y_i - y_j) == 4*(diag(row_sums) - pq) @ y
        return 4.0 * ((pq.sum(dim=1)[:, None] * y) - pq @ y)

    y, vel, gains = y0, torch.zeros_like(y0), torch.ones_like(y0)
    with f32_products(p.device):
        for i in range(n_iter):
            pmat = p * exaggeration if i < stop_lying_iter else p
            g = grad_kl(y, pmat)
            momentum = momentum_init if i < switch_momentum_iter else momentum_final
            same_sign = (g > 0) == (vel > 0)
            gains = torch.where(same_sign, gains * 0.8, gains + 0.2).clamp_min(0.01)
            vel = momentum * vel - learning_rate * gains * g
            y = y + vel
            y = y - y.mean(dim=0, keepdim=True)
    return y


class Tsne:
    """Exact t-SNE (reference plot/Tsne.java surface): ``fit_transform(X)``
    returns the [n, n_components] embedding. Runs on ``device`` (None: the
    GPU, raising without one)."""

    def __init__(self, n_components: int = 2, perplexity: float = 30.0,
                 learning_rate: float = 200.0, n_iter: int = 1000,
                 stop_lying_iteration: int = 250, momentum: float = 0.5,
                 final_momentum: float = 0.8, seed: int = 12345,
                 switch_momentum_iteration: int = 20,
                 exaggeration: float = 4.0, device=None):
        from deeplearning4j_tpu_torch.nn.model import resolve_device

        # reference Tsne.java defaults differ (switchMomentumIteration=100;
        # classic BH-tSNE uses 12x early exaggeration) — both are exposed
        # here and shared by the exact and barnes_hut paths
        self.n_components = n_components
        self.perplexity = perplexity
        self.learning_rate = learning_rate
        self.n_iter = n_iter
        self.stop_lying_iteration = stop_lying_iteration
        self.momentum = momentum
        self.final_momentum = final_momentum
        self.switch_momentum_iteration = switch_momentum_iteration
        self.exaggeration = exaggeration
        self.seed = seed
        self.device = resolve_device(device)
        self.embedding_: Optional[np.ndarray] = None

    def fit_transform(self, x) -> np.ndarray:
        x = np.asarray(x, np.float32)
        n = x.shape[0]
        perp = min(self.perplexity, max((n - 1) / 3.0, 2.0))
        sqd = pairwise_distance(x, x, "sqeuclidean", device=self.device)
        p_cond = _binary_search_perplexity(sqd, perp)
        p = ((p_cond + p_cond.T) / (2.0 * n)).clamp_min(1e-12)
        rs = np.random.RandomState(self.seed)
        y0 = torch.as_tensor(rs.randn(n, self.n_components).astype(np.float32) * 1e-2,
                             device=self.device)
        y = _tsne_optimize(
            p, y0, float(np.float32(self.learning_rate)),
            float(np.float32(self.momentum)), float(np.float32(self.final_momentum)),
            self.n_iter, self.stop_lying_iteration,
            switch_momentum_iter=self.switch_momentum_iteration,
            exaggeration=float(self.exaggeration))
        self.embedding_ = y.cpu().numpy()
        return self.embedding_


class BarnesHutTsne(Tsne):
    """Reference BarnesHutTsne.java:65 surface. ``method="exact"`` (default)
    runs the dense device gradient (module docstring). ``method="barnes_hut"``
    runs a host-side Barnes-Hut loop over `clustering/sptree.SpTree` with
    sparse top-k input similarities (the kNN on the device), honoring
    ``theta`` — for when the n^2 terms cannot fit."""

    def __init__(self, theta: float = 0.5, method: str = "exact", **kw):
        super().__init__(**kw)
        self.theta = theta
        if method not in ("exact", "barnes_hut"):
            raise ValueError(f"method must be 'exact' or 'barnes_hut': {method!r}")
        self.method = method

    def fit(self, x) -> "BarnesHutTsne":
        self.fit_transform(x)
        return self

    def fit_transform(self, x) -> np.ndarray:
        if self.method == "exact":
            return super().fit_transform(x)
        from deeplearning4j_tpu_torch.clustering.sptree import barnes_hut_gradient

        x = np.asarray(x, np.float32)
        n = x.shape[0]
        perp = min(self.perplexity, max((n - 1) / 3.0, 2.0))
        # Sparse input similarities over the 3*perplexity nearest neighbors
        # only (standard BH-tSNE input sparsity): O(n*k) memory end to end.
        k = min(n - 1, max(int(3 * perp), 2))
        nbr_idx, nbr_sqd = knn_search(x, x, k + 1, metric="sqeuclidean",
                                      chunk_size=65536, device=self.device)
        # Drop the self-match by index (not "column 0"): among coincident
        # points top-k breaks ties by index, so a high-index duplicate's own
        # row index can be ABSENT from its k+1 — then every returned
        # neighbor is a genuine distance-0 neighbor and we drop the worst
        # column instead.
        rows = np.arange(n)
        is_self = nbr_idx == rows[:, None]
        self_col = np.where(is_self.any(axis=1),
                            np.argmax(is_self, axis=1), k)
        keep_cols = np.ones_like(nbr_idx, dtype=bool)
        keep_cols[rows, self_col] = False
        nbr_idx = nbr_idx[keep_cols].reshape(n, k)
        sqd = nbr_sqd[keep_cols].reshape(n, k).astype(np.float64)
        p_rows = _sparse_perplexity_rows(sqd, perp)          # [n, k]
        # symmetrize P over the union pattern: P_ij = (p_i|j + p_j|i)/(2n)
        # with the missing direction contributing 0 — attraction must stay
        # conservative or the BH loop diverges (one-sided truncation
        # rotates). Vectorized COO -> coalesced CSR (no Python pair loops).
        src = np.repeat(rows, k)
        dst = nbr_idx.ravel().astype(np.int64)
        v = p_rows.ravel() / (2.0 * n)
        key = np.concatenate([src * n + dst, dst * n + src])
        vals2 = np.concatenate([v, v])
        uniq, inv = np.unique(key, return_inverse=True)
        val_p = np.bincount(inv, weights=vals2, minlength=uniq.size)
        col_p = uniq % n
        row_p = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(uniq // n, minlength=n), out=row_p[1:])
        val_p /= max(val_p.sum(), 1e-12)

        rs = np.random.RandomState(self.seed)
        y = rs.randn(n, self.n_components) * 1e-2
        vel = np.zeros_like(y)
        gains = np.ones_like(y)
        # auto-capped learning rate (Belkina et al. 2019: eta ~ n/exaggeration,
        # floored at 50): the momentum+gains loop oscillates on small n when
        # driven at the dense-path default of 200
        lr = min(self.learning_rate, max(n / self.exaggeration, 50.0))
        for it in range(self.n_iter):
            lying = it < self.stop_lying_iteration
            g = barnes_hut_gradient(
                y, row_p, col_p,
                val_p * (self.exaggeration if lying else 1.0), self.theta)
            momentum = (self.momentum if it < self.switch_momentum_iteration
                        else self.final_momentum)
            same_sign = (g > 0) == (vel > 0)
            gains = np.maximum(np.where(same_sign, gains * 0.8, gains + 0.2), 0.01)
            vel = momentum * vel - lr * gains * g
            y = y + vel
            y -= y.mean(axis=0, keepdims=True)
        self.embedding_ = y.astype(np.float32)
        return self.embedding_
