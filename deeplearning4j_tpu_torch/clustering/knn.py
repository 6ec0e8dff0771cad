"""Batched brute-force k-nearest-neighbour search (PyTorch port of the JAX
package's ``clustering/knn.py``).

The replacement for the reference's pointer-chasing search trees
(VPTree.java:48 'search', KDTree.java 'knn'): one distance matrix (a
single matmul for the dominant term) and a top-k per corpus chunk, with a
streaming top-k merge across chunks so the corpus never has to fit in one
buffer. Plain torch: no hand-written kernel lies on this path.

Two rules every search module of the port shares live here:

- **Ties.** :func:`topk_stable` orders by (score descending, index
  ascending), the order ``lax.top_k`` gives. ``torch.topk`` promises no
  order among equal values (on CUDA it varies), and duplicate corpus rows,
  a query equal to a corpus row or ``/knn``'s self-exclusion all make ties.
- **Precision.** Every product is IEEE float32, whatever the process set
  for TF32: the search modules run their products inside
  :func:`f32_products`, which turns TF32 off for cuBLAS while one of them is
  in flight (process-wide: the setting is a global of torch) and restores
  the caller's setting after the last one.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["f32_products", "knn_search", "pairwise_distance", "topk_stable"]

_METRICS = ("euclidean", "sqeuclidean", "cosinesimilarity", "cosinedistance",
            "dot", "manhattan")

_PREC_LOCK = threading.Lock()
_prec = {"users": 0, "saved": False}


def _tf32_on() -> bool:
    m = torch.backends.cuda.matmul
    # torch >= 2.9 also has fp32_precision ("ieee" | "tf32"): its getter
    # never raises, where the legacy one does once the new setter was used
    if hasattr(m, "fp32_precision"):
        return m.fp32_precision == "tf32"
    return bool(m.allow_tf32)


@contextlib.contextmanager
def f32_products(device):
    """Run the enclosed CUDA products in IEEE float32 (no TF32). Reference
    counted across threads: the first entrant saves the process setting,
    the last one out restores it. It sets through the legacy
    ``allow_tf32``, which keeps the legacy and the new precision settings
    in agreement. A no-op off the GPU."""
    if torch.device(device).type != "cuda":
        yield
        return
    with _PREC_LOCK:
        if _prec["users"] == 0:
            _prec["saved"] = _tf32_on()
            torch.backends.cuda.matmul.allow_tf32 = False
        _prec["users"] += 1
    try:
        yield
    finally:
        with _PREC_LOCK:
            _prec["users"] -= 1
            if _prec["users"] == 0:
                torch.backends.cuda.matmul.allow_tf32 = _prec["saved"]


def topk_stable(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of each row of a float32 ``scores`` as
    ``(values, indices)``, ordered by (value descending, index ascending):
    ``lax.top_k``'s order, ties included.

    Each entry gets a unique int64 key: the float's bits mapped onto an
    order-preserving integer in the high 32 bits, ``n - 1 - index`` in the
    low 32, so one ``torch.topk`` over the keys has a single answer. The
    order is the floats' total order, as in ``lax.top_k``: -0.0 ranks below
    +0.0."""
    n = scores.shape[-1]
    bits = scores.contiguous().view(torch.int32).to(torch.int64)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    low = (n - 1) - torch.arange(n, device=scores.device, dtype=torch.int64)
    _, idx = torch.topk(ordered * (1 << 32) + low, k, dim=-1)
    return torch.gather(scores, -1, idx), idx


def _tensor(x, device) -> torch.Tensor:
    """``x`` as a float32 tensor: a tensor stays on its device, anything
    else goes to ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _device_of(*xs, device=None) -> torch.device:
    from deeplearning4j_tpu_torch.nn.model import resolve_device

    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return resolve_device(device)


def pairwise_distance(x, y, metric: str = "euclidean", device=None) -> torch.Tensor:
    """[Q,D] x [N,D] -> [Q,N] distance (or similarity, for *similarity
    metrics) matrix on the inputs' device (a tensor's own; numpy inputs go
    to ``device``, None meaning the GPU). Euclidean/cosine/dot reduce to one
    matmul."""
    m = metric.lower()
    if m not in _METRICS:
        raise ValueError(f"unknown metric {metric!r}; one of {_METRICS}")
    dev = _device_of(x, y, device=device)
    x = torch.atleast_2d(_tensor(x, dev))
    y = torch.atleast_2d(_tensor(y, dev))
    with f32_products(dev):
        if m in ("euclidean", "sqeuclidean"):
            # ||x-y||^2 = ||x||^2 - 2<x,y> + ||y||^2 : the cross term is the matmul
            sq = ((x * x).sum(-1, keepdim=True) - 2.0 * (x @ y.T)
                  + (y * y).sum(-1)[None, :])
            sq = sq.clamp_min(0.0)
            return sq if m == "sqeuclidean" else sq.sqrt()
        if m in ("cosinesimilarity", "cosinedistance"):
            xn = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)
            yn = y / torch.linalg.vector_norm(y, dim=-1, keepdim=True).clamp_min(1e-12)
            sim = xn @ yn.T
            return sim if m == "cosinesimilarity" else 1.0 - sim
        if m == "dot":
            return x @ y.T
    # manhattan: no matmul form; broadcast-reduce
    return (x[:, None, :] - y[None, :, :]).abs().sum(-1)


def _larger_is_better(metric: str) -> bool:
    return metric.lower() in ("cosinesimilarity", "dot")


def _chunk_topk(queries, chunk, k: int, metric: str, offset: int):
    d = pairwise_distance(queries, chunk, metric)
    scores = d if _larger_is_better(metric) else -d
    best, idx = topk_stable(scores, k)  # [Q,k]
    return best, idx + offset


def _merge_topk(best_a, idx_a, best_b, idx_b, k: int):
    best, sel = topk_stable(torch.cat([best_a, best_b], dim=1), k)
    return best, torch.gather(torch.cat([idx_a, idx_b], dim=1), 1, sel)


def knn_search(
    corpus,
    queries,
    k: int,
    metric: str = "euclidean",
    chunk_size: Optional[int] = None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact top-k over ``corpus`` for each query row.

    Returns (indices [Q,k] int32, distances [Q,k]) as host arrays, ordered
    best-first, ties to the lower index. ``chunk_size`` bounds the corpus
    rows scored per step: a host corpus is copied to the device a chunk at
    a time, each chunk's top-k merged into a running one. Tensors stay on
    their device; numpy inputs go to ``device`` (None: the GPU, raising
    without one)."""
    dev = _device_of(corpus, queries, device=device)
    if not isinstance(corpus, torch.Tensor):
        corpus = np.asarray(corpus, np.float32)
    q = torch.atleast_2d(_tensor(queries, dev))
    n = corpus.shape[0]
    k = min(k, n)
    if chunk_size is None or chunk_size >= n:
        best, idx = _chunk_topk(q, _tensor(corpus, dev), k, metric, 0)
    else:
        best = idx = None
        for s in range(0, n, chunk_size):
            chunk = _tensor(corpus[s:s + chunk_size], dev)
            kk = min(k, chunk.shape[0])
            b, i = _chunk_topk(q, chunk, kk, metric, s)
            if best is None:
                best, idx = b, i
            else:
                best, idx = _merge_topk(best, idx, b, i,
                                        min(k, best.shape[1] + b.shape[1]))
    dist = best if _larger_is_better(metric) else -best
    return idx.to(torch.int32).cpu().numpy(), dist.cpu().numpy()
