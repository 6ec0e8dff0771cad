"""VPTree / KDTree — exact-search APIs over the batched brute-force scan
(PyTorch port of the JAX package's ``clustering/trees.py``).

Capability parity with clustering/vptree/VPTree.java:48 and
clustering/kdtree/KDTree.java. The reference builds pointer-chasing trees
to prune distance evaluations on a CPU; on the card the unpruned batched
scan (``knn.knn_search``: a matmul and a top-k per chunk) is exactly as
exact, so these classes keep the reference's construction/search surface
and delegate to it, on ``device`` (None: the GPU, raising without one).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from deeplearning4j_tpu_torch.clustering.knn import knn_search, pairwise_distance


class VPTree:
    """``VPTree(items, similarity_function='euclidean', invert=False)``;
    ``search(target, k)`` -> (items, distances) best-first (reference
    VPTree.search). ``invert=True`` flips the ordering objective, like the
    reference's use for similarity functions."""

    EUCLIDEAN = "euclidean"

    def __init__(self, items, similarity_function: str = "euclidean",
                 invert: bool = False, workers: int = 1, chunk_size: int = 65536,
                 device=None):
        from deeplearning4j_tpu_torch.nn.model import resolve_device

        self.items = np.asarray(items, np.float32)
        self.similarity_function = similarity_function
        self.invert = bool(invert)
        self.workers = workers  # kept for API parity; search is one device op
        self.chunk_size = chunk_size
        self.device = resolve_device(device)

    def search(self, target, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """k nearest items to ``target``: (items [k,D], distances [k])."""
        metric = self.similarity_function
        if self.invert:
            # inverted objective: farthest-first under the metric
            d = pairwise_distance(np.atleast_2d(np.asarray(target, np.float32)),
                                  self.items, metric,
                                  device=self.device)[0].cpu().numpy()
            order = np.argsort(-d)[: min(k, d.size)]
            return self.items[order], d[order]
        idx, dist = knn_search(self.items, np.atleast_2d(target), k,
                               metric=metric, chunk_size=self.chunk_size,
                               device=self.device)
        return self.items[idx[0]], dist[0]

    def get_items(self) -> np.ndarray:
        return self.items

    def distance(self, a, b) -> float:
        return float(pairwise_distance(np.atleast_2d(a), np.atleast_2d(b),
                                       self.similarity_function,
                                       device=self.device)[0, 0])


class KDTree:
    """``KDTree(dims)`` with ``insert(point)``, ``nn(point)``,
    ``knn(point, distance)`` (reference kdtree/KDTree.java: knn returns all
    points within ``distance``, nearest first; nn returns (distance, point)).
    Mutable corpus; each search is the exact batched scan."""

    def __init__(self, dims: int, device=None):
        from deeplearning4j_tpu_torch.nn.model import resolve_device

        self.dims = int(dims)
        self.device = resolve_device(device)
        self._points: List[np.ndarray] = []

    def insert(self, point) -> None:
        p = np.asarray(point, np.float32).reshape(-1)
        if p.shape[0] != self.dims:
            raise ValueError(f"expected dim {self.dims}, got {p.shape[0]}")
        self._points.append(p)

    def delete(self, point) -> bool:
        p = np.asarray(point, np.float32).reshape(-1)
        for i, q in enumerate(self._points):
            if np.array_equal(p, q):
                del self._points[i]
                return True
        return False

    def size(self) -> int:
        return len(self._points)

    def _corpus(self) -> np.ndarray:
        if not self._points:
            raise RuntimeError("empty KDTree")
        return np.stack(self._points)

    def nn(self, point) -> Tuple[float, np.ndarray]:
        corpus = self._corpus()
        idx, dist = knn_search(corpus, np.atleast_2d(point), 1, device=self.device)
        return float(dist[0, 0]), corpus[idx[0, 0]]

    def knn(self, point, distance: float) -> List[Tuple[float, np.ndarray]]:
        corpus = self._corpus()
        d = pairwise_distance(np.atleast_2d(np.asarray(point, np.float32)),
                              corpus, "euclidean",
                              device=self.device)[0].cpu().numpy()
        order = np.argsort(d)
        return [(float(d[i]), corpus[i]) for i in order if d[i] <= distance]
