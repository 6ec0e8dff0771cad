"""Random-projection (signed) LSH for cosine distance (PyTorch port of the
JAX package's ``clustering/lsh.py``).

Capability parity with the reference's clustering/lsh/RandomProjectionLSH.java
(hash/makeIndex/bucket/search for the cosine distance, with entropy-LSH
query perturbation). Hashing is one [N,D]x[D,H] product + sign on the
device; bucket matching is one Hamming-agreement reduction over all tables
at once. The projection and the entropy perturbations draw from the host's
``np.random.RandomState`` in the JAX package's order, so both packages hash
alike.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.clustering.knn import f32_products, pairwise_distance


def _signs(data: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    with f32_products(data.device):
        return (data @ proj >= 0.0).to(torch.uint8)  # [N, tables*hash_len]


def _bucket_mask(index_hash, query_hash, num_tables: int, hash_length: int):
    """Row i is in the query's bucket iff SOME table agrees on all bits."""
    ih = index_hash.reshape(-1, num_tables, hash_length)
    qh = query_hash.reshape(num_tables, hash_length)
    agree = (ih == qh[None]).all(dim=2)              # [N, tables]
    return agree.any(dim=1)                          # [N]


class RandomProjectionLSH:
    """``RandomProjectionLSH(hash_length, num_tables, in_dimension, radius)``
    (reference RandomProjectionLSH.java:75). ``radius`` drives entropy-LSH
    perturbation sampling in ``entropy``; search falls back to an exact
    scan when a bucket is empty (the reference raises). Runs on ``device``
    (None: the GPU, raising without one)."""

    def __init__(self, hash_length: int, num_tables: int, in_dimension: int,
                 radius: float = 0.1, seed: int = 12345, device=None):
        from deeplearning4j_tpu_torch.nn.model import resolve_device

        self.hash_length = int(hash_length)
        self.num_tables = int(num_tables)
        self.in_dimension = int(in_dimension)
        self.radius = float(radius)
        self.device = resolve_device(device)
        rs = np.random.RandomState(seed)
        proj = (rs.randn(in_dimension, num_tables * hash_length).astype(np.float32)
                / np.sqrt(in_dimension))
        self.projection = torch.as_tensor(proj, dtype=torch.float32,
                                          device=self.device)
        self._rs = rs
        self.index_data: Optional[np.ndarray] = None
        self.index_hash: Optional[torch.Tensor] = None

    # -- hashing -----------------------------------------------------------
    def _hash_t(self, data) -> torch.Tensor:
        data = np.atleast_2d(np.asarray(data, np.float32))
        return _signs(torch.as_tensor(data, device=self.device), self.projection)

    def hash(self, data) -> np.ndarray:
        return self._hash_t(data).cpu().numpy()

    def entropy(self, x) -> np.ndarray:
        """Entropy-LSH query offsets: points sampled on the sphere of radius
        ``radius`` around x (reference RandomProjectionLSH.entropy:106)."""
        x = np.asarray(x, np.float32).reshape(-1)
        pert = self._rs.randn(self.num_tables, x.shape[0]).astype(np.float32)
        pert /= np.maximum(np.linalg.norm(pert, axis=1, keepdims=True), 1e-12)
        return x[None, :] + self.radius * pert

    # -- index -------------------------------------------------------------
    def make_index(self, data) -> None:
        self.index_data = np.asarray(data, np.float32)
        self.index_hash = self._hash_t(self.index_data)

    def _require_index(self):
        if self.index_data is None:
            raise RuntimeError("call make_index(data) first")

    def bucket(self, query) -> np.ndarray:
        """Boolean row mask of index points sharing a hash bucket with the
        query under ANY table, including entropy perturbations."""
        self._require_index()
        qs = np.vstack([np.atleast_2d(np.asarray(query, np.float32)),
                        self.entropy(query)])
        mask = torch.zeros(self.index_data.shape[0], dtype=torch.bool,
                           device=self.device)
        for qh in self._hash_t(qs):
            mask |= _bucket_mask(self.index_hash, qh, self.num_tables,
                                 self.hash_length)
        return mask.cpu().numpy()

    # -- search ------------------------------------------------------------
    def search(self, query, k: Optional[int] = None,
               max_range: Optional[float] = None) -> np.ndarray:
        """Bucketed cosine-distance search: ``k`` nearest (search(query, k),
        reference :212) or all within ``max_range`` (search(query, maxRange),
        reference :191). Returns the matching index rows, nearest first."""
        self._require_index()
        mask = self.bucket(query)
        cand_idx = np.nonzero(mask)[0]
        if cand_idx.size == 0:
            cand_idx = np.arange(self.index_data.shape[0])
        cand = self.index_data[cand_idx]
        d = pairwise_distance(np.atleast_2d(np.asarray(query, np.float32)),
                              cand, "cosinedistance",
                              device=self.device)[0].cpu().numpy()
        order = np.argsort(d)
        if k is not None:
            order = order[: min(k, order.size)]
        elif max_range is not None:
            order = order[d[order] <= max_range]
        return self.index_data[cand_idx[order]]
