"""K-Means clustering, Lloyd iterations on the device (PyTorch port of the
JAX package's ``clustering/kmeans.py``).

Capability parity with the reference's
clustering/kmeans/KMeansClustering.java (setup(clusterCount,
maxIterationCount, distanceFunction) -> applyTo(points) -> ClusterSet):
one assignment + update iteration is a handful of torch ops (the distance
matrix, ``argmin``, the centroid sums as one product), not per-point loops.

The centroid sums are ``one_hot.T @ points``, as in the JAX package, and
not an ``index_add_``: a float scatter on CUDA adds in an order that
changes from run to run, so k-means would not repeat itself. ``argmin``
returns the first minimum, as ``jnp.argmin`` does. Point counts are
padded up the shared bucket ladder (``utils/bucketing``) and padded rows
are masked out of the sums, so the padded update equals the unpadded one;
the ``kmeans.lloyd`` / ``kmeans.assign`` bucket hits are recorded, and
each new signature as a compile there (the retrace guard bounds the two
against the hits, ``analysis/retrace_guard.py``). The
seeding (k-means++ or random rows) draws from the host's
``np.random.RandomState`` in the JAX package's order. Products are IEEE
float32 (``knn.f32_products``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.analysis import retrace_guard
from deeplearning4j_tpu_torch.clustering.knn import (
    _device_of, _tensor, f32_products, pairwise_distance)
from deeplearning4j_tpu_torch.utils import bucketing

# the signatures of the two module-level steps, process-wide as the JAX
# package's module-level jit caches are
_SIGS = retrace_guard.Signatures()
_sig = retrace_guard.signature_of


@dataclass
class Cluster:
    """One cluster of a ClusterSet (reference clustering/cluster/Cluster.java)."""

    center: np.ndarray
    point_indices: np.ndarray

    @property
    def count(self) -> int:
        return int(len(self.point_indices))


@dataclass
class ClusterSet:
    """Result container (reference clustering/cluster/ClusterSet.java).
    ``device`` is where ``nearest_cluster`` computes (None: the GPU)."""

    centers: np.ndarray            # [k, d]
    assignments: np.ndarray        # [n] cluster id per point
    distances: np.ndarray          # [n] distance to own center
    distance_function: str = "euclidean"
    clusters: List[Cluster] = field(default_factory=list)
    device: Optional[str] = None

    def __post_init__(self):
        if not self.clusters:
            self.clusters = [
                Cluster(self.centers[c], np.nonzero(self.assignments == c)[0])
                for c in range(len(self.centers))
            ]

    def nearest_cluster(self, point) -> int:
        d = pairwise_distance(np.atleast_2d(point), self.centers,
                              self.distance_function, device=self.device)
        return int(torch.argmin(d[0]))


def _lloyd_step(points, centers, n_valid: int, metric: str):
    """One Lloyd iteration: assign + recompute. Empty clusters keep their
    previous center (reference keeps the cluster alive too). Rows at or past
    ``n_valid`` are bucket padding: they still get an argmin assignment (the
    caller slices them off) but a validity mask zeroes them out of the
    centroid sums, so the padded update equals the unpadded one exactly."""
    d = pairwise_distance(points, centers, metric)
    assign = torch.argmin(d, dim=1)
    k = centers.shape[0]
    valid = (torch.arange(points.shape[0], device=points.device)
             < n_valid).to(points.dtype)
    one_hot = F.one_hot(assign, k).to(points.dtype) * valid[:, None]
    counts = one_hot.sum(0)                                        # [k]
    with f32_products(points.device):
        sums = one_hot.T @ points                                  # [k, d]
    new_centers = torch.where(counts[:, None] > 0,
                              sums / counts[:, None].clamp_min(1.0), centers)
    shift = torch.linalg.vector_norm(new_centers - centers, dim=1).max()
    return new_centers, assign, d.amin(dim=1), shift


def _assign_step(points, centers, metric: str):
    """Assignment-only: nearest center id + distance per row. Row
    independent, so bucket padding needs no mask."""
    d = pairwise_distance(points, centers, metric)
    return torch.argmin(d, dim=1), d.amin(dim=1)


def assign_points(points, centers, metric: str = "euclidean",
                  chunk_rows: int = 16384, device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Nearest-center assignment for a full corpus, chunked and bucketed.

    Chunking caps the [rows, k] distance matrix (16384×512 f32 ≈ 32 MB);
    each chunk's leading axis is padded up the shared ladder. Returns
    ``(assign int32, distance float32)`` as host arrays of length
    ``len(points)``. A host ``points`` is copied to ``device`` (None: the
    GPU) a chunk at a time; tensors stay where they are."""
    dev = _device_of(points, centers, device=device)
    if not isinstance(points, torch.Tensor):
        points = np.asarray(points, np.float32)
    centers = _tensor(centers, dev)
    n = points.shape[0]
    ladder = bucketing.ladder_from_env()
    tel = bucketing.telemetry()
    assigns, dists = [], []
    for lo in range(0, n, chunk_rows):
        chunk = points[lo:lo + chunk_rows]
        rows = chunk.shape[0]
        target = ladder.bucket(rows) if bucketing.bucketing_enabled() else rows
        tel.record_hit("kmeans.assign", rows, target)
        padded = bucketing.pad_rows_zero(_tensor(chunk, dev), target)
        _SIGS.note("kmeans.assign", _sig(padded, centers, metric), tuple(padded.shape))
        a, d = _assign_step(padded, centers, metric)
        retrace_guard.check_if_enabled("kmeans.assign")
        assigns.append(a[:rows].to(torch.int32))
        dists.append(d[:rows])
    if not assigns:
        return np.zeros(0, np.int32), np.zeros(0, np.float32)
    return torch.cat(assigns).cpu().numpy(), torch.cat(dists).cpu().numpy()


def _kmeanspp_init(points: torch.Tensor, k: int, metric: str,
                   rs: np.random.RandomState) -> torch.Tensor:
    """k-means++ seeding (D^2 sampling), drawn on the host in the JAX
    package's order; the distances are computed where ``points`` lies."""
    n = points.shape[0]
    picks = [rs.randint(n)]
    for _ in range(1, k):
        d = pairwise_distance(points, points[picks], metric).amin(dim=1)
        d = d.cpu().numpy()
        d2 = d * d
        tot = d2.sum()
        if tot <= 0:
            picks.append(rs.randint(n))
            continue
        picks.append(rs.choice(n, p=d2 / tot))
    return points[picks].clone()


def _random_init(points: torch.Tensor, k: int, rs: np.random.RandomState):
    """Random distinct-row seeding (the reference's own strategy). O(k) vs
    k-means++'s O(n·k²) distance work — the right trade for IVF coarse
    quantizers where k is large and Lloyd refines anyway."""
    idx = rs.choice(points.shape[0], size=k, replace=False)
    return points[torch.as_tensor(idx, device=points.device)].clone()


class KMeansClustering:
    """``KMeansClustering.setup(k, max_iters, distance_fn)`` then
    ``apply_to(points)`` (reference KMeansClustering.java:52). Runs on
    ``device`` (None: the GPU, raising without one)."""

    def __init__(self, cluster_count: int, max_iteration_count: int = 100,
                 distance_function: str = "euclidean", tolerance: float = 1e-4,
                 seed: int = 12345, init: str = "kmeanspp", device=None):
        from deeplearning4j_tpu_torch.nn.model import resolve_device

        if distance_function.lower() in ("cosinesimilarity", "dot"):
            raise ValueError(
                "k-means needs a distance (smaller=closer); use 'cosinedistance'"
            )
        if init not in ("kmeanspp", "random"):
            raise ValueError(f"init must be 'kmeanspp' or 'random', got {init!r}")
        self.k = int(cluster_count)
        self.max_iterations = int(max_iteration_count)
        self.distance_function = distance_function
        self.tolerance = float(tolerance)
        self.seed = seed
        self.init = init
        self.device = resolve_device(device)

    @staticmethod
    def setup(cluster_count: int, max_iteration_count: int = 100,
              distance_function: str = "euclidean", **kw) -> "KMeansClustering":
        return KMeansClustering(cluster_count, max_iteration_count,
                                distance_function, **kw)

    def apply_to(self, points) -> ClusterSet:
        points = np.asarray(points, np.float32)
        n = points.shape[0]
        if n < self.k:
            raise ValueError(f"need >= {self.k} points, got {n}")
        rs = np.random.RandomState(self.seed)
        pts = torch.as_tensor(points, device=self.device)
        if self.init == "random":
            centers = _random_init(pts, self.k, rs)
        else:
            centers = _kmeanspp_init(pts, self.k, self.distance_function, rs)
        ladder = bucketing.ladder_from_env()
        target = ladder.bucket(n) if bucketing.bucketing_enabled() else n
        bucketing.telemetry().record_hit("kmeans.lloyd", n, target)
        pts = bucketing.pad_rows_zero(pts, target)
        assign = mind = None
        _SIGS.note("kmeans.lloyd", _sig(pts, centers, self.distance_function),
                   tuple(pts.shape))
        for _ in range(self.max_iterations):
            centers, assign, mind, shift = _lloyd_step(
                pts, centers, n, self.distance_function)
            retrace_guard.check_if_enabled("kmeans.lloyd")
            if float(shift) < self.tolerance:
                break
        return ClusterSet(
            centers=centers.cpu().numpy(),
            assignments=assign[:n].to(torch.int32).cpu().numpy(),
            distances=mind[:n].cpu().numpy(),
            distance_function=self.distance_function,
            device=str(self.device),
        )
