"""Nearest-neighbours + clustering suite (PyTorch port of the JAX
package's ``clustering/``).

Capability parity with the reference's
deeplearning4j-nearestneighbors-parent/nearestneighbor-core
(clustering/vptree/VPTree.java:48, kdtree/KDTree.java, kmeans/KMeansClustering.java,
lsh/RandomProjectionLSH.java) and deeplearning4j-core's plot/BarnesHutTsne.java:65.

The reference's trees are pointer-chasing CPU structures; here the same
exact-search capability is a batched brute-force top-k (one matmul + top-k
per corpus chunk, streamed over device memory), and VPTree/KDTree remain as
exact-API shims over it. Plain torch: no hand-written kernel lies on this
path. Every entry point takes ``device`` (None: the GPU, raising without
one; ``"cpu"`` runs the same ops on the CPU).
"""

from deeplearning4j_tpu_torch.clustering.knn import knn_search, pairwise_distance
from deeplearning4j_tpu_torch.clustering.kmeans import KMeansClustering, Cluster, ClusterSet
from deeplearning4j_tpu_torch.clustering.lsh import RandomProjectionLSH
from deeplearning4j_tpu_torch.clustering.server import NearestNeighborsServer
from deeplearning4j_tpu_torch.clustering.sptree import QuadTree, SpTree
from deeplearning4j_tpu_torch.clustering.trees import KDTree, VPTree
from deeplearning4j_tpu_torch.clustering.tsne import BarnesHutTsne, Tsne

__all__ = [
    "knn_search",
    "pairwise_distance",
    "KMeansClustering",
    "Cluster",
    "ClusterSet",
    "RandomProjectionLSH",
    "KDTree",
    "VPTree",
    "QuadTree",
    "SpTree",
    "BarnesHutTsne",
    "Tsne",
    "NearestNeighborsServer",
]
