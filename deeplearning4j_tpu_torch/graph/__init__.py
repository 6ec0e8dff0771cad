"""Graph embeddings (deeplearning4j-graph parity), the PyTorch port of the
JAX package's ``graph/``.

Reference: deeplearning4j-graph/src/main/java/org/deeplearning4j/graph/ —
api/IGraph + graph/Graph (adjacency lists), iterator/RandomWalkIterator
(+ weighted), data/GraphLoader (edge-list files), models/deepwalk/DeepWalk
(+ GraphHuffman). Walks are generated on the host (cheap, int indexing;
``api``, ``loader`` and ``walks`` are copies of the JAX package's modules)
and batched into fixed-shape (center, huffman path) arrays; the
hierarchical-softmax update is one PyTorch step per batch on the model's
device instead of the reference's per-pair Java thread workers.
"""

from deeplearning4j_tpu_torch.graph.api import Edge, Graph, Vertex
from deeplearning4j_tpu_torch.graph.deepwalk import DeepWalk, GraphHuffman
from deeplearning4j_tpu_torch.graph.loader import GraphLoader
from deeplearning4j_tpu_torch.graph.node2vec import Node2Vec
from deeplearning4j_tpu_torch.graph.walks import (
    Node2VecWalkIterator,
    RandomWalkIterator,
    WeightedRandomWalkIterator,
)

__all__ = [
    "Edge",
    "Graph",
    "Vertex",
    "DeepWalk",
    "GraphHuffman",
    "GraphLoader",
    "Node2Vec",
    "Node2VecWalkIterator",
    "RandomWalkIterator",
    "WeightedRandomWalkIterator",
]
