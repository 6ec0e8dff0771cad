"""Node2Vec: p/q-biased walks + skip-gram vertex embeddings.

Reference parity: deeplearning4j-nlp-parent/deeplearning4j-nlp/src/main/java/
org/deeplearning4j/models/node2vec/Node2Vec.java (walks into SequenceVectors
skip-gram). The PyTorch port of the JAX package's ``graph/node2vec.py``:
walks are generated on the host (graph traversal is irreducibly
pointer-chasing) and the training reuses the batched negative-sampling
step of nlp/embeddings.py on the model's device — the same [B]-indexed
scatter-add step Word2Vec uses, with vertex indices as the vocabulary.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch.graph.api import Graph
from deeplearning4j_tpu_torch.graph.walks import Node2VecWalkIterator


class Node2Vec:
    """``Node2Vec(p=1.0, q=1.0).fit(graph)`` -> vertex vectors.

    ``p``: return parameter (higher = less backtracking);
    ``q``: in-out parameter (<1 explores outward, >1 stays local).
    ``device``: None means the GPU (it raises with none); the CPU must be
    asked for with ``device="cpu"``.
    """

    def __init__(self, vector_size: int = 100, window: int = 5,
                 walk_length: int = 40, walks_per_vertex: int = 4,
                 p: float = 1.0, q: float = 1.0, negative: int = 5,
                 learning_rate: float = 0.025, epochs: int = 1,
                 batch_size: int = 512, seed: int = 12345, device=None):
        from deeplearning4j_tpu_torch.nn.model import resolve_device

        self.device = resolve_device(device)
        self.vector_size = vector_size
        self.window = window
        self.walk_length = walk_length
        self.walks_per_vertex = walks_per_vertex
        self.p = p
        self.q = q
        self.negative = negative
        self.learning_rate = learning_rate
        self.epochs = epochs
        self.batch_size = batch_size
        self.seed = seed
        self._sv = None
        self.num_vertices: Optional[int] = None

    def generate_walks(self, graph: Graph) -> List[np.ndarray]:
        walks = []
        for r in range(self.walks_per_vertex):
            it = Node2VecWalkIterator(graph, self.walk_length, p=self.p,
                                      q=self.q, seed=self.seed + r)
            walks.extend(list(it))
        return walks

    def fit(self, graph: Graph) -> "Node2Vec":
        from deeplearning4j_tpu_torch.nlp.embeddings import SequenceVectors

        self.num_vertices = graph.num_vertices()
        walks = self.generate_walks(graph)
        # vertex ids ARE the tokens
        seqs = [[str(int(v)) for v in w] for w in walks]
        self._sv = SequenceVectors(
            layer_size=self.vector_size, window=self.window,
            negative=self.negative, learning_rate=self.learning_rate,
            min_word_frequency=1, epochs=self.epochs,
            batch_size=self.batch_size, seed=self.seed, sample=0.0,
            device=self.device)
        self._sv.fit(seqs)
        return self

    # -- GraphVectors surface ----------------------------------------------
    def _fitted(self):
        if self._sv is None:
            raise RuntimeError("Node2Vec: call fit(graph) before querying vectors")
        return self._sv

    def get_vertex_vector(self, idx: int) -> Optional[np.ndarray]:
        return self._fitted().get_word_vector(str(int(idx)))

    def similarity(self, a: int, b: int) -> float:
        return self._fitted().similarity(str(int(a)), str(int(b)))

    def vertices_nearest(self, idx: int, top_n: int = 10) -> List[int]:
        return [int(w) for w in self._fitted().words_nearest(str(int(idx)), top_n)]
