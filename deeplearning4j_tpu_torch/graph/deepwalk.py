"""DeepWalk graph embeddings on PyTorch (the port of the JAX package's
``graph/deepwalk.py``).

Reference: graph/models/deepwalk/DeepWalk.java (initialize(graph) builds a
Huffman tree over vertex degrees via GraphHuffman.java, fit(graph,
walk_length) trains skip-gram hierarchical softmax over random-walk
windows). Walk windows are batched into (center, huffman path) index
arrays and updated by the same HS step the word2vec stack uses
(nlp/embeddings._sg_hs_step) — one gather/einsum/scatter step per batch on
the model's device instead of per-pair Java threads. Walk vertices are
checked on the host before they are uploaded.
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.graph.api import Graph
from deeplearning4j_tpu_torch.graph.walks import RandomWalkIterator
from deeplearning4j_tpu_torch.nlp.embeddings import (
    _cosine,
    _f32,
    _ids,
    _nearest,
    _sg_hs_step,
    _to_device,
)


class GraphHuffman:
    """Huffman coding of vertices by degree (GraphHuffman.java): frequent
    (high-degree) vertices get short codes. Produces padded [V, L] code /
    inner-node-index / mask tables for the batched HS step."""

    def __init__(self, counts: np.ndarray, max_code_length: int = 64):
        counts = np.asarray(counts, np.int64)
        n = len(counts)
        # standard two-queue-free heap Huffman over (count, tiebreak, node)
        heap: List[Tuple[int, int, int]] = [(int(c), i, i) for i, c in enumerate(counts)]
        heapq.heapify(heap)
        parent = np.full(2 * n - 1, -1, np.int64)
        binary = np.zeros(2 * n - 1, np.int8)
        nxt = n
        while len(heap) > 1:
            c1, _, n1 = heapq.heappop(heap)
            c2, _, n2 = heapq.heappop(heap)
            parent[n1] = nxt
            parent[n2] = nxt
            binary[n2] = 1
            heapq.heappush(heap, (c1 + c2, nxt, nxt))
            nxt += 1
        root = 2 * n - 2
        codes = np.zeros((n, max_code_length), np.float32)
        points = np.zeros((n, max_code_length), np.int32)
        mask = np.zeros((n, max_code_length), np.float32)
        self.code_lengths = np.zeros(n, np.int32)
        for v in range(n):
            path_bits: List[int] = []
            path_nodes: List[int] = []
            node = v
            while parent[node] != -1:
                path_bits.append(int(binary[node]))
                path_nodes.append(int(parent[node]) - n)  # inner node id
                node = parent[node]
            path_bits.reverse()
            path_nodes.reverse()
            L = min(len(path_bits), max_code_length)
            self.code_lengths[v] = L
            codes[v, :L] = path_bits[:L]
            points[v, :L] = path_nodes[:L]
            mask[v, :L] = 1.0
        self.codes, self.points, self.mask = codes, points, mask
        self.num_inner = max(n - 1, 1)

    def get_code_length(self, vertex: int) -> int:
        return int(self.code_lengths[vertex])


class DeepWalk:
    """``DeepWalk(vector_size=100, window_size=5, learning_rate=0.025)``;
    ``initialize(graph)`` then ``fit(graph, walk_length)``
    (DeepWalk.java:67,95). GraphVectors surface: ``get_vertex_vector``,
    ``similarity``, ``vertices_nearest``. ``device``: None means the GPU
    (it raises with none); the CPU must be asked for with ``device="cpu"``."""

    def __init__(self, vector_size: int = 100, window_size: int = 5,
                 learning_rate: float = 0.025, batch_size: int = 512,
                 seed: int = 12345, device=None):
        from deeplearning4j_tpu_torch.nn.model import resolve_device

        self.vector_size = vector_size
        self.window_size = window_size
        self.learning_rate = learning_rate
        self.batch_size = batch_size
        self.seed = seed
        self.device = resolve_device(device)
        self.huffman: Optional[GraphHuffman] = None
        self.params: Optional[dict] = None
        self._rs = np.random.RandomState(seed)

    # -- init --------------------------------------------------------------
    def initialize(self, graph_or_degrees) -> "DeepWalk":
        degrees = (
            graph_or_degrees.degrees()
            if isinstance(graph_or_degrees, Graph)
            else np.asarray(graph_or_degrees, np.int64)
        )
        n = len(degrees)
        self.huffman = GraphHuffman(np.maximum(degrees, 1))
        rs = np.random.RandomState(self.seed)
        init = {
            "syn0": (rs.rand(n, self.vector_size).astype(np.float32) - 0.5)
            / self.vector_size,
            "syn1": np.zeros((self.huffman.num_inner, self.vector_size), np.float32),
        }
        self.params = {k: _to_device(v, self.device) for k, v in init.items()}
        return self

    # -- training ----------------------------------------------------------
    def _pairs_from_walk(self, walk: np.ndarray):
        w = self.window_size
        for i, center in enumerate(walk):
            lo, hi = max(0, i - w), min(len(walk), i + w + 1)
            for j in range(lo, hi):
                if j != i:
                    yield int(center), int(walk[j])

    def fit(self, graph_or_iterator, walk_length: int = 40,
            epochs: int = 1) -> "DeepWalk":
        if isinstance(graph_or_iterator, Graph):
            if self.params is None:
                self.initialize(graph_or_iterator)
            n_vertices = graph_or_iterator.num_vertices()
            make_it = lambda ep: RandomWalkIterator(
                graph_or_iterator, walk_length, seed=self.seed + ep
            )
        else:
            if self.params is None:
                raise RuntimeError("call initialize(graph) before fit(iterator)")
            n_vertices = self.num_vertices()
            # Multi-epoch support: walk iterators expose reset() (and need
            # it — RandomWalkIterator.__iter__ shares cursor state, so it
            # yields nothing on a second pass); plain sequences (lists of
            # walks) re-iterate naturally; a bare single-use iterator
            # (iter(x) is x, e.g. a generator) would silently train on
            # nothing after epoch 1, so reject it up front.
            has_reset = hasattr(graph_or_iterator, "reset")
            if (epochs > 1 and not has_reset
                    and iter(graph_or_iterator) is graph_or_iterator):
                raise ValueError(
                    "epochs>1 with a single-use iterator would silently train "
                    "on nothing after epoch 1; pass a Graph, a sequence of "
                    "walks, or an iterator with reset()"
                )

            def make_it(ep):
                if ep > 0 and has_reset:
                    graph_or_iterator.reset()
                return graph_or_iterator
        dev = self.device
        codes = _to_device(self.huffman.codes, dev)
        points = _to_device(self.huffman.points, dev, torch.int64)
        hmask = _to_device(self.huffman.mask, dev)
        # word2vec-style linear lr decay over the expected pair count; a
        # batched scatter-add applies MANY same-vertex updates at once, so a
        # constant lr diverges on small dense graphs
        total_pairs = max(
            epochs * n_vertices * (walk_length + 1) * 2 * self.window_size, 1
        )
        seen = 0
        for ep in range(epochs):
            buf_c: List[int] = []
            buf_t: List[int] = []
            for walk in make_it(ep):
                for c, t in self._pairs_from_walk(walk):
                    buf_c.append(c)
                    buf_t.append(t)
                    if len(buf_c) == self.batch_size:
                        seen += len(buf_c)
                        self._apply(buf_c, buf_t, codes, points, hmask,
                                    self._lr_at(seen, total_pairs))
                        buf_c, buf_t = [], []
            if buf_c:
                seen += len(buf_c)
                self._apply(buf_c, buf_t, codes, points, hmask,
                            self._lr_at(seen, total_pairs))
        return self

    def _lr_at(self, seen: int, total: int) -> float:
        frac = min(seen / total, 1.0)
        return max(self.learning_rate * (1.0 - frac), self.learning_rate * 1e-2)

    def _apply(self, centers, targets, codes, points, hmask, lr):
        n, dev = self.num_vertices(), self.device
        c = _ids(np.asarray(centers, np.int64), n, dev, "walk vertices")
        t = _ids(np.asarray(targets, np.int64), n, dev, "walk vertices")
        self.params, _ = _sg_hs_step(
            self.params, c, codes[t], points[t], hmask[t], _f32(lr))

    # -- GraphVectors surface ---------------------------------------------
    @property
    def syn0(self) -> np.ndarray:
        """The whole [V, D] table on the host (a copy from the device)."""
        return self.params["syn0"].cpu().numpy()

    def get_vertex_vector(self, idx: int) -> np.ndarray:
        """The vertex's row, copied alone from the device."""
        return self.params["syn0"][idx].cpu().numpy()

    def num_vertices(self) -> int:
        return self.params["syn0"].shape[0]

    def similarity(self, a: int, b: int) -> float:
        return _cosine(self.get_vertex_vector(a), self.get_vertex_vector(b))

    def vertices_nearest(self, idx: int, top_n: int = 10) -> List[int]:
        """Cosine-nearest vertices: one product and a top-k on the model's
        device."""
        m = self.params["syn0"]
        order = [i for i in _nearest(m, m[idx], top_n + 1) if i != idx]
        return order[:top_n]
