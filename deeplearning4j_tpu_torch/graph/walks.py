"""Random-walk iterators over a Graph.

Reference surface: graph/iterator/RandomWalkIterator.java (uniform next-hop)
and WeightedRandomWalkIterator.java (edge-weight-proportional next-hop),
with NoEdgeHandling SELF_LOOP_ON_DISCONNECTED | EXCEPTION_ON_DISCONNECTED.
Each ``next()`` yields one fixed-length walk of vertex indices; one epoch
visits every vertex as a start exactly once (shuffled order).
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from deeplearning4j_tpu_torch.graph.api import Graph

SELF_LOOP_ON_DISCONNECTED = "self_loop"
EXCEPTION_ON_DISCONNECTED = "exception"


class NoEdgesException(RuntimeError):
    pass


class RandomWalkIterator:
    """Uniform random walks of ``walk_length`` hops from every vertex."""

    def __init__(self, graph: Graph, walk_length: int, seed: int = 12345,
                 no_edge_handling: str = SELF_LOOP_ON_DISCONNECTED):
        self.graph = graph
        self.walk_length = int(walk_length)
        self.no_edge_handling = no_edge_handling
        self._rs = np.random.RandomState(seed)
        self.reset()

    def reset(self) -> None:
        self._order = self._rs.permutation(self.graph.num_vertices())
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < len(self._order)

    def _step(self, cur: int) -> int:
        nbrs = self.graph.get_connected_vertex_indices(cur)
        if not nbrs:
            if self.no_edge_handling == EXCEPTION_ON_DISCONNECTED:
                raise NoEdgesException(f"vertex {cur} is disconnected")
            return cur  # self loop
        return nbrs[self._rs.randint(len(nbrs))]

    def next(self) -> np.ndarray:
        """Walk of walk_length+1 vertex indices (start included)."""
        if not self.has_next():
            raise StopIteration
        cur = int(self._order[self._pos])
        self._pos += 1
        walk = np.empty(self.walk_length + 1, np.int64)
        walk[0] = cur
        for i in range(1, self.walk_length + 1):
            cur = self._step(cur)
            walk[i] = cur
        return walk

    def __iter__(self) -> Iterator[np.ndarray]:
        while self.has_next():
            yield self.next()


class Node2VecWalkIterator(RandomWalkIterator):
    """Second-order biased walks (node2vec; reference
    deeplearning4j-nlp-parent models/node2vec/Node2Vec.java uses these
    semantics): from edge (prev -> cur), the next hop x is drawn with
    unnormalized probability 1/p if x == prev (return), 1 if x is a
    neighbor of prev (BFS-ish), 1/q otherwise (DFS-ish)."""

    def __init__(self, graph: Graph, walk_length: int, p: float = 1.0,
                 q: float = 1.0, seed: int = 12345,
                 no_edge_handling: str = SELF_LOOP_ON_DISCONNECTED):
        self.p = float(p)
        self.q = float(q)
        super().__init__(graph, walk_length, seed, no_edge_handling)

    def _step2(self, cur: int, prev: int, prev_nbrs: Optional[frozenset]):
        """One biased hop. ``prev_nbrs``: prev's neighbor set, carried over
        from the previous step (cur's neighbors become next step's prev set —
        avoids re-fetching/copying adjacency twice per hop on hub vertices).
        Returns (next_vertex, cur_nbrs_set)."""
        nbrs = self.graph.get_connected_vertex_indices(cur)
        cur_set = frozenset(nbrs)
        if not nbrs:
            if self.no_edge_handling == EXCEPTION_ON_DISCONNECTED:
                raise NoEdgesException(f"vertex {cur} is disconnected")
            return cur, cur_set
        if prev < 0:
            return nbrs[self._rs.randint(len(nbrs))], cur_set
        w = np.empty(len(nbrs), np.float64)
        for i, x in enumerate(nbrs):
            if x == prev:
                w[i] = 1.0 / self.p
            elif x in prev_nbrs:
                w[i] = 1.0
            else:
                w[i] = 1.0 / self.q
        w /= w.sum()
        return int(nbrs[self._rs.choice(len(nbrs), p=w)]), cur_set

    def next(self) -> np.ndarray:
        if not self.has_next():
            raise StopIteration
        cur = int(self._order[self._pos])
        self._pos += 1
        walk = np.empty(self.walk_length + 1, np.int64)
        walk[0] = cur
        prev = -1
        prev_nbrs: Optional[frozenset] = None
        for i in range(1, self.walk_length + 1):
            nxt, cur_nbrs = self._step2(cur, prev, prev_nbrs)
            prev, cur, prev_nbrs = cur, nxt, cur_nbrs
            walk[i] = cur
        return walk


class WeightedRandomWalkIterator(RandomWalkIterator):
    """Next hop drawn proportional to edge weight
    (WeightedRandomWalkIterator.java)."""

    def _step(self, cur: int) -> int:
        nbrs = self.graph.get_connected_vertex_indices(cur)
        if not nbrs:
            if self.no_edge_handling == EXCEPTION_ON_DISCONNECTED:
                raise NoEdgesException(f"vertex {cur} is disconnected")
            return cur
        w = np.asarray(self.graph.get_edge_weights(cur), np.float64)
        tot = w.sum()
        if tot <= 0:
            return nbrs[self._rs.randint(len(nbrs))]
        return nbrs[self._rs.choice(len(nbrs), p=w / tot)]
