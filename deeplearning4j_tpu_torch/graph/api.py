"""Graph API: vertices, edges, adjacency-list graph.

Reference surface: graph/api/Vertex.java, Edge.java, IGraph.java and
graph/graph/Graph.java (numVertices, addEdge, getConnectedVertexIndices,
getVertexDegree, directed/undirected).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Generic, List, Optional, Sequence, TypeVar

import numpy as np

V = TypeVar("V")


@dataclass(frozen=True)
class Vertex(Generic[V]):
    idx: int
    value: Optional[V] = None


@dataclass(frozen=True)
class Edge:
    from_idx: int
    to_idx: int
    weight: float = 1.0
    directed: bool = False


class Graph:
    """Adjacency-list graph (reference graph/Graph.java). ``directed=False``
    stores each edge in both endpoint lists."""

    def __init__(self, num_vertices: int, directed: bool = False,
                 values: Optional[Sequence] = None):
        if num_vertices <= 0:
            raise ValueError("num_vertices must be positive")
        self.directed = directed
        self._values = list(values) if values is not None else [None] * num_vertices
        if len(self._values) != num_vertices:
            raise ValueError("values length != num_vertices")
        self._adj: List[List[int]] = [[] for _ in range(num_vertices)]
        self._w: List[List[float]] = [[] for _ in range(num_vertices)]

    # -- construction ------------------------------------------------------
    def add_edge(self, from_idx: int, to_idx: int, weight: float = 1.0,
                 directed: Optional[bool] = None) -> None:
        d = self.directed if directed is None else directed
        self._adj[from_idx].append(to_idx)
        self._w[from_idx].append(float(weight))
        if not d and from_idx != to_idx:
            self._adj[to_idx].append(from_idx)
            self._w[to_idx].append(float(weight))

    # -- queries -----------------------------------------------------------
    def num_vertices(self) -> int:
        return len(self._adj)

    def get_vertex(self, idx: int) -> Vertex:
        return Vertex(idx, self._values[idx])

    def get_connected_vertex_indices(self, idx: int) -> List[int]:
        return list(self._adj[idx])

    def get_edge_weights(self, idx: int) -> List[float]:
        return list(self._w[idx])

    def get_vertex_degree(self, idx: int) -> int:
        return len(self._adj[idx])

    def degrees(self) -> np.ndarray:
        return np.array([len(a) for a in self._adj], np.int64)

    def get_random_connected_vertex(self, idx: int, rs: np.random.RandomState) -> int:
        if not self._adj[idx]:
            raise ValueError(f"vertex {idx} has no edges")
        return self._adj[idx][rs.randint(len(self._adj[idx]))]
