"""Edge-list file loading (reference graph/data/GraphLoader.java)."""

from __future__ import annotations

from typing import Optional

from deeplearning4j_tpu_torch.graph.api import Graph


class GraphLoader:
    @staticmethod
    def load_undirected_graph_edge_list_file(path: str, num_vertices: int,
                                             delim: Optional[str] = None) -> Graph:
        """Each line: ``from<delim>to[<delim>weight]``. Blank lines and lines
        starting with '#' are skipped (GraphLoader.loadUndirectedGraphEdgeListFile)."""
        g = Graph(num_vertices, directed=False)
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split(delim) if delim else line.split()
                a, b = int(parts[0]), int(parts[1])
                w = float(parts[2]) if len(parts) > 2 else 1.0
                g.add_edge(a, b, w)
        return g

    @staticmethod
    def load_directed_graph_edge_list_file(path: str, num_vertices: int,
                                           delim: Optional[str] = None) -> Graph:
        g = Graph(num_vertices, directed=True)
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split(delim) if delim else line.split()
                a, b = int(parts[0]), int(parts[1])
                w = float(parts[2]) if len(parts) > 2 else 1.0
                g.add_edge(a, b, w)
        return g
