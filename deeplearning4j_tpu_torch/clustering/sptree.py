"""SpTree / QuadTree — Barnes-Hut space-partitioning trees (host-side).

A copy of the JAX package's ``clustering/sptree.py`` (host numpy only, so
the port keeps its own copy instead of importing that package).
Capability parity with the reference's clustering/sptree/SpTree.java:35 and
clustering/quadtree/QuadTree.java (the support structures behind
plot/BarnesHutTsne.java). Semantics follow the reference exactly:

- nodes summarise their subtree by center-of-mass + cumulative size;
- ``compute_non_edge_forces(i, theta)`` walks the tree and treats a cell as
  a summary when ``max_width / sqrt(D) < theta`` (SpTree.java:210-237),
  accumulating the Student-t repulsive force and the Q normaliser;
- ``compute_edge_forces(row_p, col_p, val_p)`` accumulates the attractive
  force over the sparse P matrix in CSR form (SpTree.java:252-271).

These are pointer trees, so they live on the host (numpy): the point of
Barnes-Hut is to prune work. The port's t-SNE (`clustering/tsne.py`) keeps
the exact dense gradient on the device as its default, and
`BarnesHutTsne(method="barnes_hut")` runs this tree when the O(n^2) dense
form cannot fit.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


class Cell:
    """Axis-aligned cell: corner (center) + half-width per dimension
    (reference sptree/Cell.java)."""

    __slots__ = ("corner", "width")

    def __init__(self, corner: np.ndarray, width: np.ndarray):
        self.corner = np.asarray(corner, np.float64)
        self.width = np.asarray(width, np.float64)

    def contains_point(self, point: np.ndarray) -> bool:
        return bool(np.all(np.abs(self.corner - point) <= self.width + 1e-12))


class SpTree:
    """n-dimensional Barnes-Hut tree over a fixed [n, d] data matrix.

    Construction inserts every row; each node keeps at most one point
    (QT_NODE_CAPACITY=1, duplicates stack on the same leaf like the
    reference's duplicate check, SpTree.java insert path).
    """

    def __init__(self, data, corner: Optional[np.ndarray] = None,
                 width: Optional[np.ndarray] = None, _root: bool = True):
        data = np.asarray(data, np.float64)
        self.data = data
        self.d = data.shape[1]
        self.n_children = 2 ** self.d
        if _root:
            mean = data.mean(axis=0)
            half = np.maximum(
                data.max(axis=0) - mean, mean - data.min(axis=0)) + 1e-5
            corner, width = mean, half
        self.boundary = Cell(corner, width)
        self.center_of_mass = np.zeros(self.d)
        self.cum_size = 0
        self.size = 0
        self.index: List[int] = []
        self.children: List[Optional["SpTree"]] = [None] * self.n_children
        self._is_leaf = True
        if _root:
            for i in range(data.shape[0]):
                self.insert(i)

    # -- construction -----------------------------------------------------

    def is_leaf(self) -> bool:
        return self._is_leaf

    def insert(self, i: int) -> bool:
        point = self.data[i]
        if not self.boundary.contains_point(point):
            return False
        # online center-of-mass update
        self.cum_size += 1
        mult1 = (self.cum_size - 1) / self.cum_size
        self.center_of_mass = self.center_of_mass * mult1 + point / self.cum_size
        if self._is_leaf and self.size == 0:
            self.index.append(i)
            self.size = 1
            return True
        if self._is_leaf:
            # duplicate point: stack on this leaf (reference duplicate check).
            # Near-duplicates also stack once the cell is already tiny —
            # subdividing below the contains_point tolerance would recurse
            # forever (points closer than ~1e-12 but not bit-identical).
            if (np.all(self.data[self.index[0]] == point)
                    or self.boundary.width.max() < 1e-10):
                self.index.append(i)
                self.size += 1
                return True
            self.subdivide()
        for child in self.children:
            if child.insert(i):
                return True
        raise AssertionError("point fell through all children")  # pragma: no cover

    def subdivide(self) -> None:
        """Split into 2^d children and push the stored point(s) down
        (SpTree.java:168-208)."""
        half = self.boundary.width / 2.0
        for c in range(self.n_children):
            offs = np.array([(1 if (c >> bit) & 1 else -1)
                             for bit in range(self.d)], np.float64)
            corner = self.boundary.corner + offs * half
            self.children[c] = SpTree(self.data, corner, half, _root=False)
        self._is_leaf = False
        old, self.size = self.index, 0
        self.index = []
        for i in old:
            for child in self.children:
                if child.insert(i):
                    break

    def depth(self) -> int:
        if self._is_leaf:
            return 1
        return 1 + max(c.depth() for c in self.children if c is not None)

    # -- Barnes-Hut forces -------------------------------------------------

    def compute_non_edge_forces(self, point_index: int, theta: float,
                                ) -> Tuple[np.ndarray, float]:
        """Repulsive force on one point: returns (negative_force [d], sum_q).
        Iterative traversal of the reference's recursion (SpTree.java:210)."""
        point = self.data[point_index]
        neg = np.zeros(self.d)
        sum_q = 0.0
        stack = [self]
        while stack:
            node = stack.pop()
            if node.cum_size == 0 or (
                    node._is_leaf and node.size == 1
                    and node.index[0] == point_index):
                continue
            buf = point - node.center_of_mass
            dist2 = float(buf @ buf)
            max_width = float(node.boundary.width.max())
            if node._is_leaf or max_width / max(np.sqrt(dist2), 1e-12) < theta:
                # self-interaction inside a stacked-duplicate leaf: the
                # reference includes it; so do we (exact only for size==1)
                q = 1.0 / (1.0 + dist2)
                mult = node.cum_size * q
                sum_q += mult
                neg += buf * (mult * q)
            else:
                stack.extend(c for c in node.children if c is not None)
        return neg, sum_q

    def compute_edge_forces(self, row_p, col_p, val_p) -> np.ndarray:
        """Attractive forces over sparse P (CSR): returns pos_f [n, d]
        (SpTree.java:252-271) — vectorized over all edges at once."""
        row_p = np.asarray(row_p, np.int64)
        col_p = np.asarray(col_p, np.int64)
        val_p = np.asarray(val_p, np.float64)
        n = row_p.size - 1
        counts = np.diff(row_p)
        src = np.repeat(np.arange(n), counts)
        diff = self.data[src] - self.data[col_p]            # [nnz, d]
        # Student-t attraction p_ij/(1+d2) — the reference divides by
        # (1e-12 + d2) (SpTree.java:262-263), a deviation from the BH-tSNE
        # paper/implementation it is based on; we keep the correct kernel
        d2 = 1.0 + np.sum(diff * diff, axis=1)
        w = (val_p / d2)[:, None] * diff
        pos_f = np.zeros((n, self.d))
        np.add.at(pos_f, src, w)
        return pos_f


class QuadTree(SpTree):
    """2-D specialisation (reference clustering/quadtree/QuadTree.java).
    The reference hard-codes QT_NO_DIMS=2; this class asserts it and exposes
    the compass-named children."""

    def __init__(self, data):
        data = np.asarray(data, np.float64)
        if data.shape[1] != 2:
            raise ValueError(f"QuadTree is 2-D only, got d={data.shape[1]}")
        super().__init__(data)

    def _compass(self, idx: int) -> Optional[SpTree]:
        return self.children[idx] if not self._is_leaf else None

    @property
    def north_west(self):  # (-x, +y)
        return self._compass(0b10)

    @property
    def north_east(self):  # (+x, +y)
        return self._compass(0b11)

    @property
    def south_west(self):  # (-x, -y)
        return self._compass(0b00)

    @property
    def south_east(self):  # (+x, -y)
        return self._compass(0b01)


def barnes_hut_gradient(y: np.ndarray, row_p, col_p, val_p,
                        theta: float = 0.5) -> np.ndarray:
    """One t-SNE gradient via Barnes-Hut: 4*(attr - rep/sum_q), the exact
    combination BarnesHutTsne.java computes from the two force passes."""
    y = np.asarray(y, np.float64)
    tree = SpTree(y)
    pos_f = tree.compute_edge_forces(row_p, col_p, val_p)
    neg_f = np.zeros_like(y)
    sum_q = 0.0
    for i in range(y.shape[0]):
        f, q = tree.compute_non_edge_forces(i, theta)
        neg_f[i] = f
        sum_q += q
    return 4.0 * (pos_f - neg_f / max(sum_q, 1e-12))
