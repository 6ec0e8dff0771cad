"""Parameter trees: nested tuples, lists and dicts of tensors.

The JAX package keeps params, layer state and optimizer state as pytrees
and walks them with ``jax.tree_util``. The port keeps the same structures
(a tuple of per-layer dicts, ``{"m": ..., "v": ...}`` updater state) and
walks them here. Leaf order is JAX's treedef order: sequences in order,
dict keys sorted at every level, ``None`` and empty containers holding no
leaf — the order the checkpoint zip stores its npz leaves in.
"""

from __future__ import annotations

from typing import Any, Callable, List

__all__ = ["assign_leaves", "tree_leaves", "tree_map", "tree_unflatten_like"]


def tree_leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in JAX treedef order."""
    out: List[Any] = []

    def visit(t):
        if t is None:
            return
        if isinstance(t, dict):
            for k in sorted(t):
                visit(t[k])
        elif isinstance(t, (tuple, list)):
            for x in t:
                visit(x)
        else:
            out.append(t)

    visit(tree)
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf over trees of one structure (the first
    tree's); containers are rebuilt with their own types."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x, *(r[i] for r in rest))
                          for i, x in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten_like(template, leaves: List[Any]):
    """A tree shaped like ``template`` whose leaves, in treedef order, are
    ``leaves``."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(template)


def _same_structure(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same_structure(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return isinstance(b, (tuple, list)) and len(a) == len(b) and all(
            _same_structure(x, y) for x, y in zip(a, b))
    return (a is None) == (b is None)


def assign_leaves(dst, src):
    """Write ``src``'s values into ``dst``'s tensors in place and return
    ``dst``; both trees must have one structure and every leaf pair one
    shape, dtype and device (a ``ValueError`` otherwise: a caller that
    creates the tree rebinds it itself). The port's step keeps the tensors
    it updates (the donation guard, ``analysis/donation_guard.py``):
    whoever else holds a leaf reads the new values."""
    import torch

    if dst is src:
        return dst
    if not _same_structure(dst, src):
        raise ValueError("assign_leaves: the trees differ in structure")
    with torch.no_grad():
        for a, b in zip(tree_leaves(dst), tree_leaves(src)):
            if not (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                    and a.shape == b.shape and a.dtype == b.dtype
                    and a.device == b.device):
                raise ValueError(
                    f"assign_leaves: a leaf {getattr(a, 'shape', a)} "
                    f"{getattr(a, 'dtype', '')} cannot take "
                    f"{getattr(b, 'shape', b)} {getattr(b, 'dtype', '')}")
            if a.data_ptr() != b.data_ptr() or a.stride() != b.stride():
                a.copy_(b)
    return dst
