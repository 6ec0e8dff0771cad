"""The active mesh (the PyTorch port of ``parallel/context.py``).

Layers that can use a mesh axis (ring attention over ``seq``, the
positional embedding's offset under a sharded time axis, the
tensor-parallel products over ``model``, BatchNorm's statistics over
``data x seq``) look the mesh up here instead of threading it through
every ``apply`` signature.
``use_mesh`` is re-entrant: it sets a module-level variable and restores
the previous one on exit.
"""

from __future__ import annotations

import contextlib
from typing import Optional

_ACTIVE_MESH = None


def current_mesh():
    """The mesh of the innermost active :func:`use_mesh`, or None."""
    return _ACTIVE_MESH


@contextlib.contextmanager
def use_mesh(mesh):
    """Publish ``mesh`` (a :class:`~deeplearning4j_tpu_torch.parallel.mesh.Mesh`
    or None) to the layers for the duration of the block."""
    global _ACTIVE_MESH
    prev = _ACTIVE_MESH
    _ACTIVE_MESH = mesh
    try:
        yield mesh
    finally:
        _ACTIVE_MESH = prev


def mesh_axis_size(axis: str, mesh: Optional[object] = None) -> int:
    """The size of ``axis`` in ``mesh`` (default: the active mesh); 1 when
    there is no mesh."""
    mesh = current_mesh() if mesh is None else mesh
    return 1 if mesh is None else int(mesh.shape.get(axis, 1))


def mesh_sub(axes):
    """The active mesh's sub-group over ``axes`` (``Mesh.sub``), or None
    when there is no mesh or the group is this rank alone. Layers ask for
    ``"model"`` (tensor parallelism) and ``("data", "seq")`` (BatchNorm's
    batch statistics over the global batch)."""
    mesh = current_mesh()
    if mesh is None:
        return None
    sub = mesh.sub(axes)
    return sub if sub.size > 1 else None
