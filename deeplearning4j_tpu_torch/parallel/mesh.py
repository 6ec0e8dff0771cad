"""The process mesh (the PyTorch port of ``parallel/mesh.py``).

The JAX package lays its devices out as a ``data x model x seq x pipe``
grid (``jax.sharding.Mesh``) and lets GSPMD place every array. The port
runs one process per card (SPMD over ``torch.distributed``): a
:class:`Mesh` lays the ranks of the default process group out in the same
grid, in ``np.reshape`` order as the JAX package reshapes
``jax.devices()``, and gives each axis the sub-group of the ranks that
share this rank's other coordinates, for the collectives along it.

:meth:`Mesh.sub` gives the sub-group over one axis or several (``("data",
"seq")`` for the gradient all-reduce under tensor parallelism, ``("data",
"pipe")`` for the sharded weight update), created together with the
single-axis ones because ``dist.new_group`` is a collective call.
"""

from __future__ import annotations

import datetime
import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["AXES", "Mesh", "MeshSpec", "SubGroup", "data_axis_size", "make_mesh",
           "timed_group"]

AXES = ("data", "model", "seq", "pipe")


@dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape. -1 on ``data`` means 'all remaining ranks'.

    Axes: ``data`` (dp), ``model`` (tp, and ep: expert weights shard their
    expert axis here), ``seq`` (sp, ring attention), ``pipe`` (pp)."""

    data: int = -1
    model: int = 1
    seq: int = 1
    pipe: int = 1

    def resolve(self, n_devices: int) -> Tuple[int, int, int, int]:
        d, m, s, p = self.data, self.model, self.seq, self.pipe
        fixed = max(m, 1) * max(s, 1) * max(p, 1)
        if d == -1:
            d = n_devices // fixed
        if d * m * s * p != n_devices:
            raise ValueError(
                f"MeshSpec {d}x{m}x{s}x{p} does not cover {n_devices} devices")
        return d, m, s, p


class Mesh:
    """The ranks of the default process group as a ``data x model x seq x
    pipe`` grid, seen from this rank.

    ``shape`` maps each axis to its size, ``devices`` is the grid of global
    ranks, ``coords`` this rank's index on each axis, ``device`` the torch
    device this rank computes on. :meth:`group` is the sub-group along an
    axis (None where the axis has size 1 or there is no process group),
    :meth:`axis_ranks` its global ranks in axis order."""

    axis_names = AXES

    def __init__(self, grid: np.ndarray, rank: int, device: torch.device,
                 groups: Dict[str, object]):
        self.devices = grid
        self.rank = rank
        self.device = device
        self.shape = dict(zip(AXES, (int(n) for n in grid.shape)))
        self.coords = dict(zip(AXES, (int(c) for c in np.argwhere(grid == rank)[0])))
        self._groups = groups

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_index(self, axis: str) -> int:
        return self.coords[axis]

    def axis_ranks(self, axis: str) -> List[int]:
        """The global ranks along ``axis`` through this rank, in axis order."""
        idx = [self.coords[a] for a in AXES]
        idx[AXES.index(axis)] = slice(None)
        return [int(r) for r in self.devices[tuple(idx)]]

    def group(self, axis: str):
        return self._groups.get((axis,))

    def sub(self, axes) -> "SubGroup":
        """The ranks that share this rank's coordinates on every axis but
        ``axes`` (one axis name or a tuple of them), in grid order, with
        their process group (None when they are this rank alone)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = [slice(None) if a in axes else self.coords[a] for a in AXES]
        ranks = [int(r) for r in np.ravel(self.devices[tuple(idx)])]
        key = tuple(a for a in AXES if a in axes and self.shape[a] > 1)
        group = self._groups.get(key) if len(ranks) > 1 else None
        return SubGroup(group, ranks, ranks.index(self.rank))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, device={self.device})"


@dataclass(frozen=True)
class SubGroup:
    """A set of ranks for a collective (``Mesh.sub``): the process group
    (None for a set of one), the global ranks in order and this rank's
    index among them."""

    group: object
    ranks: Tuple[int, ...]
    index: int

    def __init__(self, group, ranks, index):
        object.__setattr__(self, "group", group)
        object.__setattr__(self, "ranks", tuple(ranks))
        object.__setattr__(self, "index", int(index))

    @property
    def size(self) -> int:
        return len(self.ranks)


def make_mesh(spec: Optional[MeshSpec] = None, device=None) -> Mesh:
    """The mesh over the ranks of the default process group (one rank and
    no group when ``torch.distributed`` is not initialised: a 1x1x1x1 mesh
    over this process's card). ``device``: where this rank computes; by
    default the device :func:`~deeplearning4j_tpu_torch.parallel.distributed.init_distributed`
    chose, else the GPU (raising when there is none). Every rank must call
    this with the same spec: it creates the axes' sub-groups, which is a
    collective call."""
    from deeplearning4j_tpu_torch.parallel import distributed

    spec = spec or MeshSpec()
    initialised = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialised else 1
    rank = dist.get_rank() if initialised else 0
    d, m, s, p = spec.resolve(world)
    grid = np.arange(world).reshape(d, m, s, p)
    groups: Dict[Tuple[str, ...], object] = {}
    if initialised:
        # every rank creates every sub-group, in one order (new_group is
        # collective): one per non-empty set of axes longer than 1
        live = [a for a, n in zip(AXES, grid.shape) if n > 1]
        for k in range(1, len(live) + 1):
            for axes in itertools.combinations(live, k):
                if len(axes) == len(live):
                    groups[axes] = dist.group.WORLD
                    continue
                cut = [AXES.index(a) for a in axes]
                others = [range(n) if i not in cut else [slice(None)]
                          for i, n in enumerate(grid.shape)]
                for idx in itertools.product(*others):
                    ranks = [int(r) for r in np.ravel(grid[tuple(idx)])]
                    g = dist.new_group(ranks)
                    if rank in ranks:
                        groups[axes] = g
    return Mesh(grid, rank, distributed.default_device(device), groups)


def data_axis_size(mesh: Mesh) -> int:
    """Replica count of the data-parallel exchange (the ``data`` axis)."""
    return mesh.shape["data"]


def timed_group(timeout_s: float, backend: str = "gloo") -> SubGroup:
    """Every rank of the default process group on a group of its own whose
    collectives time out after ``timeout_s`` (an elastic slice's, whose
    rendezvous waited longer); the whole group alone without one. A
    collective call: every rank makes it."""
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return SubGroup(None, [0], 0)
    world = dist.get_world_size()
    group = dist.new_group(list(range(world)), backend=backend,
                           timeout=datetime.timedelta(seconds=float(timeout_s)))
    return SubGroup(group, range(world), dist.get_rank())
