"""The named-mesh trainer (the PyTorch port of ``parallel/mesh_step.py``):
training on a ``data x model x pipe`` mesh.

- ``data``: the global batch's rows are cut over it;
- ``model``: tensor parallelism by the rules of ``parallel/tp.py`` (the
  params' shards placed by :class:`~deeplearning4j_tpu_torch.parallel.tp.ShardedTrainer`,
  the collectives in the layers);
- ``pipe``: as in the JAX package's mesh step, the stage axis carries the
  sharded weight update (arXiv 2004.13336): the updater state and the
  update math of every param (of its tensor-parallel shard) are cut over
  every spare axis, ``data x pipe``: gradients reduce-scattered, 1/(d·s)
  of each flat param updated per rank, the params all-gathered
  (``parallel/grads.py`` in sharded mode over those axes). Pipelined stage
  compute is ``parallel/gpipe.py``.

With no spec the shape comes from the ``DL4J_TPU_MESH_*`` knobs
(``nn/step_program.py`` ``mesh_shape_from_env``), after the tuning DB's
winner for the model is applied when ``DL4J_TPU_TUNE`` is set
(``tune.maybe_apply(model, "fit")``, as in the JAX package).
``compress=True`` takes the compressed exchange, on a pure data
mesh only, as in the JAX package. :meth:`MeshTrainer.finish` leaves the
layout: the model's params and updater state are whole again.

:class:`MeshSlice` (one elastic member of several ranks, the
elastic-of-slices composition) and :func:`shard_update_spec` (the JAX
package's spec arithmetic for the sharded update, on tuples) come along.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.parallel.context import use_mesh
from deeplearning4j_tpu_torch.parallel.distributed import global_array, process_count
from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, make_mesh, timed_group

__all__ = ["MeshSlice", "MeshTrainer", "shard_update_spec"]


class MeshSlice:
    """One elastic member of ``d·t·s`` ranks (the elastic-of-slices
    composition of ``train/elastic.py``; ``spec``: ``"d[,t[,s]]"``).

    In the JAX package a member is one process whose vshard backward runs
    GSPMD-sharded over a ``(d, t, s)`` device mesh. The port runs one
    process per rank, so a member is a group of processes: the default
    process group holds exactly the member's ``d·t·s`` ranks (the elastic
    launcher forms it through ``file://<outdir>/slice_<wid>_<incarnation>/
    store``, one store per incarnation), laid out as a ``data x model x
    pipe`` mesh. Rank 0 is the member's leader. The helpers keep the JAX
    semantics: rows are cut over ``data`` (:meth:`round_rows`,
    :meth:`rows`, :meth:`shard_batch`), params and state are replicated
    (:meth:`replicate`), and ``t`` and ``s`` replicate the compute.

    The member's own collectives (:meth:`broadcast`,
    :meth:`sum_to_leader`) run over gloo, on the CPU and on the card (NCCL
    refuses two ranks on one device; CUDA tensors go through host memory
    where gloo takes none, ``parallel/comm.py``), on a group whose timeout
    is ``timeout_s``, so that a rank that hangs ends its member instead of
    stalling it. A broadcast with ``wait=True`` runs on a second group
    whose timeout is ``wait_s``: a follower's wait for its leader's next
    word, which may follow a long wait of the leader's on the other
    members. A spec of one rank needs no process group.

    Bit-exactness of elastic runs holds across member COUNT at a fixed
    spec: the ranks' parts are summed in ``data``-coordinate order.
    """

    def __init__(self, spec, device=None, *, timeout_s: float = 300.0,
                 wait_s: Optional[float] = None):
        d, t, s = self.parse_spec(spec)
        self.spec = MeshSpec(data=d, model=t, pipe=s)
        self.size = d * t * s
        if self.size > 1 and process_count() != self.size:
            raise ValueError(
                f"slice spec {spec!r} is a member of {self.size} ranks: it needs a "
                f"process group of exactly those ranks (this process is in one of "
                f"{process_count()}); start the member through the elastic launcher "
                f"(--mesh {spec} --slice-devices {self.size}) or join its ranks with "
                f"parallel.init_distributed(..., backend='gloo') first")
        self.mesh = make_mesh(self.spec, device=device)
        self.data = int(self.mesh.shape["data"])
        self.rank = int(self.mesh.rank)
        self.leader = self.rank == 0
        # the ranks whose rows differ, one per data coordinate, in order
        self.data_ranks = [int(r) for r in self.mesh.devices[:, 0, 0, 0]]
        self.group = timed_group(timeout_s, backend="gloo")
        self.wait_group = timed_group(timeout_s if wait_s is None else wait_s,
                                      backend="gloo")

    @staticmethod
    def parse_spec(spec) -> Tuple[int, int, int]:
        if isinstance(spec, (tuple, list)):
            parts = [int(v) for v in spec]
        else:
            parts = [int(v) for v in str(spec).split(",") if v.strip()]
        if not parts or len(parts) > 3 or any(v < 1 for v in parts):
            raise ValueError(f"slice spec {spec!r}: want 1-3 positive ints 'd[,t[,s]]'")
        return tuple(parts + [1] * (3 - len(parts)))  # type: ignore

    @classmethod
    def ranks_of(cls, spec) -> int:
        """The rank count ``d·t·s`` of a spec (1 for None or empty)."""
        if not spec:
            return 1
        return int(np.prod(cls.parse_spec(spec)))

    def round_rows(self, rows: int) -> int:
        """The smallest multiple of the data axis at or above ``rows``."""
        return -(-int(rows) // self.data) * self.data

    def rows(self, rows: int) -> Tuple[int, int]:
        """This rank's contiguous rows ``[lo, hi)`` of a ``rows``-row batch
        (a multiple of the data axis), as GSPMD cuts a batch over ``data``."""
        rows = int(rows)
        if rows % self.data:
            raise ValueError(f"{rows} rows do not divide over the data axis ({self.data})")
        part = rows // self.data
        i = self.mesh.coords["data"]
        return i * part, (i + 1) * part

    def shard_batch(self, arr):
        """This rank's rows of a batch (cut over ``data``)."""
        if arr is None:
            return None
        lo, hi = self.rows(arr.shape[0])
        return arr[lo:hi]

    def replicate(self, tree):
        """Every tensor leaf of ``tree`` set to the leader's values, in place
        (a collective of the member). Returns ``tree``."""
        from deeplearning4j_tpu_torch.parallel import comm
        from deeplearning4j_tpu_torch.utils.tree import tree_leaves

        if self.size > 1:
            with torch.no_grad():
                for t in tree_leaves(tree):
                    if isinstance(t, torch.Tensor):
                        comm.broadcast(t, 0, self.group)
        return tree

    def broadcast(self, t: torch.Tensor, wait: bool = False) -> torch.Tensor:
        """``t`` from the leader, in place; with ``wait`` over the group
        whose timeout is ``wait_s``."""
        from deeplearning4j_tpu_torch.parallel import comm

        return comm.broadcast(t, 0, self.wait_group if wait else self.group)

    def sum_to_leader(self, part: torch.Tensor) -> Optional[np.ndarray]:
        """The ranks' 1-D f32 ``part`` s gathered to the leader and summed
        there in f32 on the host, in ``data``-coordinate order (the ``t``
        and ``s`` replicas' parts are the same rows' and are left out).
        Returns the sum on the leader, None on the other ranks."""
        from deeplearning4j_tpu_torch.parallel import comm

        host = part.detach().to(device="cpu", dtype=torch.float32)
        parts = comm.gather(host, 0, self.group)
        if parts is None:
            return None
        total = parts[self.data_ranks[0]].numpy().copy()
        for r in self.data_ranks[1:]:
            total += parts[r].numpy()
        return total

    def run(self, fn, *args, **kwargs):
        """Call ``fn`` under this slice's mesh."""
        with use_mesh(self.mesh):
            return fn(*args, **kwargs)


def shard_update_spec(spec, shape, mesh, axes=("data", "pipe")):
    """Extend a TP spec (a tuple, ``()`` for replicated) with the sharded
    update of arXiv 2004.13336: the first dimension the TP rules left
    unsharded whose size the spare axes divide shards over them, jointly
    when possible (``(("data", "pipe"), None)``), else over each alone;
    otherwise the spec stays as it was."""
    spec = tuple(spec)
    if not shape:
        return spec
    dims = list(spec) + [None] * (len(shape) - len(spec))
    live = [a for a in axes if mesh.shape.get(a, 1) > 1]
    for combo in (tuple(live),) + tuple((a,) for a in live):
        if not combo:
            continue
        n = int(np.prod([mesh.shape[a] for a in combo]))
        if n <= 1:
            continue
        for i, d in enumerate(dims):
            if d is None and shape[i] % n == 0 and shape[i] >= n:
                dims[i] = combo if len(combo) > 1 else combo[0]
                return tuple(dims)
    return spec


class MeshTrainer:
    """Train a MultiLayerNetwork on a ``data x model x pipe`` mesh (see the
    module docstring). ``device``: where this rank computes (by default the
    device ``init_distributed`` chose, else the GPU)."""

    def __init__(self, model, spec: Optional[MeshSpec] = None, *, device=None,
                 compress: bool = False):
        from deeplearning4j_tpu_torch.nn.step_program import mesh_shape_from_env
        from deeplearning4j_tpu_torch.parallel.grads import DataParallelStep
        from deeplearning4j_tpu_torch.parallel.tp import ShardedTrainer

        self.model = model
        if spec is None:
            if os.environ.get("DL4J_TPU_TUNE"):
                # the DB's winner lands before the mesh knobs are read
                from deeplearning4j_tpu_torch import tune

                tune.maybe_apply(model, "fit")
            d, t, s = mesh_shape_from_env(process_count())
            spec = MeshSpec(data=d, model=t, pipe=s)
        self.spec = spec
        self.mesh = make_mesh(spec, device=device if device is not None else model.device)
        self.shape = tuple(spec.resolve(self.mesh.size))   # (d, t, s_seq, p)
        if model.params is None:
            model.init()
        d, t, _, p = self.shape
        if compress and (t > 1 or p > 1):
            raise ValueError(
                "compressed exchange needs a pure data mesh (t=s=1): the packed wire "
                f"format has no tensor/stage decomposition — got (d={d}, t={t}, s={p})")
        # the params' tensor-parallel shards (every param whole when t = 1)
        self._tp = ShardedTrainer(model, self.mesh)
        self._dp = DataParallelStep(model, self.mesh, compress=compress,
                                    sharded_update=not compress, axes=("data", "pipe"))

    def _rows(self, arr):
        if arr is None:
            return None
        d = self.mesh.shape["data"]
        if arr.shape[0] % d:
            raise ValueError(f"batch rows {arr.shape[0]} must divide the data axis ({d})")
        return global_array(self.mesh, arr, ("data",))

    def fit_batch(self, x, y, fm=None, lm=None, ew=None):
        """One mesh step on the global batch (every rank passes the same
        arrays); returns the loss (a device scalar)."""
        with obs.span("mesh.step"):
            return self._dp.fit_batch(*(self._rows(a) for a in (x, y, fm, lm, ew)))

    def fit(self, data, epochs: int = 1, batch_size: Optional[int] = None):
        from deeplearning4j_tpu_torch.nn.model import _iter_batches

        model = self.model
        for _ in range(epochs):
            source = data() if callable(data) else data
            for xb, yb, fmb, lmb in _iter_batches(source, batch_size):
                score = self.fit_batch(xb, yb, fmb, lmb)
                if model.listeners:
                    score = float(score)
                    for l in model.listeners:
                        l.iteration_done(model, model.iteration, score, len(xb))
            model.epoch += 1
        return model

    def output(self, x):
        """The output on the global batch, gathered on every rank."""
        return self._tp.output(x)

    def finish(self):
        """Leave the mesh layout (a collective): the updater state gathered
        over the spare axes, then params and updater state over ``model``,
        so the model serializes and runs on one device as usual."""
        self._dp.finish()
        if self._tp._tp.size > 1:
            whole = self._tp.to_model()
            m = self.model
            m.params, m.opt_state = whole.params, whole.opt_state
            self._tp = None
            self._dp = None
