"""Data-parallel training (the PyTorch port of ``parallel/wrapper.py``,
DL4J's ParallelWrapper).

The JAX package feeds a globally sharded batch to its one jitted step and
lets XLA insert the gradient all-reduce. The port runs one process per
rank (SPMD over ``torch.distributed``), and its contract is the JAX
package's multi-process one: every rank calls :meth:`ParallelWrapper.fit`
with its LOCAL rows, the global batch of a step is the ranks' batches
concatenated in rank order, and the result is the single-process fit on
that global batch:

- each rank's batch is padded up the shared bucket ladder with tiled rows
  (``utils/bucketing.py``), then every rank's padded row count is raised to
  the largest (one all-gather of ``[real, padded]`` a batch, on every
  batch: a cached count would deadlock when one rank's batch size
  changes);
- the padded rows are weighted 0 in the loss and every real row weighs
  ``gB / n_tot`` (the global padded and real row counts), so uneven ranks
  average over the global real rows; the per-example weight ``ew`` keeps
  the padded rows out of BatchNorm's statistics, which are those of the
  global batch;
- the step is :class:`~deeplearning4j_tpu_torch.parallel.grads.DataParallelStep`:
  the mean all-reduce of every gradient and the replicated update, or,
  switched on by ``grad_compress`` / ``sharded_update`` (or
  ``DL4J_TPU_GRAD_COMPRESS`` / ``DL4J_TPU_SHARDED_UPDATE``, the threshold
  ``compress_threshold`` / ``DL4J_TPU_COMPRESS_THRESHOLD``), the
  compressed exchange and the sharded weight update. The JAX package's
  single-process-only restriction on those switches does not apply.

``fit(resume_from=dir)`` restores the newest valid checkpoint (the
residuals of a compressed run included) through ``train/resilience.py``;
listeners and the divergence guard see the global loss. Without a process
group the wrapper is a world of one on the model's device.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.parallel import comm
from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, make_mesh

__all__ = ["ParallelWrapper"]


def _env_flag(name: str) -> Optional[bool]:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return None
    return raw != "0"


def _rows(a) -> int:
    return len(a) if a is not None else 0


class ParallelWrapper:
    """Data parallelism for a MultiLayerNetwork or a ComputationGraph over
    the ``data`` axis of ``mesh`` (default: every rank of the default
    process group, on the model's device). See the module docstring."""

    def __init__(self, model, mesh=None, grad_compress: Optional[bool] = None,
                 sharded_update: Optional[bool] = None,
                 compress_threshold: Optional[float] = None):
        self.model = model
        self.mesh = mesh if mesh is not None else make_mesh(MeshSpec(), device=model.device)
        others = {a: n for a, n in self.mesh.shape.items() if a != "data" and n > 1}
        if others:
            raise ValueError(f"ParallelWrapper takes a data-only mesh, got {self.mesh.shape}")
        self.n_data = self.mesh.shape["data"]
        self._sub = self.mesh.sub("data")
        if grad_compress is None:
            grad_compress = _env_flag("DL4J_TPU_GRAD_COMPRESS")
        if sharded_update is None:
            sharded_update = _env_flag("DL4J_TPU_SHARDED_UPDATE")
        if compress_threshold is None:
            compress_threshold = float(os.environ.get("DL4J_TPU_COMPRESS_THRESHOLD", "1e-3"))
        self.grad_compress = bool(grad_compress)
        self.sharded_update = bool(sharded_update)
        self.compress_threshold = float(compress_threshold)
        self._runner = None

    # -- the batch ----------------------------------------------------------
    def _pad_to_bucket(self, arrs, record: bool = False):
        """Tile a batch's members up the bucket ladder (every member has the
        same rows); returns (padded members, real rows)."""
        from deeplearning4j_tpu_torch.utils import bucketing

        n = next(_rows(a) for a in arrs if a is not None)
        target = bucketing.bucket_size(n) if bucketing.bucketing_enabled() and n > 0 else n
        target = max(target, n, 1)
        if record:
            bucketing.telemetry().record_hit("dp.fit", n, target)
        if target == n:
            return tuple(arrs), n
        return tuple(bucketing.tile_pad(a, target - n) for a in arrs), n

    def _even_ranks(self, arrs, n):
        """Raise this rank's padded rows to the largest over the ranks;
        returns (members, global real rows, global padded rows)."""
        from deeplearning4j_tpu_torch.utils import bucketing

        local = next(_rows(a) for a in arrs if a is not None)
        info = torch.tensor([n, local], dtype=torch.int64, device=self.model.device)
        info = torch.stack(comm.all_gather(info, self._sub)).cpu().numpy()
        n_tot, target = int(info[:, 0].sum()), int(info[:, 1].max())
        if local < target:
            arrs = tuple(bucketing.tile_pad(a, target - local) for a in arrs)
        return tuple(arrs), n_tot, target * self.n_data

    def _label_masks(self, ys, lms, n, scale):
        from deeplearning4j_tpu_torch.utils.bucketing import padded_label_mask

        return tuple(padded_label_mask(y, lm, n, scale=scale) for y, lm in zip(ys, lms))

    def _prepare(self, members):
        """Pad one batch (a flat tuple of its members, rows first) for this
        rank's share of the global step; returns (members, real rows, the
        real rows' loss weight or None for B_pad / n, whether any rank
        padded)."""
        flat, n = self._pad_to_bucket(members, record=True)
        scale = None
        if self.n_data > 1:
            flat, n_tot, gB = self._even_ranks(flat, n)
            padded = n_tot != gB
            if padded:
                scale = gB / n_tot
        else:
            padded = _rows(flat[0]) != n
        return flat, n, scale, padded

    # -- the exchange -------------------------------------------------------
    def _exchange_runner(self):
        """The step (built once and kept: compression residuals persist
        across fit calls)."""
        if self._runner is None:
            from deeplearning4j_tpu_torch.parallel.grads import DataParallelStep

            self._runner = DataParallelStep(
                self.model, self.mesh, compress=self.grad_compress,
                sharded_update=self.sharded_update, threshold=self.compress_threshold)
        return self._runner

    def _replicate_model(self):
        from deeplearning4j_tpu_torch.parallel.distributed import replicate_global

        m = self.model
        replicate_global(self.mesh, m.params)
        replicate_global(self.mesh, m.state)
        if m.opt_state is not None:
            replicate_global(self.mesh, m.opt_state)

    def fit(self, data, epochs: int = 1, batch_size: Optional[int] = None, resume_from=None):
        """``model.fit``'s semantics on the global batch (this rank passes its
        rows). ``resume_from``: a CheckpointListener directory (this rank's):
        the newest valid checkpoint is restored, ``epochs`` counts the total
        and the interrupted epoch skips its used batches."""
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
        from deeplearning4j_tpu_torch.train import resilience
        from deeplearning4j_tpu_torch.train.listeners import close_listeners

        model = self.model
        if model.params is None:
            model.init()
        resume_skip = 0
        if resume_from is not None and resilience.resume(model, resume_from) is not None:
            resume_skip = int(getattr(model, "batch_in_epoch", 0))
            epochs = max(epochs - model.epoch, 0)
            self._runner = None      # a new plan around the restored updaters
        self._replicate_model()
        is_graph = isinstance(model, ComputationGraph)
        runner = self._exchange_runner()
        runner.begin()
        guard = getattr(model, "divergence_guard", None)
        try:
            for _ in range(epochs):
                skip_n, resume_skip = resume_skip, 0
                model.batch_in_epoch = skip_n
                for l in model.listeners:
                    l.on_epoch_start(model, model.epoch)
                source = data() if callable(data) else data
                it = self._batches(source, batch_size, is_graph)
                for _ in range(skip_n):
                    if next(it, None) is None:
                        break
                for batch in it:
                    with obs.span("dp.fit_batch"):
                        score, n = (self._graph_step(runner, batch) if is_graph
                                    else self._step(runner, batch))
                    model.batch_in_epoch += 1
                    if guard is not None:
                        guard.observe(model, score)
                    if model.listeners:
                        score = float(score)
                        resilience.note_score(score)
                        for l in model.listeners:
                            l.iteration_done(model, model.iteration, score, n)
                if guard is not None:
                    guard.flush(model)
                for l in model.listeners:
                    l.on_epoch_end(model, model.epoch)
                model.epoch += 1
        finally:
            runner.finish()
            close_listeners(model.listeners)
        return model

    def _batches(self, source, batch_size, is_graph):
        if is_graph:
            return self.model._iter_multi(source, batch_size)
        from deeplearning4j_tpu_torch.nn.model import _iter_batches

        return _iter_batches(source, batch_size)

    def _step(self, runner, batch):
        from deeplearning4j_tpu_torch.utils.bucketing import padded_label_mask

        (x, y, fm, lm), n, scale, padded = self._prepare(tuple(batch))
        if padded or lm is not None:   # an unpadded batch keeps its own mask (or none)
            lm = padded_label_mask(y, lm, n, scale=scale)
        ew = None
        if padded:
            ew = np.zeros(_rows(x), np.float32)
            ew[:n] = 1.0
        return runner.fit_batch(x, y, fm, lm, ew=ew), n

    def _graph_step(self, runner, batch):
        f, lbl, fm, lm = batch
        groups = [t for t in (f, lbl, fm, lm)]
        lens = [len(t) if t is not None else 0 for t in groups]
        flat = sum((list(t) for t in groups if t is not None), [])
        flat, n, scale, padded = self._prepare(tuple(flat))
        flat = list(flat)
        parts = []
        for ln, t in zip(lens, groups):
            parts.append(tuple(flat[:ln]) if t is not None else None)
            flat = flat[ln:]
        f, lbl, fm, lm = parts
        if lbl is not None and (padded or lm is not None):
            lms = lm if lm is not None else (None,) * len(lbl)
            lm = self._label_masks(lbl, lms, n, scale)
        ew = None
        if padded:
            ew = np.zeros(_rows(f[0]), np.float32)
            ew[:n] = 1.0
        return runner.fit_batch_graph((f, lbl, fm, lm), ew=ew), n

    # -- inference ----------------------------------------------------------
    def output(self, x):
        """The output on the global batch: this rank passes its rows (a
        graph: a tuple of inputs), every rank gets every rank's outputs in
        rank order (uneven rows padded for the exchange and trimmed)."""
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

        model = self.model
        xs = tuple(x) if isinstance(x, (tuple, list)) else (x,)
        out = (model.output(*xs) if isinstance(model, ComputationGraph)
               else model.output(xs[0]))
        if self.n_data == 1:
            return out
        n = _rows(xs[0])
        counts = torch.stack(comm.all_gather(
            torch.tensor([n], dtype=torch.int64, device=model.device), self._sub))
        counts = [int(c) for c in counts.cpu().reshape(-1)]
        top = max(counts)

        def gather(o):
            o = o.contiguous()
            if o.shape[0] < top:
                o = torch.cat([o, o.new_zeros((top - o.shape[0],) + tuple(o.shape[1:]))])
            parts = comm.all_gather(o, self._sub)
            return torch.cat([p[:c] for p, c in zip(parts, counts)])

        with torch.inference_mode():
            if isinstance(out, (tuple, list)):
                return type(out)(gather(o) for o in out)
            return gather(out)
