"""The sharded trainer (the PyTorch port of ``parallel/tp.py``'s
``ShardedTrainer``) over the ``data`` and ``seq`` axes of a mesh.

In the JAX package ``ShardedTrainer`` places params by tensor-parallel
rules, shards the batch over ``data`` and the time axis over ``seq``, and
GSPMD turns the one jitted step into a program over the mesh. The port
writes that program out (SPMD over ``torch.distributed``):

- params, layer state and updater state are replicated: broadcast from rank
  0 at construction, then kept bit-equal because every rank applies the
  same update to the same values;
- every rank is given the global batch in :meth:`ShardedTrainer.fit_batch`
  and keeps its rows (its ``data`` coordinate) and, with a ``seq`` axis,
  its time chunk (its ``seq`` coordinate); attention layers with
  ``sequence_parallel=True`` then run ring attention over ``seq`` and the
  positional embedding adds the chunk's positions (``nn/layers/attention.py``);
- each rank scales its loss so that a SUM all-reduce over data x seq gives
  ``losses.average_score`` of the global batch: per-example sums over the
  global B, or with a [B, T] mask on a rank-3 output over the global mask
  sum (one all-reduce of its own); regularisation is counted once (rank 0);
- the gradients go through one all-reduce per dtype, as one flat bucket,
  and every rank applies the same update; ``fit_batch`` returns the global
  loss.

Not in this slice (ROADMAP Queue 1 item 7): tensor parallelism (a ``model``
axis, ``tp_param_shardings``), a ``pipe`` axis, layers whose state depends
on the batch (BatchNorm) across ranks, and layers that mix time steps other
than sequence-parallel attention under a ``seq`` axis.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.parallel.context import use_mesh
from deeplearning4j_tpu_torch.parallel.distributed import (
    global_array,
    process_count,
    replicate_global,
)

__all__ = ["ShardedTrainer"]

# layer types that act on each time step alone (and so take a time chunk),
# attention only with sequence_parallel=True
_TIME_LOCAL = {"embedding_sequence", "positional_embedding", "layer_norm", "rnn_output",
               "dropout", "activation", "multi_head_attention", "transformer_block"}


def _all_reduce_sum(tensors):
    """SUM all-reduce of a list of tensors over the default group, one flat
    bucket per dtype; returns new tensors in the same order."""
    out = list(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat)
        at = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[at:at + n].view_as(tensors[i])
            at += n
    return out


class ShardedTrainer:
    """Drives a MultiLayerNetwork's training step over a ``data x seq``
    mesh (see the module docstring). ``shard_time``: cut the time axis over
    ``seq`` (the port needs it whenever the mesh has a seq axis)."""

    def __init__(self, model, mesh, *, shard_time: bool = True):
        if mesh.shape["model"] > 1 or mesh.shape["pipe"] > 1:
            raise NotImplementedError(
                f"ShardedTrainer takes data and seq axes; model > 1 (tensor "
                f"parallelism, tp_param_shardings) and pipe > 1 are not ported yet, "
                f"ROADMAP Queue 1 item 7 (mesh {mesh.shape})")
        if model.device.type != mesh.device.type:
            raise ValueError(f"the model is on {model.device}, the mesh's rank on "
                             f"{mesh.device}")
        self.model = model
        self.mesh = mesh
        self.shard_time = shard_time and mesh.shape["seq"] > 1
        if mesh.shape["seq"] > 1:
            self._check_time_local(shard_time)
        if model.params is None:
            model.init()
        if mesh.size > 1 and any(s for s in model.state):
            raise NotImplementedError(
                "layer state that depends on the batch (BatchNorm's statistics) is not "
                "combined across ranks yet, ROADMAP Queue 1 item 7")
        replicate_global(mesh, model.params)
        if model.opt_state is not None:
            replicate_global(mesh, model.opt_state)

    def _check_time_local(self, shard_time: bool):
        m = self.model
        if not shard_time:
            raise ValueError("with a seq axis the port's SPMD trainer cuts the time axis "
                             "over it: shard_time=False would run each rank's attention "
                             "over the whole sequence")
        if not m.conf.input_type or not getattr(m.conf.input_type, "timesteps", None):
            raise ValueError("a seq axis needs a model with a sequence input (a time axis)")
        for layer in m.layers:
            name = getattr(layer, "_type_name", type(layer).__name__)
            if name not in _TIME_LOCAL or (
                    name in ("multi_head_attention", "transformer_block")
                    and not layer.sequence_parallel):
                raise ValueError(
                    f"layer {name} mixes time steps and cannot take a time chunk of a "
                    f"seq axis (attention needs sequence_parallel=True; other such "
                    f"layers are ROADMAP Queue 1 item 7)")

    # -- the batch ----------------------------------------------------------
    def _shard(self, arr):
        """This rank's rows (and, cutting time, its time chunk) of a global
        array, or None."""
        if arr is None:
            return None
        spec = ("data", "seq") if self.shard_time and arr.ndim >= 2 else ("data",)
        return global_array(self.mesh, arr, spec)

    def _loss_scale(self, a, out_mask, b_local, b_global):
        """The factor that makes this rank's average score its share of the
        global one (``losses.average_score``)."""
        if out_mask is not None and a.dim() == 3 and out_mask.dim() == 2:
            local = torch.clamp_min(out_mask.sum().float(), 1.0)
            total = out_mask.sum().float()
            if dist.is_initialized():
                dist.all_reduce(total)
            return local / torch.clamp_min(total, 1.0)
        return b_local / b_global

    def _value_and_grad(self, x, y, fm, lm, b_global):
        """This rank's scaled loss and gradients, all-reduced: (global loss,
        new layer state, the gradient tree)."""
        from deeplearning4j_tpu_torch.utils.tree import (
            tree_leaves, tree_map, tree_unflatten_like)

        m = self.model
        leaves = tree_leaves(m.params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        params = tree_unflatten_like(m.params, live)
        a, new_state, _, prop_mask, _ = m._forward(
            params, m.state, x, train=True, rng=m._gen, fmask=fm,
            upto=len(m.layers) - 1)
        out_mask = lm if lm is not None else prop_mask
        loss = m.layers[-1].score(params[-1], a, y, mask=out_mask, average=True)
        scale = self._loss_scale(a, out_mask, x.shape[0], b_global)
        if not (isinstance(scale, float) and scale == 1.0):
            loss = loss * (scale.to(loss.dtype) if isinstance(scale, torch.Tensor) else scale)
        if self.mesh.rank == 0:   # the penalties once, not once per rank
            loss = loss + sum(l.regularization_penalty(p) for l, p in zip(m.layers, params))
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        loss = loss.detach()
        if dist.is_initialized():
            loss, *grads = _all_reduce_sum([loss] + grads)
        new_state = tree_map(lambda s: s.detach(), new_state)
        return loss, new_state, tree_unflatten_like(m.params, grads)

    def fit_batch(self, x, y, fmask=None, lmask=None):
        """One training step on the global batch (every rank passes the same
        arrays); returns the global loss (a device scalar, equal on every
        rank)."""
        from deeplearning4j_tpu_torch.nn.model import _cast_labels, _cast_mask

        m = self.model
        b_global = x.shape[0]
        xs, ys, fms, lms = (self._shard(a) for a in (x, y, fmask, lmask))
        with use_mesh(self.mesh):
            loss, new_state, grads = self._value_and_grad(
                m._features(xs), _cast_labels(ys, m.dtype, m.device),
                _cast_mask(fms, m.dtype, m.device), _cast_mask(lms, m.dtype, m.device),
                b_global)
        m._apply_step(loss, new_state, grads)
        m.iteration += 1
        return loss

    def fit(self, data, epochs: int = 1, batch_size: Optional[int] = None):
        """Train over ``data`` (as ``MultiLayerNetwork.fit`` takes it, no tail
        padding), one :meth:`fit_batch` a batch; listeners see the global
        loss, as in the JAX package."""
        from deeplearning4j_tpu_torch.nn.model import _iter_batches

        model = self.model
        for _ in range(epochs):
            source = data() if callable(data) else data
            for xb, yb, fm, lm in _iter_batches(source, batch_size):
                score = self.fit_batch(xb, yb, fm, lm)
                if model.listeners:
                    score = float(score)
                    for l in model.listeners:
                        l.iteration_done(model, model.iteration, score, len(xb))
            model.epoch += 1
        return model

    def output(self, x):
        """The network's output on the global batch ``x``: each rank runs its
        shard (ring attention across the seq axis) and the shards are
        gathered back into the global [B, T, ...] on every rank."""
        with use_mesh(self.mesh):
            local = self.model.output(self._shard(x))
        if process_count() == 1:
            return local
        with torch.inference_mode():
            parts = [torch.empty_like(local) for _ in range(self.mesh.size)]
            dist.all_gather(parts, local.contiguous())
            grid = self.mesh.devices            # [data, 1, seq, 1] of global ranks
            rows = []
            for di in range(grid.shape[0]):
                chunks = [parts[int(grid[di, 0, si, 0])] for si in range(grid.shape[2])]
                rows.append(torch.cat(chunks, dim=1) if self.shard_time else chunks[0])
            return torch.cat(rows, dim=0)
