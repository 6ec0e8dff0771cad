"""GPipe pipeline parallelism as a framework feature (the PyTorch port of
``parallel/gpipe.py``): any MultiLayerConfiguration trained pipelined over
the mesh's ``pipe`` axis.

- **Partitioning**: the resolved layer list (preprocessors included) but
  the loss head is split into ``pipe``-many contiguous stages balanced by
  parameter count (:func:`partition_layers`, the JAX package's).
- **Stages**: each ``pipe`` rank holds its stage as an ordinary list of
  layers and runs it on each micro-batch; the activations and their
  gradients move between ranks by point-to-point (``parallel/pipeline.py``
  ``run_schedule``). The JAX package ravels every stage into one padded
  vector and switches on the rank inside one program, and switches the
  fused LSTM kernel off there; the port needs neither, so a recurrent
  stage runs kernels #4/#5 on the card.
- **The update**: each rank updates its own layers (and the last rank the
  head) with the network's per-layer updaters, so per-layer learning-rate
  overrides and frozen layers are the single-device ones; gradient
  normalization and constraints apply per layer.
- **BatchNorm**: per-micro-batch statistics (the GPipe semantics); each
  BatchNorm layer is applied with zero running statistics to read its
  batch statistics, those are combined over the ``data`` axis with the
  parallel-variance form, and the running statistics are chained over the
  micro-batches in order, as the JAX package does.
- **Masks**: every rank propagates the feature mask through the layers
  before its stage (the mask of [B, T] recurrent input); the head scores
  with the label mask or the propagated feature mask.
- **Token ids**: an EmbeddingSequence first stage takes the integer ids as
  they are.
- **PP x TP** (``tp_axis``): the head's weight is column-sharded over
  ``tp_axis`` on the last stage's ranks, its outputs all-gathered before
  the loss (``parallel/comm.py``; the head's bias stays whole).
- **Randomness**: dropout and weight noise draw from a ``torch.Generator``
  per (step, micro-batch, layer), seeded from ``conf.seed``; a run of
  :func:`microbatched_reference` (one stage, one device) draws the same.
- **Listeners** fire per iteration with the global loss, on every rank.

With a ``data`` axis the micro-batches' rows are cut over it (the loss and
gradients averaged over the data ranks); ``seq`` and unused ``model`` ranks
hold replicas. :meth:`GPipeTrainer.to_model` gathers every stage into an
ordinary MultiLayerNetwork on every rank.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.parallel import comm
from deeplearning4j_tpu_torch.parallel.context import use_mesh
from deeplearning4j_tpu_torch.parallel.pipeline import run_schedule

__all__ = ["GPipeTrainer", "microbatched_reference", "partition_layers"]


def partition_layers(param_counts: Sequence[int], n_stages: int) -> List[Tuple[int, int]]:
    """Contiguous [start, end) ranges balanced by parameter count (greedy
    prefix split at target boundaries; every stage non-empty)."""
    n = len(param_counts)
    if n_stages > n:
        raise ValueError(f"{n_stages} stages for {n} layers")
    total = float(sum(param_counts)) or 1.0
    bounds = [0]
    acc = 0.0
    for i, c in enumerate(param_counts):
        acc += c
        remaining_needed = n_stages - len(bounds)
        if len(bounds) < n_stages and acc >= total * len(bounds) / n_stages \
                and i + 1 <= n - remaining_needed:
            bounds.append(i + 1)
    while len(bounds) < n_stages:
        bounds.append(min(bounds[-1] + 1, n - (n_stages - len(bounds))))
    bounds.append(n)
    return [(bounds[i], bounds[i + 1]) for i in range(n_stages)]


def _generator(device, seed: int, *path) -> torch.Generator:
    """A generator seeded from ``seed`` and a (step, micro-batch, layer,
    ...) path: the same draws on any rank and in the reference."""
    digest = hashlib.sha256(repr((seed,) + path).encode()).digest()
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(digest[:8], "little") & ((1 << 63) - 1))
    return g


class GPipeTrainer:
    """Pipeline-parallel trainer for a MultiLayerConfiguration (see the
    module docstring)::

        mesh = make_mesh(MeshSpec(data=2, pipe=2))
        tr = GPipeTrainer(conf, mesh, n_micro=4)
        tr.fit((x, y), epochs=3)
        model = tr.to_model()     # ordinary MultiLayerNetwork, every rank

    Every rank passes the global batch to ``fit`` / ``fit_batch``."""

    def __init__(self, conf, mesh, n_micro: int = 2, pipe_axis: str = "pipe",
                 data_axis: str = "data", tp_axis: Optional[str] = None,
                 _one_stage: bool = False):
        from deeplearning4j_tpu_torch.nn.layers import BatchNorm
        from deeplearning4j_tpu_torch.nn.model import MultiLayerNetwork
        from deeplearning4j_tpu_torch.utils.tree import tree_leaves

        self.conf = conf
        self.mesh = mesh
        self.n_micro = n_micro
        self.pipe_axis, self.data_axis, self.tp_axis = pipe_axis, data_axis, tp_axis
        self.n_stages = mesh.shape[pipe_axis]
        if self.n_stages < 2 and not _one_stage:
            raise ValueError("GPipeTrainer needs a pipe axis of size >= 2")
        self._pipe = mesh.sub(pipe_axis)
        self._data = mesh.sub(data_axis)
        self._tp = mesh.sub(tp_axis) if tp_axis else None
        # an ordinary network resolves the layers (preprocessors, n_in) and
        # draws the initial params, the same on every rank
        self._ref = MultiLayerNetwork(conf, device=mesh.device).init()
        ref = self._ref
        for i, layer in enumerate(ref.layers):
            if tree_leaves(ref.state[i]) and not isinstance(layer, BatchNorm):
                raise NotImplementedError(
                    f"GPipeTrainer: layer {i} ({type(layer).__name__}) carries non-BN "
                    "running state — use data or tensor parallelism for such nets")
        self.head_idx = len(ref.layers) - 1
        self.head_cfg = ref.layers[self.head_idx]
        counts = [sum(int(t.numel()) for t in tree_leaves(ref.params[i]))
                  for i in range(self.head_idx)]
        self.stage_ranges = partition_layers(counts, self.n_stages)
        self.stage = self._pipe.index
        s, e = self.stage_ranges[self.stage]
        self.mine = list(range(s, e)) + ([self.head_idx] if self._is_last else [])
        self._head_sharded = False
        if self._is_last and self._tp is not None and self._tp.size > 1:
            self._shard_head()
        self.iteration = 0
        self.epoch = 0
        self.listeners: list = []
        self._mask_alive = self._mask_topology()

    @property
    def _is_last(self) -> bool:
        return self.stage == self.n_stages - 1

    def _shard_head(self):
        """Column-shard the head's 2-D weight over ``tp_axis``."""
        p = dict(self._ref.params[self.head_idx])
        W = p["W"]
        n = self._tp.size
        if W.dim() == 2 and W.shape[1] % n == 0:
            self._head_sharded = True
            p["W"] = W.chunk(n, dim=1)[self._tp.index].clone()
            params = list(self._ref.params)
            params[self.head_idx] = p
            self._ref.params = tuple(params)

    def _mask_topology(self):
        """Which layers' inputs carry a mask when the input is a [B, T]
        recurrent sequence (None when the net cannot take masks: the mask
        must keep its shape through every layer)."""
        it0 = self.conf.input_type
        if getattr(it0, "kind", None) != "recurrent" or not it0.timesteps:
            return None
        W = int(it0.timesteps)
        m = torch.ones((1, W))
        alive = []
        for layer, it in zip(self._ref.layers, self._ref.layer_input_types):
            alive.append(m is not None)
            if m is not None:
                m = layer.propagate_mask(m, it)
                if m is not None and tuple(m.shape) != (1, W):
                    return None
        return alive

    # -- one step -----------------------------------------------------------
    def _stage_forward(self, params, x, i, fm_i, bn_stats):
        """This rank's layers on micro-batch ``i`` (``fm_i``: its input
        mask or None). BatchNorm layers record their batch statistics into
        ``bn_stats[gi]``. Returns (activation, mask)."""
        from deeplearning4j_tpu_torch.nn.layers import BatchNorm

        ref = self._ref
        s, e = self.stage_ranges[self.stage]
        seed = ref.conf.seed
        a = x if not x.is_floating_point() else x.to(ref.dtype)
        m = fm_i
        for gi in range(s, e):
            layer, p = ref.layers[gi], params[gi]
            gen = _generator(ref.device, seed, self.iteration, i, gi)
            if layer.weight_noise:
                p = layer.maybe_weight_noise(p, True, _generator(ref.device, seed,
                                                                 self.iteration, i, gi, "noise"))
            if isinstance(layer, BatchNorm):
                zero = {k: torch.zeros_like(v) for k, v in ref.state[gi].items()}
                a, ns = layer.apply(p, zero, a, train=True, rng=gen, mask=m)
                bn_stats.setdefault(gi, []).append(
                    (ns["mean"].detach() / (1.0 - layer.decay),
                     ns["var"].detach() / (1.0 - layer.decay)))
            else:
                a, _ = layer.apply(p, ref.state[gi], a, train=True, rng=gen, mask=m)
            if m is not None:
                m = layer.propagate_mask(m, ref.layer_input_types[gi])
        return a, m

    def _masks_at(self, fm, upto: int):
        """The feature mask propagated through layers [0, upto)."""
        if fm is None:
            return None
        ref = self._ref
        m = fm
        for gi in range(upto):
            if m is not None:
                m = ref.layers[gi].propagate_mask(m, ref.layer_input_types[gi])
        return m

    def _chain_bn(self, bn_stats):
        """Combine each BatchNorm layer's per-micro-batch statistics over the
        data ranks (the parallel-variance form) and chain its running
        statistics over the micro-batches in order."""
        ref = self._ref
        state = list(ref.state)
        for gi, stats in bn_stats.items():
            decay = ref.layers[gi].decay
            mean, var = state[gi]["mean"], state[gi]["var"]
            for mu, v in stats:
                if self._data.size > 1:
                    n = self._data.size
                    mu_g = comm.all_reduce(mu.clone(), self._data) / n
                    v = (comm.all_reduce(v.clone(), self._data) / n
                         + comm.all_reduce((mu - mu_g) ** 2, self._data) / n)
                    mu = mu_g
                mean = decay * mean + (1.0 - decay) * mu
                var = decay * var + (1.0 - decay) * v
            state[gi] = {"mean": mean, "var": var}
        ref.state = tuple(state)

    def fit_batch(self, x, y, fm=None, lm=None):
        """One pipelined step on the global batch; returns the loss (a device
        scalar, the same on every rank)."""
        from deeplearning4j_tpu_torch.nn.model import _cast_labels, _cast_mask
        from deeplearning4j_tpu_torch.utils.tree import tree_leaves, tree_unflatten_like

        ref = self._ref
        B = len(x)
        if B % self.n_micro:
            raise ValueError(f"batch size {B} must be divisible by n_micro={self.n_micro}")
        mb = B // self.n_micro
        nd = self._data.size
        if mb % nd:
            raise ValueError(f"microbatch size {mb} (= {B}/{self.n_micro}) must be "
                             f"divisible by the '{self.data_axis}' mesh axis ({nd})")
        if (fm is not None or lm is not None) and self._mask_alive is None:
            raise NotImplementedError(
                "GPipeTrainer masks need a recurrent [B, T] input whose mask keeps its "
                "shape through every layer — use data or tensor parallelism for other "
                "mask layouts")
        lo, hi = self._data.index * mb // nd, (self._data.index + 1) * mb // nd

        def rows(a, cast):
            if a is None:
                return None
            t = cast(a)
            t = t.reshape((self.n_micro, mb) + tuple(t.shape[1:]))[:, lo:hi]
            return t

        dev, dt = ref.device, ref.dtype
        xm = rows(x, lambda a: ref._features(a))
        fmm = rows(fm, lambda a: _cast_mask(a, dt, dev))
        first = self.stage_ranges[self.stage][0]
        live = {gi: [t.detach().requires_grad_(True) for t in tree_leaves(ref.params[gi])]
                for gi in self.mine}
        params = {gi: tree_unflatten_like(ref.params[gi], live[gi]) for gi in self.mine}
        bn_stats: dict = {}
        in_masks = [self._masks_at(fmm[i], first) if fmm is not None else None
                    for i in range(self.n_micro)]
        head_masks = []

        def stage(a, i):
            out, m = self._stage_forward(params, a, i, in_masks[i], bn_stats)
            head_masks.append(m)
            return out

        def head(outs):
            yl = rows(y, lambda a: _cast_labels(a, dt, dev))
            pre = torch.cat(list(outs), dim=0)
            ys = yl.reshape((-1,) + tuple(yl.shape[2:]))
            if lm is not None:
                hm = rows(lm, lambda a: _cast_mask(a, dt, dev))
                hm = hm.reshape((-1,) + tuple(hm.shape[2:]))
            elif fmm is not None:
                hm = torch.cat(head_masks, dim=0) if head_masks[0] is not None else None
            else:
                hm = None
            with use_mesh(self.mesh if self._tp is not None else None):
                return self.head_cfg.score(params[self.head_idx], pre, ys, mask=hm,
                                           average=True)

        loss = run_schedule(stage, self._pipe, self.n_micro, lambda i: xm[i], head, dev)
        # the L1/L2 penalties: each rank its own layers', the sum reported
        pen = sum(ref.layers[gi].regularization_penalty(params[gi]) for gi in self.mine)
        if isinstance(pen, torch.Tensor) and pen.requires_grad:
            pen.backward()
        if isinstance(pen, torch.Tensor):
            loss = loss + comm.all_reduce(pen.detach().float().clone(), self._pipe)
        grads = {gi: [t.grad if t.grad is not None else torch.zeros_like(t)
                      for t in live[gi]] for gi in self.mine}
        if nd > 1:
            for gi in self.mine:
                flat = comm.all_reduce(torch.cat([g.reshape(-1) for g in grads[gi]]),
                                       self._data) / nd
                at, out = 0, []
                for g in grads[gi]:
                    out.append(flat[at:at + g.numel()].view_as(g))
                    at += g.numel()
                grads[gi] = out
            loss = comm.all_reduce(loss.clone(), self._data) / nd
        self._update({gi: tree_unflatten_like(ref.params[gi], grads[gi]) for gi in self.mine})
        self._chain_bn(bn_stats)
        self.iteration += 1
        return loss

    def _update(self, grads):
        """The per-layer update of this rank's layers (gradient
        normalization, the layer's updater, constraints), in place."""
        from deeplearning4j_tpu_torch.nn.constraints import apply_constraints
        from deeplearning4j_tpu_torch.train.updaters import apply_gradient_normalization
        from deeplearning4j_tpu_torch.utils.tree import tree_leaves

        ref = self._ref
        if ref.opt_state is None:
            ref.opt_state = tuple(u.init(p) if i in self.mine else ()
                                  for i, (u, p) in enumerate(zip(ref._updaters, ref.params)))
        opt = list(ref.opt_state)
        new_params = list(ref.params)
        with torch.no_grad():
            for gi, g in grads.items():
                layer, p = ref.layers[gi], ref.params[gi]
                if not tree_leaves(g):
                    continue
                gn = getattr(layer, "gradient_normalization", None)
                if gn:
                    g = apply_gradient_normalization(
                        gn, getattr(layer, "gradient_normalization_threshold", 1.0), g)
                upd, opt[gi] = ref._updaters[gi].update(g, opt[gi], p, self.iteration)
                for pi, d in zip(tree_leaves(p), tree_leaves(upd)):
                    pi.sub_(d)
                if getattr(layer, "constraints", None):
                    new_params[gi] = apply_constraints(layer, p)
        ref.params = tuple(new_params)
        ref.opt_state = tuple(opt)

    # -- training API ------------------------------------------------------
    def fit(self, data, epochs: int = 1, batch_size: Optional[int] = None):
        from deeplearning4j_tpu_torch.nn.model import _iter_batches

        for _ in range(epochs):
            for l in self.listeners:
                l.on_epoch_start(self, self.epoch)
            source = data() if callable(data) else data
            for x, y, fm, lm in _iter_batches(source, batch_size):
                loss = self.fit_batch(x, y, fm, lm)
                if self.listeners:
                    loss = float(loss)
                    for l in self.listeners:
                        l.iteration_done(self, self.iteration, loss, len(x))
            for l in self.listeners:
                l.on_epoch_end(self, self.epoch)
            self.epoch += 1
        return self

    def set_listeners(self, *ls):
        self.listeners = list(ls)
        return self

    # -- back to an ordinary model ----------------------------------------
    def to_model(self):
        """An ordinary MultiLayerNetwork with every stage's params and
        BatchNorm statistics, on every rank (a collective over ``pipe``, and
        over ``tp_axis`` for a sharded head)."""
        from deeplearning4j_tpu_torch.nn.model import MultiLayerNetwork
        from deeplearning4j_tpu_torch.utils.tree import tree_leaves, tree_map

        ref = self._ref
        params = [tree_map(lambda t: t.detach().clone(), p) for p in ref.params]
        state = [tree_map(lambda t: t.clone(), st) for st in ref.state]
        if self._head_sharded:
            h = dict(params[self.head_idx])
            h["W"] = torch.cat(comm.all_gather(h["W"].contiguous(), self._tp), dim=1)
            params[self.head_idx] = h
        for si, (s, e) in enumerate(self.stage_ranges):
            owned = list(range(s, e)) + ([self.head_idx] if si == self.n_stages - 1 else [])
            for gi in owned:
                for t in tree_leaves(params[gi]) + tree_leaves(state[gi]):
                    comm.broadcast(t, si, self._pipe)
        model = MultiLayerNetwork(self.conf, device=ref.device)
        model.params = tuple(params)
        model.state = tuple(state)
        model._build_updaters()
        model.iteration, model.epoch = self.iteration, self.epoch
        return model


def microbatched_reference(conf, n_micro: int, device=None) -> GPipeTrainer:
    """The single-device run that micro-batches as :class:`GPipeTrainer`
    does (every layer in one stage, one process, the same per-(step,
    micro-batch, layer) generators): what a pipelined run with dropout or
    weight noise is held to."""
    from deeplearning4j_tpu_torch.parallel.mesh import Mesh

    from deeplearning4j_tpu_torch.parallel.distributed import default_device

    mesh = Mesh(np.zeros((1, 1, 1, 1), dtype=np.int64), 0, default_device(device), {})
    return GPipeTrainer(conf, mesh, n_micro=n_micro, _one_stage=True)
