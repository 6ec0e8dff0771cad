"""Explicit data-parallel gradient exchange: the compressed exchange and
the sharded weight update (the PyTorch port of ``parallel/grads.py``).

The default ParallelWrapper path all-reduces every gradient and runs the
same update on every rank. :class:`DataParallelStep` is the explicit
alternative, per layer (a ComputationGraph: per vertex):

1. **Threshold compression** (``parallel/compress.py``): each rank adds its
   gradient to its residual, ternary-quantizes the sum against the
   threshold, keeps the remainder as its new residual (error feedback) and
   all-gathers the 2-bit packed encodings; every rank decodes the same
   fixed-order sum. 16x fewer bytes than a dense f32 all-reduce.
2. **The sharded weight update** (arXiv 2004.13336): gradients are
   reduce-scattered, each rank applies the updater to its 1/R of the flat
   params with its 1/R of the updater state, and the updated params are
   all-gathered.

A layer is exchanged flat (the modes above) only when its params share one
floating dtype and it declares no gradient normalization (which needs the
whole gradient); otherwise it takes an exact mean all-reduce and the
replicated update. The loss is the mean over the ranks, as the JAX
package's ``pmean``.

The JAX class runs in one process over a ``shard_map``; the port's is SPMD
by nature: each rank (one process) holds its rows, its residuals and, in
sharded mode, its ``[m]`` slice of each flat updater statistic.
:meth:`DataParallelStep.begin` converts the model's updater state into
that layout and :meth:`DataParallelStep.finish` gathers it back;
:meth:`export_residuals` / :meth:`load_residuals` carry every rank's
residuals as the JAX package's ``[R, n_pad]`` arrays through checkpoints
(``train/resilience.py``; both are collectives).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.parallel import comm
from deeplearning4j_tpu_torch.parallel import compress as compression
from deeplearning4j_tpu_torch.parallel.context import use_mesh
from deeplearning4j_tpu_torch.nn import aot
from deeplearning4j_tpu_torch.nn.step_program import guarded_step
from deeplearning4j_tpu_torch.utils.tree import assign_leaves

__all__ = ["DataParallelStep", "GradExchange"]


@dataclass
class _Entry:
    """The exchange plan of one layer / vertex."""

    key: Any
    shapes: Tuple[Tuple[int, ...], ...]
    n: int                  # elements over the leaves
    m: int                  # per-rank shard length
    n_pad: int              # R * m
    dtype: Any              # the leaves' one dtype (flat modes)
    mode: str               # "sharded" | "replicated" | "dense"
    compress: bool
    updater: Any
    cfg: Any


def _flat(tree) -> torch.Tensor:
    from deeplearning4j_tpu_torch.utils.tree import tree_leaves

    leaves = tree_leaves(tree)
    if len(leaves) == 1:
        return leaves[0].reshape(-1)
    return torch.cat([l.reshape(-1) for l in leaves])


def _pad_flat(flat: torch.Tensor, n_pad: int) -> torch.Tensor:
    n = flat.shape[0]
    if n_pad == n:
        return flat
    return torch.cat([flat, flat.new_zeros((n_pad - n,))])


def _unflat_leaves(flat, shapes):
    out, off = [], 0
    for shp in shapes:
        k = int(np.prod(shp)) if shp else 1
        out.append(flat[off:off + k].reshape(shp))
        off += k
    return out


def _constrain(cfg, p):
    if getattr(cfg, "constraints", None):
        from deeplearning4j_tpu_torch.nn.constraints import apply_constraints

        return assign_leaves(p, apply_constraints(cfg, p))
    return p


class GradExchange:
    """The collective exchange and parameter update of one model over the
    ranks of ``sub`` (a ``Mesh.sub``): every method runs on each rank with
    its local values."""

    def __init__(self, entries: Dict[Any, _Entry], sub, threshold: float):
        self.entries = entries
        self.sub = sub
        self.R = sub.size
        self.threshold = float(threshold)

    def mean_loss(self, loss):
        return comm.all_reduce(loss.detach().clone(), self.sub) / self.R

    def _dense(self, e: _Entry, g, p, o, it):
        """Exact: the mean gradient (one flat all-reduce), gradient
        normalization on it, the replicated update."""
        from deeplearning4j_tpu_torch.train.updaters import apply_gradient_normalization
        from deeplearning4j_tpu_torch.utils.tree import tree_leaves, tree_unflatten_like

        leaves = tree_leaves(g)
        flat = comm.all_reduce(torch.cat([l.reshape(-1).float() for l in leaves]), self.sub)
        flat = flat / self.R
        g = tree_unflatten_like(g, [x.to(l.dtype) for x, l in
                                    zip(_unflat_leaves(flat, e.shapes), leaves)])
        gn = getattr(e.cfg, "gradient_normalization", None)
        if gn:
            g = apply_gradient_normalization(
                gn, getattr(e.cfg, "gradient_normalization_threshold", 1.0), g)
        upd, o_new = e.updater.update(g, o, p, it)
        for pi, d in zip(tree_leaves(p), tree_leaves(upd)):
            pi.sub_(d)
        return _constrain(e.cfg, p), o_new

    def _flat_entry(self, e: _Entry, g, p, o, r, it):
        """The compressed and / or sharded exchange of one entry."""
        from deeplearning4j_tpu_torch.utils.tree import tree_leaves, tree_unflatten_like

        R, thr = self.R, self.threshold
        g_mean = None
        if e.compress:
            # residual and encoding in f32 whatever the param dtype, so that
            # sub-threshold error feedback never rounds away in bf16
            with obs.span("phase.compress"):
                g32 = _pad_flat(_flat(g).float(), e.n_pad)
                packed, r = compression.encode_packed(g32, r, thr)
                gathered = torch.stack(comm.all_gather(packed, self.sub))   # [R, nbytes]
                g_mean = compression.decode_gathered(gathered, e.n_pad, thr,
                                                     torch.float32) / R
        leaves = tree_leaves(p)
        if e.mode == "sharded":
            i, m = self.sub.index, e.m
            if e.compress:
                g_shard = g_mean[i * m:(i + 1) * m].to(e.dtype)
            else:
                g_shard = comm.reduce_scatter(_pad_flat(_flat(g), e.n_pad), self.sub) / R
            p_shard = _pad_flat(_flat(p), e.n_pad)[i * m:(i + 1) * m]
            upd, o_new = e.updater.update(g_shard, o, p_shard, it)
            full = torch.cat(comm.all_gather(p_shard - upd, self.sub))[:e.n]
            for pi, v in zip(leaves, _unflat_leaves(full, e.shapes)):
                pi.copy_(v)
        else:
            # compressed, replicated update: every rank decodes the same
            # fixed-order sum, so the updates agree with no more collectives
            g_tree = tree_unflatten_like(g, _unflat_leaves(g_mean[:e.n].to(e.dtype), e.shapes))
            upd, o_new = e.updater.update(g_tree, o, p, it)
            for pi, d in zip(leaves, tree_leaves(upd)):
                pi.sub_(d)
        return _constrain(e.cfg, p), o_new, r

    def update(self, grads, params, opt_state, residuals, it):
        """One update of every entry: returns (params, opt state,
        residuals), dicts keyed like ``grads``; params change in place."""
        with obs.span("phase.exchange"), torch.no_grad():
            new_p, new_o, new_r = dict(params), dict(opt_state), dict(residuals)
            for key, e in self.entries.items():
                if e.mode == "dense":
                    new_p[key], new_o[key] = self._dense(e, grads[key], params[key],
                                                         opt_state[key], it)
                else:
                    new_p[key], new_o[key], new_r[key] = self._flat_entry(
                        e, grads[key], params[key], opt_state[key], residuals[key], it)
            return new_p, new_o, new_r


class DataParallelStep:
    """The explicit-exchange step for ParallelWrapper (and MeshTrainer's
    compressed path) over the ``axes`` of ``mesh`` (``data`` by default):
    see the module docstring. ``fit_batch`` / ``fit_batch_graph`` take this
    rank's rows."""

    COMM_SITE = "dp.grads"

    def __init__(self, model, mesh, *, compress: bool = False,
                 sharded_update: bool = False, threshold: float = 1e-3,
                 axes=("data",)):
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

        if model.params is None:
            model.init()
        self.model = model
        self.mesh = mesh
        self.sub = mesh.sub(axes)
        self.is_graph = isinstance(model, ComputationGraph)
        self.R = self.sub.size
        self.compress = bool(compress)
        self.sharded_update = bool(sharded_update)
        self.threshold = float(threshold)
        self._build_plan()
        self.exchange = GradExchange(self._entries, self.sub, self.threshold)
        self._opt_flat = None
        self._residual = None
        self.active = False
        self._record_comm()
        model._dp_runner = self   # checkpoints find the active exchange here

    # -- plan ---------------------------------------------------------------
    def _keys(self):
        m = self.model
        if self.is_graph:
            return [k for k in m.topo_order if m._trainable(k)]
        return list(range(len(m.layers)))

    def _cfg(self, key):
        return self.model.rt[key].config if self.is_graph else self.model.layers[key]

    def _build_plan(self):
        from deeplearning4j_tpu_torch.utils.tree import tree_leaves

        model = self.model
        entries: Dict[Any, _Entry] = {}
        for key in self._keys():
            leaves = tree_leaves(model.params[key])
            if not leaves:
                continue
            cfg = self._cfg(key)
            n = sum(int(l.numel()) for l in leaves)
            dtypes = {l.dtype for l in leaves}
            uniform_float = len(dtypes) == 1 and next(iter(dtypes)).is_floating_point
            eligible = uniform_float and not getattr(cfg, "gradient_normalization", None)
            if eligible and self.sharded_update:
                mode = "sharded"
            elif eligible and self.compress:
                mode = "replicated"      # compressed exchange, replicated update
            else:
                mode = "dense"           # exact mean all-reduce (gn, mixed dtypes)
            m = -(-n // self.R)
            entries[key] = _Entry(
                key=key, shapes=tuple(tuple(l.shape) for l in leaves), n=n, m=m,
                n_pad=m * self.R, dtype=next(iter(dtypes)) if uniform_float else None,
                mode=mode, compress=self.compress and eligible,
                updater=model._updaters[key], cfg=cfg)
        self._entries = entries

    def comm_stats(self) -> dict:
        """Per-step bytes of the gradient exchange, per rank: ``dense_bytes``
        what a dense all-reduce of every exchanged gradient would move,
        ``wire_bytes`` what this configuration moves for gradients,
        ``param_bytes`` the sharded update's all-gather of updated params."""
        dense = wire = param = 0
        for e in self._entries.values():
            itemsize = (torch.tensor([], dtype=e.dtype).element_size()
                        if e.dtype is not None else 4)
            nbytes = e.n * itemsize
            dense += nbytes
            wire += compression.packed_nbytes(e.n_pad) if e.compress else nbytes
            if e.mode == "sharded":
                param += nbytes
        return {"dense_bytes": dense, "wire_bytes": wire, "param_bytes": param,
                "n_entries": len(self._entries),
                "compressed_entries": sum(e.compress for e in self._entries.values()),
                "sharded_entries": sum(e.mode == "sharded" for e in self._entries.values())}

    def _record_comm(self):
        from deeplearning4j_tpu_torch.utils import bucketing

        s = self.comm_stats()
        bucketing.telemetry().record_comm(self.COMM_SITE, s["dense_bytes"],
                                          s["wire_bytes"], s["param_bytes"])

    # -- the updater state's layout -----------------------------------------
    def _template(self, e: _Entry):
        return e.updater.init(torch.zeros((e.m,), dtype=e.dtype, device=self.model.device))

    def _to_flat_opt(self, e: _Entry, structured):
        """The model's updater state of one entry -> this rank's ``[m]``
        slice of each flat statistic (the state is params-parallel: its
        leaves come in groups of ``len(e.shapes)``)."""
        from deeplearning4j_tpu_torch.utils.tree import tree_leaves, tree_unflatten_like

        leaves = tree_leaves(structured)
        k = len(e.shapes)
        if leaves and len(leaves) % k:
            raise ValueError(f"updater state of {e.key} has {len(leaves)} leaves, not a "
                             f"multiple of its {k} params: cannot flatten")
        i, m = self.sub.index, e.m
        stats = [_pad_flat(torch.cat([l.reshape(-1) for l in leaves[j:j + k]]), e.n_pad)
                 [i * m:(i + 1) * m].clone() for j in range(0, len(leaves), k)]
        return tree_unflatten_like(self._template(e), stats)

    def _from_flat_opt(self, e: _Entry, flat_entry, like):
        """Inverse of :meth:`_to_flat_opt` (a collective): the whole
        statistics gathered and cut back into ``like``'s structure."""
        from deeplearning4j_tpu_torch.utils.tree import tree_leaves, tree_unflatten_like

        out = []
        for leaf in tree_leaves(flat_entry):
            full = torch.cat(comm.all_gather(leaf, self.sub))[:e.n]
            out += _unflat_leaves(full, e.shapes)
        return tree_unflatten_like(like, out)

    def _structured(self):
        """The model's updater state with the sharded entries gathered."""
        model = self.model
        out = dict(enumerate(model.opt_state)) if not self.is_graph else dict(model.opt_state)
        for key, e in self._entries.items():
            out[key] = (self._from_flat_opt(e, self._opt_flat[key], model.opt_state[key])
                        if e.mode == "sharded" else self._opt_flat[key])
        return out if self.is_graph else tuple(out[k] for k in range(len(out)))

    def begin(self):
        """Enter the exchange's layout: the sharded entries' updater state
        becomes this rank's flat slices; residuals start at zero (or from a
        checkpoint's, parked on the model)."""
        if self.active:
            return
        model = self.model
        model.init_opt_state()
        self._opt_flat = {k: (self._to_flat_opt(e, model.opt_state[k])
                              if e.mode == "sharded" else model.opt_state[k])
                          for k, e in self._entries.items()}
        if self._residual is None:
            self._residual = {k: (torch.zeros((e.n_pad,), dtype=torch.float32,
                                              device=model.device) if e.compress else None)
                              for k, e in self._entries.items()}
        pending = getattr(model, "_pending_residuals", None)
        if pending:
            self.load_residuals(pending)
            model._pending_residuals = None
        self.active = True

    def finish(self):
        """Leave the exchange's layout: the model's updater state is whole
        again (a collective); the residuals stay on the runner."""
        if not self.active:
            return
        self.model.opt_state = assign_leaves(self.model.opt_state, self._structured())
        self._opt_flat = None
        self.active = False

    def snapshot_opt_state(self):
        """The model-structured updater state as of now, without leaving the
        layout (a collective): what a checkpoint taken mid-fit records."""
        return self._structured() if self.active else self.model.opt_state

    def export_residuals(self) -> Dict[str, np.ndarray]:
        """Every rank's residuals as host ``[R, n_pad]`` arrays keyed by
        ``str(entry key)`` (a collective); empty when nothing compresses."""
        if self._residual is None:
            return {}
        return {str(k): torch.stack(comm.all_gather(v, self.sub)).cpu().numpy()
                for k, v in self._residual.items() if v is not None}

    def load_residuals(self, arrays: Dict[str, np.ndarray]):
        """This rank's row of a checkpoint's ``[R, n_pad]`` residuals; an
        entry the arrays lack starts at zero."""
        dev = self.model.device
        res = {}
        for k, e in self._entries.items():
            if not e.compress:
                res[k] = None
                continue
            a = arrays.get(str(k))
            res[k] = (torch.zeros((e.n_pad,), dtype=torch.float32, device=dev) if a is None
                      else torch.as_tensor(np.asarray(a, np.float32).reshape(self.R, e.n_pad)
                                           [self.sub.index]).to(dev))
        self._residual = res

    def reload(self):
        """Re-enter the layout around reloaded model state (a rollback's
        restore with new updaters): a new plan, then ``begin``."""
        self.active = False
        self._opt_flat = None
        self._build_plan()
        self.exchange = GradExchange(self._entries, self.sub, self.threshold)
        self.begin()

    # -- the step -----------------------------------------------------------
    @property
    def aot_site(self) -> "aot.AotFunction":
        """This runner's ``dp.step`` site (``nn/aot.py``): the signatures its
        step took (``fit_batch``'s arguments; ``aot.warm_dp`` warms them),
        counted against ``dp.fit``'s bucket traffic. Another runner, another
        step: the site is the runner's."""
        site = self.__dict__.get("_aot_site")
        if site is None:
            if self.is_graph:
                call = lambda f, l, fm, lm, ew: self.fit_batch_graph((f, l, fm, lm), ew=ew)  # noqa: E731
            else:
                call = self.fit_batch
            site = self._aot_site = aot.wrap(call, "dp.step", self.model, stateful=True,
                                             replay=False, hits_site="dp.fit")
        return site

    def _run(self, value_and_grad):
        """One step under the donation guard, then the retrace-guard check."""
        loss = guarded_step("dp.step", self.model, self._step, value_and_grad)
        self.aot_site.guard()
        return loss

    def _step(self, value_and_grad):
        from deeplearning4j_tpu_torch.nn.model import _write_state

        model = self.model
        if not self.active:
            self.begin()
        with use_mesh(self.mesh):
            loss, new_state, grads = value_and_grad()
        keys = list(self._entries)
        params = {k: model.params[k] for k in keys}
        g = {k: grads[k] for k in keys}
        new_p, self._opt_flat, self._residual = self.exchange.update(
            g, params, self._opt_flat, self._residual, model.iteration)
        if self.is_graph:
            model.params = dict(model.params, **new_p)
        else:
            model.params = tuple(new_p.get(i, p) for i, p in enumerate(model.params))
        model.state = _write_state(model.state, new_state)
        model.iteration += 1
        return self.exchange.mean_loss(loss)

    def fit_batch(self, x, y, fm, lm, ew=None):
        """One MultiLayerNetwork step on this rank's rows."""
        from deeplearning4j_tpu_torch.nn.model import _cast_labels, _cast_mask
        from deeplearning4j_tpu_torch.train import resilience

        model = self.model
        self.aot_site.note_seen(x, y, fm, lm, ew)
        chaos = resilience.active_chaos()
        if chaos is not None:
            chaos.maybe_preempt(model.iteration)
            chaos.maybe_slow(model.iteration)
            x = chaos.maybe_nan_batch(model.iteration, x)
        dt, dev = model.dtype, model.device
        args = (model._features(x), _cast_labels(y, dt, dev), _cast_mask(fm, dt, dev),
                _cast_mask(lm, dt, dev), _cast_mask(ew, dt, dev))
        with obs.span("dp.step"):
            return self._run(lambda: model._value_and_grad(model.state, *args)[:3])

    def fit_batch_graph(self, batch, ew=None):
        """One ComputationGraph step on this rank's ``(f, l, fm, lm)``."""
        from deeplearning4j_tpu_torch.nn.model import _cast_mask
        from deeplearning4j_tpu_torch.train import resilience

        model = self.model
        self.aot_site.note_seen(*batch, ew)
        f, l, fm, lm = model._as_multi_batch(batch)
        chaos = resilience.active_chaos()
        if chaos is not None:
            chaos.maybe_preempt(model.iteration)
            chaos.maybe_slow(model.iteration)
            f = chaos.maybe_nan_batch(model.iteration, f)
        inputs, labels, fms, lms = model._to_device(f, l, fm, lm)
        ewt = _cast_mask(ew, model.dtype, model.device)
        with obs.span("dp.step"):
            return self._run(lambda: model._value_and_grad(
                model.state, inputs, labels, fms, lms, ewt)[:3])
