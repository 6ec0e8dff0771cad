"""Tensor parallelism and the sharded trainer (the PyTorch port of
``parallel/tp.py``) over the ``data``, ``model`` and ``seq`` axes of a
mesh.

In the JAX package ``tp_param_shardings`` maps each param to a
PartitionSpec over the ``model`` axis (Megatron's column-parallel
in-projections and row-parallel out-projections, the expert axis of a
MixtureOfExperts) and GSPMD turns the one jitted step into a program over
the mesh. :func:`tp_param_shardings` keeps those rules and returns them as
tuples in the params' structure (``(None, "model")`` where JAX has
``P(None, "model")``). :class:`ShardedTrainer` writes out the program GSPMD
would make (SPMD over ``torch.distributed``, one process per rank):

- params are broadcast from rank 0, then each rank keeps its shard of every
  param the rules shard over ``model``; a dimension the ``model`` axis does
  not divide stays whole (GSPMD would pad it). ``Wqkv`` / ``bqkv`` shard by
  heads: a rank holds its heads' columns of each of q, k and v (three
  strided pieces), which is the layout the attention layer reads. The
  layers see their shards through the active mesh and run the collectives
  of ``parallel/comm.py`` themselves (``nn/layers/attention.py``,
  ``moe.py``, ``core.py``): attention on ``H / model`` local heads with a
  row-parallel ``Wo``, the FFN column- then row-parallel, each rank's
  experts combined by a SUM all-reduce, large dense / output weights
  column-sharded with their outputs gathered before the loss, embeddings
  feature-sharded and gathered. Updater state is sharded like its params;
  gradient normalization of a layer takes its norm over every shard (each
  sharded leaf's sum of squares all-reduced over ``model``);
  layer state (BatchNorm's statistics) is replicated and its batch
  statistics are those of the global batch (``nn/layers/normalization.py``);
- every rank is given the global batch in :meth:`ShardedTrainer.fit_batch`
  and keeps its rows (its ``data`` coordinate) and, with a ``seq`` axis,
  its time chunk (its ``seq`` coordinate); attention layers with
  ``sequence_parallel=True`` then run ring attention over ``seq`` (on their
  local heads under a ``model`` axis) and the positional embedding adds the
  chunk's positions. A layer that mixes time steps otherwise (an LSTM)
  all-gathers the time axis, runs the whole sequence and keeps its chunk,
  which is what GSPMD does; attention without ``sequence_parallel`` is
  refused under ``seq``, as before;
- each rank scales its loss so that a SUM all-reduce over ``data x seq``
  gives ``losses.average_score`` of the global batch: per-example sums over
  the global B, or with a [B, T] mask on a rank-3 output over the global
  mask sum; regularisation is counted once per ``model`` rank;
- the gradients go through one all-reduce per dtype over ``data x seq``,
  as one flat bucket; every ``model`` rank's replicated params receive the
  same gradient, so the ranks keep bit-equal copies; a ``pipe`` axis holds
  replicas that see the same rows.

:meth:`ShardedTrainer.gathered_params` gathers the shards back into the
JAX package's layout and :meth:`ShardedTrainer.to_model` returns an
ordinary single-device MultiLayerNetwork, which is what a checkpoint zip
should hold: the trained model's own params are its shards.
"""

from __future__ import annotations

from typing import Optional

import torch

from deeplearning4j_tpu_torch.parallel import comm
from deeplearning4j_tpu_torch.parallel.context import use_mesh
from deeplearning4j_tpu_torch.parallel.distributed import (
    global_array,
    process_count,
    replicate_global,
)

__all__ = ["ShardedTrainer", "TP_DENSE_SHARD_MIN_ELEMS", "tp_param_shardings"]

# Dense/output weight matrices at or above this element count shard
# column-wise over the model axis (the JAX package's threshold).
TP_DENSE_SHARD_MIN_ELEMS = 1 << 16

# layer types that act on each time step alone (and so take a time chunk),
# attention only with sequence_parallel=True
_TIME_LOCAL = {"embedding_sequence", "positional_embedding", "layer_norm", "rnn_output",
               "dropout", "activation", "multi_head_attention", "transformer_block",
               "mixture_of_experts", "dense", "batch_norm"}
_ATTENTION = ("multi_head_attention", "transformer_block")


def _type(layer) -> str:
    return getattr(layer, "_type_name", "")


def _spec_for(layer, pname: str, value, model_axis: str,
              dense_shard_min_elems: int = TP_DENSE_SHARD_MIN_ELEMS) -> tuple:
    """The TP spec of one param of one layer (``()``: replicated)."""
    t = _type(layer)
    if t == "multi_head_attention":
        return {"Wqkv": (None, model_axis), "bqkv": (model_axis,),
                "Wo": (model_axis, None)}.get(pname, ())
    if t == "transformer_block":
        return {"Wi": (None, model_axis), "bi": (model_axis,),
                "Wo": (model_axis, None)}.get(pname, ())
    if t == "mixture_of_experts":
        return (model_axis,) if pname in ("Wi", "bi", "Wo", "bo") else ()
    if t in ("dense", "output") and pname == "W" and value.numel() >= dense_shard_min_elems:
        return (None, model_axis)
    if t in ("embedding", "embedding_sequence") and pname == "W":
        return (None, model_axis)
    return ()


def _walk_specs(layer, params, mesh_shape, model_axis, dense_shard_min_elems):
    """{name: spec} for one layer's params, nested subtrees resolved through
    the owner's ``nested_param_layers``; an expert axis that the model axis
    does not divide raises (it would change the routing capacity)."""
    out = {}
    for name, v in params.items():
        if isinstance(v, dict):
            inner = layer.nested_param_layers().get(name, layer)
            out[name] = _walk_specs(inner, v, mesh_shape, model_axis, dense_shard_min_elems)
            continue
        spec = _spec_for(layer, name, v, model_axis, dense_shard_min_elems)
        if _type(layer) == "mixture_of_experts":
            for dim, ax in enumerate(spec):
                if ax is None:
                    continue
                size, n = v.shape[dim], mesh_shape[ax]
                if size % n:
                    raise ValueError(
                        f"TP sharding: {type(layer).__name__}.{name} dim {dim} (size "
                        f"{size}) is not divisible by mesh axis '{ax}' ({n}) — make "
                        f"n_experts a multiple of the '{ax}' axis")
        out[name] = spec
    return out


def tp_param_shardings(model, mesh, model_axis: str = "model",
                       dense_shard_min_elems: int = TP_DENSE_SHARD_MIN_ELEMS):
    """The TP spec of every param of a MultiLayerNetwork, in the params'
    structure (a tuple of per-layer dicts): ``(None, "model")``,
    ``("model",)``, ``("model", None)`` or ``()``, leaf for leaf the
    JAX package's ``NamedSharding.spec``. Raises for a MixtureOfExperts
    whose expert count the model axis does not divide."""
    if model.params is None:
        model.init()
    return tuple(_walk_specs(l, p, mesh.shape, model_axis, dense_shard_min_elems)
                 for l, p in zip(model.layers, model.params))


# -- the shard layout ----------------------------------------------------------

def _layout(layer, name, value, spec, m, model_axis="model"):
    """How a param splits over ``m`` model ranks: None (whole), ("qkv",)
    (its heads' columns of each of q, k and v) or ("dim", d)."""
    if m == 1 or model_axis not in spec:
        return None
    d = spec.index(model_axis)
    if _type(layer) == "multi_head_attention":   # by heads, or not at all
        if layer.n_heads % m:
            return None
        return ("qkv",) if name in ("Wqkv", "bqkv") else ("dim", d)
    return ("dim", d) if value.shape[d] % m == 0 else None


def _layouts(model, mesh):
    specs = tp_param_shardings(model, mesh)
    m = mesh.shape["model"]

    def walk(layer, params, lspecs):
        out = {}
        for name, v in params.items():
            if isinstance(v, dict):
                out[name] = walk(layer.nested_param_layers().get(name, layer), v, lspecs[name])
            else:
                out[name] = _layout(layer, name, v, lspecs[name], m)
        return out

    return tuple(walk(l, p, s) for l, p, s in zip(model.layers, model.params, specs))


def _shard(value, lay, m, r):
    if lay is None:
        return value
    if lay[0] == "qkv":
        parts = value.chunk(3, dim=-1)
        return torch.cat([p.chunk(m, dim=-1)[r] for p in parts], dim=-1).clone()
    return value.chunk(m, dim=lay[1])[r].clone()


def _unshard(parts, lay):
    """The full param from every model rank's shard, in rank order."""
    if lay[0] == "qkv":
        per = [p.chunk(3, dim=-1) for p in parts]
        return torch.cat([torch.cat([q[i] for q in per], dim=-1) for i in range(3)], dim=-1)
    return torch.cat(parts, dim=lay[1])


def _map_layouts(fn, tree, layouts):
    """``fn(leaf, layout)`` over a param-shaped tree (dicts of tensors)."""
    if isinstance(tree, dict):
        return {k: _map_layouts(fn, v, layouts[k]) for k, v in tree.items()}
    return fn(tree, layouts)


def _map_opt(fn, opt_layer, layouts):
    """``fn(leaf, layout)`` over one layer's updater state: each slot is a
    params-shaped tree; anything else stays as it is."""
    if not isinstance(opt_layer, dict):
        return opt_layer
    out = {}
    for slot, tree in opt_layer.items():
        try:
            out[slot] = _map_layouts(fn, tree, layouts)
        except (KeyError, TypeError):
            out[slot] = tree
    return out


def _has_shards(layouts) -> bool:
    if isinstance(layouts, dict):
        return any(_has_shards(v) for v in layouts.values())
    return layouts is not None


class ShardedTrainer:
    """Drives a MultiLayerNetwork's training step over a ``data x model x
    seq`` mesh (see the module docstring). ``shard_time``: cut the time
    axis over ``seq`` (the port needs it whenever the mesh has a seq
    axis)."""

    def __init__(self, model, mesh, *, shard_time: bool = True):
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
        replicate_global(mesh, model.params)
        replicate_global(mesh, model.state)
        if model.opt_state is not None:
            replicate_global(mesh, model.opt_state)
        self._grad_sub = mesh.sub(("data", "seq"))
        self._tp = mesh.sub("model")
        self._seq = mesh.sub("seq")
        self.layouts = _layouts(model, mesh)
        if self._tp.size > 1:
            self._place()

    def _place(self):
        m = self.model
        n, r = self._tp.size, self._tp.index
        shard = lambda v, lay: _shard(v, lay, n, r)
        with torch.no_grad():
            m.params = tuple(_map_layouts(shard, p, lay)
                             for p, lay in zip(m.params, self.layouts))
            if m.opt_state is not None:
                m.opt_state = tuple(_map_opt(shard, o, lay)
                                    for o, lay in zip(m.opt_state, self.layouts))

    def _check_time_local(self, shard_time: bool):
        m = self.model
        if not shard_time:
            raise ValueError("with a seq axis the port's SPMD trainer cuts the time axis "
                             "over it: shard_time=False would run each rank's attention "
                             "over the whole sequence")
        if not m.conf.input_type or not getattr(m.conf.input_type, "timesteps", None):
            raise ValueError("a seq axis needs a model with a sequence input (a time axis)")
        for layer, it in zip(m.layers, m.layer_input_types):
            name = _type(layer) or type(layer).__name__
            if name in _ATTENTION and not layer.sequence_parallel:
                raise ValueError(
                    f"layer {name} mixes time steps and cannot take a time chunk of a "
                    f"seq axis: attention needs sequence_parallel=True (ring attention)")
            if name not in _TIME_LOCAL:
                out = layer.output_type(it)
                if out.kind != "recurrent" or out.timesteps != it.timesteps:
                    raise ValueError(
                        f"layer {name} does not keep the time axis, so its input "
                        f"cannot be cut over a seq axis")

    def _mixes_time(self, layer) -> bool:
        return self.shard_time and (_type(layer) or type(layer).__name__) not in _TIME_LOCAL

    # -- the batch ----------------------------------------------------------
    def _shard_rows(self, arr):
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
            total = comm.all_reduce(out_mask.sum().float(), self._grad_sub)
            return local / torch.clamp_min(total, 1.0)
        return b_local / b_global

    def _forward(self, params, x, fmask, ex_weight, train=True, upto=None):
        """The forward through the first ``upto`` layers (all but the output
        layer by default): the model's ``_forward`` with the seq gather
        around layers that mix time steps. Returns (act, new_state, mask)."""
        m = self.model
        rng = m._gen if train else None
        a = m._features(x)
        mask = fmask
        new_state = list(m.state)
        for i in range(len(m.layers) - 1 if upto is None else upto):
            layer, p_i = m.layers[i], params[i]
            if train and layer.weight_noise:
                p_i = layer.maybe_weight_noise(p_i, True, rng)
            kw = {}
            if ex_weight is not None and getattr(layer, "CONSUMES_EXAMPLE_WEIGHT", False):
                kw["ex_weight"] = ex_weight
            if self._mixes_time(layer):
                sub, T = self._seq, a.shape[1]
                full = comm.gather_dim(a, 1, sub, grad="sum")
                fm = torch.cat(comm.all_gather(mask, sub), 1) if mask is not None else None
                out, new_state[i] = layer.apply(p_i, m.state[i], full, train=train, rng=rng,
                                                mask=fm, **kw)
                a = out.narrow(1, sub.index * T, T)
            else:
                a, new_state[i] = layer.apply(p_i, m.state[i], a, train=train, rng=rng,
                                              mask=mask, **kw)
            mask = layer.propagate_mask(mask, m.layer_input_types[i])
        return a, tuple(new_state), mask

    def _penalty(self, params):
        m = self.model
        return sum(l.regularization_penalty(p) for l, p in zip(m.layers, params))

    def value_and_grad(self, x, y, fm, lm, ew, b_global):
        """This rank's loss share and gradients on its local rows (device
        tensors), all-reduced over ``data x seq``: (global loss, new layer
        state, the gradient tree of this rank's params)."""
        from deeplearning4j_tpu_torch.utils.tree import (
            tree_leaves, tree_map, tree_unflatten_like)

        m = self.model
        leaves = tree_leaves(m.params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        params = tree_unflatten_like(m.params, live)
        with use_mesh(self.mesh):
            a, new_state, prop_mask = self._forward(params, x, fm, ew)
            out_mask = lm if lm is not None else prop_mask
            loss = m.layers[-1].score(params[-1], a, y, mask=out_mask, average=True)
            scale = self._loss_scale(a, out_mask, x.shape[0], b_global)
        if not (isinstance(scale, float) and scale == 1.0):
            loss = loss * (scale.to(loss.dtype) if isinstance(scale, torch.Tensor) else scale)
        reported = None
        if self._grad_sub.index == 0:   # the penalties once per model rank
            pen = self._penalty(params)
            loss = loss + pen
            if self._tp.size > 1 and isinstance(pen, torch.Tensor) and any(
                    _has_shards(l) for l in self.layouts):
                with torch.no_grad():   # the loss reports the whole params' penalty
                    reported = loss.detach() - pen.detach() + self._penalty(
                        self.gathered_params())
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        loss = (reported if reported is not None else loss).detach()
        if self._grad_sub.size > 1:
            loss, *grads = _all_reduce_sum([loss] + grads, self._grad_sub)
        new_state = tree_map(lambda s: s.detach(), new_state)
        return loss, new_state, tree_unflatten_like(m.params, grads)

    def fit_batch(self, x, y, fmask=None, lmask=None):
        """One training step on the global batch (every rank passes the same
        arrays); returns the global loss (a device scalar, equal on every
        rank)."""
        from deeplearning4j_tpu_torch.nn.model import _cast_labels, _cast_mask

        m = self.model
        b_global = x.shape[0]
        xs, ys, fms, lms = (self._shard_rows(a) for a in (x, y, fmask, lmask))
        loss, new_state, grads = self.value_and_grad(
            m._features(xs), _cast_labels(ys, m.dtype, m.device),
            _cast_mask(fms, m.dtype, m.device), _cast_mask(lms, m.dtype, m.device),
            None, b_global)
        m._apply_step(loss, new_state, grads,
                      norm_sumsq=self._norm_sumsq if self._tp.size > 1 else None)
        m.iteration += 1
        return loss

    def _norm_sumsq(self, i: int):
        """Layer ``i``'s per-leaf sums of squares for gradient normalization
        (``train/updaters.py`` ``apply_gradient_normalization``): a sharded
        leaf's local sum all-reduced over ``model``, a replicated leaf's
        counted once. The JAX package gets the same global norm from
        GSPMD."""
        tp = self._tp

        def sq(g, lay):
            # f32 partial sums, rounded to the grads' dtype once after the
            # all-reduce, as the one-process sum is rounded once
            s = torch.sum(g * g, dtype=torch.float32)
            return (s if lay is None else comm.all_reduce(s, tp)).to(g.dtype)

        return lambda grads: _map_layouts(sq, grads, self.layouts[i])

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

    # -- back to whole arrays --------------------------------------------
    def _gather_tree(self, tree, layouts):
        tp = self._tp
        return _map_layouts(
            lambda v, lay: v if lay is None else _unshard(comm.all_gather(v, tp), lay),
            tree, layouts)

    def gathered_params(self):
        """The whole params (every rank the same, the JAX package's layout):
        the model ranks' shards gathered. A collective over ``model``."""
        m = self.model
        if self._tp.size == 1:
            return m.params
        with torch.no_grad():
            return tuple(self._gather_tree(p, lay) for p, lay in zip(m.params, self.layouts))

    def to_model(self):
        """An ordinary MultiLayerNetwork on this rank's device with the
        whole params, updater state and layer state, the step counters
        copied (what a checkpoint zip holds). A collective over ``model``."""
        from deeplearning4j_tpu_torch.nn.model import MultiLayerNetwork
        from deeplearning4j_tpu_torch.utils.tree import tree_map

        m = self.model
        out = MultiLayerNetwork(m.conf, device=m.device)
        out.params = tuple(tree_map(lambda t: t.detach().clone(), p)
                           for p in self.gathered_params())
        out.state = tree_map(lambda t: t.clone(), m.state)
        out._build_updaters()
        if m.opt_state is not None:
            with torch.no_grad():
                out.opt_state = tuple(
                    _map_opt(lambda v, lay: v.clone() if lay is None else _unshard(
                        comm.all_gather(v, self._tp), lay), o, lay)
                    for o, lay in zip(m.opt_state, self.layouts))
        out.iteration, out.epoch = m.iteration, m.epoch
        return out

    def output(self, x):
        """The network's output on the global batch ``x``: each rank runs its
        shard (ring attention across the seq axis, its heads under a model
        axis) and the shards are gathered back into the global [B, T, ...]
        on every rank."""
        m = self.model
        with use_mesh(self.mesh), torch.inference_mode():
            local = self._forward(m.params, self._shard_rows(x), None, None, train=False,
                                  upto=len(m.layers))[0]
        if process_count() == 1:
            return local
        with torch.inference_mode():
            world = self.mesh.sub(("data", "model", "seq", "pipe"))
            parts = comm.all_gather(local.contiguous(), world)
            grid = self.mesh.devices
            rows = []
            for di in range(grid.shape[0]):
                chunks = [parts[world.ranks.index(int(grid[di, 0, si, 0]))]
                          for si in range(grid.shape[2])]
                rows.append(torch.cat(chunks, dim=1) if self.shard_time else chunks[0])
            return torch.cat(rows, dim=0)


def _all_reduce_sum(tensors, sub):
    """SUM all-reduce of a list of tensors over ``sub``, one flat bucket per
    dtype; returns new tensors in the same order."""
    out = list(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        comm.all_reduce(flat, sub)
        at = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[at:at + n].view_as(tensors[i])
            at += n
    return out
