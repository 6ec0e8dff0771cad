"""Sequential model: MultiLayerConfiguration + MultiLayerNetwork (PyTorch).

Counterpart of ``deeplearning4j_tpu/nn/model.py`` (DL4J's
MultiLayerNetwork / MultiLayerConfiguration). The configuration class is
the same and reads and writes the same JSON, ``"format"`` tag included.
The network keeps the JAX package's surface: ``params`` is a tuple of
per-layer dicts of tensors (same keys, shapes and layouts), ``state`` a
tuple of per-layer dicts, ``opt_state`` a tuple of per-layer updater
states (None until the first update needs it), and ``output`` pads a
batch's rows up the shared bucket ladder before the forward pass and
slices them back.

Training: ``fit`` walks epochs and minibatches (a partial tail batch is
padded to the full row count, its padded rows weighted out of the loss),
and each step is forward, ``torch.autograd.grad`` of the average score
plus L1/L2 penalties, then per layer gradient normalization, the updater
and the constraints. Where the JAX step donates its buffers, the port
updates params in place under ``torch.no_grad()``. Around the step, as in
the reference: ``fit(resume_from=)`` (train/resilience.py, exact resume
from the newest valid checkpoint), ``set_divergence_guard`` (skip_batch
selects old or new values on the device), the chaos hooks, chained K-step
dispatch (``DL4J_TPU_CHAIN_STEPS``, off by default; ``auto`` chains small
models that draw no randomness),
three synchronised phases under spans (``DL4J_TPU_PHASE_SPANS=1``), device
prefetch of the next batch on a side stream (``DL4J_TPU_DEVICE_PREFETCH=1``,
off by default), the tuning DB's winner (``DL4J_TPU_TUNE=auto``,
``tune.maybe_apply``), the first step warmed on a snapshot
(``DL4J_TPU_AOT=1``, ``nn/aot.py``; the dispatch sites ``mln.output``,
``mln.step`` and ``mln.step.tbptt`` record their signatures for it),
``DataSet`` input, and the non-SGD solvers (train/solvers.py) when
``optimization_algo`` names one. ``score``, ``evaluate``,
``evaluate_regression`` and ``evaluate_roc`` are here too.

Recurrent state: layers with a carry (``BaseRecurrent.SUPPORTS_CARRY``)
take their carries through ``_forward``. With ``backprop_type="tbptt"``
``fit`` cuts a 3-D batch's time axis into ``tbptt_fwd_length`` chunks and
takes one update per chunk, carrying the RNN state across chunks detached
(the truncation); ``rnn_time_step`` feeds one or more steps at a time and
keeps the carries on the model's device between calls.

The network lives on one device, chosen at construction: ``device=None``
means the GPU, and raises when there is none; ``device="cpu"`` must be
asked for. The training RNG is a ``torch.Generator`` on that device,
seeded from ``conf.seed``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.nn import aot
from deeplearning4j_tpu_torch.nn.config import LayerConfig, _encode_value, layer_from_dict
from deeplearning4j_tpu_torch.nn.constraints import apply_constraints
from deeplearning4j_tpu_torch.nn.input_type import InputType
from deeplearning4j_tpu_torch.nn.layers import BaseRecurrent, Embedding, EmbeddingSequence
from deeplearning4j_tpu_torch.nn.preprocessors import infer_preprocessor
from deeplearning4j_tpu_torch.nn.step_program import (
    accum_applicable,
    accum_value_and_grad,
    chain_batches,
    chain_k_from_env,
    grad_accum_from_env,
)
from deeplearning4j_tpu_torch.train.listeners import close_listeners
from deeplearning4j_tpu_torch.train.updaters import (
    apply_gradient_normalization,
    make_updater,
    scale_lr,
)
from deeplearning4j_tpu_torch.utils import bucketing
from deeplearning4j_tpu_torch.utils.tree import (
    assign_leaves,
    tree_leaves,
    tree_map,
    tree_unflatten_like,
)

__all__ = ["MultiLayerConfiguration", "MultiLayerNetwork", "resolve_device",
           "torch_dtype"]

_SGD_NAMES = ("stochastic_gradient_descent", "sgd")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the GPU unless the caller names
    another. With no GPU and no explicit device this raises; it never falls
    back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype string ("float32", "bfloat16", ...) as a torch dtype."""
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


@dataclass
class MultiLayerConfiguration:
    """Sequential-network config (MultiLayerConfiguration.java parity), the
    same fields and JSON as the JAX package's."""

    layers: Tuple[LayerConfig, ...] = ()
    input_type: Optional[InputType] = None
    seed: int = 12345
    updater: Any = "sgd"
    dtype: str = "float32"
    backprop_type: str = "standard"        # "standard" | "tbptt"
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
    optimization_algo: str = "stochastic_gradient_descent"
    solver_iterations: int = 5

    def __post_init__(self):
        self.layers = tuple(self.layers)

    # -- serde -------------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "format": "deeplearning4j_tpu/MultiLayerConfiguration",
            "version": 1,
            "layers": [l.to_dict() for l in self.layers],
            "input_type": self.input_type.to_dict() if self.input_type else None,
            "seed": self.seed,
            "updater": _encode_value(self.updater),
            "dtype": self.dtype,
            "backprop_type": self.backprop_type,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_back_length": self.tbptt_back_length,
            "optimization_algo": self.optimization_algo,
            "solver_iterations": self.solver_iterations,
        }

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @staticmethod
    def from_dict(d: dict) -> "MultiLayerConfiguration":
        return MultiLayerConfiguration(
            layers=tuple(layer_from_dict(ld) for ld in d["layers"]),
            input_type=InputType.from_dict(d["input_type"]) if d.get("input_type") else None,
            seed=d.get("seed", 12345),
            updater=d.get("updater", "sgd"),
            dtype=d.get("dtype", "float32"),
            backprop_type=d.get("backprop_type", "standard"),
            tbptt_fwd_length=d.get("tbptt_fwd_length", 20),
            tbptt_back_length=d.get("tbptt_back_length", 20),
            optimization_algo=d.get("optimization_algo", "stochastic_gradient_descent"),
            solver_iterations=d.get("solver_iterations", 5),
        )

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        return MultiLayerConfiguration.from_dict(json.loads(s))

    def to_yaml(self) -> str:
        from deeplearning4j_tpu_torch.nn.config import yaml_dump

        return yaml_dump(self.to_dict())

    @staticmethod
    def from_yaml(s: str) -> "MultiLayerConfiguration":
        from deeplearning4j_tpu_torch.nn.config import yaml_load

        return MultiLayerConfiguration.from_dict(yaml_load(s))


def _cast_input(x, dtype: torch.dtype, device: torch.device):
    """A feature array as a tensor on ``device`` in the model dtype,
    PRESERVING integer/bool dtypes (token ids must not round-trip through
    bf16 — ids above 256 would be corrupted) and float64 (kept at double
    precision on purpose)."""
    if x is None:
        return None
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    t = t.to(device)
    if t.is_floating_point() and t.dtype != torch.float64:
        return t.to(dtype)
    return t


def _cast_labels(y, dtype: torch.dtype, device: torch.device):
    """Labels on ``device``: integer (sparse class) labels stay integers as
    int64 — the loss head's sparse path needs them — anything else takes
    the model dtype."""
    if y is None:
        return None
    t = y if isinstance(y, torch.Tensor) else torch.as_tensor(np.asarray(y))
    t = t.to(device)
    if t.is_floating_point():
        return t.to(dtype)
    return t.to(torch.int64)


def _cast_mask(m, dtype: torch.dtype, device: torch.device):
    if m is None:
        return None
    t = m if isinstance(m, torch.Tensor) else torch.as_tensor(np.asarray(m))
    return t.to(device=device, dtype=dtype)


def _as_batch(batch):
    """A batch as (features, labels, features_mask, labels_mask): from an
    (x, y), (x, y, fmask) or (x, y, fmask, lmask) tuple, a dict with those
    keys, or a DataSet object."""
    if hasattr(batch, "as_tuple"):  # datasets.DataSet / MultiDataSet
        batch = batch.as_tuple()
    if isinstance(batch, dict):
        return (batch["features"], batch.get("labels"),
                batch.get("features_mask"), batch.get("labels_mask"))
    if isinstance(batch, (tuple, list)):
        x = batch[0]
        y = batch[1] if len(batch) > 1 else None
        fm = batch[2] if len(batch) > 2 else None
        lm = batch[3] if len(batch) > 3 else None
        return x, y, fm, lm
    return batch, None, None, None


def _is_arrays(data) -> bool:
    """(x, y[, masks]) arrays rather than an iterable of batches."""
    return (isinstance(data, (tuple, list)) and len(data) >= 2
            and not isinstance(data[0], (tuple, list, dict))
            and not hasattr(data[0], "as_tuple"))   # a list of DataSets


def _iter_batches(data, batch_size=None):
    """Yield (x, y, fmask, lmask) batches from (x, y[, masks]) arrays or a
    DataSet (minibatched when ``batch_size`` is given, the final partial
    batch included) or from any iterable of batches."""
    if hasattr(data, "as_tuple"):  # datasets.DataSet: unpack, then minibatch
        data = data.as_tuple()
    if _is_arrays(data):
        x, y, fm, lm = _as_batch(data)
        n = len(x)
        if batch_size is None or batch_size >= n:
            yield (x, y, fm, lm)
            return
        for i in range(0, n, batch_size):
            sl = slice(i, min(i + batch_size, n))
            yield tuple(a[sl] if a is not None else None for a in (x, y, fm, lm))
        return
    for b in data:
        yield _as_batch(b)


def _fit_pad_target(source, batch_size) -> Optional[int]:
    """The uniform per-batch row count of a fit over in-memory arrays whose
    length is not a multiple of ``batch_size`` (the tail is padded up to
    it), else None. Streaming iterables return None: their batch shapes are
    not known up front."""
    if hasattr(source, "as_tuple"):
        source = source.as_tuple()
    if batch_size is None or not _is_arrays(source):
        return None
    n = len(source[0])
    if n > batch_size and n % batch_size != 0:
        return batch_size
    return None


def _ndim(a) -> int:
    return a.dim() if isinstance(a, torch.Tensor) else np.ndim(a)


def _host(a) -> np.ndarray:
    """Labels as a host array (a tensor comes back from its device, 16-bit
    floats as float32)."""
    if isinstance(a, torch.Tensor):
        return (a.float() if a.is_floating_point() else a).cpu().numpy()
    return np.asarray(a)


def _device_prefetch_enabled() -> bool:
    """DL4J_TPU_DEVICE_PREFETCH=1 turns the device prefetch on. Off by
    default, unlike the JAX package: on the card its thread and page-locked
    copies made a host-bound LeNet-5 step slower (PERF.md)."""
    return os.environ.get("DL4J_TPU_DEVICE_PREFETCH", "0") == "1"


def _write_state(old, new, ok=None):
    """Layer state after a step (under ``ok``, the skip_batch select:
    ``new`` where ``ok``, else ``old``), written into ``old``'s tensors;
    returns the state tree. A leaf whose dtype the step widened (the f32
    running statistics of a float64 model's first step, which the JAX
    package's step widens as well) is rebound: that step creates it at its
    dtype."""
    old_leaves, new_leaves = tree_leaves(old), tree_leaves(new)
    if not old_leaves and not new_leaves:   # stateless layers: nothing to keep
        return old
    if ok is not None:
        new = tree_map(lambda n, o: torch.where(ok, n, o), new, old)
        new_leaves = tree_leaves(new)
    if all(o.dtype == n.dtype for o, n in zip(old_leaves, new_leaves)):
        return assign_leaves(old, new)
    return tree_map(lambda o, n: assign_leaves(o, n) if o.dtype == n.dtype else n, old, new)


def _select_into(ok, new, old):
    """The skip_batch select over a tree, written into ``old``'s tensors:
    ``new`` where ``ok`` (a device bool), else ``old``; returns ``old``."""
    for n, o in zip(tree_leaves(new), tree_leaves(old)):
        torch.where(ok, n, o, out=o)
    return old


class MultiLayerNetwork:
    """Model facade over the config's layer stack.

    Host state: ``params`` (tuple of per-layer dicts of tensors), ``state``
    (tuple of per-layer dicts), ``opt_state`` (tuple of per-layer updater
    states), ``iteration``/``epoch``, ``listeners``, ``device`` and
    ``dtype``.
    """

    def __init__(self, conf: MultiLayerConfiguration, device=None):
        if conf.input_type is None:
            raise ValueError("MultiLayerConfiguration.input_type is required")
        self.conf = conf
        self.device = resolve_device(device)
        self.dtype = torch_dtype(conf.dtype)
        self._resolve_layers()
        self.params = None
        self.state = None
        self.opt_state = None
        self.iteration = 0
        self.epoch = 0
        self.batch_in_epoch = 0
        self.listeners: list = []
        self._rnn_carries = None
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(conf.seed)
        self.divergence_guard = None
        self._lr_scale = 1.0
        self._solver = None

    # -- resolution: preprocessors + n_in inference + per-layer input types --
    def _resolve_layers(self):
        layers: List[LayerConfig] = []
        input_types: List[InputType] = []
        it = self.conf.input_type
        for layer in self.conf.layers:
            pre = infer_preprocessor(it, layer)
            if pre is not None:
                layers.append(pre)
                input_types.append(it)
                it = pre.output_type(it)
            if hasattr(layer, "with_n_in"):
                layer = layer.with_n_in(layer.infer_n_in(it))
            layers.append(layer)
            input_types.append(it)
            it = layer.output_type(it)
        self.layers: List[LayerConfig] = layers
        self.layer_input_types: List[InputType] = input_types
        self.output_type: InputType = it
        self._carry_flags = [isinstance(l, BaseRecurrent) and l.SUPPORTS_CARRY
                             for l in layers]

    # -- init --------------------------------------------------------------
    def init(self, seed: Optional[int] = None) -> "MultiLayerNetwork":
        """Draw every layer's params from one ``torch.Generator`` on the
        model's device, seeded from ``conf.seed`` (or ``seed``); build the
        per-layer updaters; reset the step counters. The updaters' state is
        built at the first update (or when a checkpoint's is loaded), so a
        model that only serves holds no optimizer moments."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.conf.seed if seed is None else seed)
        with torch.no_grad():
            self.params = tuple(
                l.init(gen, it, self.dtype, self.device)
                for l, it in zip(self.layers, self.layer_input_types))
            self.state = tuple(tree_map(lambda t: t.to(self.device), l.init_state(it))
                               for l, it in zip(self.layers, self.layer_input_types))
        self._build_updaters()
        self.opt_state = None
        self.iteration = 0
        self.epoch = 0
        return self

    def _build_updaters(self):
        """One updater per layer: the layer's own ``updater`` overrides the
        network default; frozen layers get ``noop``. Every rate is scaled by
        ``_lr_scale``, the divergence guard's rollback backoff (1.0 unless
        a rollback backed it off)."""
        scale = float(getattr(self, "_lr_scale", 1.0))
        default = scale_lr(self.conf.updater, scale)
        self._updaters = []
        for l in self.layers:
            if not getattr(l, "trainable", True):
                self._updaters.append(make_updater("noop"))
            elif getattr(l, "updater", None) is not None:
                self._updaters.append(make_updater(scale_lr(l.updater, scale)))
            else:
                self._updaters.append(make_updater(default))

    def set_divergence_guard(self, guard) -> "MultiLayerNetwork":
        """Install a train/resilience.DivergenceGuard (None to remove)."""
        self.divergence_guard = guard
        return self

    def uses_rng(self) -> bool:
        """Does a training step draw randomness (dropout, weight noise)?"""
        return any(l.uses_rng() for l in self.layers)

    def init_opt_state(self):
        """The per-layer updater state, built from the params on first use."""
        if self.opt_state is None:
            with torch.no_grad():
                self.opt_state = tuple(u.init(p) for u, p in zip(self._updaters, self.params))
        return self.opt_state

    @property
    def n_layers(self) -> int:
        """Resolved layers, auto-inserted preprocessors included."""
        return len(self.layers)

    def num_params(self) -> int:
        return sum(int(v.numel()) for v in tree_leaves(self.params))

    # -- forward -----------------------------------------------------------
    def _initial_carries(self, batch: int):
        """Zero carries for every carry layer (``()`` for the others)."""
        return tuple(l.initial_carry(batch, self.dtype, self.device) if f else ()
                     for l, f in zip(self.layers, self._carry_flags))

    def _forward(self, params, state, x, *, train: bool, rng=None, fmask=None,
                 carries=None, upto: Optional[int] = None, collect: bool = False,
                 ex_weight=None, deterministic: bool = False):
        """Walk the layer stack (the first ``upto`` layers). Returns (act,
        new_state, new_carries, mask, activations). With ``carries`` (one
        per layer, as ``_initial_carries`` makes them) the carry layers
        start from them and ``new_carries`` holds their final carries; else
        ``new_carries`` is None. ``ex_weight`` is a per-example [B] validity
        weight for layers that declare CONSUMES_EXAMPLE_WEIGHT.
        ``deterministic`` (``score(train=True)``): layers whose train-mode
        apply draws randomness run in eval mode, everything else keeps
        train-mode semantics."""
        n = len(self.layers) if upto is None else upto
        acts = []
        new_state = list(state)
        new_carries = list(carries) if carries is not None else None
        mask = fmask
        a = self._features(x)
        for i in range(n):
            layer = self.layers[i]
            ltrain = train and not (deterministic and layer.uses_rng())
            p_i = params[i]
            if ltrain and layer.weight_noise and rng is not None:
                p_i = layer.maybe_weight_noise(p_i, ltrain, rng)
            if new_carries is not None and self._carry_flags[i]:
                a = layer.maybe_dropout_input(a, ltrain, rng)
                a, new_carries[i] = layer.apply_seq(p_i, a, new_carries[i], mask)
            else:
                kw = {}
                if ex_weight is not None and getattr(layer, "CONSUMES_EXAMPLE_WEIGHT", False):
                    kw["ex_weight"] = ex_weight
                a, new_state[i] = layer.apply(p_i, state[i], a, train=ltrain, rng=rng,
                                              mask=mask, **kw)
            mask = layer.propagate_mask(mask, self.layer_input_types[i])
            if collect:
                acts.append(a)
        return (a, tuple(new_state),
                tuple(new_carries) if new_carries is not None else None, mask, acts)

    def _features(self, x):
        """A feature batch on the model's device (``_cast_input``). Ids from
        the host for an embedding first layer are range-checked here, before
        the copy, so that the layer's device gather never reads back."""
        if x is None:
            return None
        t = self._check_host_ids(x)
        return _cast_input(t, self.dtype, self.device)

    def _check_host_ids(self, x) -> torch.Tensor:
        """``x`` as a tensor, its ids range-checked when it lies on the host
        and the first layer embeds ids (a ValueError for an id outside the
        vocabulary). ``fit`` calls this before its prefetch copies a batch."""
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        first = self.layers[0] if self.layers else None
        if (t.device.type == "cpu" and self.params is not None
                and hasattr(first, "check_host_ids")):
            ids = t.to(self.dtype) if t.is_floating_point() and t.dtype != torch.float64 else t
            first.check_host_ids(ids, self.params[0]["W"].shape[0])
        return t

    def feed_forward(self, x, train: bool = False):
        """All layer activations (MultiLayerNetwork.feedForward); with
        ``train`` the layers run in train mode (dropout draws from the
        model's generator), as the reference's ``feed_forward(x, train)``."""
        with torch.inference_mode():
            return self._forward(self.params, self.state, x, train=train,
                                 rng=self._gen if train else None, collect=True)[4]

    # -- loss and the training step ----------------------------------------
    def _loss(self, params, state, x, y, fmask, lmask, rng, carries=None,
              train: bool = True, ex_weight=None, deterministic: bool = False):
        """Average score plus L1/L2 penalties; returns (loss, (new_state,
        new_carries))."""
        a, new_state, new_carries, prop_mask, _ = self._forward(
            params, state, x, train=train, rng=rng, fmask=fmask, carries=carries,
            upto=len(self.layers) - 1, ex_weight=ex_weight,
            deterministic=deterministic)
        out_layer = self.layers[-1]
        out_mask = lmask if lmask is not None else prop_mask
        loss = out_layer.score(params[-1], a, y, mask=out_mask, average=True)
        reg = sum(l.regularization_penalty(p) for l, p in zip(self.layers, params))
        return loss + reg, (new_state, new_carries)

    def _value_and_grad(self, state, x, y, fmask, lmask, ex_weight, carries=None):
        """Loss, new layer state, the gradient tree (the params' shape; zeros
        where a param does not reach the loss) and the final carries,
        detached (None without ``carries``), on one batch."""
        leaves = tree_leaves(self.params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        params = tree_unflatten_like(self.params, live)
        loss, (new_state, new_carries) = self._loss(
            params, state, x, y, fmask, lmask, self._gen, carries=carries,
            ex_weight=ex_weight)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        # layer state (BatchNorm's running statistics) carries no graph
        new_state = tree_map(lambda s: s.detach(), new_state)
        if new_carries is not None:
            new_carries = tree_map(lambda c: c.detach(), new_carries)
        return (loss.detach(), new_state, tree_unflatten_like(self.params, grads),
                new_carries)

    def _update_params(self, grads, ok=None, norm_sumsq=None):
        """The per-layer optimizer update (gradient normalization, updater,
        constraints), in place under ``torch.no_grad()``: params and updater
        state keep their tensors. With ``ok`` (the skip_batch guard's device
        bool) each layer's new params and updater state are computed out of
        place and ``torch.where(ok, new, old)`` is written back: a rejected
        update leaves both as they were.
        ``norm_sumsq(i)`` gives layer ``i``'s ``sumsq`` for gradient
        normalization (``apply_gradient_normalization``; the tensor-parallel
        trainer's norm spans the shards)."""
        self.init_opt_state()
        with torch.no_grad():
            for i, (u, layer) in enumerate(zip(self._updaters, self.layers)):
                p, g = self.params[i], grads[i]
                if not g:  # param-free layer
                    continue
                gn = getattr(layer, "gradient_normalization", None)
                if gn:
                    g = apply_gradient_normalization(
                        gn, getattr(layer, "gradient_normalization_threshold", 1.0), g,
                        sumsq=norm_sumsq(i) if norm_sumsq is not None else None)
                upd, new_s = u.update(g, self.opt_state[i], p, self.iteration,
                                      inplace=ok is None)
                if ok is None:
                    for pi, d in zip(tree_leaves(p), tree_leaves(upd)):
                        pi.sub_(d)
                    if getattr(layer, "constraints", None):
                        assign_leaves(p, apply_constraints(layer, p))
                else:
                    cand = tree_map(lambda a, d: a - d, p, upd)
                    if getattr(layer, "constraints", None):
                        cand = apply_constraints(layer, cand)
                    _select_into(ok, cand, p)
                    _select_into(ok, new_s, self.opt_state[i])

    def _apply_step(self, loss, new_state, grads, norm_sumsq=None):
        """Update params, updater state and layer state from one batch's
        gradients, under the skip_batch select when that guard is on."""
        g = self.divergence_guard
        if g is not None and g.policy == "skip_batch":
            from deeplearning4j_tpu_torch.train.resilience import guard_ok

            ok = guard_ok(loss, g.spike_limit)
            self._update_params(grads, ok, norm_sumsq)
        else:
            ok = None
            self._update_params(grads, norm_sumsq=norm_sumsq)
        self.state = _write_state(self.state, new_state, ok)

    def _step(self, x, y, fmask, lmask, ex_weight):
        """One training step on tensors already on the device; returns the
        loss as a device scalar."""
        accum = grad_accum_from_env()
        batch = (x, y, fmask, lmask, ex_weight)
        if accum_applicable(accum, batch):
            loss, new_state, grads = accum_value_and_grad(
                accum, self.params, self.state, batch,
                lambda mb, st: self._value_and_grad(st, *mb)[:3])
        else:
            loss, new_state, grads, _ = self._value_and_grad(self.state, *batch)
        self._apply_step(loss, new_state, grads)
        self.iteration += 1
        return loss

    def _fit_batch_phases(self, x, y, fm, lm, ew):
        """One training step as three synchronised phases under nested
        ``phase.fwd`` / ``phase.bwd`` / ``phase.update`` spans (inside the
        caller's ``mln.fit_batch`` span), each ending in
        ``torch.cuda.synchronize()`` on the card: the forward alone, the
        forward again with its backward (the price of splitting), then the
        update. The generator is set back between the two forwards, so both
        draw the same dropout masks, and the parameter math is the fused
        step's. A profiling mode (``DL4J_TPU_PHASE_SPANS=1``): the
        synchronisations forfeit overlap."""
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        sites = [aot.grid_site(self, s)
                 for s in ("mln.phase.fwd", "mln.phase.bwd", "mln.phase.update")]
        for s in sites:
            s.note_seen(x, y, fm, lm, ew)
        gen_state = self._gen.get_state()
        with obs.span("phase.fwd"):
            with torch.no_grad():
                self._loss(self.params, self.state, x, y, fm, lm, self._gen,
                           ex_weight=ew)
            sync()
        self._gen.set_state(gen_state)
        with obs.span("phase.bwd"):
            loss, new_state, grads, _ = self._value_and_grad(self.state, x, y, fm, lm, ew)
            sync()
        with obs.span("phase.update"):
            self._update_params(grads)
            sync()
        self.state = _write_state(self.state, new_state)
        self.iteration += 1
        for s in sites:
            s.guard()
        return loss

    # -- training ----------------------------------------------------------
    def set_listeners(self, *listeners):
        self.listeners = list(listeners)
        return self

    def _chain_k(self) -> int:
        """Steps chained per group in fit()'s loop (0 = per step, the
        default). DL4J_TPU_CHAIN_STEPS forces a count; "auto" chains 8 only
        for models that draw no randomness and hold fewer than
        ``CHAIN_AUTO_PARAM_LIMIT`` params (nn/step_program.py)."""
        return chain_k_from_env(self.uses_rng(), self.num_params())

    def fit(self, data, epochs: int = 1, batch_size: Optional[int] = None,
            resume_from=None):
        """Train. ``data``: (x, y[, fmask[, lmask]]) arrays or a DataSet
        (minibatched by ``batch_size``), an iterable of such batches, or a
        callable returning a fresh iterable per epoch. Over arrays whose
        length is not a multiple of ``batch_size`` the tail batch is padded
        to ``batch_size`` rows with tiled rows weighted out of the loss
        (DL4J_TPU_BUCKETING=0 turns that off); under tBPTT a 3-D batch is
        cut into time chunks instead, and its tail is not padded.

        ``resume_from``: a CheckpointListener directory. The newest VALID
        checkpoint is restored (params, updater and layer state, the
        generator's state, iteration and epoch, the batch position, the LR
        scale); ``epochs`` then counts the TOTAL budget (the epochs already
        done are subtracted) and the interrupted epoch skips the batches it
        already used, without drawing from the generator, so the resumed
        run ends with an uninterrupted run's bits.

        Chained steps (``_chain_k``, nn/step_program.py ``chain_batches``)
        run when no listener and no guard is attached: K batches at a time
        go to the device in one stacked copy and then through the same
        per-step path. ``DL4J_TPU_DEVICE_PREFETCH=1`` copies unchained
        batches on a side stream instead. The loss is read on the host only
        for listeners and the guard."""
        from deeplearning4j_tpu_torch.train import resilience

        if self.params is None:
            self.init()
        resume_skip = 0
        if resume_from is not None:
            if resilience.resume(self, resume_from) is not None:
                resume_skip = int(self.batch_in_epoch)
                epochs = max(epochs - self.epoch, 0)
        if os.environ.get("DL4J_TPU_TUNE"):
            # the tuning DB's winner lands before chain_k, the warm and the
            # step read their knobs (tune/__init__.py)
            from deeplearning4j_tpu_torch import tune

            tune.maybe_apply(self, "fit")
        tbptt = self.conf.backprop_type == "tbptt"
        sgd = self.conf.optimization_algo in _SGD_NAMES
        guard = self.divergence_guard
        chain_k = self._chain_k() if sgd and not self.listeners and guard is None else 0
        if aot.enabled() and sgd and not tbptt and chain_k <= 1:
            # the first batch's step runs once on a snapshot (nn/aot.py)
            aot.warm_fit(self, data, batch_size)
        # chained batches go to the device in one stacked copy
        prefetch = (sgd and chain_k <= 1 and self.device.type == "cuda"
                    and _device_prefetch_enabled())
        try:
            for _ in range(epochs):
                skip_n, resume_skip = resume_skip, 0
                self.batch_in_epoch = skip_n
                for l in self.listeners:
                    l.on_epoch_start(self, self.epoch)
                source = data() if callable(data) else data
                # one row count for every batch, the tail padded; the
                # chained path takes bare (x, y) batches, so it opts out
                pad_target = (_fit_pad_target(source, batch_size)
                              if sgd and chain_k <= 1 and bucketing.bucketing_enabled()
                              else None)

                def batches():
                    it = _iter_batches(source, batch_size)
                    # resume: the interrupted epoch's used batches are
                    # skipped here, before padding and any copy, without
                    # drawing from the generator (its state is past them)
                    for _ in range(skip_n):
                        if next(it, None) is None:
                            return
                    for x, y, fm, lm in it:
                        n = len(x)   # the real rows, before padding
                        if prefetch or chain_k > 1:
                            self._check_host_ids(x)
                        if pad_target is not None and not (tbptt and _ndim(x) == 3):
                            yield bucketing.pad_fit_batch(
                                x, y, fm, lm, pad_target, site="mln.fit") + (n,)
                        else:
                            yield (x, y, fm, lm, None, n)

                stream = batches()
                if chain_k > 1:
                    stream = chain_batches(
                        stream, chain_k, self.device,
                        lambda b: (b[2] is None and b[3] is None and b[4] is None
                                   and not (tbptt and _ndim(b[0]) == 3)),
                        note=aot.grid_site(self, "mln.chain").note_seen)
                elif prefetch:   # the next batch copied on a side stream
                    from deeplearning4j_tpu_torch.datasets.iterator import prefetch_to_device

                    stream = prefetch_to_device(stream, device=self.device)
                for x, y, fm, lm, ew, n_real in stream:
                    with obs.span("mln.fit_batch"):
                        if not sgd:
                            score = self._fit_solver(x, y, fm, lm)
                        elif tbptt and _ndim(x) == 3:
                            score = self._fit_tbptt(x, y, fm, lm)
                        else:
                            score = self._fit_batch(x, y, fm, lm, ew=ew)
                    self.batch_in_epoch += 1
                    if guard is not None:
                        guard.observe(self, score)
                    # the loss stays on the device unless a listener reads it
                    if self.listeners:
                        score = float(score)
                        resilience.note_score(score)
                        for l in self.listeners:
                            l.iteration_done(self, self.iteration, score, n_real)
                if guard is not None:
                    guard.flush(self)
                for l in self.listeners:
                    l.on_epoch_end(self, self.epoch)
                self.epoch += 1
        finally:
            # a run ending inside a ProfilerListener window (normally, or by
            # an exception or a chaos preemption) must not leak an open trace
            close_listeners(self.listeners)
        return self

    def _fit_batch(self, x, y, fm, lm, ew=None):
        """One step on a host or device batch; returns the loss as a device
        scalar. ``ew``: optional per-example validity weight."""
        from deeplearning4j_tpu_torch.train import resilience

        chaos = resilience.active_chaos()
        if chaos is not None:
            chaos.maybe_preempt(self.iteration)
            chaos.maybe_slow(self.iteration)
            x = chaos.maybe_nan_batch(self.iteration, x)
        args = (self._features(x), _cast_labels(y, self.dtype, self.device),
                _cast_mask(fm, self.dtype, self.device),
                _cast_mask(lm, self.dtype, self.device),
                _cast_mask(ew, self.dtype, self.device))
        if obs.phase_spans_enabled() and self.divergence_guard is None:
            return self._fit_batch_phases(*args)
        return self._get_step_fn()(*args)

    def _fit_solver(self, x, y, fm, lm):
        """A non-SGD ``optimization_algo`` (Solver.java's dispatch):
        ``conf.solver_iterations`` deterministic solver steps on this batch
        (train/solvers.py); the Solver is kept on the model across batches.
        ``iteration`` advances by one."""
        from deeplearning4j_tpu_torch.train.solvers import Solver

        solver = self._solver
        if solver is None or solver.algorithm != self.conf.optimization_algo:
            solver = Solver(self, self.conf.optimization_algo)
            self._solver = solver
        loss = solver.optimize((x, y, fm, lm), iterations=self.conf.solver_iterations)
        self.iteration += 1
        return loss

    def _fit_tbptt(self, x, y, fm, lm):
        """Truncated BPTT (doTruncatedBPTT): cut the time axis into
        ``tbptt_fwd_length`` chunks and take one update per chunk, passing
        the RNN carries on detached. Returns the mean chunk loss as a device
        scalar; ``iteration`` advances once per chunk. The chaos hooks run
        once per batch; ``nan_grad`` poisons the whole batch here (the JAX
        package's tBPTT path ignores it)."""
        from deeplearning4j_tpu_torch.train import resilience

        chaos = resilience.active_chaos()
        if chaos is not None:
            chaos.maybe_preempt(self.iteration)
            chaos.maybe_slow(self.iteration)
            x = chaos.maybe_nan_batch(self.iteration, x)
        x = self._features(x)
        T, L = x.shape[1], self.conf.tbptt_fwd_length
        y = _cast_labels(y, self.dtype, self.device)
        # time-sliced labels: one-hot [B, T, C] and sparse integer [B, T];
        # rank-2 float labels (sequence-level heads) pass through whole
        y_sliced = y is not None and (y.dim() == 3 or (
            y.dim() == 2 and not y.is_floating_point()))
        fm = _cast_mask(fm, self.dtype, self.device)
        lm = _cast_mask(lm, self.dtype, self.device)
        carries = self._initial_carries(x.shape[0])
        step = self._get_tbptt_fn()
        total, nchunks = 0.0, 0
        for t0 in range(0, T, L):
            sl = slice(t0, min(t0 + L, T))
            loss, carries = step(x[:, sl], y[:, sl] if y_sliced else y,
                                 fm[:, sl] if fm is not None else None,
                                 lm[:, sl] if lm is not None else None, carries)
            total = total + loss
            nchunks += 1
        return total / max(nchunks, 1)

    def _tbptt_chunk(self, x, y, fm, lm, carries):
        """One tBPTT update on one time chunk; returns (loss, the final
        carries, detached)."""
        loss, new_state, grads, carries = self._value_and_grad(
            self.state, x, y, fm, lm, None, carries=carries)
        self._apply_step(loss, new_state, grads)
        self.iteration += 1
        return loss, carries

    # -- dispatch sites (nn/aot.py) ------------------------------------------
    def _get_output_fn(self):
        """The ``mln.output`` site: one forward at a bucketed batch."""
        return aot.site(self, "mln.output", self._infer_site, stateful=False)

    def _get_step_fn(self, tbptt: bool = False):
        """The ``mln.step`` site: one training step on device tensors. Its
        bucket traffic is recorded at ``mln.fit`` (``pad_fit_batch``)."""
        if tbptt:
            return self._get_tbptt_fn()
        return aot.site(self, "mln.step", self._step, stateful=True, hits_site="mln.fit")

    def _get_tbptt_fn(self):
        """The ``mln.step.tbptt`` site: one tBPTT chunk update."""
        return aot.site(self, "mln.step.tbptt", self._tbptt_chunk, stateful=True,
                        hits_site="mln.fit")

    def _infer_site(self, x, fmask):
        with torch.inference_mode():
            return self._infer(x, fmask)

    # -- inference ---------------------------------------------------------
    def output(self, x, train: bool = False, fmask=None) -> torch.Tensor:
        """Final-layer post-activation output (MultiLayerNetwork.output),
        a tensor on the model's device. ``train`` is accepted for the
        reference's signature and, as there, ignored: inference always runs
        the layers in eval mode.

        Batch rows are padded up to the shared bucket ladder before the
        forward pass (and sliced back off), so mixed caller batch sizes run
        on one warmed shape per bucket; inference is row-independent, so
        zero-pad rows are dead compute, not a numerics change. Disable via
        DL4J_TPU_BUCKETING=0. Runs under ``torch.inference_mode()``."""
        if self.params is None:
            raise RuntimeError("call init() (or load params) before output()")
        with torch.inference_mode():
            x = self._features(x)
            fmask = _cast_mask(fmask, self.dtype, self.device)
            n = x.shape[0]
            with obs.span("mln.output"):
                if bucketing.bucketing_enabled() and n > 0:
                    target = bucketing.bucket_size(n)
                    bucketing.telemetry().record_hit("mln.output", n, target)
                    if target > n:
                        x = bucketing.pad_rows_zero(x, target)
                        fmask = bucketing.pad_rows_zero(fmask, target)
                        return bucketing.unpad(self._get_output_fn()(x, fmask), n)
                return self._get_output_fn()(x, fmask)

    def _infer(self, x, fmask):
        return self._forward(self.params, self.state, x, train=False, fmask=fmask)[0]

    def rnn_time_step(self, x) -> torch.Tensor:
        """Feed one or more steps (rnnTimeStep), carrying the RNN state
        between calls: ``x`` [B, T, F], or [B, F] for one step (the output
        then has no time axis). The carries stay on the model's device; a
        call with another batch size starts from zero carries. Runs under
        ``torch.inference_mode()``."""
        with torch.inference_mode():
            x = self._features(x)
            squeeze = x.ndim == 2
            if squeeze:
                x = x[:, None, :]
            leaves = tree_leaves(self._rnn_carries)
            if self._rnn_carries is None or (leaves and leaves[0].shape[0] != x.shape[0]):
                self._rnn_carries = self._initial_carries(x.shape[0])
            a, _, self._rnn_carries, _, _ = self._forward(
                self.params, self.state, x, train=False, carries=self._rnn_carries)
            return a[:, 0, :] if squeeze and a.ndim == 3 else a

    def rnn_clear_previous_state(self):
        """Forget the carries that ``rnn_time_step`` kept."""
        self._rnn_carries = None

    def predict(self, x) -> np.ndarray:
        """Class indices (argmax over the last axis, taken on the device)."""
        return self.output(x).argmax(dim=-1).cpu().numpy()

    def score(self, batch_or_x, y=None, fmask=None, lmask=None,
              train: bool = False) -> float:
        """Average loss on a batch (MultiLayerNetwork.score(data, training)),
        penalties included. ``train=True`` scores with training-mode layer
        semantics while dropout and weight noise stay off, so the result is
        deterministic."""
        if y is None:
            x, y, fmask, lmask = _as_batch(batch_or_x)
        else:
            x = batch_or_x
        with torch.no_grad():
            loss, _ = self._loss(
                self.params, self.state, x,
                _cast_labels(y, self.dtype, self.device),
                _cast_mask(fmask, self.dtype, self.device),
                _cast_mask(lmask, self.dtype, self.device),
                rng=None, train=train, deterministic=True)
        return float(loss)

    # -- evaluation --------------------------------------------------------
    def _output_mask(self, fm, lm):
        """Mask for scoring/eval at the network output: the labels mask, or
        the features mask propagated through the layer stack."""
        if lm is not None:
            return np.asarray(lm)
        if fm is None:
            return None
        mask = _cast_mask(fm, self.dtype, self.device)
        for layer, it in zip(self.layers, self.layer_input_types):
            mask = layer.propagate_mask(mask, it)
            if mask is None:
                return None
        return mask.float().cpu().numpy()

    def evaluate(self, data, batch_size: Optional[int] = None, top_n: int = 1):
        """Classification metrics (eval/Evaluation) over ``data``."""
        from deeplearning4j_tpu_torch.eval import Evaluation

        ev = Evaluation(top_n=top_n)
        for x, y, fm, lm in _iter_batches(data, batch_size):
            preds = self.output(x, fmask=fm).float().cpu().numpy()
            ev.eval(_host(y), preds, mask=self._output_mask(fm, lm))
        return ev

    def evaluate_regression(self, data, batch_size: Optional[int] = None):
        """Regression metrics (eval/RegressionEvaluation) over ``data``."""
        from deeplearning4j_tpu_torch.eval import RegressionEvaluation

        ev = RegressionEvaluation()
        for x, y, fm, lm in _iter_batches(data, batch_size):
            preds = self.output(x, fmask=fm).float().cpu().numpy()
            ev.eval(_host(y), preds, mask=self._output_mask(fm, lm))
        return ev

    def evaluate_roc(self, data, batch_size: Optional[int] = None, num_bins: int = 200):
        """A binary ROC (eval/ROC) over ``data`` with ``num_bins``
        probability bins (0: exact)."""
        from deeplearning4j_tpu_torch.eval import ROC

        roc = ROC(num_bins)
        for x, y, fm, lm in _iter_batches(data, batch_size):
            preds = self.output(x, fmask=fm).float().cpu().numpy()
            roc.eval(_host(y), preds)
        return roc

    @property
    def takes_ids(self) -> bool:
        """Does the first layer take integer ids (an embedding)?"""
        return isinstance(self.layers[0], (Embedding, EmbeddingSequence))

    def dummy_input(self, batch: int) -> torch.Tensor:
        """A zero batch of ``batch`` rows shaped for this model's input: token
        ids [batch, T] when the first layer embeds a sequence, ids [batch, 1]
        for an Embedding, else zeros of the input type's shape in the model
        dtype ([batch, H, W, C] images for a convolutional input, [batch,
        H*W*C] for a flattened one)."""
        it = self.conf.input_type
        if isinstance(self.layers[0], EmbeddingSequence):
            return torch.zeros((batch, it.timesteps or 16), dtype=torch.int64,
                               device=self.device)
        if isinstance(self.layers[0], Embedding):
            return torch.zeros((batch, 1), dtype=torch.int64, device=self.device)
        return torch.zeros(it.batch_shape(batch), dtype=self.dtype,
                           device=self.device)

    # -- copies and description ------------------------------------------------
    def clone(self) -> "MultiLayerNetwork":
        """A deep copy on the same device: params, layer state, optimizer
        state and the step counters (MultiLayerNetwork.clone)."""
        m = MultiLayerNetwork(self.conf, device=self.device)
        if self.params is not None:
            m.init()
            with torch.no_grad():
                copy = lambda t: tree_map(lambda x: x.detach().clone(), t)  # noqa: E731
                m.params = copy(self.params)
                m.state = copy(self.state)
                m.opt_state = copy(self.opt_state)
            m.iteration = self.iteration
            m.epoch = self.epoch
        return m

    def summary(self) -> str:
        """One line per resolved layer (index, type, output shape, params)
        and the total, as the JAX package's ``summary`` prints them."""
        lines = [f"{'idx':<4} {'type':<22} {'output':<24} {'params':<10}"]
        for i, (l, it) in enumerate(zip(self.layers, self.layer_input_types)):
            out = l.output_type(it)
            n = (sum(int(p.numel()) for p in tree_leaves(self.params[i]))
                 if self.params is not None else "?")
            lines.append(f"{i:<4} {l._type_name:<22} {str(out.batch_shape())[0:24]:<24} {n:<10}")
        lines.append(f"Total params: {self.num_params() if self.params is not None else '?'}")
        return "\n".join(lines)
