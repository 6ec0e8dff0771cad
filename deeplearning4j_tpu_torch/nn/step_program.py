"""The training step's micro-batching policy (PyTorch port of the torch-
relevant part of ``nn/step_program.py``).

- :func:`grad_accum_from_env` / :func:`accum_applicable` — the
  ``DL4J_TPU_GRAD_ACCUM`` knob and its gate (equal micro-batches only);
- :func:`accum_value_and_grad` — gradient accumulation as a loop over the
  equal micro-batches: each runs forward and backward at 1/accum of the
  activation footprint, gradients add up in the param dtype (the JAX
  step's ``zeros_like(params)`` carry) and are averaged once, so the one
  optimizer update sees the mean of the micro-batch gradients.

- :func:`chain_k_from_env` — the chained-fit gate (``DL4J_TPU_CHAIN_STEPS``,
  off unless set): how many steps ``fit`` issues back to back from one
  stacked copy of their batches;
- :func:`chain_batches` — the chain itself, as a batch source in front of
  ``fit``'s one per-step loop;
- :func:`mesh_shape_from_env` — the named-mesh trainer's ``(data, model,
  pipe)`` shape from the ``DL4J_TPU_MESH_*`` knobs
  (``parallel/mesh_step.py``);
- :func:`guarded_step` — one in-place step under the donation guard
  (``analysis/donation_guard.py``), the counterpart of the JAX
  ``StepProgram.__call__``'s donation check: ``nn/aot.py``'s training
  sites and the data-parallel step run through it.

The JAX module's jit wiring has no counterpart: PyTorch runs eagerly and
the model updates its params, updater state and layer state in place
under ``torch.no_grad()`` (where the JAX step donates them); the sites
that record signatures and run the retrace guard are ``nn/aot.py``'s. A chain is K eager steps in a row, each drawing from
the model's generator as the per-step path does, so chaining changes no
bit of the result (the JAX package's scan folds a per-step key into the
chain's and is reproducible only for models that draw no randomness).
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.analysis import donation_guard
from deeplearning4j_tpu_torch.utils.tree import tree_leaves, tree_map

__all__ = ["CHAIN_AUTO_PARAM_LIMIT", "accum_applicable", "accum_value_and_grad",
           "chain_batches", "chain_k_from_env", "grad_accum_from_env",
           "guarded_step", "mesh_shape_from_env"]

# Above this parameter count "auto" never chains: big models are
# compute-bound, so issuing steps back to back buys nothing and the
# stacked [K, B, ...] batch only costs memory.
CHAIN_AUTO_PARAM_LIMIT = 2_000_000


def chain_k_from_env(uses_rng: bool, n_params: int) -> int:
    """The chained-fit gate shared by MultiLayerNetwork and
    ComputationGraph: DL4J_TPU_CHAIN_STEPS forces a count (0 disables);
    "auto" chains 8 only for models that draw no randomness and hold fewer
    than ``CHAIN_AUTO_PARAM_LIMIT`` params, as the JAX package does. Phase
    spans (DL4J_TPU_PHASE_SPANS=1) turn "auto" off: a chain would hide the
    per-phase split; an explicit count still wins.

    Unset, the variable means 0 in the port, where the JAX package reads
    "auto": an eager chain issues the per-step path's kernels and saves
    only the batch copies, and on an H100 it ran LeNet-5 no faster than
    the per-step loop (PERF.md)."""
    env = os.environ.get("DL4J_TPU_CHAIN_STEPS", "0")
    if env == "auto":
        if obs.phase_spans_enabled():
            return 0
        return 8 if (not uses_rng and n_params < CHAIN_AUTO_PARAM_LIMIT) else 0
    try:
        return max(int(env), 0)
    except ValueError:
        return 0


def _batch_sig(batch):
    """Shape and dtype of every array of a batch: batches that may share
    one chain (same-shape batches of different dtypes must not stack)."""
    if isinstance(batch, (tuple, list)):
        return tuple(_batch_sig(a) for a in batch)
    if isinstance(batch, (np.ndarray, torch.Tensor)):
        return tuple(batch.shape), str(batch.dtype)
    return None


def _stacked(arrays, device: torch.device) -> torch.Tensor:
    """K same-shape arrays as one [K, ...] tensor on ``device``: stacked
    on the host into page-locked memory and copied without the host
    waiting for the card (the caching host allocator keeps the buffer
    until the copy is done)."""
    ts = [a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
          for a in arrays]
    if all(t.device == device for t in ts):
        return torch.stack(ts)
    ts = [t.cpu() for t in ts]
    if device.type != "cuda":
        return torch.stack(ts).to(device)
    buf = torch.empty((len(ts),) + tuple(ts[0].shape), dtype=ts[0].dtype, pin_memory=True)
    torch.stack(ts, out=buf)
    return buf.to(device, non_blocking=True)


def _unstack(group, device: torch.device) -> list:
    """A group of same-structure batches as the same batches whose arrays
    are views of one stacked copy each; other leaves pass through."""
    first = group[0]
    if isinstance(first, (tuple, list)):
        cols = [_unstack([b[i] for b in group], device) for i in range(len(first))]
        return [type(first)(c[j] for c in cols) for j in range(len(group))]
    if isinstance(first, (np.ndarray, torch.Tensor)):
        return list(_stacked(group, device).unbind(0))
    return list(group)


def _copy_chain(group, device: torch.device) -> list:
    """One chain's batches on ``device`` from one copy per array, under a
    ``fit.chain_copy`` span."""
    with obs.span("fit.chain_copy", batches=len(group)):
        return _unstack(group, device)


def chain_batches(batches, k: int, device, chainable, note=None):
    """Chained dispatch as a batch source: each run of ``k`` consecutive
    batches that ``chainable`` accepts and whose arrays share shapes and
    dtypes goes to ``device`` in one stacked copy per array, and comes out
    one batch at a time as views of that copy. Any other batch, and a run
    cut short (the tail), passes through as it came.

    The fit loop runs its one per-step path over whatever this yields, so
    a chain draws from the model's generator in the per-step order and
    ends with the per-step path's bits, dropout included. What a chain
    saves is K-1 of every K batch copies, and with them the host's wait
    for the card that a copy from pageable memory makes: inside a chain
    the host reads nothing back and issues the K steps back to back.
    ``note(k, batch_signature)`` (the ``note_seen`` of the model's
    ``mln.chain`` / ``cg.chain`` site) sees every chain's signature."""
    device = torch.device(device)
    group: list = []
    for b in batches:
        if chainable(b) and (not group or _batch_sig(b) == _batch_sig(group[0])):
            group.append(b)
            if len(group) == k:
                if note is not None:
                    note(len(group), _batch_sig(group[0]))
                yield from _copy_chain(group, device)
                group = []
            continue
        yield from group
        group = []
        yield b
    yield from group


_GRAD_ACCUM_WARNED = False


def grad_accum_from_env() -> int:
    """Micro-batch count for gradient accumulation (DL4J_TPU_GRAD_ACCUM,
    default 1 = off)."""
    try:
        return max(int(os.environ.get("DL4J_TPU_GRAD_ACCUM", "1")), 1)
    except ValueError:
        return 1


def accum_applicable(accum: int, batch) -> bool:
    """Every batch-major leaf of ``batch`` must share one leading row count
    divisible by ``accum`` (equal micro-batches keep the mean of means equal
    to the full-batch mean). Otherwise the step runs un-accumulated — with
    a one-shot warning when the knob is set but the batch does not fit."""
    if accum <= 1:
        return False
    leaves = tree_leaves(batch)
    if not leaves or leaves[0].dim() == 0:
        return False
    b = leaves[0].shape[0]
    if b < accum or b % accum != 0 or not all(
            l.dim() >= 1 and l.shape[0] == b for l in leaves):
        global _GRAD_ACCUM_WARNED
        if not _GRAD_ACCUM_WARNED:
            _GRAD_ACCUM_WARNED = True
            warnings.warn(
                f"DL4J_TPU_GRAD_ACCUM={accum} does not divide the batch "
                f"(leading dims {[l.shape[0] for l in leaves[:4]]}); this "
                "step runs un-accumulated.")
        return False
    return True


def accum_value_and_grad(accum: int, params, state, batch, value_and_grad):
    """Gradient accumulation over ``accum`` equal micro-batches.

    ``batch`` is a tuple of batch-major tensors (None allowed);
    ``value_and_grad(micro_batch, state) -> (loss, new_state, grads)`` runs
    one micro-batch. Layer state threads micro-batch to micro-batch.
    Returns ``(mean loss, state, mean grads)``."""
    def micro(i):
        return tuple(None if t is None else t.reshape(
            (accum, t.shape[0] // accum) + tuple(t.shape[1:]))[i] for t in batch)

    g_acc = tree_map(torch.zeros_like, params)
    loss_acc = None
    for i in range(accum):
        loss_i, state, g_i = value_and_grad(micro(i), state)
        g_acc = tree_map(lambda a, g: a + g, g_acc, g_i)
        loss_i = loss_i.float()
        loss_acc = loss_i if loss_acc is None else loss_acc + loss_i
    inv = 1.0 / accum
    return loss_acc * inv, state, tree_map(lambda g: g * inv, g_acc)


def guarded_step(site: str, model, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, one in-place step of ``model``; under
    ``DL4J_TPU_DONATION_GUARD=1`` every param, updater-state and
    layer-state leaf it took must still be in place afterwards (a rebound
    one trips, its old tensor NaN)."""
    snap = donation_guard.snapshot(model, site)
    out = fn(*args, **kwargs)
    donation_guard.check_after_step(snap, model)
    return out


def _axis_env(name: str) -> int:
    raw = os.environ.get(name, "0")
    try:
        return max(int(raw), 0)
    except ValueError:
        return 0


def mesh_shape_from_env(n_devices: int):
    """The named-mesh step's ``(data, model, pipe)`` shape from
    ``DL4J_TPU_MESH_DATA`` / ``DL4J_TPU_MESH_MODEL`` / ``DL4J_TPU_MESH_PIPE``
    (0 or unset: auto). Unset model and pipe axes are 1 and an unset data
    axis takes every remaining rank, so with no knob set this is pure data
    parallelism over all ``n_devices`` ranks. A shape that does not cover
    ``n_devices`` raises."""
    t = _axis_env("DL4J_TPU_MESH_MODEL") or 1
    s = _axis_env("DL4J_TPU_MESH_PIPE") or 1
    d = _axis_env("DL4J_TPU_MESH_DATA")
    if d == 0:
        if n_devices % (t * s):
            raise ValueError(
                f"mesh axes model={t} x pipe={s} do not divide {n_devices} devices")
        d = n_devices // (t * s)
    if d * t * s != n_devices:
        raise ValueError(
            f"mesh shape (d={d}, t={t}, s={s}) does not cover {n_devices} devices")
    return d, t, s
