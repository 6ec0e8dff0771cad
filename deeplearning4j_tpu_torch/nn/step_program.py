"""The training step's micro-batching policy (PyTorch port of the torch-
relevant part of ``nn/step_program.py``).

- :func:`grad_accum_from_env` / :func:`accum_applicable` — the
  ``DL4J_TPU_GRAD_ACCUM`` knob and its gate (equal micro-batches only);
- :func:`accum_value_and_grad` — gradient accumulation as a loop over the
  equal micro-batches: each runs forward and backward at 1/accum of the
  activation footprint, gradients add up in the param dtype (the JAX
  step's ``zeros_like(params)`` carry) and are averaged once, so the one
  optimizer update sees the mean of the micro-batch gradients.

The JAX module's jit/donation wiring has no counterpart: PyTorch runs
eagerly and the model updates its params in place under
``torch.no_grad()``. Chained K-step dispatch is not ported yet.
"""

from __future__ import annotations

import os
import warnings

import torch

from deeplearning4j_tpu_torch.utils.tree import tree_leaves, tree_map

__all__ = ["accum_applicable", "accum_value_and_grad", "grad_accum_from_env"]

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
