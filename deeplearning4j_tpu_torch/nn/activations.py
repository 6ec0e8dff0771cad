"""Activation functions: a name -> function registry (PyTorch).

Counterpart of ``deeplearning4j_tpu/nn/activations.py``, with the same
DL4J-compatible lowercase names. Only the activations of the ported layers
are here so far; an unported name raises with the list of known ones.

``gelu`` is the tanh approximation: ``jax.nn.gelu`` defaults to
``approximate=True``, while ``torch.nn.functional.gelu`` defaults to the
exact erf form.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

Activation = Callable[[torch.Tensor], torch.Tensor]

_REGISTRY: Dict[str, Activation] = {}


def register(name: str) -> Callable[[Activation], Activation]:
    def deco(fn: Activation) -> Activation:
        _REGISTRY[name.lower()] = fn
        return fn

    return deco


def get(name_or_fn) -> Activation:
    """Resolve an activation by DL4J-style name (case-insensitive) or pass
    a callable through."""
    if callable(name_or_fn):
        return name_or_fn
    key = str(name_or_fn).lower()
    if key not in _REGISTRY:
        raise ValueError(
            f"Unknown activation '{name_or_fn}' (not ported to "
            f"deeplearning4j_tpu_torch yet?). Known: {sorted(_REGISTRY)}")
    return _REGISTRY[key]


def names() -> list:
    return sorted(_REGISTRY)


@register("identity")
def identity(x):
    return x


_REGISTRY["linear"] = identity


@register("relu")
def relu(x):
    return torch.relu(x)


@register("tanh")
def tanh(x):
    return torch.tanh(x)


@register("sigmoid")
def sigmoid(x):
    return torch.sigmoid(x)


@register("softmax")
def softmax(x):
    return torch.softmax(x, dim=-1)


@register("gelu")
def gelu(x):
    return F.gelu(x, approximate="tanh")
