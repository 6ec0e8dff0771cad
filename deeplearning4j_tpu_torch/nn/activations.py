"""Activation functions: a name -> function registry (PyTorch).

Counterpart of ``deeplearning4j_tpu/nn/activations.py``, with the same
DL4J-compatible lowercase names and the same formulas (an unknown name
raises with the list of known ones).

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


@register("relu6")
def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


@register("leakyrelu")
def leakyrelu(x):
    return F.leaky_relu(x, negative_slope=0.01)


@register("elu")
def elu(x):
    return F.elu(x)


@register("selu")
def selu(x):
    return F.selu(x)


@register("hardsigmoid")
def hardsigmoid(x):
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


@register("hardtanh")
def hardtanh(x):
    return torch.clamp(x, -1.0, 1.0)


@register("rationaltanh")
def rationaltanh(x):
    # DL4J's ActivationRationalTanh: 1.7159 * tanh(2x/3), rational form
    a = torch.abs(2.0 * x / 3.0)
    approx = 1.0 - 1.0 / (1.0 + a + a * a + 1.41645 * a ** 4)
    return 1.7159 * torch.sign(x) * approx


@register("rectifiedtanh")
def rectifiedtanh(x):
    return torch.clamp_min(torch.tanh(x), 0.0)


@register("logsoftmax")
def logsoftmax(x):
    return torch.log_softmax(x, dim=-1)


@register("softplus")
def softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


@register("softsign")
def softsign(x):
    return x / (1.0 + torch.abs(x))


@register("cube")
def cube(x):
    return x * x * x


@register("swish")
def swish(x):
    return F.silu(x)


@register("mish")
def mish(x):
    return x * torch.tanh(softplus(x))


@register("thresholdedrelu")
def thresholdedrelu(x):
    return torch.where(x > 1.0, x, torch.zeros_like(x))
