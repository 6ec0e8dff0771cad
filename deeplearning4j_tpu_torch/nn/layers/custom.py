"""The custom-layer API and the remaining heads (PyTorch port of
``nn/layers/custom.py``): ``CustomLayer`` (the SameDiff-layer equivalent),
``LambdaLayer``, ``FrozenLayer``, ``CenterLossOutputLayer`` and
``CnnLossLayer``, with the JAX package's JSON tags, fields, defaults and
parameter trees.

A custom layer is the LayerConfig contract itself: subclass
:class:`CustomLayer`, implement ``init`` (a dict of tensors) and
``forward`` (a function of params and x); autograd gives the backward.
Decorate it with ``@register_layer("my_type")`` for JSON serde.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from deeplearning4j_tpu_torch.nn import initializers, losses
from deeplearning4j_tpu_torch.nn.config import FeedForwardLayerConfig, LayerConfig, register_layer
from deeplearning4j_tpu_torch.nn.input_type import InputType


class CustomLayer(LayerConfig):
    """Base class for user-defined layers: implement ``init`` and
    ``forward(params, x)``."""

    def forward(self, params, x):
        raise NotImplementedError

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return self.forward(params, x), state


@register_layer("lambda")
@dataclass
class LambdaLayer(LayerConfig):
    """A stateless function layer (SameDiffLambdaLayer): ``fn`` is a torch
    callable. It does not survive JSON, as in the JAX package (its JSON
    holds a marker that refuses to load)."""

    fn: Optional[Callable] = None

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        if self.fn is None:
            raise ValueError("LambdaLayer.fn missing (not restorable from JSON)")
        return self.fn(x), state


@register_layer("frozen")
@dataclass
class FrozenLayer(LayerConfig):
    """A wrapper that keeps the inner layer out of training
    (nn/conf/layers/misc/FrozenLayer.java): the noop updater, no gradient
    asked for, and the inner layer always applied in eval mode (BatchNorm's
    statistics stay as they are)."""

    inner: Optional[LayerConfig] = None

    def __post_init__(self):
        self.trainable = False

    def output_type(self, input_type: InputType) -> InputType:
        return self.inner.output_type(input_type)

    def init(self, gen, input_type, dtype=torch.float32, device=None):
        return self.inner.init(gen, input_type, dtype, device)

    def init_state(self, input_type: InputType):
        return self.inner.init_state(input_type)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        y, _ = self.inner.apply(params, state, x, train=False, rng=rng, mask=mask)
        return y, state

    def propagate_mask(self, mask, input_type):
        return self.inner.propagate_mask(mask, input_type)

    def score(self, params, x, labels, mask=None, average=True, weights=None):
        return self.inner.score(params, x, labels, mask=mask, average=average, weights=weights)


@register_layer("center_loss_output")
@dataclass
class CenterLossOutputLayer(FeedForwardLayerConfig):
    """Softmax output plus the center loss (CenterLossOutputLayer.java),
    which pulls each example's input features toward its class center. The
    centers are params (``centers`` [n_out, n_in]); the center term's
    gradient on them is the (feature - center) direction the reference
    applies by hand, so SGD or Adam on them reproduces it. ``lambda_``
    weights the term, ``alpha`` scales it relative to 0.05."""

    alpha: float = 0.05
    lambda_: float = 2e-4
    loss: Any = "mcxent"
    activation: Any = "softmax"

    BIAS_PARAM_NAMES = frozenset({"b", "centers"})  # centers: no l1/l2

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def init(self, gen, input_type, dtype=torch.float32, device=None):
        n_in = self.n_in if self.n_in is not None else input_type.flat_size()
        return {
            "W": initializers.initialize(self.weight_init, gen, (n_in, self.n_out), n_in,
                                         self.n_out, dtype, device),
            "b": torch.full((self.n_out,), self.bias_init, dtype=dtype, device=device),
            "centers": torch.zeros((self.n_out, n_in), dtype=dtype, device=device),
        }

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return self.activation_fn()(x @ params["W"] + params["b"]), state

    def score(self, params, x, labels, mask=None, average=True, weights=None):
        preact = x @ params["W"] + params["b"]
        base = losses.average_score(self.loss, labels, preact, self.activation, mask, weights)
        if labels.dim() == preact.dim() - 1:
            # sparse integer labels index their centers directly
            centers_for = params["centers"][labels.to(torch.int64)]
        else:
            centers_for = labels.to(preact.dtype) @ params["centers"]  # one-hot picks rows
        center_term = 0.5 * torch.mean(torch.sum((x - centers_for) ** 2, dim=-1))
        return base + self.lambda_ * self.alpha / 0.05 * center_term


@register_layer("cnn_loss")
@dataclass
class CnnLossLayer(LayerConfig):
    """A per-pixel loss head for dense prediction (CnnLossLayer.java):
    activation and loss at every position of [B, H, W, C]; a [B, H, W]
    mask weights the pixels."""

    CONSUMES_CONV = True  # takes [b, h, w, c] as it is (no flattening)

    activation: Any = "identity"
    loss: Any = "mcxent"

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return self.activation_fn()(x), state

    def score(self, params, x, labels, mask=None, average=True, weights=None):
        B, H, W, C = x.shape
        flat_x = x.reshape(B * H * W, C)
        flat_y = labels.reshape(B * H * W, C)
        flat_m = mask.reshape(-1) if mask is not None else None
        if average:
            return losses.average_score(self.loss, flat_y, flat_x, self.activation, flat_m,
                                        weights)
        per = losses.per_example_scores(self.loss, flat_y, flat_x, self.activation, flat_m,
                                        weights)
        return per.reshape(B, H, W)
