"""Recurrent layers (PyTorch port of ``nn/layers/recurrent.py``).

Ported so far: the ``BaseRecurrent`` scaffolding and ``RnnOutputLayer``,
the time-distributed softmax head of the TransformerLM with its loss head
(``score``). LSTM, GravesLSTM
(and their fused kernels), SimpleRnn, Bidirectional, LastTimeStep and
MaskZero arrive with the recurrent slice.

Layout: [batch, time, features]; mask [batch, time].
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from deeplearning4j_tpu_torch.nn import initializers, losses
from deeplearning4j_tpu_torch.nn.config import FeedForwardLayerConfig, register_layer
from deeplearning4j_tpu_torch.nn.input_type import InputType


@dataclass
class BaseRecurrent(FeedForwardLayerConfig):
    """Common recurrent scaffolding."""

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timesteps)


@register_layer("rnn_output")
@dataclass
class RnnOutputLayer(BaseRecurrent):
    """Time-distributed output layer (RnnOutputLayer.java): dense + activation
    applied at every timestep of [batch, time, feat], with its loss."""

    activation: Any = "softmax"
    loss: Any = "mcxent"
    has_bias: bool = True

    def init(self, gen, input_type, dtype=torch.float32, device=None):
        n_in = self.n_in if self.n_in is not None else input_type.size
        params = {
            "W": initializers.initialize(self.weight_init, gen, (n_in, self.n_out),
                                         n_in, self.n_out, dtype, device)
        }
        if self.has_bias:
            params["b"] = torch.full((self.n_out,), self.bias_init, dtype=dtype,
                                     device=device)
        return params

    def preactivation(self, params, x):
        y = x @ params["W"]
        if self.has_bias:
            y = y + params["b"]
        return y

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        x = self.maybe_dropout_input(x, train, rng)
        y = self.activation_fn()(self.preactivation(params, x))
        if mask is not None:
            y = y * mask[..., None]
        return y, state

    def score(self, params, x, labels, mask=None, average=True, weights=None):
        """The loss head on the layer's input ``x`` [B, T, n_in]: the mean
        score (``average``) or per-example scores, from the preactivation
        (softmax+mcxent fused; integer labels [B, T] are sparse)."""
        preact = self.preactivation(params, x)
        if average:
            return losses.average_score(self.loss, labels, preact, self.activation,
                                        mask, weights)
        return losses.per_example_scores(self.loss, labels, preact, self.activation,
                                         mask, weights)
