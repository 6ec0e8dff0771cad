"""Core feed-forward layers (PyTorch port of ``nn/layers/core.py``).

Dense, Output and Loss heads, the standalone and parameterised
activations, Permute and RepeatVector, the dropout and noise family,
Embedding and EmbeddingSequence, and AutoEncoder (its supervised forward;
layer-wise pretraining is not ported). The same JSON tags, fields,
defaults and parameter trees as the JAX package's: ``W`` [n_in, n_out]
with ``x @ W`` (never ``nn.Linear``'s [out, in]) and ``b`` [n_out].

Tensor parallelism (``parallel/tp.py``): a ``W`` that holds this rank's
columns (narrower than ``n_out``) makes Dense / Output a column-parallel
product whose outputs are all-gathered before the bias, the activation and
the loss, and makes Embedding / EmbeddingSequence gather their rows'
features back (``parallel/comm.py``).

Randomness (dropout, noise) draws from the ``torch.Generator`` the model
passes as ``rng``; the JAX package draws from threefry keys, so the two
agree on what a layer does in train mode, not on its bits. Eval mode is
deterministic and matches the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from deeplearning4j_tpu_torch.nn import initializers, losses
from deeplearning4j_tpu_torch.nn.config import (
    FeedForwardLayerConfig,
    LayerConfig,
    batch_draw,
    register_layer,
)
from deeplearning4j_tpu_torch.nn.input_type import InputType
from deeplearning4j_tpu_torch.parallel import comm
from deeplearning4j_tpu_torch.parallel.context import mesh_sub


def _dense_params(layer, gen, input_type, dtype, device, bias: bool):
    """``W`` [n_in, n_out] from the layer's weight init and, with ``bias``,
    ``b`` [n_out] filled with ``bias_init``."""
    n_in = layer.n_in if layer.n_in is not None else input_type.flat_size()
    params = {"W": initializers.initialize(layer.weight_init, gen, (n_in, layer.n_out),
                                           n_in, layer.n_out, dtype, device)}
    if bias:
        params["b"] = torch.full((layer.n_out,), layer.bias_init, dtype=dtype, device=device)
    return params


def _check_host_ids(x: torch.Tensor, vocab: int) -> None:
    """Raise a ValueError for a host tensor of ids outside ``[0, vocab)``."""
    idx = x.to(torch.int64)
    if idx.numel() and bool(((idx < 0) | (idx >= vocab)).any()):
        raise ValueError(
            f"embedding ids must lie in [0, {vocab}), got "
            f"[{int(idx.min())}, {int(idx.max())}]")


def _take_rows(W: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``W`` as ``jnp.take(W, idx, axis=0)`` gives them, with no
    read back to the host: ids in ``[-V, 0)`` wrap and ids outside
    ``[-V, V)`` give rows of NaN."""
    V = W.shape[0]
    idx = torch.where(idx < 0, idx + V, idx)
    valid = (idx >= 0) & (idx < V)
    rows = W[idx.clamp(0, V - 1)]
    return torch.where(valid[..., None], rows, rows.new_tensor(float("nan")))


def _gather_features(rows: torch.Tensor, n_out: int) -> torch.Tensor:
    """Embedding rows of a feature-sharded table (tensor parallelism: this
    rank holds ``n_out / model`` columns) gathered back to ``n_out``."""
    if rows.shape[-1] == n_out:
        return rows
    return comm.gather_dim(rows, rows.dim() - 1, mesh_sub("model"))


def _bernoulli(rng, p_keep: float, shape, device) -> torch.Tensor:
    return batch_draw(torch.rand, shape, generator=rng, device=device) < p_keep


@register_layer("dense")
@dataclass
class Dense(FeedForwardLayerConfig):
    """Fully connected layer: act(x @ W + b) (DenseLayer.java), over
    [batch, feat] or, batched over the leading axes, [batch, time, feat]."""

    has_bias: bool = True

    def output_type(self, input_type: InputType) -> InputType:
        if input_type.kind == "recurrent":
            return InputType.recurrent(self.n_out, input_type.timesteps)
        return InputType.feed_forward(self.n_out)

    def init(self, gen, input_type, dtype=torch.float32, device=None):
        return _dense_params(self, gen, input_type, dtype, device, self.has_bias)

    def preactivation(self, params, x):
        W = params["W"]
        if W.shape[-1] != self.n_out:   # column-sharded (tensor parallelism)
            tp = mesh_sub("model")
            y = comm.gather_dim(comm.copy_to(x, tp) @ W, x.dim() - 1, tp)
        else:
            y = x @ W
        if self.has_bias:
            y = y + params["b"]
        return y

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        x = self.maybe_dropout_input(x, train, rng)
        return self.activation_fn()(self.preactivation(params, x)), state


@register_layer("output")
@dataclass
class OutputLayer(Dense):
    """Dense + loss head (OutputLayer.java). The model scores the
    PRE-activation, so (softmax, mcxent) runs as a stable log-softmax."""

    loss: Any = "mcxent"

    def score(self, params, x, labels, mask=None, average=True, weights=None):
        preact = self.preactivation(params, x)
        act = getattr(self, "activation", "identity")
        if average:
            return losses.average_score(self.loss, labels, preact, act, mask, weights)
        return losses.per_example_scores(self.loss, labels, preact, act, mask, weights)


@register_layer("loss")
@dataclass
class LossLayer(LayerConfig):
    """Parameter-free loss head (LossLayer.java): activation and loss on its
    input as it comes."""

    activation: Any = "identity"
    loss: Any = "mcxent"

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return self.activation_fn()(x), state

    def score(self, params, x, labels, mask=None, average=True, weights=None):
        if average:
            return losses.average_score(self.loss, labels, x, self.activation, mask, weights)
        return losses.per_example_scores(self.loss, labels, x, self.activation, mask, weights)


@register_layer("activation")
@dataclass
class ActivationLayer(LayerConfig):
    """Standalone activation (ActivationLayer.java)."""

    activation: Any = "relu"

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return self.activation_fn()(x), state


@register_layer("leaky_relu_layer")
@dataclass
class LeakyReLULayer(LayerConfig):
    """Leaky ReLU with a configurable slope (Keras LeakyReLU)."""

    alpha: float = 0.3

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return torch.nn.functional.leaky_relu(x, negative_slope=self.alpha), state


@register_layer("elu_layer")
@dataclass
class ELULayer(LayerConfig):
    """ELU with a configurable alpha (Keras ELU)."""

    alpha: float = 1.0

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return torch.where(x > 0, x, self.alpha * (torch.exp(x) - 1.0)), state


@register_layer("thresholded_relu_layer")
@dataclass
class ThresholdedReLULayer(LayerConfig):
    """Keras ThresholdedReLU: x if x > theta else 0."""

    theta: float = 1.0

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return torch.where(x > self.theta, x, torch.zeros_like(x)), state


@register_layer("prelu")
@dataclass
class PReLU(LayerConfig):
    """PReLU with a learned negative slope (PReLULayer.java): one ``alpha``
    per non-batch element, initialised to zero."""

    def init(self, gen, input_type, dtype=torch.float32, device=None):
        shape = input_type.batch_shape(1)[1:]
        return {"alpha": torch.zeros(shape, dtype=dtype, device=device)}

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return torch.where(x >= 0, x, params["alpha"] * x), state


@register_layer("permute")
@dataclass
class Permute(LayerConfig):
    """Permute the non-batch axes (Keras Permute); ``dims`` is a 1-based
    permutation of them."""

    dims: Any = (1,)

    def _axes(self):
        return (0,) + tuple(int(d) for d in self.dims)

    def output_type(self, input_type: InputType) -> InputType:
        shape = input_type.batch_shape(1)[1:]
        new = tuple(shape[d - 1] for d in self.dims)
        if len(new) == 1:
            return InputType.feed_forward(new[0])
        if len(new) == 2:
            return InputType.recurrent(new[1], new[0])
        if len(new) == 3:
            return InputType.convolutional(new[0], new[1], new[2])
        raise ValueError(f"Permute: unsupported rank {len(new)}")

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return x.permute(self._axes()), state


@register_layer("repeat_vector")
@dataclass
class RepeatVector(LayerConfig):
    """[B, F] -> [B, n, F] (RepeatVector.java)."""

    n: int = 1

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(input_type.flat_size(), self.n)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return x[:, None, :].repeat(1, self.n, 1), state


@register_layer("dropout")
@dataclass
class DropoutLayer(LayerConfig):
    """Standalone inverted dropout (DropoutLayer.java): ``dropout`` is the
    DROP probability; identity at inference."""

    dropout: float = 0.5

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return self.maybe_dropout_input(x, train, rng), state


@register_layer("spatial_dropout")
@dataclass
class SpatialDropout(LayerConfig):
    """Channel-wise dropout (SpatialDropout.java): one draw per [batch,
    channel], broadcast over every axis between them ([B, H, W, C] and
    [B, T, C] alike); inverted scaling, identity at inference."""

    dropout: float = 0.5

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        p = float(self.dropout)
        if not train or p <= 0.0:
            return x, state
        if rng is None:
            raise ValueError("SpatialDropout requires an rng generator in training mode")
        shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
        keep = _bernoulli(rng, 1.0 - p, shape, x.device)
        return torch.where(keep, x / (1.0 - p), torch.zeros_like(x)).to(x.dtype), state


@register_layer("gaussian_noise")
@dataclass
class GaussianNoise(LayerConfig):
    """Additive gaussian noise (GaussianNoise.java); identity at inference."""

    stddev: float = 0.1

    def uses_rng(self) -> bool:
        return super().uses_rng() or self.stddev > 0.0

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        if not train or self.stddev <= 0.0:
            return x, state
        if rng is None:
            raise ValueError("GaussianNoise requires an rng generator in training mode")
        noise = batch_draw(torch.randn, x.shape, generator=rng, device=x.device,
                           dtype=x.dtype)
        return x + self.stddev * noise, state


@register_layer("gaussian_dropout")
@dataclass
class GaussianDropout(LayerConfig):
    """Multiplicative gaussian noise (GaussianDropout.java):
    x * N(1, rate / (1 - rate)); identity at inference."""

    rate: float = 0.5

    def uses_rng(self) -> bool:
        return super().uses_rng() or self.rate > 0.0

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        if not train or self.rate <= 0.0:
            return x, state
        if rng is None:
            raise ValueError("GaussianDropout requires an rng generator in training mode")
        std = (self.rate / (1.0 - self.rate)) ** 0.5
        noise = batch_draw(torch.randn, x.shape, generator=rng, device=x.device,
                           dtype=x.dtype)
        return x * (1.0 + std * noise), state


@register_layer("alpha_dropout")
@dataclass
class AlphaDropout(LayerConfig):
    """SELU-preserving dropout (AlphaDropout.java): dropped units take the
    SELU saturation value, then an affine map keeps mean and variance."""

    dropout: float = 0.5

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        if not train or self.dropout <= 0.0:
            return x, state
        if rng is None:
            raise ValueError("AlphaDropout requires an rng generator in training mode")
        p_keep = 1.0 - self.dropout
        alpha, scale = 1.6732632423543772, 1.0507009873554805
        alpha_p = -alpha * scale
        keep = _bernoulli(rng, p_keep, x.shape, x.device)
        a = (p_keep + alpha_p ** 2 * p_keep * (1 - p_keep)) ** -0.5
        b = -a * alpha_p * (1 - p_keep)
        return a * torch.where(keep, x, torch.full_like(x, alpha_p)) + b, state


@register_layer("embedding")
@dataclass
class Embedding(FeedForwardLayerConfig):
    """Embedding lookup (EmbeddingLayer.java): integer ids [batch] or
    [batch, 1] -> [batch, n_out], then the bias (``has_bias``) and the
    activation. Gathers as the JAX package's ``jnp.take`` does
    (:func:`_take_rows`); ids from the host are range-checked before the
    copy (:meth:`check_host_ids`)."""

    has_bias: bool = False

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def init(self, gen, input_type, dtype=torch.float32, device=None):
        return _dense_params(self, gen, input_type, dtype, device, self.has_bias)

    check_host_ids = staticmethod(_check_host_ids)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        idx = x.to(torch.int64)
        if idx.dim() == 2 and idx.shape[-1] == 1:
            idx = idx[:, 0]
        y = _gather_features(_take_rows(params["W"], idx), self.n_out)
        if self.has_bias:
            y = y + params["b"]
        return self.activation_fn()(y), state


@register_layer("embedding_sequence")
@dataclass
class EmbeddingSequence(FeedForwardLayerConfig):
    """Sequence embedding: int [batch, time] -> [batch, time, n_out].

    ``apply`` gathers as the reference's ``jnp.take(W, idx, axis=0)``
    does, with no read back to the host: ids in ``[-V, 0)`` wrap and ids
    outside ``[-V, V)`` give rows of NaN. Ids that arrive from the host
    (numpy or CPU tensors) are checked before they are copied to the
    device (:meth:`check_host_ids`, called by the model's input path) and
    raise a ValueError outside ``[0, V)``."""

    has_bias: bool = False

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timesteps)

    def init(self, gen, input_type, dtype=torch.float32, device=None):
        return _dense_params(self, gen, input_type, dtype, device, False)

    check_host_ids = staticmethod(_check_host_ids)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        idx = x.to(torch.int64)
        if idx.dim() == 3 and idx.shape[-1] == 1:
            idx = idx[..., 0]
        return _gather_features(_take_rows(params["W"], idx), self.n_out), state


@register_layer("autoencoder")
@dataclass
class AutoEncoder(FeedForwardLayerConfig):
    """Denoising autoencoder layer (AutoEncoder.java). Its supervised path
    is a Dense encoder act(x @ W + b); :meth:`reconstruct` is encode then
    decode act(h @ W.T + vb) (``vb`` [n_in], the visible bias), on an input
    whose entries are zeroed with probability ``corruption_level`` during
    layer-wise pretraining (train/pretrain.py)."""

    corruption_level: float = 0.3
    activation: Any = "sigmoid"

    def init(self, gen, input_type, dtype=torch.float32, device=None):
        params = _dense_params(self, gen, input_type, dtype, device, True)
        params["vb"] = torch.zeros((params["W"].shape[0],), dtype=dtype, device=device)
        return params

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        x = self.maybe_dropout_input(x, train, rng)
        return self.activation_fn()(x @ params["W"] + params["b"]), state

    def encode(self, params, x):
        return self.activation_fn()(x @ params["W"] + params["b"])

    def decode(self, params, h):
        return self.activation_fn()(h @ params["W"].T + params["vb"])

    def reconstruct(self, params, x, *, rng=None, corrupt=False):
        if corrupt and rng is not None and self.corruption_level > 0:
            keep = _bernoulli(rng, 1.0 - self.corruption_level, x.shape, x.device)
            x = torch.where(keep, x, torch.zeros_like(x))
        return self.decode(params, self.encode(params, x))
