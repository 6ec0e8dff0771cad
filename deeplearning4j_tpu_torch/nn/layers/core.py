"""Core feed-forward layers (PyTorch port of ``nn/layers/core.py``).

Ported so far: ``EmbeddingSequence``, the token embedding of the
TransformerLM. The rest of the file (Dense, OutputLayer, the dropout and
noise family, Embedding, AutoEncoder) arrives with its slice.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from deeplearning4j_tpu_torch.nn import initializers
from deeplearning4j_tpu_torch.nn.config import FeedForwardLayerConfig, register_layer
from deeplearning4j_tpu_torch.nn.input_type import InputType


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
        n_in = self.n_in if self.n_in is not None else input_type.flat_size()
        return {
            "W": initializers.initialize(self.weight_init, gen, (n_in, self.n_out),
                                         n_in, self.n_out, dtype, device)
        }

    @staticmethod
    def check_host_ids(x: torch.Tensor, vocab: int) -> None:
        """Raise a ValueError for a host tensor of ids outside ``[0, vocab)``."""
        idx = x.to(torch.int64)
        if idx.numel() and bool(((idx < 0) | (idx >= vocab)).any()):
            raise ValueError(
                f"embedding ids must lie in [0, {vocab}), got "
                f"[{int(idx.min())}, {int(idx.max())}]")

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        idx = x.to(torch.int64)
        if idx.dim() == 3 and idx.shape[-1] == 1:
            idx = idx[..., 0]
        W = params["W"]
        V = W.shape[0]
        idx = torch.where(idx < 0, idx + V, idx)
        valid = (idx >= 0) & (idx < V)
        rows = W[idx.clamp(0, V - 1)]
        return torch.where(valid[..., None], rows, rows.new_tensor(float("nan"))), state
