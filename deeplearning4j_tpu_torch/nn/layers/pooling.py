"""Global pooling (PyTorch port of ``nn/layers/pooling.py``;
GlobalPoolingLayer.java): reduce over time ([b, t, f] -> [b, f]) or the
spatial axes ([b, h, w, c] -> [b, c]); MAX | AVG | SUM | PNORM; masked over
time as the reference's masked reduction (util/MaskedReductionUtil.java)
does."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from deeplearning4j_tpu_torch.nn.config import LayerConfig, register_layer
from deeplearning4j_tpu_torch.nn.input_type import InputType


@register_layer("global_pooling")
@dataclass
class GlobalPooling(LayerConfig):
    pooling: str = "max"
    pnorm: int = 2

    def output_type(self, input_type: InputType) -> InputType:
        if input_type.kind == "recurrent":
            return InputType.feed_forward(input_type.size)
        if input_type.kind == "conv":
            return InputType.feed_forward(input_type.channels)
        return input_type

    def _masked(self, x, mask):
        """[b, t, f] pooled over the time steps where ``mask`` [b, t] > 0."""
        m = mask[..., None].to(x.dtype)
        if self.pooling == "max":
            return torch.amax(torch.where(m > 0, x, x.new_tensor(float("-inf"))), dim=1)
        if self.pooling in ("avg", "mean"):
            return torch.sum(x * m, dim=1) / torch.clamp_min(torch.sum(m, dim=1), 1.0)
        if self.pooling == "sum":
            return torch.sum(x * m, dim=1)
        if self.pooling == "pnorm":
            p = float(self.pnorm)
            return torch.sum((torch.abs(x) * m) ** p, dim=1) ** (1.0 / p)
        raise ValueError(self.pooling)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        if x.dim() == 3:   # [b, t, f], reduced over time
            if mask is not None:
                return self._masked(x, mask), state
            axes = (1,)
        elif x.dim() == 4:   # [b, h, w, c]
            axes = (1, 2)
        else:
            raise ValueError(f"GlobalPooling expects rank 3 or 4 input, got {tuple(x.shape)}")
        if self.pooling == "max":
            y = torch.amax(x, dim=axes)
        elif self.pooling in ("avg", "mean"):
            y = torch.mean(x, dim=axes)
        elif self.pooling == "sum":
            y = torch.sum(x, dim=axes)
        elif self.pooling == "pnorm":
            p = float(self.pnorm)
            y = torch.sum(torch.abs(x) ** p, dim=axes) ** (1.0 / p)
        else:
            raise ValueError(self.pooling)
        return y, state

    def propagate_mask(self, mask, input_type):
        return None
