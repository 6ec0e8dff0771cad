"""Normalization layers (PyTorch port of ``nn/layers/normalization.py``):
BatchNorm, LocalResponseNormalization, the functional ``layer_norm`` and
``LayerNorm``.

BatchNorm keeps the JAX package's numbers, not ``F.batch_norm``'s: the
batch statistics in f32 (the variance biased, taken two-pass around the
mean), the running statistics ``decay * old + (1 - decay) * batch`` in the
layer ``state`` (f32 ``mean`` and ``var``, not params), and the
normalisation folded into a per-channel scale and shift applied in the
input dtype. ``F.batch_norm`` would update the running variance with the
unbiased estimate and weigh the batch by ``momentum``.

Under a mesh whose ``data`` or ``seq`` axis is larger than 1 (the parallel
trainers), the batch statistics are those of the global batch: the
per-rank weighted counts and sums are SUM-all-reduced, then the squared
residuals around the global mean (the same two passes, no E[x^2] - mean^2
cancellation), through collectives autograd sees (``parallel/comm.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from deeplearning4j_tpu_torch.nn.config import LayerConfig, register_layer
from deeplearning4j_tpu_torch.nn.input_type import InputType
from deeplearning4j_tpu_torch.parallel import comm
from deeplearning4j_tpu_torch.parallel.context import mesh_sub


@register_layer("batch_norm")
@dataclass
class BatchNorm(LayerConfig):
    """Batch normalization over the channel / feature axis (the last, NHWC).

    DL4J defaults (BatchNormalization.java): decay=0.9 (the running
    statistics' EMA), eps=1e-5, lockGammaBeta=False. ``ex_weight`` [B]
    (the fit loop's padded tail rows weighted 0) keeps rows out of the batch
    statistics."""

    CONSUMES_EXAMPLE_WEIGHT = True  # batch stats must exclude padded rows

    decay: float = 0.9
    eps: float = 1e-5
    use_gamma_beta: bool = True   # lockGammaBeta=True in DL4J means fixed 1/0
    gamma_init: float = 1.0
    beta_init: float = 0.0

    def _nfeat(self, input_type: InputType) -> int:
        return input_type.channels if input_type.kind == "conv" else input_type.flat_size()

    def init(self, gen, input_type, dtype=torch.float32, device=None):
        if not self.use_gamma_beta:
            return {}
        n = self._nfeat(input_type)
        return {"gamma": torch.full((n,), self.gamma_init, dtype=dtype, device=device),
                "beta": torch.full((n,), self.beta_init, dtype=dtype, device=device)}

    def init_state(self, input_type: InputType):
        n = self._nfeat(input_type)
        return {"mean": torch.zeros((n,), dtype=torch.float32),
                "var": torch.ones((n,), dtype=torch.float32)}

    def apply(self, params, state, x, *, train=False, rng=None, mask=None, ex_weight=None):
        dt = x.dtype
        f32 = torch.float32 if dt in (torch.bfloat16, torch.float16) else dt
        axes = tuple(range(x.dim() - 1))   # all but the channel / feature axis
        sync = mesh_sub(("data", "seq")) if train else None
        if train:
            # f32-accumulated mean of x, then the f32-accumulated mean of the
            # squared residual in the model dtype (two-pass, biased)
            if sync is not None:
                mean, var = self._global_stats(x, ex_weight, f32, axes, sync)
            elif ex_weight is not None:
                w = ex_weight.reshape((x.shape[0],) + (1,) * (x.dim() - 1)).to(dt)
                spatial = 1
                for d in x.shape[1:-1]:
                    spatial *= d
                denom = torch.clamp_min(torch.sum(w, dtype=f32) * spatial, 1.0)
                mean = torch.sum(x * w, dim=axes, dtype=f32) / denom
                xc = (x - mean.to(dt)) * w
                var = torch.sum(xc * xc, dim=axes, dtype=f32) / denom
            else:
                mean = torch.mean(x, dim=axes, dtype=f32)
                xc = x - mean.to(dt)
                var = torch.mean(xc * xc, dim=axes, dtype=f32)
            new_state = {
                "mean": self.decay * state["mean"] + (1.0 - self.decay) * mean,
                "var": self.decay * state["var"] + (1.0 - self.decay) * var,
            }
        else:
            mean, var = state["mean"].to(f32), state["var"].to(f32)
            new_state = state
        inv = torch.rsqrt(var + self.eps)
        if self.use_gamma_beta and params:
            a = params["gamma"].to(f32) * inv
            b = params["beta"].to(f32) - mean * a
        else:
            a = inv
            b = -mean * inv
        return x * a.to(dt) + b.to(dt), new_state

    @staticmethod
    def _global_stats(x, ex_weight, f32, axes, sub):
        """Mean and biased variance over every rank's rows of ``sub``: the
        weighted count and sum all-reduced, then the squared residuals
        around the global mean."""
        dt = x.dtype
        w = None
        if ex_weight is not None:
            w = ex_weight.reshape((x.shape[0],) + (1,) * (x.dim() - 1)).to(dt)
            spatial = 1
            for d in x.shape[1:-1]:
                spatial *= d
            n = torch.sum(w, dtype=f32) * spatial
            s1 = torch.sum(x * w, dim=axes, dtype=f32)
        else:
            n = torch.tensor(float(x.numel() // x.shape[-1]), dtype=f32, device=x.device)
            s1 = torch.sum(x, dim=axes, dtype=f32)
        tot = comm.all_reduce_sum(torch.cat([n.reshape(1), s1]), sub)
        denom = torch.clamp_min(tot[0], 1.0)
        mean = tot[1:] / denom
        xc = x - mean.to(dt)
        if w is not None:
            xc = xc * w
        var = comm.all_reduce_sum(torch.sum(xc * xc, dim=axes, dtype=f32), sub) / denom
        return mean, var


@register_layer("lrn")
@dataclass
class LocalResponseNormalization(LayerConfig):
    """Local response normalization across channels
    (LocalResponseNormalization.java): x / (k + alpha * sum of x^2 over n
    adjacent channels)^beta, the window padded with zeros as
    ``reduce_window`` pads it. DL4J defaults: k=2, n=5, alpha=1e-4,
    beta=0.75."""

    k: float = 2.0
    n: int = 5
    alpha: float = 1e-4
    beta: float = 0.75

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        half = self.n // 2
        sq = torch.nn.functional.pad(x * x, (half, self.n - 1 - half))
        ssum = sq.unfold(-1, self.n, 1).sum(-1)
        return x / (self.k + self.alpha * ssum) ** self.beta, state


def layer_norm(x, gamma=None, beta=None, eps: float = 1e-5):
    """Layer norm over the last axis, as the JAX package computes it:
    statistics in f32 for bf16 input, the normalised value cast back to the
    input dtype BEFORE the affine, which then runs in the input dtype.
    (``torch.nn.functional.layer_norm`` applies the affine in f32, a
    different function for bf16, so it runs here without one.) Its kernel
    reduces each row on its own, whatever the count of rows; a ``mean`` over
    the last axis does not on the card, where a row's statistics then
    depend on the batch it rides in (a decode step batched would round
    otherwise than the same rows alone)."""
    dt = x.dtype
    xs = x.float() if dt == torch.bfloat16 else x
    y = torch.nn.functional.layer_norm(xs, (xs.shape[-1],), eps=eps).to(dt)
    if gamma is not None:
        y = y * gamma + beta
    return y


@register_layer("layer_norm")
@dataclass
class LayerNorm(LayerConfig):
    """Layer normalization over the last (feature) axis."""

    eps: float = 1e-5
    use_gamma_beta: bool = True

    def _nfeat(self, input_type: InputType) -> int:
        return input_type.channels if input_type.kind == "conv" else input_type.size

    def init(self, gen, input_type, dtype=torch.float32, device=None):
        if not self.use_gamma_beta:
            return {}
        n = self._nfeat(input_type)
        return {"gamma": torch.ones((n,), dtype=dtype, device=device),
                "beta": torch.zeros((n,), dtype=dtype, device=device)}

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        g = params.get("gamma") if params else None
        b = params.get("beta") if params else None
        return layer_norm(x, g, b, self.eps), state
