"""The variational autoencoder layer (PyTorch port of
``nn/layers/variational.py``; VariationalAutoencoder.java): encoder and
decoder MLPs, the Gaussian reparameterization, a Gaussian or Bernoulli
reconstruction distribution, the negative ELBO, the importance-sampled
reconstruction log-probability, and ``apply`` = the posterior mean (the
reference's ``activate``, the supervised path). The same JSON tag, fields,
defaults and parameter tree (``enc``/``dec`` lists of ``{W, b}``, the
``zW``/``zb`` head of q(z|x), the ``xW``/``xb`` head of p(x|z)).

Randomness (the reparameterization's eps) draws from a ``torch.Generator``
passed as ``rng``, or is given as ``eps`` [num_samples, B, n_out] so a test
can feed both packages the same noise. The layer-wise pretraining loop is
``train/pretrain.py``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from deeplearning4j_tpu_torch.nn import activations, initializers
from deeplearning4j_tpu_torch.nn.config import FeedForwardLayerConfig, batch_draw, register_layer
from deeplearning4j_tpu_torch.nn.input_type import InputType

_HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)


@register_layer("vae")
@dataclass
class VariationalAutoencoder(FeedForwardLayerConfig):
    """VAE as a layer. ``n_out`` is the latent size; ``reconstruction`` is
    "gaussian" (diagonal, learned variance) or "bernoulli" (sigmoid
    logits)."""

    encoder_layer_sizes: Tuple[int, ...] = (256,)
    decoder_layer_sizes: Tuple[int, ...] = (256,)
    reconstruction: str = "gaussian"
    pzx_activation: Any = "identity"
    num_samples: int = 1

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def _dims(self, n_in: int):
        enc = [n_in, *self.encoder_layer_sizes]
        dec = [self.n_out, *self.decoder_layer_sizes]
        rec_params_per_feat = 2 if self.reconstruction == "gaussian" else 1
        return enc, dec, rec_params_per_feat

    def init(self, gen, input_type, dtype=torch.float32, device=None):
        n_in = self.n_in if self.n_in is not None else input_type.flat_size()
        enc, dec, rpf = self._dims(n_in)

        def mk(fi, fo):
            return initializers.initialize(self.weight_init, gen, (fi, fo), fi, fo, dtype,
                                           device)

        def zeros(n):
            return torch.zeros((n,), dtype=dtype, device=device)

        p: Dict[str, Any] = {"enc": [], "dec": []}
        for a, b in zip(enc[:-1], enc[1:]):
            p["enc"].append({"W": mk(a, b), "b": zeros(b)})
        p["zW"] = mk(enc[-1], 2 * self.n_out)    # q(z|x): mean and log-variance
        p["zb"] = zeros(2 * self.n_out)
        for a, b in zip(dec[:-1], dec[1:]):
            p["dec"].append({"W": mk(a, b), "b": zeros(b)})
        p["xW"] = mk(dec[-1], rpf * n_in)        # p(x|z)'s parameters
        p["xb"] = zeros(rpf * n_in)
        return p

    def _mlp(self, blocks, x):
        act = self.activation_fn()
        for blk in blocks:
            x = act(x @ blk["W"] + blk["b"])
        return x

    def encode(self, params, x):
        """q(z|x) -> (mean, log_var)."""
        h = self._mlp(params["enc"], x)
        mean, log_var = torch.chunk(h @ params["zW"] + params["zb"], 2, dim=-1)
        return activations.get(self.pzx_activation)(mean), log_var

    def decode(self, params, z):
        return self._mlp(params["dec"], z) @ params["xW"] + params["xb"]

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        x = self.maybe_dropout_input(x, train, rng)
        return self.encode(params, x)[0], state

    def _reconstruction_log_prob(self, params, x, z):
        out = self.decode(params, z)
        if self.reconstruction == "bernoulli":
            return -torch.sum(torch.clamp_min(out, 0) - out * x
                              + torch.log1p(torch.exp(-torch.abs(out))), dim=-1)
        mu, log_var = torch.chunk(out, 2, dim=-1)
        return -torch.sum(_HALF_LOG_2PI + 0.5 * log_var
                          + 0.5 * (x - mu) ** 2 / torch.exp(log_var), dim=-1)

    @staticmethod
    def _eps(n, mean, rng, eps):
        if eps is not None:
            return [e.to(mean.dtype) for e in eps]
        return [batch_draw(torch.randn, mean.shape, generator=rng, device=mean.device,
                           dtype=mean.dtype) for _ in range(n)]

    def elbo_loss(self, params, x, rng=None, eps=None):
        """The negative ELBO averaged over the batch (the pretraining
        score); ``eps`` [num_samples, B, n_out] replaces the draws."""
        mean, log_var = self.encode(params, x)
        kl = 0.5 * torch.sum(torch.exp(log_var) + mean ** 2 - 1.0 - log_var, dim=-1)
        rec = 0.0
        for e in self._eps(self.num_samples, mean, rng, eps):
            z = mean + torch.exp(0.5 * log_var) * e
            rec = rec + self._reconstruction_log_prob(params, x, z)
        return torch.mean(kl - rec / self.num_samples)

    def reconstruction_log_probability(self, params, x, rng=None, num_samples: int = 5,
                                       eps=None):
        """The importance-sampled estimate of log p(x)
        (reconstructionLogProbability)."""
        mean, log_var = self.encode(params, x)
        terms = []
        for e in self._eps(num_samples, mean, rng, eps):
            z = mean + torch.exp(0.5 * log_var) * e
            log_px_z = self._reconstruction_log_prob(params, x, z)
            log_pz = -torch.sum(_HALF_LOG_2PI + 0.5 * z ** 2, dim=-1)
            log_qz = -torch.sum(_HALF_LOG_2PI + 0.5 * log_var + 0.5 * e ** 2, dim=-1)
            terms.append(log_px_z + log_pz - log_qz)
        return torch.logsumexp(torch.stack(terms), dim=0) - math.log(num_samples)

    def generate(self, params, z):
        """Reconstruction means of latent codes (generateAtMeanGivenZ)."""
        out = self.decode(params, z)
        if self.reconstruction == "bernoulli":
            return torch.sigmoid(out)
        return torch.chunk(out, 2, dim=-1)[0]
