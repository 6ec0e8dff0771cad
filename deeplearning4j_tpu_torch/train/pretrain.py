"""Layerwise unsupervised pretraining (VAE ELBO, denoising autoencoder)
(PyTorch port of ``deeplearning4j_tpu/train/pretrain.py``).

Capability parity with the reference's pretrain path
(MultiLayerNetwork.pretrain / pretrainLayer — the Solver drives a
pretrainable layer's own score; gradientcheck/GradientCheckUtil.java:512
checks it). Each step is the layer's unsupervised objective on that
layer's params alone, with the earlier layers applied in inference mode as
a fixed featurizer, then the updater (its own state, built per call).
"""

from __future__ import annotations

from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.model import MultiLayerNetwork, _iter_batches
from deeplearning4j_tpu_torch.train.updaters import make_updater, normalize_updater
from deeplearning4j_tpu_torch.utils.tree import (
    tree_leaves,
    tree_map,
    tree_unflatten_like,
)

__all__ = ["is_pretrainable", "pretrain", "pretrain_layer"]


def _pretrain_loss(layer, params, x, rng):
    """Dispatch to the layer's unsupervised objective."""
    if hasattr(layer, "elbo_loss"):  # VariationalAutoencoder
        return layer.elbo_loss(params, x, rng)
    if hasattr(layer, "reconstruct"):  # AutoEncoder: denoising MSE
        rec = layer.reconstruct(params, x, rng=rng, corrupt=True)
        return torch.mean(torch.sum((rec - x) ** 2, dim=-1))
    raise ValueError(f"Layer {layer._type_name} is not pretrainable")


def is_pretrainable(layer) -> bool:
    return hasattr(layer, "elbo_loss") or hasattr(layer, "reconstruct")


def pretrain_layer(model: MultiLayerNetwork, layer_idx: int, data,
                   epochs: int = 1, batch_size: Optional[int] = None,
                   updater=None) -> MultiLayerNetwork:
    """Unsupervised-train ONE layer; earlier layers featurize in inference
    mode (MultiLayerNetwork.pretrainLayer). Draws come from the model's
    generator."""
    layer = model.layers[layer_idx]
    if not is_pretrainable(layer):
        raise ValueError(f"layer {layer_idx} ({layer._type_name}) is not pretrainable")
    upd = make_updater(normalize_updater(updater or model.conf.updater))
    lparams = tree_map(lambda t: t.detach().clone(), model.params[layer_idx])
    with torch.no_grad():
        opt_state = upd.init(lparams)
    it = 0
    for _ in range(epochs):
        source = data() if callable(data) else data
        for x, _, _, _ in _iter_batches(source, batch_size):
            # featurize through the preceding stack, no state updates
            with torch.no_grad():
                feats = model._forward(model.params, model.state, x, train=False,
                                       upto=layer_idx)[0]
            live = [t.requires_grad_(True) for t in tree_leaves(lparams)]
            loss = _pretrain_loss(layer, tree_unflatten_like(lparams, live), feats,
                                  model._gen)
            grads = tree_unflatten_like(lparams, list(torch.autograd.grad(loss, live)))
            with torch.no_grad():
                delta, opt_state = upd.update(grads, opt_state, lparams, it)
                lparams = tree_map(lambda p, d: (p - d).detach(), lparams, delta)
            it += 1
    model.params = model.params[:layer_idx] + (lparams,) + model.params[layer_idx + 1:]
    return model


def pretrain(model: MultiLayerNetwork, data, epochs: int = 1,
             batch_size: Optional[int] = None, updater=None) -> MultiLayerNetwork:
    """Greedy layerwise pretraining over every pretrainable layer, in order
    (MultiLayerNetwork.pretrain)."""
    if model.params is None:
        model.init()
    for i, layer in enumerate(model.layers):
        if is_pretrainable(layer):
            pretrain_layer(model, i, data, epochs=epochs, batch_size=batch_size,
                           updater=updater)
    return model
