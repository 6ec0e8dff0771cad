"""Layerwise pretraining (train/pretrain.py) against the JAX package's on
the CPU: an AutoEncoder stack (corruption off, so no draw separates the
packages) and a VAE (the reparameterisation noise fixed to the same numpy
array in both) pretrained from the same f32 params; the pretrained layers'
params after a few Adam steps, the untouched layers bit-equal, and the
denoising corruption drawing from the model's generator."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.nn.input_type import InputType as JInputType
from deeplearning4j_tpu.nn.layers import AutoEncoder as JAutoEncoder
from deeplearning4j_tpu.nn.layers import Dense as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutputLayer
from deeplearning4j_tpu.nn.layers import VariationalAutoencoder as JVAE
from deeplearning4j_tpu.nn.model import MultiLayerConfiguration as JConf
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JNetwork
from deeplearning4j_tpu.train import pretrain as jpre
from deeplearning4j_tpu_torch.interop import params_from_numpy, params_to_numpy
from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration, MultiLayerNetwork
from deeplearning4j_tpu_torch.train import pretrain
from deeplearning4j_tpu_torch.utils.tree import tree_leaves

# f32, a few Adam steps in two frameworks
F32 = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith("DL4J_TPU_"):
            monkeypatch.delenv(k)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _pair(layers):
    jconf = JConf(layers=layers, input_type=JInputType.feed_forward(6),
                  updater={"type": "adam", "lr": 1e-2}, seed=8)
    jm = JNetwork(jconf).init()
    m = MultiLayerNetwork(MultiLayerConfiguration.from_json(jconf.to_json()),
                          device="cpu").init()
    params_from_numpy(m, jax.tree_util.tree_map(np.asarray, jm.params))
    return jm, m


def _x(n=24, seed=0):
    return np.random.RandomState(seed).rand(n, 6).astype(np.float32)


def _close(m, jm, layers=None):
    mp, jp = params_to_numpy(m), jm.params
    for i in (range(len(mp)) if layers is None else layers):
        for a, b in zip(tree_leaves(mp[i]), jax.tree_util.tree_leaves(jp[i])):
            np.testing.assert_allclose(a, np.asarray(b), **F32)


def test_autoencoder_stack_pretrains_as_the_reference():
    layers = (JAutoEncoder(n_out=5, corruption_level=0.0),
              JAutoEncoder(n_out=4, corruption_level=0.0, activation="tanh"),
              JOutputLayer(n_out=2, activation="softmax"))
    jm, m = _pair(layers)
    out_before = [t.clone() for t in tree_leaves(m.params[2])]
    x = _x()
    jpre.pretrain(jm, x, epochs=2, batch_size=8)
    pretrain.pretrain(m, x, epochs=2, batch_size=8)
    _close(m, jm)
    assert all(torch.equal(a, b) for a, b in zip(out_before, tree_leaves(m.params[2])))
    assert not np.allclose(params_to_numpy(m)[0]["W"], np.asarray(JNetwork(jm.conf).init()
                                                                   .params[0]["W"]))


def test_vae_pretrains_as_the_reference_with_the_same_noise(monkeypatch):
    layers = (JDense(n_out=6, activation="tanh"),
              JVAE(n_out=2, encoder_layer_sizes=(5,), decoder_layer_sizes=(5,),
                   reconstruction="gaussian", num_samples=2),
              JOutputLayer(n_out=2, activation="softmax"))
    jm, m = _pair(layers)
    x = _x(16)
    eps = np.random.RandomState(3).randn(2, 8, 2).astype(np.float32)

    def jloss(layer, params, feats, rng):   # the reference's ELBO, noise fixed
        mean, log_var = layer.encode(params, feats)
        kl = 0.5 * jnp.sum(jnp.exp(log_var) + mean ** 2 - 1.0 - log_var, axis=-1)
        rec = 0.0
        for e in eps:
            rec = rec + layer._reconstruction_log_prob(
                params, feats, mean + jnp.exp(0.5 * log_var) * e)
        return jnp.mean(kl - rec / layer.num_samples)

    monkeypatch.setattr(jpre, "_pretrain_loss", jloss)
    monkeypatch.setattr(pretrain, "_pretrain_loss",
                        lambda layer, p, feats, rng: layer.elbo_loss(
                            p, feats, rng, eps=torch.as_tensor(eps)))
    jpre.pretrain_layer(jm, 1, x, epochs=3, batch_size=8)
    pretrain.pretrain_layer(m, 1, x, epochs=3, batch_size=8)
    _close(m, jm)


def test_denoising_corruption_draws_from_the_model_generator():
    conf = MultiLayerConfiguration.from_json(JConf(
        layers=(JAutoEncoder(n_out=3, corruption_level=0.5),
                JOutputLayer(n_out=2, activation="softmax")),
        input_type=JInputType.feed_forward(6), seed=8).to_json())
    runs = []
    for _ in range(2):
        m = MultiLayerNetwork(conf, device="cpu").init()
        g0 = m._gen.get_state()
        pretrain.pretrain(m, _x(8), epochs=1)
        assert not torch.equal(g0, m._gen.get_state())
        runs.append(m)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(runs[0].params),
                                                 tree_leaves(runs[1].params)))


def test_pretrain_layer_rejects_a_plain_layer():
    _, m = _pair((JDense(n_out=3), JOutputLayer(n_out=2, activation="softmax")))
    with pytest.raises(ValueError, match="not pretrainable"):
        pretrain.pretrain_layer(m, 0, _x())
    assert not pretrain.is_pretrainable(m.layers[0])
