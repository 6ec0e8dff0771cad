"""The six layer types this slice ports, on the CPU against the JAX package
from the same numpy params and inputs: ``lambda``, ``frozen``,
``center_loss_output``, ``cnn_loss``, ``vae`` and ``yolo2_output`` (their
forward, score and gradients; the VAE's ELBO, log-probability and
generation with the same eps fed to both; the YOLO host helpers), and
their JSON. f32 within 1e-5 relative (F32); gradients within 1e-4."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.nn.config import LayerConfig as JLayerConfig
from deeplearning4j_tpu.nn.input_type import InputType as JInputType
from deeplearning4j_tpu.nn.layers import custom as jcustom
from deeplearning4j_tpu.nn.layers import objdetect as jobj
from deeplearning4j_tpu.nn.layers import variational as jvae
from deeplearning4j_tpu.nn.layers.core import Dense as JDense
from deeplearning4j_tpu.nn.layers.core import OutputLayer as JOutputLayer
from deeplearning4j_tpu.nn.layers.normalization import BatchNorm as JBatchNorm
from deeplearning4j_tpu.nn.model import MultiLayerConfiguration as JConf
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JNetwork
from deeplearning4j_tpu_torch.interop import params_from_numpy, params_to_numpy
from deeplearning4j_tpu_torch.nn.config import LayerConfig
from deeplearning4j_tpu_torch.nn.input_type import InputType
from deeplearning4j_tpu_torch.nn.layers import custom, objdetect, variational
from deeplearning4j_tpu_torch.nn.layers.core import Dense
from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration, MultiLayerNetwork

F32 = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    # another test module may leave tuning knobs (DL4J_TPU_GRAD_ACCUM, ...)
    # in os.environ; both packages' fit paths read them
    for k in list(os.environ):
        if k.startswith("DL4J_TPU_"):
            monkeypatch.delenv(k)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _t(a):
    return torch.from_numpy(np.array(a))


def _params_pair(jlayer, layer, it, jit, seed=0):
    """The JAX layer's params (numpy) and the same as tensors, grad-ready."""
    jp = jax.tree_util.tree_map(np.asarray, jlayer.init(jax.random.PRNGKey(seed), jit))
    tp = jax.tree_util.tree_map(lambda a: _t(a).requires_grad_(True), jp)
    return jp, tp


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _grads_close(loss, tp, jgrads):
    got = torch.autograd.grad(loss, _leaves(tp))
    for g, w in zip(got, _leaves(jax.tree_util.tree_map(np.asarray, jgrads))):
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD["rtol"],
                                   atol=GRAD["atol"] * max(1.0, np.abs(w).max()))


# -- JSON ---------------------------------------------------------------------

@pytest.mark.parametrize("layer", [
    custom.FrozenLayer(inner=Dense(n_in=3, n_out=4, activation="tanh")),
    custom.CenterLossOutputLayer(n_out=4, alpha=0.1, lambda_=1e-3),
    custom.CnnLossLayer(activation="softmax", loss="mcxent"),
    variational.VariationalAutoencoder(n_out=3, encoder_layer_sizes=(8, 6),
                                       decoder_layer_sizes=(5,), reconstruction="bernoulli"),
    objdetect.Yolo2OutputLayer(boxes=((1.0, 1.5), (2.0, 0.5)), lambda_coord=4.0),
], ids=["frozen", "center_loss_output", "cnn_loss", "vae", "yolo2_output"])
def test_layer_json_round_trips_across_packages(layer):
    s = layer.to_json()
    assert LayerConfig.from_json(s) == layer
    assert JLayerConfig.from_json(s).to_dict() == json.loads(s)
    assert json.loads(LayerConfig.from_json(JLayerConfig.from_json(s).to_json()).to_json()) \
        == json.loads(s)


def test_lambda_layer_applies_its_function_and_refuses_json():
    lam = custom.LambdaLayer(fn=lambda x: 2.0 * torch.tanh(x))
    x = torch.randn(3, 4)
    y, st = lam.apply({}, {}, x)
    torch.testing.assert_close(y, 2.0 * torch.tanh(x))
    assert st == {}
    d = json.loads(lam.to_json())
    assert d["fn"] == {"@callable": "<lambda>"}
    with pytest.raises(ValueError, match="callable"):
        LayerConfig.from_json(lam.to_json())
    with pytest.raises(ValueError, match="fn missing"):
        custom.LambdaLayer().apply({}, {}, x)


# -- frozen -------------------------------------------------------------------

def test_frozen_layer_runs_eval_mode_and_takes_no_update():
    jconf = JConf(layers=(jcustom.FrozenLayer(inner=JDense(n_in=4, n_out=5, activation="tanh")),
                          jcustom.FrozenLayer(inner=JBatchNorm()),
                          JOutputLayer(n_out=3, activation="softmax")),
                  input_type=JInputType.feed_forward(4), updater={"type": "sgd", "lr": 0.1})
    jm = JNetwork(jconf).init()
    m = MultiLayerNetwork(MultiLayerConfiguration.from_json(jconf.to_json()),
                          device="cpu").init()
    params_from_numpy(m, jax.tree_util.tree_map(np.asarray, jm.params))
    assert not m.layers[0].trainable and not m.layers[1].trainable
    rs = np.random.RandomState(0)
    x = rs.randn(6, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 6)]
    frozen = m.params[0]["W"].clone()
    m.fit((x, y), epochs=2)
    jm.fit((x, y), epochs=2)
    assert torch.equal(m.params[0]["W"], frozen)
    assert torch.equal(m.state[1]["mean"], torch.zeros(5))   # eval mode: no statistics
    for a, b in zip(_leaves(params_to_numpy(m)),
                    _leaves(jax.tree_util.tree_map(np.asarray, jm.params))):
        np.testing.assert_allclose(a, b, **GRAD)
    np.testing.assert_allclose(m.output(x).numpy(), np.asarray(jm.output(x)), **F32)


# -- center loss, cnn loss ----------------------------------------------------

@pytest.mark.parametrize("sparse", [False, True], ids=["one_hot", "sparse"])
def test_center_loss_output_matches_jax(sparse):
    kw = dict(n_in=5, n_out=4, alpha=0.1, lambda_=0.5)
    jl, tl_ = jcustom.CenterLossOutputLayer(**kw), custom.CenterLossOutputLayer(**kw)
    jp, tp = _params_pair(jl, tl_, InputType.feed_forward(5), JInputType.feed_forward(5))
    rs = np.random.RandomState(1)
    jp["centers"] = rs.randn(4, 5).astype(np.float32)
    tp["centers"] = _t(jp["centers"]).requires_grad_(True)
    x = rs.randn(6, 5).astype(np.float32)
    cls = rs.randint(0, 4, 6)
    y = cls.astype(np.int32) if sparse else np.eye(4, dtype=np.float32)[cls]
    jy, ty = jnp.asarray(y), (_t(y).long() if sparse else _t(y))
    np.testing.assert_allclose(tl_.apply(tp, {}, _t(x))[0].detach().numpy(),
                               np.asarray(jl.apply(jp, {}, jnp.asarray(x))[0]), **F32)
    jloss, jg = jax.jit(jax.value_and_grad(lambda p: jl.score(p, jnp.asarray(x), jy)))(jp)
    loss = tl_.score(tp, _t(x), ty)
    np.testing.assert_allclose(loss.item(), float(jloss), **F32)
    _grads_close(loss, tp, jg)
    assert tl_.regularization_penalty({"W": tp["W"], "b": tp["b"],
                                       "centers": tp["centers"]}).item() == 0.0


def test_cnn_loss_matches_jax():
    jl, tl_ = jcustom.CnnLossLayer(activation="softmax"), custom.CnnLossLayer(activation="softmax")
    rs = np.random.RandomState(2)
    x = rs.randn(2, 3, 4, 5).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rs.randint(0, 5, (2, 3, 4))]
    m = (rs.rand(2, 3, 4) > 0.3).astype(np.float32)
    xt = _t(x).requires_grad_(True)
    for mask in (None, m):
        jloss, jg = jax.jit(jax.value_and_grad(lambda a: jl.score(
            {}, a, jnp.asarray(y), None if mask is None else jnp.asarray(mask))))(jnp.asarray(x))
        loss = tl_.score({}, xt, _t(y), None if mask is None else _t(mask))
        np.testing.assert_allclose(loss.item(), float(jloss), **F32)
        _grads_close(loss, [xt], [jg])
    per = tl_.score({}, _t(x), _t(y), average=False)
    np.testing.assert_allclose(per.numpy(), np.asarray(jl.score({}, jnp.asarray(x),
                                                               jnp.asarray(y), average=False)),
                               **F32)
    assert tl_.output_type(InputType.convolutional(3, 4, 5)).kind == "conv"


# -- VAE ----------------------------------------------------------------------

@pytest.mark.parametrize("recon", ["gaussian", "bernoulli"])
def test_vae_matches_jax_with_the_same_noise(recon):
    kw = dict(n_out=3, encoder_layer_sizes=(8, 6), decoder_layer_sizes=(7,),
              reconstruction=recon, activation="tanh", num_samples=2)
    jl, tl_ = jvae.VariationalAutoencoder(**kw), variational.VariationalAutoencoder(**kw)
    jp, tp = _params_pair(jl, tl_, InputType.feed_forward(5), JInputType.feed_forward(5))
    assert len(tl_.init(torch.Generator().manual_seed(0), InputType.feed_forward(5))["enc"]) == 2
    rs = np.random.RandomState(3)
    x = (rs.rand(4, 5) > 0.5).astype(np.float32) if recon == "bernoulli" else \
        rs.randn(4, 5).astype(np.float32)
    np.testing.assert_allclose(tl_.apply(tp, {}, _t(x))[0].detach().numpy(),
                               np.asarray(jl.apply(jp, {}, jnp.asarray(x))[0]), **F32)
    # the JAX package draws eps from its keys; feed those same draws here
    key = jax.random.PRNGKey(5)
    eps = np.stack([np.asarray(jax.random.normal(k, (4, 3))) for k in
                    jax.random.split(key, 2)])
    jloss, jg = jax.jit(jax.value_and_grad(lambda p: jl.elbo_loss(p, jnp.asarray(x), key)))(jp)
    loss = tl_.elbo_loss(tp, _t(x), eps=_t(eps))
    np.testing.assert_allclose(loss.item(), float(jloss), **F32)
    _grads_close(loss, tp, jg)
    eps5 = np.stack([np.asarray(jax.random.normal(k, (4, 3))) for k in
                     jax.random.split(key, 5)])
    np.testing.assert_allclose(
        tl_.reconstruction_log_probability(tp, _t(x), eps=_t(eps5)).detach().numpy(),
        np.asarray(jl.reconstruction_log_probability(jp, jnp.asarray(x), key)),
        rtol=1e-5, atol=1e-5)
    z = rs.randn(4, 3).astype(np.float32)
    np.testing.assert_allclose(tl_.generate(tp, _t(z)).detach().numpy(),
                               np.asarray(jl.generate(jp, jnp.asarray(z))), **F32)
    # a generator's draws: a finite loss of the same scale
    g = torch.Generator().manual_seed(0)
    assert torch.isfinite(tl_.elbo_loss(tp, _t(x), rng=g))


# -- YOLO ---------------------------------------------------------------------

def _yolo_case(seed):
    rs = np.random.RandomState(seed)
    B, H, W, C = 2, 3, 3, 4
    boxes = ((1.0, 1.5), (2.0, 0.7))
    x = (0.5 * rs.randn(B, H, W, len(boxes) * (5 + C))).astype(np.float32)
    y = np.zeros((B, H, W, 4 + C), np.float32)
    for b, i, j in ((0, 0, 1), (0, 2, 2), (1, 1, 0)):
        cx, cy = j + rs.rand(), i + rs.rand()
        w, h = 0.5 + rs.rand() * 1.5, 0.5 + rs.rand() * 1.5
        y[b, i, j, :4] = (cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2)
        y[b, i, j, 4 + rs.randint(0, C)] = 1.0
    return boxes, x, y, C


def test_yolo2_output_score_and_activate_match_jax():
    boxes, x, y, C = _yolo_case(4)
    jl = jobj.Yolo2OutputLayer(boxes=boxes)
    tl_ = objdetect.Yolo2OutputLayer(boxes=boxes)
    for a, b in zip(tl_.activate(_t(x), C), jl.activate(jnp.asarray(x), C)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)
    xt = _t(x).requires_grad_(True)
    for average in (True, False):
        jloss, jg = jax.jit(jax.value_and_grad(
            lambda a: jl.score({}, a, jnp.asarray(y), average=average)))(jnp.asarray(x))
        loss = tl_.score({}, xt, _t(y), average=average)
        np.testing.assert_allclose(loss.item(), float(jloss), **F32)
        _grads_close(loss, [xt], [jg])
    assert tl_.apply({}, {}, _t(x))[0] is not None


def test_yolo_host_helpers_match_jax():
    boxes, x, _, C = _yolo_case(5)
    jl = jobj.Yolo2OutputLayer(boxes=boxes)
    tl_ = objdetect.Yolo2OutputLayer(boxes=boxes)
    dets = objdetect.get_predicted_objects(tl_, _t(x), C, threshold=0.4)
    jdets = jobj.get_predicted_objects(jl, x, C, threshold=0.4)
    assert [len(d) for d in dets] == [len(d) for d in jdets]
    for a, b in zip(sum(dets, []), sum(jdets, [])):
        assert a.class_idx == b.class_idx
        np.testing.assert_allclose(a.box, b.box, **F32)
        np.testing.assert_allclose(a.confidence, b.confidence, **F32)
    kept = objdetect.non_max_suppression(sum(dets, []), 0.3)
    jkept = jobj.non_max_suppression(sum(jdets, []), 0.3)
    assert sorted((d.class_idx, round(d.confidence, 5)) for d in kept) == \
        sorted((d.class_idx, round(d.confidence, 5)) for d in jkept)
    assert objdetect.iou_xyxy(np.array([0, 0, 2, 2]), np.array([1, 1, 3, 3])) == \
        pytest.approx(1 / 7)
    assert "cls=" in repr(kept[0]) if kept else True


def test_tiny_yolo_scores_like_jax():
    """TinyYOLO at 64 x 64 (a 2 x 2 grid) from the same weights: the
    network's YOLO loss."""
    from deeplearning4j_tpu.models import TinyYOLO as JTinyYOLO
    from deeplearning4j_tpu_torch.models import TinyYOLO

    jm = JNetwork(JTinyYOLO(height=64, width=64, num_classes=3)).init()
    m = MultiLayerNetwork(TinyYOLO(height=64, width=64, num_classes=3), device="cpu").init()
    params_from_numpy(m, jax.tree_util.tree_map(np.asarray, jm.params))
    x = np.random.RandomState(0).randn(1, 64, 64, 3).astype(np.float32)
    y = np.zeros((1, 2, 2, 7), np.float32)
    y[:, 0, 0, :4] = [0.1, 0.1, 0.9, 0.9]
    y[:, 0, 0, 4] = 1.0
    assert tuple(m.output(x).shape) == (1, 2, 2, 40)
    np.testing.assert_allclose(m.score(x, y), jm.score(x, y), rtol=1e-4)


# -- activations --------------------------------------------------------------

def _activation_names():
    from deeplearning4j_tpu.nn import activations as jact

    return jact.names()


@pytest.mark.parametrize("name", _activation_names())
def test_every_activation_matches_jax(name):
    """Every activation of the JAX package's registry is in the port's,
    with the same values and gradients (leakyrelu came with Darknet19 and
    TinyYOLO)."""
    from deeplearning4j_tpu.nn import activations as jact
    from deeplearning4j_tpu_torch.nn import activations as act

    # 40 points off the kinks (0, +-1, +-6), where the two frameworks'
    # subgradient conventions differ
    x = (np.linspace(-7.0, 7.0, 40) + 0.0123).astype(np.float32)[None]
    jy, jg = jax.jit(jax.value_and_grad(lambda a: jnp.sum(jact.get(name)(a) * jnp.arange(40.0))))(
        jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    y = torch.sum(act.get(name)(xt) * torch.arange(40.0))
    np.testing.assert_allclose(y.item(), float(jy), rtol=1e-5, atol=1e-5)
    _grads_close(y, [xt], [jg])
