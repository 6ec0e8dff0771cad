"""LeNet-5 and SimpleCNN end to end on the CPU against the JAX package, at
12 x 12 inputs, from the same numpy weights (``params_from_numpy``, and
``state_from_numpy`` for BatchNorm's running statistics): ``output``,
``feed_forward`` layer by layer, the gradient tree, a 3-step Adam ``fit``
(10 rows at batch 4, the tail padded, which BatchNorm's example weights
keep out of its statistics) with its loss curve, post-update params and
BatchNorm state, ``evaluate``, checkpoint zips written by one package and
read by the other, the trainer CLI on a tiny ``.npz``, ``:predict`` with
integer pixels, and ``clone`` / ``summary`` / ``n_layers``.

SimpleCNN's dropout draws from threefry in one package and a
``torch.Generator`` in the other, so the training comparisons run it with
``dropout=0`` in both (its train mode is held on the port alone in
``test_torch_cnn_layers.py``)."""

import dataclasses
import json
import os
import urllib.request

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.layers import DropoutLayer as JDropoutLayer
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JNetwork
from deeplearning4j_tpu.train import __main__ as jcli
from deeplearning4j_tpu.train.listeners import CollectScoresListener as JCollect
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu_torch import serve
from deeplearning4j_tpu_torch.interop import (
    params_from_numpy,
    params_to_numpy,
    state_from_numpy,
    state_to_numpy,
)
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration, MultiLayerNetwork
from deeplearning4j_tpu_torch.train import __main__ as cli
from deeplearning4j_tpu_torch.train.listeners import CollectScoresListener
from deeplearning4j_tpu_torch.utils import serialization as ser
from deeplearning4j_tpu_torch.utils.tree import tree_leaves

HW = 12
F32 = dict(rtol=1e-4, atol=1e-5)   # f32, the same steps; summation order differs


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


def _no_dropout(layer):
    return dataclasses.replace(layer, dropout=0.0) if isinstance(layer, JDropoutLayer) else layer


def _jconf(name, updater=None):
    """The zoo configuration at 12 x 12 (its own updater, Adam 1e-3, unless
    one is given)."""
    kw = dict(height=HW, width=HW, seed=7)
    if updater is not None:
        kw["updater"] = updater
    conf = getattr(jzoo, name)(**kw)
    if name == "SimpleCNN":
        conf.layers = tuple(_no_dropout(l) for l in conf.layers)
    return conf


def _pair(name, updater=None):
    """(JAX network, port network) with the same f32 weights and layer
    state (BatchNorm's running statistics set from a numpy seed, so that
    eval mode reads non-trivial ones)."""
    jm = JNetwork(_jconf(name, updater)).init()
    rs = np.random.RandomState(9)
    jm.state = tuple(
        {"mean": jax.numpy.asarray(0.3 * rs.randn(*s["mean"].shape), jax.numpy.float32),
         "var": jax.numpy.asarray(rs.uniform(0.5, 1.5, s["var"].shape), jax.numpy.float32)}
        if s else s for s in jm.state)
    m = MultiLayerNetwork(MultiLayerConfiguration.from_json(jm.conf.to_json()),
                          device="cpu").init()
    params_from_numpy(m, jax.tree_util.tree_map(np.asarray, jm.params))
    state_from_numpy(m, jax.tree_util.tree_map(np.asarray, jm.state))
    return jm, m


def _data(n, seed=0, channels=1):
    rs = np.random.RandomState(seed)
    x = rs.rand(n, HW, HW, channels).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rs.randint(0, 10, n)]
    return x, y


def _channels(name):
    return 3 if name == "SimpleCNN" else 1


def _flat(tree):
    out = {}
    for i, layer in enumerate(tree):
        for k, v in layer.items():
            out[f"{i}.{k}"] = np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
    return out


def _assert_trees_close(got, want, tol=F32, scaled=False):
    """Leaf by leaf; with ``scaled`` the atol is a share of the leaf's
    largest entry (gradients of order 5 whose entries near zero are sums of
    cancelling terms, regrouped)."""
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k in want:
        atol = tol["atol"] * max(1.0, float(np.abs(want[k]).max())) if scaled else tol["atol"]
        np.testing.assert_allclose(got[k], want[k], err_msg=k, rtol=tol["rtol"], atol=atol)


NAMES = ["LeNet5", "SimpleCNN"]


@pytest.mark.parametrize("name", NAMES)
def test_output_and_feed_forward_match_jax(name):
    jm, m = _pair(name)
    x, _ = _data(5, seed=1, channels=_channels(name))
    got = m.output(x)
    assert got.shape == (5, 10) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.output(x)), **F32)
    jacts, acts = jm.feed_forward(x), m.feed_forward(x)
    assert len(acts) == len(jacts) == m.n_layers == jm.n_layers
    for i, (a, b) in enumerate(zip(acts, jacts)):
        assert tuple(a.shape) == b.shape, i
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=str(i), **F32)


@pytest.mark.parametrize("name", NAMES)
def test_loss_gradients_and_new_state_match_jax(name):
    jm, m = _pair(name)
    x, y = _data(4, seed=2, channels=_channels(name))
    (jloss, (jstate, _)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm._loss(p, jm.state, x, y, None, None, None), has_aux=True))(jm.params)
    loss, new_state, grads, _ = m._value_and_grad(
        m.state, torch.from_numpy(x), torch.from_numpy(y), None, None, None)
    np.testing.assert_allclose(float(loss), float(jloss), **F32)
    want = jax.tree_util.tree_map(np.asarray, jgrads)
    _assert_trees_close(grads, want, F32, scaled=True)
    _assert_trees_close(new_state, jax.tree_util.tree_map(np.asarray, jstate),
                        dict(rtol=1e-5, atol=1e-6))
    assert not any(s.requires_grad for s in tree_leaves(new_state))


def _noise_entries(jm, x, y):
    """Entries whose first-step gradient (JAX) is nonzero but below 1e-7 of
    their tensor's largest: rounding noise, whose sign Adam turns into a
    step of +-lr either way. (Exact zeros, the weights of units whose ReLU
    is off for every row, are zero in both packages and stay compared.)"""
    g = jax.jit(jax.grad(lambda p: jm._loss(p, jm.state, x, y, None, None, None)[0]))(jm.params)
    g = _flat(jax.tree_util.tree_map(np.asarray, g))
    return {k: (v != 0) & (np.abs(v) < 1e-7 * np.abs(v).max()) for k, v in g.items()}


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("updater", [None, {"type": "sgd", "lr": 0.01}], ids=["adam", "sgd"])
def test_three_step_fit_matches_jax(name, updater):
    """Three steps at the zoo's own Adam rate (1e-3), and of SGD: the loss
    per step, the post-update params and BatchNorm's state. (At Adam 1e-2
    the steps are large enough that units whose ReLU input is near zero flip
    on rounding, and the trajectories part.)"""
    jm, m = _pair(name, updater)
    x, y = _data(10, seed=3, channels=_channels(name))
    noise = _noise_entries(jm, x[:4], y[:4])
    jl, pl = JCollect(), CollectScoresListener()
    jm.set_listeners(jl)
    m.set_listeners(pl)
    jm.fit((x, y), epochs=1, batch_size=4)    # 4, 4 and 2 rows padded to 4
    m.fit((x, y), epochs=1, batch_size=4)
    assert [i for i, _ in pl.scores] == [i for i, _ in jl.scores] == [1, 2, 3]
    np.testing.assert_allclose([s for _, s in pl.scores], [s for _, s in jl.scores], **F32)
    got = _flat(params_to_numpy(m))
    want = _flat(jax.tree_util.tree_map(np.asarray, jm.params))
    lr = m.conf.updater["lr"]
    for k in want:
        keep = ~noise[k]
        assert keep.mean() > 0.999, k
        np.testing.assert_allclose(got[k][keep], want[k][keep], err_msg=k, **F32)
        assert np.abs(got[k] - want[k]).max() <= 2 * 3 * lr, k
    _assert_trees_close(state_to_numpy(m), jax.tree_util.tree_map(np.asarray, jm.state),
                        dict(rtol=1e-5, atol=1e-6))
    if name == "SimpleCNN":   # four BatchNorm layers whose statistics moved
        bn = [s for s in m.state if s]
        assert len(bn) == 4 and all(s["mean"].abs().sum() > 0 for s in bn)
    ev, jev = m.evaluate((x, y), batch_size=4), jm.evaluate((x, y), batch_size=4)
    assert ev.accuracy() == jev.accuracy()


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_zips_cross_packages(name, writer, tmp_path):
    jm, m = _pair(name)
    x, y = _data(4, seed=4, channels=_channels(name))
    m.fit((x, y), epochs=1)
    jm.fit((x, y), epochs=1)
    path = str(tmp_path / "m.zip")
    if writer == "port":
        ser.save_network(m, path)
        back = jser.restore_network(path)
        _assert_trees_close(params_to_numpy(m), jax.tree_util.tree_map(np.asarray, back.params),
                            dict(rtol=0, atol=0))
        _assert_trees_close(state_to_numpy(m), jax.tree_util.tree_map(np.asarray, back.state),
                            dict(rtol=0, atol=0))
        np.testing.assert_allclose(np.asarray(back.output(x)), m.output(x).numpy(), **F32)
    else:
        jser.save_network(jm, path)
        back = ser.restore_network(path, device="cpu")
        _assert_trees_close(params_to_numpy(back), jax.tree_util.tree_map(np.asarray, jm.params),
                            dict(rtol=0, atol=0))
        _assert_trees_close(state_to_numpy(back), jax.tree_util.tree_map(np.asarray, jm.state),
                            dict(rtol=0, atol=0))
        np.testing.assert_allclose(back.output(x).numpy(), np.asarray(jm.output(x)), **F32)
        assert back.iteration == jm.iteration


def test_trainer_cli_on_a_tiny_npz_matches_jax(tmp_path, capsys):
    conf = _jconf("LeNet5", {"type": "adam", "lr": 1e-3})
    init = tmp_path / "init.zip"
    jser.save_network(JNetwork(conf).init(), str(init))
    x, y = _data(10, seed=5)
    data = tmp_path / "x.npz"
    np.savez(data, x=x, y=y)
    common = ["--data", str(data), "--epochs", "2", "--batch-size", "4", "--evaluate"]
    jcli.main([str(init), *common, "--output", str(tmp_path / "j.zip")])
    cli.main([str(init), *common, "--output", str(tmp_path / "p.zip"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Accuracy" in out and "saved" in out
    want = jser.restore_network(str(tmp_path / "j.zip"))
    got = ser.restore_network(str(tmp_path / "p.zip"), device="cpu")
    assert got.iteration == want.iteration == 6
    _assert_trees_close(params_to_numpy(got), jax.tree_util.tree_map(np.asarray, want.params))
    # a configuration JSON trains as well (lenet.json, random weights)
    conf_json = tmp_path / "lenet.json"
    conf_json.write_text(zoo.LeNet5(height=HW, width=HW).to_json())
    model = cli.run([str(conf_json), "--data", str(data), "--epochs", "1",
                     "--batch-size", "4", "--output", str(tmp_path / "c.zip"),
                     "--device", "cpu"])
    assert model.iteration == 3 and np.isfinite(model.score((x, y)))


def _post(port, name, payload, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/{name}:predict",
        data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def test_predict_with_integer_pixels_serves_an_image_model():
    """Integer pixels 0-255 reach the convolution as floats in the model
    dtype (the model takes no ids), as the JAX package's route decodes
    them; float rows and a coalesced batch come back as ``output`` gives
    them."""
    m = MultiLayerNetwork(zoo.LeNet5(height=HW, width=HW), device="cpu").init()
    assert not m.takes_ids
    assert m.dummy_input(4).shape == (4, HW, HW, 1) and m.dummy_input(4).dtype == torch.float32
    reg = serve.ModelRegistry(device="cpu")
    reg.register("lenet", m)
    srv = serve.InferenceServer(reg).start(port=0)
    try:
        pix = np.random.RandomState(6).randint(0, 256, (1, HW, HW, 1))
        status, body = _post(srv.port, "lenet", {"inputs": pix.tolist(), "deadline_ms": 60000})
        assert status == 200 and body["rows"] == 1
        want = m.output(pix.astype(np.float32)).numpy()
        np.testing.assert_allclose(np.asarray(body["outputs"], np.float32), want, **F32)
        x, _ = _data(8, seed=7)
        status, body = _post(srv.port, "lenet", {"inputs": x.tolist(), "deadline_ms": 60000})
        np.testing.assert_allclose(np.asarray(body["outputs"], np.float32),
                                   m.output(x).numpy(), **F32)
    finally:
        srv.stop()


@pytest.mark.parametrize("name", NAMES)
def test_clone_summary_and_n_layers_follow_jax(name):
    jm, m = _pair(name)
    assert m.n_layers == jm.n_layers
    assert m.num_params() == jm.num_params()
    assert m.summary() == jm.summary()
    c = m.clone()
    assert c.summary() == m.summary() and c.device == m.device
    x, y = _data(4, seed=8, channels=_channels(name))
    np.testing.assert_array_equal(c.output(x).numpy(), m.output(x).numpy())
    c.fit((x, y), epochs=1)   # the clone's params are its own
    assert not all(torch.equal(a, b) for a, b in zip(tree_leaves(c.params),
                                                      tree_leaves(m.params)))
    fresh = MultiLayerNetwork(m.conf, device="cpu")
    assert fresh.clone().params is None and fresh.summary().endswith("Total params: ?")
