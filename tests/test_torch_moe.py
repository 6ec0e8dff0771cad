"""MixtureOfExperts parity: the port's layer against the JAX package's on
the same numpy weights and inputs (output, ``load_balance_loss`` and
``jax.grad`` gradients, with a padding mask and with a capacity low enough
that tokens drop), and the MoE TransformerLM (``moe_experts=2``):
forward, loss, gradients and one Adam step against JAX's, plus its JSON
and zip round trips.

Tolerances: f32 on the CPU, where both sides compute the same products in
other summation orders, so rtol 1e-4 / atol 1e-5 on outputs and losses
and atol 2e-6 on gradients of order 1e-2 (as test_torch_train.py). Routing
is compared in f32, where a near-tie between two experts' gates is far
below what the inputs here produce."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.input_type import InputType as JInputType
from deeplearning4j_tpu.nn.layers import MixtureOfExperts as JMoE
from deeplearning4j_tpu.nn.model import MultiLayerConfiguration as JConf
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JNetwork
from deeplearning4j_tpu_torch.interop import params_from_numpy, params_to_numpy
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.nn.config import LayerConfig
from deeplearning4j_tpu_torch.nn.layers import MixtureOfExperts
from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration, MultiLayerNetwork
from deeplearning4j_tpu_torch.utils.serialization import restore_network, save_network

F32 = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=2e-6)
LM = dict(vocab_size=29, max_len=16, d_model=32, n_heads=4, n_blocks=2, moe_experts=2,
          dtype="float32")


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


def _layer_pair(capacity_factor, n_experts=4, C=16, seed=0):
    """(JAX layer, its numpy params, port layer, torch params)."""
    kw = dict(n_experts=n_experts, ffn_mult=2, capacity_factor=capacity_factor)
    jl = JMoE(**kw)
    jp = jl.init(jax.random.PRNGKey(seed), JInputType.recurrent(C))
    # the biases start at zero: give them values so their use is checked
    rs = np.random.RandomState(seed + 1)
    jp = dict(jp, bi=jnp.asarray(rs.randn(*jp["bi"].shape).astype(np.float32) * 0.1),
              bo=jnp.asarray(rs.randn(*jp["bo"].shape).astype(np.float32) * 0.1))
    npp = {k: np.asarray(v) for k, v in jp.items()}
    tl = MixtureOfExperts(**kw)
    tp = {k: torch.from_numpy(v.copy()) for k, v in npp.items()}
    return jl, npp, tl, tp


def _x(B=3, T=10, C=16, seed=2):
    return np.random.RandomState(seed).randn(B, T, C).astype(np.float32)


def _mask(B=3, T=10):
    m = np.ones((B, T), np.float32)
    m[1, 6:] = 0.0
    m[2, :3] = 0.0
    return m


@pytest.mark.parametrize("capacity_factor,masked", [(1.25, False), (1.25, True),
                                                    (0.5, False), (0.5, True)])
def test_layer_output_matches_jax(capacity_factor, masked):
    jl, npp, tl, tp = _layer_pair(capacity_factor)
    x = _x()
    mask = _mask() if masked else None
    want, _ = jl.apply(npp, {}, x, mask=mask)
    got, _ = tl.apply(tp, {}, torch.from_numpy(x),
                      mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    # routing, held on its own: which tokens the JAX dense dispatch kept
    N, E = x.shape[0] * x.shape[1], tl.n_experts
    logits = (x.reshape(N, -1) @ npp["Wg"]).astype(np.float32)
    expert = np.argmax(logits, -1)
    _, _, slot, keep = tl.route(tp, torch.from_numpy(x.reshape(N, -1)),
                                None if mask is None else torch.from_numpy(mask))
    onehot = np.eye(E, dtype=np.float32)[expert]
    if mask is not None:
        onehot *= mask.reshape(N)[:, None]
    pos = (np.cumsum(onehot, 0) * onehot - 1.0)[np.arange(N), expert]
    cap = max(int(capacity_factor * N / E), 1)
    np.testing.assert_array_equal(keep.numpy(), (pos >= 0) & (pos < cap))
    np.testing.assert_array_equal(slot.numpy()[keep.numpy()], pos[keep.numpy()])
    dropped = tl.dropped_tokens(tp, torch.from_numpy(x),
                                None if mask is None else torch.from_numpy(mask))
    if capacity_factor < 1:
        assert dropped > 0, "the low capacity dropped no token"
    assert dropped == int(((pos >= 0) & (pos >= cap)).sum())


@pytest.mark.parametrize("capacity_factor,masked", [(1.25, True), (0.5, False)])
def test_layer_gradients_match_jax_grad(capacity_factor, masked):
    jl, npp, tl, tp = _layer_pair(capacity_factor, seed=3)
    x = _x(seed=4)
    w = np.random.RandomState(5).randn(*x.shape).astype(np.float32)
    mask = _mask() if masked else None

    def jloss(p, xx):
        return jnp.sum(jl.apply(p, {}, xx, mask=mask)[0] * w)

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(npp, x)
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out, _ = tl.apply(tp, {}, xt, mask=None if mask is None else torch.from_numpy(mask))
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **GRAD)
    for k in npp:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jgp[k]), err_msg=k,
                                   **GRAD)


def test_load_balance_loss_matches_jax():
    jl, npp, tl, tp = _layer_pair(1.25, seed=6)
    x = _x(seed=7)
    want = float(jl.load_balance_loss(npp, x))
    got = float(tl.load_balance_loss(tp, torch.from_numpy(x)))
    np.testing.assert_allclose(got, want, **F32)


def test_layer_json_round_trips_across_packages():
    layer = MixtureOfExperts(n_experts=3, ffn_mult=2, capacity_factor=0.75,
                             activation="relu", name="moe")
    s = layer.to_json()
    assert LayerConfig.from_json(s) == layer
    assert json.loads(JMoE.from_json(s).to_json()) == json.loads(s)


def _lm_pair(seed=3):
    jconf = jzoo.TransformerLM(seed=seed, updater={"type": "adam", "lr": 1e-2}, **LM)
    jm = JNetwork(jconf).init()
    m = MultiLayerNetwork(MultiLayerConfiguration.from_json(jconf.to_json()),
                          device="cpu").init()
    params_from_numpy(m, jax.tree_util.tree_map(np.asarray, jm.params))
    return jm, m


def _data(n, seed=0):
    x = np.random.RandomState(seed).randint(0, LM["vocab_size"], (n, LM["max_len"]))
    return x, np.roll(x, -1, axis=1)


def _flat(tree):
    out = {}
    for i, layer in enumerate(tree):
        def walk(d, path):
            for k, v in d.items():
                if isinstance(v, dict):
                    walk(v, f"{path}.{k}")
                else:
                    out[f"{path}.{k}"] = np.asarray(v)
        walk(layer, str(i))
    return out


def _np(v):
    if isinstance(v, dict):
        return {k: _np(x) for k, x in v.items()}
    return v.detach().numpy()


def test_moe_lm_layout_and_forward_match_jax():
    jm, m = _lm_pair()
    kinds = [type(l).__name__ for l in m.layers]
    assert kinds == [type(l).__name__ for l in jm.layers]
    assert kinds.count("MixtureOfExperts") == 1   # after block 1 of 2
    assert m.params[kinds.index("MixtureOfExperts")]["Wi"].shape == (2, 32, 128)
    x, _ = _data(3)
    np.testing.assert_allclose(m.output(x).numpy(), np.asarray(jm.output(x)), **F32)


def test_moe_lm_loss_and_gradients_match_jax():
    jm, m = _lm_pair(seed=4)
    x, y = _data(3, seed=1)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm._loss(p, jm.state, x, y, None, None, None)[0]))(jm.params)
    loss, _, grads, _ = m._value_and_grad(m.state, torch.from_numpy(x),
                                          torch.from_numpy(y), None, None, None)
    np.testing.assert_allclose(float(loss), float(jloss), **F32)
    want = _flat(jax.tree_util.tree_map(np.asarray, jgrads))
    got = _flat(tuple(_np(g) for g in grads))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **GRAD)


def test_moe_lm_adam_step_matches_jax():
    jm, m = _lm_pair(seed=5)
    x, y = _data(4, seed=2)
    jm.fit((x, y), epochs=1, batch_size=4)
    m.fit((x, y), epochs=1, batch_size=4)
    want = _flat(jax.tree_util.tree_map(np.asarray, jm.params))
    got = _flat(params_to_numpy(m))
    C = LM["d_model"]
    for k in want:
        w, g = want[k], got[k]
        if k.endswith("attn.bqkv"):
            # the key third's gradient is rounding noise on both sides, and
            # Adam moves it by +-lr whatever its size (test_torch_train.py)
            w, g = np.concatenate([w[:C], w[2 * C:]]), np.concatenate([g[:C], g[2 * C:]])
        np.testing.assert_allclose(g, w, err_msg=k, rtol=1e-4, atol=1e-5)


def test_moe_lm_json_and_zip_round_trip(tmp_path):
    conf = zoo.TransformerLM(**LM)
    jconf = jzoo.TransformerLM(**LM)
    assert json.loads(conf.to_json()) == json.loads(jconf.to_json())
    assert JConf.from_json(conf.to_json()).to_dict() == json.loads(conf.to_json())
    m = MultiLayerNetwork(conf, device="cpu").init()
    path = str(tmp_path / "moe.zip")
    save_network(m, path)
    r = restore_network(path, device="cpu")
    for a, b in zip(_flat(params_to_numpy(m)).values(), _flat(params_to_numpy(r)).values()):
        np.testing.assert_array_equal(a, b)
    # the JAX package reads the port's zip: the [E, ...] leaves keep their place
    from deeplearning4j_tpu.utils.serialization import restore_network as jrestore

    jr = jrestore(path)
    want = _flat(params_to_numpy(m))
    got = _flat(jax.tree_util.tree_map(np.asarray, jr.params))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
