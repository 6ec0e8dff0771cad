"""The port's recurrent path on the CPU against the JAX package's, from the
same numpy weights: each of the eight layer classes (LSTM and GravesLSTM
against both JAX paths, the scan and DL4J_TPU_FUSED_LSTM=1), the fused
policy, and at the model level the TextGenerationLSTM output, a tBPTT
``fit`` with RMSProp (loss per batch and final params), ``rnn_time_step``
and the f32 checkpoint zip in both directions.

Tolerances: layers rtol 2e-4, atol 2e-4 (the JAX package's fused-against-
scan bound); model-level f32 rtol 1e-4, atol 1e-5 (summation order)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn.input_type import InputType as JInputType
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JNetwork
from deeplearning4j_tpu.train.listeners import CollectScoresListener as JCollect
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu_torch.interop import params_from_numpy, params_to_numpy
from deeplearning4j_tpu_torch.models import TextGenerationLSTM
from deeplearning4j_tpu_torch.nn import layers
from deeplearning4j_tpu_torch.nn.config import LayerConfig
from deeplearning4j_tpu_torch.nn.layers import recurrent as rec
from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration, MultiLayerNetwork
from deeplearning4j_tpu_torch.train.listeners import CollectScoresListener
from deeplearning4j_tpu_torch.utils import serialization as ser
from deeplearning4j_tpu_torch.utils.tree import tree_leaves

LAYER_TOL = dict(rtol=2e-4, atol=2e-4)
F32 = dict(rtol=1e-4, atol=1e-5)
V, T, H = 20, 12, 128


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    # another test module may leave tuning knobs in os.environ
    for k in list(os.environ):
        if k.startswith("DL4J_TPU_"):
            monkeypatch.delenv(k)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _torch_tree(p):
    if isinstance(p, dict):
        return {k: _torch_tree(v) for k, v in p.items()}
    return torch.tensor(np.asarray(p))


def _pair(jlayer, n_in, seed, edit=None):
    """(JAX layer, JAX params, port layer, port params): the port layer from
    the JAX layer's JSON, the same weights; ``edit`` perturbs the JAX params
    (nonzero peepholes and recurrent biases)."""
    jp = jlayer.init(jax.random.PRNGKey(seed), JInputType.recurrent(n_in, 7))
    if edit is not None:
        jp = edit(jp, np.random.RandomState(seed))
    return jlayer, jp, LayerConfig.from_json(jlayer.to_json()), _torch_tree(_np_tree(jp))


def _perturb(jp, rs):
    """Every bias and peephole leaf made nonzero."""
    def walk(d):
        return {k: walk(v) if isinstance(v, dict) else (
            jnp.asarray(rs.randn(*v.shape).astype(np.float32) * 0.2)
            if k in ("b", "b_in", "b_rec", "peephole") else v) for k, v in d.items()}
    return walk(jp)


def _x_mask(seed, n_in, with_mask, B=3, steps=7):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, steps, n_in).astype(np.float32)
    m = None
    if with_mask:
        m = (np.arange(steps)[None] < np.array([7, 4, 0])[:, None]).astype(np.float32)
    return x, m


def _apply_both(jl, jp, pl, pp, x, m):
    want, _ = jl.apply(jp, {}, jnp.asarray(x), mask=None if m is None else jnp.asarray(m))
    got, _ = pl.apply(pp, {}, torch.tensor(x), mask=None if m is None else torch.tensor(m))
    return got.detach().numpy(), np.asarray(want)


LAYERS = {
    "gru": lambda: jlayers.GRU(n_out=16),
    "gru_reset_before": lambda: jlayers.GRU(n_out=16, reset_after=False),
    "simple_rnn": lambda: jlayers.SimpleRnn(n_out=16),
    "bidirectional_concat": lambda: jlayers.Bidirectional(
        rnn=jlayers.GravesLSTM(n_out=128), mode="concat"),
    "bidirectional_add_gru": lambda: jlayers.Bidirectional(
        rnn=jlayers.GRU(n_out=16), mode="add"),
    "bidirectional_average": lambda: jlayers.Bidirectional(
        rnn=jlayers.SimpleRnn(n_out=16), mode="average"),
    "last_time_step": lambda: jlayers.LastTimeStep(rnn=jlayers.LSTM(n_out=128)),
    "bidir_last_time_step": lambda: jlayers.BidirectionalLastTimeStep(
        rnn=jlayers.Bidirectional(rnn=jlayers.SimpleRnn(n_out=16))),
    "mask_zero": lambda: jlayers.MaskZero(rnn=jlayers.GRU(n_out=16)),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
@pytest.mark.parametrize("with_mask", [False, True])
def test_layer_matches_jax(name, with_mask):
    jl, jp, pl, pp = _pair(LAYERS[name](), 6, 1, _perturb)
    x, m = _x_mask(2, 6, with_mask)
    if name == "mask_zero":
        x[1, 5:] = 0.0                      # steps MaskZero masks
    got, want = _apply_both(jl, jp, pl, pp, x, m)
    np.testing.assert_allclose(got, want, **LAYER_TOL)


@pytest.mark.parametrize("cls", ["LSTM", "GravesLSTM"])
@pytest.mark.parametrize("jax_policy", ["0", "1"])
@pytest.mark.parametrize("with_mask", [False, True])
def test_lstm_layers_match_both_jax_paths(monkeypatch, cls, jax_policy, with_mask):
    """The port's default (the fused op's plain versions on the CPU) against
    the JAX scan (policy 0) and the JAX fused kernels in the interpreter
    (policy 1), with nonzero biases and peepholes."""
    jl, jp, pl, pp = _pair(getattr(jlayers, cls)(n_out=128), 10, 3, _perturb)
    x, m = _x_mask(4, 10, with_mask)
    monkeypatch.setenv("DL4J_TPU_FUSED_LSTM", jax_policy)
    want, _ = jl.apply(jp, {}, jnp.asarray(x), mask=None if m is None else jnp.asarray(m))
    monkeypatch.delenv("DL4J_TPU_FUSED_LSTM")
    got, _ = pl.apply(pp, {}, torch.tensor(x), mask=None if m is None else torch.tensor(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


def test_lstm_carry_api_matches_jax_apply_seq(monkeypatch):
    """apply_seq from a nonzero carry returns the same outputs and final
    carry as the JAX layer's, on both port paths."""
    jl, jp, pl, pp = _pair(jlayers.GravesLSTM(n_out=128), 5, 5, _perturb)
    x, m = _x_mask(6, 5, True)
    rs = np.random.RandomState(7)
    h0, c0 = (rs.randn(3, 128).astype(np.float32) * 0.5 for _ in range(2))
    want, (jh, jc) = jl.apply_seq(jp, jnp.asarray(x), (jnp.asarray(h0), jnp.asarray(c0)),
                                  jnp.asarray(m))
    for policy in ("auto", "0"):
        monkeypatch.setenv("DL4J_TPU_FUSED_LSTM", policy)
        got, (h, c) = pl.apply_seq(pp, torch.tensor(x), (torch.tensor(h0), torch.tensor(c0)),
                                   torch.tensor(m))
        for a, b in ((got, want), (h, jh), (c, jc)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **LAYER_TOL)


@pytest.mark.parametrize("cfg", [dict(n_out=100), dict(n_out=128, activation="relu"),
                                 dict(n_out=128, gate_activation="tanh"),
                                 dict(n_out=128), dict(n_out=384)])
@pytest.mark.parametrize("cls", ["LSTM", "GravesLSTM"])
def test_fused_eligible_agrees_with_jax(cls, cfg):
    assert (getattr(layers, cls)(**cfg)._fused_eligible()
            == getattr(jlayers, cls)(**cfg)._fused_eligible())


@pytest.mark.parametrize("policy,fused", [(None, True), ("auto", True), ("1", True),
                                          ("0", False)])
def test_fused_policy(monkeypatch, policy, fused):
    """DL4J_TPU_FUSED_LSTM: unset, auto or 1 take the fused op for an
    eligible layer (its plain versions on the CPU); 0 takes the step loop;
    an ineligible layer always takes the step loop."""
    calls = []

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    orig = rec.fused_lstm
    monkeypatch.setattr(rec, "fused_lstm", spy)
    if policy is not None:
        monkeypatch.setenv("DL4J_TPU_FUSED_LSTM", policy)
    x = torch.randn(2, 3, 4, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    for layer, eligible in ((layers.GravesLSTM(n_out=128, n_in=4), True),
                            (layers.LSTM(n_out=100, n_in=4), False)):
        calls.clear()
        p = layer.init(gen, None)
        layer.apply(p, {}, x)
        assert bool(calls) == (fused and eligible)


def _char_rnn_pair(seed=3, tbptt=4, updater=None):
    jconf = jzoo.TextGenerationLSTM(vocab_size=V, timesteps=T, hidden=H, seed=seed,
                                    updater=updater)
    jconf.tbptt_fwd_length = jconf.tbptt_back_length = tbptt
    jm = JNetwork(jconf).init()
    m = MultiLayerNetwork(MultiLayerConfiguration.from_json(jconf.to_json()),
                          device="cpu").init()
    params_from_numpy(m, _np_tree(jm.params))
    return jm, m


def _chars(n, seed=0):
    ids = np.random.RandomState(seed).randint(0, V, (n, T))
    eye = np.eye(V, dtype=np.float32)
    return eye[ids], eye[np.roll(ids, -1, axis=1)]


def _assert_params_close(jm, m, **tol):
    want = jax.tree_util.tree_leaves(_np_tree(jm.params))
    got = tree_leaves(params_to_numpy(m))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **tol)


def test_text_generation_lstm_config_and_output_match_jax():
    jconf = jzoo.TextGenerationLSTM()
    assert TextGenerationLSTM().to_json() == jconf.to_json()
    jm, m = _char_rnn_pair()
    x, _ = _chars(5, seed=1)
    np.testing.assert_allclose(m.output(x).numpy(), np.asarray(jm.output(x)), **F32)


@pytest.mark.parametrize("rows,batch_size", [(4, None), (5, 4)])
def test_tbptt_fit_matches_jax_fit(rows, batch_size):
    """T=12 cut into chunks of 4 (3 updates a batch), RMSProp; (5, 4): a
    1-row tail batch, which tBPTT does not pad."""
    jm, m = _char_rnn_pair()          # RMSProp at 1e-3, the model default
    x, y = _chars(rows, seed=2)
    jl, pl = JCollect(), CollectScoresListener()
    jm.set_listeners(jl)
    m.set_listeners(pl)
    jm.fit((x, y), epochs=3, batch_size=batch_size)
    m.fit((x, y), epochs=3, batch_size=batch_size)
    assert m.iteration == jm.iteration == 3 * 3 * (1 if batch_size is None else 2)
    assert [i for i, _ in pl.scores] == [i for i, _ in jl.scores]
    np.testing.assert_allclose([s for _, s in pl.scores], [s for _, s in jl.scores], **F32)
    _assert_params_close(jm, m, **F32)


def test_tbptt_truncates_the_gradient_at_chunk_boundaries():
    """The carries enter each chunk detached: one tBPTT update over a
    chunk equals an update computed from that chunk alone, started from the
    carried state."""
    _, m = _char_rnn_pair(updater={"type": "sgd", "lr": 0.1})
    x, y = _chars(3, seed=4)
    xt, yt = torch.tensor(x), torch.tensor(y)
    carries = m._initial_carries(3)
    _, _, g_first, carries = m._value_and_grad(m.state, xt[:, :4], yt[:, :4], None, None,
                                               None, carries=carries)
    assert all(not c.requires_grad for c in tree_leaves(carries))
    _, _, g_second, _ = m._value_and_grad(m.state, xt[:, 4:8], yt[:, 4:8], None, None,
                                          None, carries=carries)
    assert any(float(a.abs().max()) > 0 for a in tree_leaves(g_second))
    assert not all(torch.equal(a, b) for a, b in zip(tree_leaves(g_first),
                                                     tree_leaves(g_second)))


def test_rnn_time_step_matches_jax_and_the_full_forward():
    jm, m = _char_rnn_pair()
    x, _ = _chars(3, seed=5)
    full = m.output(x).numpy()
    jsteps = [np.asarray(jm.rnn_time_step(x[:, t])) for t in range(T)]
    steps = [m.rnn_time_step(x[:, t]).numpy() for t in range(T)]
    np.testing.assert_allclose(np.stack(steps, 1), np.stack(jsteps, 1), **F32)
    np.testing.assert_allclose(np.stack(steps, 1), full, **F32)
    # several steps at once, a changed batch size resets, clear resets
    m.rnn_clear_previous_state()
    first = m.rnn_time_step(x[:, :5]).numpy()
    rest = m.rnn_time_step(x[:, 5:]).numpy()
    np.testing.assert_allclose(np.concatenate([first, rest], 1), full, **F32)
    np.testing.assert_allclose(m.rnn_time_step(x[:2, 0]).numpy(), full[:2, 0], **F32)


def test_a_jax_char_rnn_zip_restores_and_trains_alike(tmp_path):
    jm, _ = _char_rnn_pair()
    x, y = _chars(4, seed=6)
    jm.fit((x, y), epochs=1)
    path = tmp_path / "jax.zip"
    jser.save_network(jm, str(path))
    m = ser.restore_network(str(path), device="cpu")
    assert m.iteration == jm.iteration == 3
    _assert_params_close(jm, m, rtol=0, atol=0)
    for a, b in zip(tree_leaves(m.opt_state), jax.tree_util.tree_leaves(jm.opt_state)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jm.fit((x, y), epochs=1)
    m.fit((x, y), epochs=1)
    _assert_params_close(jm, m, **F32)


def test_a_port_char_rnn_zip_restores_in_the_jax_package(tmp_path):
    _, m = _char_rnn_pair()
    x, y = _chars(4, seed=7)
    m.fit((x, y), epochs=1)
    path = tmp_path / "port.zip"
    ser.save_network(m, str(path))
    jm = jser.restore_network(str(path))
    assert jm.iteration == m.iteration == 3
    _assert_params_close(jm, m, rtol=0, atol=0)
    np.testing.assert_allclose(np.asarray(jm.output(x)), m.output(x).numpy(), **F32)


def test_params_from_numpy_loads_the_lstm_family_unchanged():
    """Wx, Wh, b and peephole keep their names and shapes, and the leaves
    keep the JAX treedef order (the zip's npz order)."""
    jconf = jzoo.TextGenerationLSTM(vocab_size=V, timesteps=T, hidden=H)
    jconf = dataclasses.replace(jconf, layers=(
        jlayers.GravesLSTM(n_out=H), jlayers.LSTM(n_out=H),
        jlayers.Bidirectional(rnn=jlayers.LSTM(n_out=H)),
        jlayers.RnnOutputLayer(n_out=V, activation="softmax", loss="mcxent")))
    jm = JNetwork(jconf).init()
    m = MultiLayerNetwork(MultiLayerConfiguration.from_json(jconf.to_json()),
                          device="cpu").init()
    tree = _np_tree(jm.params)
    params_from_numpy(m, tree)
    assert sorted(m.params[0]) == ["Wh", "Wx", "b", "peephole"]
    assert sorted(m.params[1]) == ["Wh", "Wx", "b"]
    assert tuple(m.params[0]["peephole"].shape) == (3 * H,)
    assert tuple(m.params[0]["Wx"].shape) == (V, 4 * H)
    assert tuple(m.params[1]["Wh"].shape) == (H, 4 * H)
    want = jax.tree_util.tree_leaves(tree)
    got = tree_leaves(m.params)
    assert [tuple(a.shape) for a in got] == [a.shape for a in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)
