"""Training parity: the port's f32 TransformerLM against the JAX package's on
the CPU, from the same numpy weights (``params_from_numpy``) and batches —
loss and gradients on one batch, 3-step SGD and Adam ``fit`` over 10 rows
at batch 4 (the tail batch is padded), a bf16 Adam fit, gradient
accumulation, score and evaluate — plus the fit loop's own contracts
(constraints, gradient normalization, weight noise, padding)."""

import dataclasses
import os
import warnings

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.layers import RnnOutputLayer as JRnnOutputLayer
from deeplearning4j_tpu.nn.layers import TransformerBlock as JTransformerBlock
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JNetwork
from deeplearning4j_tpu.train.listeners import CollectScoresListener as JCollect
from deeplearning4j_tpu_torch.interop import params_from_numpy, params_to_numpy
from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration, MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import flash_attention as fa
from deeplearning4j_tpu_torch.train.listeners import CollectScoresListener
from deeplearning4j_tpu_torch.utils import bucketing
from deeplearning4j_tpu_torch.utils.tree import tree_leaves

SMALL = dict(vocab_size=32, max_len=12, d_model=16, n_heads=2, n_blocks=2)
# f32 on the CPU: the JAX package attends through its XLA path, the port
# through the flash plain versions; they sum in other orders (losses of
# ~40, grads of ~1e-2)
F32 = dict(rtol=1e-4, atol=1e-5)


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


def _pair(updater, seed=3, edit=None):
    """(JAX network, port network) with the same f32 weights."""
    jconf = jzoo.TransformerLM(dtype="float32", seed=seed, updater=updater, **SMALL)
    if edit is not None:
        jconf.layers = tuple(edit(l) for l in jconf.layers)
    jm = JNetwork(jconf).init()
    m = MultiLayerNetwork(MultiLayerConfiguration.from_json(jconf.to_json()),
                          device="cpu").init()
    params_from_numpy(m, jax.tree_util.tree_map(np.asarray, jm.params))
    return jm, m


def _data(n, seed=0):
    x = np.random.RandomState(seed).randint(0, SMALL["vocab_size"], (n, SMALL["max_len"]))
    return x, np.roll(x, -1, axis=1)


def _flat(tree, prefix=""):
    """{path: array} over a per-layer tuple of nested dicts."""
    out = {}
    for i, layer in enumerate(tree):
        def walk(d, path):
            for k, v in d.items():
                if isinstance(v, dict):
                    walk(v, f"{path}.{k}")
                else:
                    out[f"{path}.{k}"] = np.asarray(v)
        walk(layer, f"{prefix}{i}")
    return out


def _key_bias_free(flat):
    """bqkv without its key third [C:2C]: softmax is shift-invariant per
    row, so that gradient is rounding noise in both packages and Adam moves
    those entries by +-lr at random."""
    C = SMALL["d_model"]
    out = dict(flat)
    for k in flat:
        if k.endswith("attn.bqkv"):
            out[k] = np.concatenate([flat[k][:C], flat[k][2 * C:]])
    return out


def _assert_params_close(jm, m, tol=F32, skip_key_bias=False):
    want = _flat(jax.tree_util.tree_map(np.asarray, jm.params))
    got = _flat(params_to_numpy(m))
    assert got.keys() == want.keys()
    if skip_key_bias:
        want, got = _key_bias_free(want), _key_bias_free(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _with_l2(layer):
    if isinstance(layer, JRnnOutputLayer):
        return dataclasses.replace(layer, l2=1e-2, l1=1e-3)
    return layer


@pytest.mark.parametrize("lmask", [False, True])
def test_loss_and_grads_match_jax_value_and_grad(lmask):
    jm, m = _pair("sgd", edit=_with_l2)
    x, y = _data(3)
    lm = None
    if lmask:
        lm = np.ones((3, SMALL["max_len"]), np.float32)
        lm[1, 7:] = 0.0
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm._loss(p, jm.state, x, y, None, lm, None)[0]))(jm.params)
    loss, _, grads, _ = m._value_and_grad(
        m.state, torch.from_numpy(x), torch.from_numpy(y), None,
        torch.from_numpy(lm) if lmask else None, None)
    np.testing.assert_allclose(float(loss), float(jloss), **F32)
    want = _flat(jax.tree_util.tree_map(np.asarray, jgrads))
    got = _flat(tuple(_np(g) for g in grads))
    assert got.keys() == want.keys()
    for k in want:
        # the key third of bqkv is rounding noise on both sides (~1e-9)
        np.testing.assert_allclose(got[k], want[k], err_msg=k, rtol=1e-4, atol=2e-6)


def _np(v):
    if isinstance(v, dict):
        return {k: _np(x) for k, x in v.items()}
    return v.detach().numpy()


@pytest.mark.parametrize("updater", [{"type": "sgd", "lr": 0.1},
                                     {"type": "adam", "lr": 1e-2}],
                         ids=["sgd", "adam"])
def test_three_step_fit_matches_jax_fit(updater):
    jm, m = _pair(updater)
    x, y = _data(10)
    jl, pl = JCollect(), CollectScoresListener()
    jm.set_listeners(jl)
    m.set_listeners(pl)
    jm.fit((x, y), epochs=1, batch_size=4)    # batches of 4, 4 and 2 (padded)
    m.fit((x, y), epochs=1, batch_size=4)
    assert [i for i, _ in pl.scores] == [1, 2, 3] == [i for i, _ in jl.scores]
    np.testing.assert_allclose([s for _, s in pl.scores], [s for _, s in jl.scores], **F32)
    assert m.iteration == jm.iteration == 3 and m.epoch == jm.epoch == 1
    _assert_params_close(jm, m, skip_key_bias=updater["type"] == "adam")
    if updater["type"] == "adam":
        want = _flat(jax.tree_util.tree_map(np.asarray, [s["m"] for s in jm.opt_state]))
        got = _flat([_np(s["m"]) for s in m.opt_state])
        for k in _key_bias_free(want):
            np.testing.assert_allclose(_key_bias_free(got)[k], _key_bias_free(want)[k],
                                       err_msg=k, rtol=1e-4, atol=1e-6)


def test_bf16_adam_fit_follows_jax_fit():
    # bf16 params with f32 Adam moments: the packages round the forward and
    # backward at other places, so each step's score may differ by the last
    # bits of a bf16 score (~40 here, an ulp of 0.25): 2 ulps, 2**-6 relative
    jconf = jzoo.TransformerLM(dtype="bfloat16", seed=3,
                               updater={"type": "adam", "lr": 1e-3}, **SMALL)
    jm = JNetwork(jconf).init()
    m = MultiLayerNetwork(MultiLayerConfiguration.from_json(jconf.to_json()),
                          device="cpu").init()
    params_from_numpy(m, jax.tree_util.tree_map(np.asarray, jm.params))
    x, y = _data(4)
    jl, pl = JCollect(), CollectScoresListener()
    jm.set_listeners(jl)
    m.set_listeners(pl)
    jm.fit((x, y), epochs=4)
    m.fit((x, y), epochs=4)
    got, want = [s for _, s in pl.scores], [s for _, s in jl.scores]
    np.testing.assert_allclose(got, want, rtol=2 ** -6)
    assert got[-1] < got[0] and want[-1] < want[0]
    assert all(p.dtype == torch.bfloat16 for p in tree_leaves(m.params))
    assert all(s.dtype == torch.float32 for s in tree_leaves(m.opt_state))


def test_padded_tail_equals_the_unpadded_step(monkeypatch):
    # the pre-scaled label mask keeps the padded tail's loss the mean over
    # its real rows
    _, m1 = _pair("sgd")
    _, m2 = _pair("sgd")
    x, y = _data(6)
    m1.fit((x, y), epochs=1, batch_size=4)            # 4 + 2 padded to 4
    monkeypatch.setenv("DL4J_TPU_BUCKETING", "0")
    m2.fit((x, y), epochs=1, batch_size=4)            # 4 + 2
    for a, b in zip(_flat(params_to_numpy(m1)).values(), _flat(params_to_numpy(m2)).values()):
        np.testing.assert_allclose(a, b, **F32)


def test_grad_accumulation_matches_jax(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_GRAD_ACCUM", "2")
    jm, m = _pair({"type": "sgd", "lr": 0.1})
    x, y = _data(10, seed=1)
    jl, pl = JCollect(), CollectScoresListener()
    jm.set_listeners(jl)
    m.set_listeners(pl)
    jm.fit((x, y), epochs=1, batch_size=4)
    m.fit((x, y), epochs=1, batch_size=4)
    np.testing.assert_allclose([s for _, s in pl.scores], [s for _, s in jl.scores], **F32)
    _assert_params_close(jm, m)


def test_grad_accumulation_equals_the_full_batch_step(monkeypatch):
    _, m1 = _pair({"type": "sgd", "lr": 0.1})
    _, m2 = _pair({"type": "sgd", "lr": 0.1})
    x, y = _data(4, seed=2)
    m1.fit((x, y), epochs=1)
    monkeypatch.setenv("DL4J_TPU_GRAD_ACCUM", "2")
    m2.fit((x, y), epochs=1)
    for a, b in zip(_flat(params_to_numpy(m1)).values(), _flat(params_to_numpy(m2)).values()):
        np.testing.assert_allclose(a, b, **F32)


def test_score_and_evaluate_match_jax():
    jm, m = _pair("sgd")
    x, y = _data(5, seed=3)
    for train in (False, True):
        np.testing.assert_allclose(m.score((x, y), train=train),
                                   jm.score((x, y), train=train), **F32)
    lm = np.ones((5, SMALL["max_len"]), np.float32)
    lm[:, 9:] = 0.0
    np.testing.assert_allclose(m.score(x, y, lmask=lm), jm.score(x, y, lmask=lm), **F32)
    ev, jev = m.evaluate((x, y), batch_size=2), jm.evaluate((x, y), batch_size=2)
    assert ev.examples == jev.examples == 5 * SMALL["max_len"]
    np.testing.assert_array_equal(ev.confusion.matrix, jev.confusion.matrix)
    assert ev.accuracy() == jev.accuracy()


def _constrained(layer):
    if isinstance(layer, JRnnOutputLayer):
        return dataclasses.replace(layer, constraints=({"type": "max_norm", "max_norm": 0.5},))
    if isinstance(layer, JTransformerBlock):
        return dataclasses.replace(layer, gradient_normalization="clip_l2_per_layer",
                                   gradient_normalization_threshold=0.05)
    return layer


def test_constraints_and_gradient_normalization_match_jax():
    jm, m = _pair({"type": "sgd", "lr": 0.5}, edit=_constrained)
    x, y = _data(8, seed=4)
    jm.set_listeners(JCollect())
    m.set_listeners(CollectScoresListener())
    jm.fit((x, y), epochs=2, batch_size=4)
    m.fit((x, y), epochs=2, batch_size=4)
    _assert_params_close(jm, m)
    W = m.params[-1]["W"]
    assert float(torch.sqrt((W * W).sum(0)).max()) <= 0.5 + 1e-5


def test_frozen_layers_and_per_layer_updaters():
    def edit(layer):
        if isinstance(layer, JTransformerBlock):
            return dataclasses.replace(layer, trainable=False)
        if isinstance(layer, JRnnOutputLayer):
            return dataclasses.replace(layer, updater={"type": "adam", "lr": 1e-2})
        return layer

    jm, m = _pair({"type": "sgd", "lr": 0.1}, edit=edit)
    before = params_to_numpy(m)
    x, y = _data(4, seed=5)
    jm.fit((x, y), epochs=1)
    m.fit((x, y), epochs=1)
    _assert_params_close(jm, m)
    after = params_to_numpy(m)
    np.testing.assert_array_equal(after[2]["Wi"], before[2]["Wi"])
    assert set(m.opt_state[-1]) == {"m", "v"}


def test_rng_layers_train_and_score_deterministically():
    conf = MultiLayerConfiguration.from_json(
        jzoo.TransformerLM(dtype="float32", **SMALL).to_json())
    conf.layers = tuple(
        dataclasses.replace(l, dropout=0.2) if l._type_name == "transformer_block"
        else dataclasses.replace(l, weight_noise={"type": "gaussian", "stddev": 0.01})
        if l._type_name == "rnn_output" else l for l in conf.layers)
    m = MultiLayerNetwork(conf, device="cpu").init()
    assert any(l.uses_rng() for l in m.layers)
    x, y = _data(4, seed=6)
    s0 = m.score((x, y), train=True)
    assert m.score((x, y), train=True) == s0
    pl = CollectScoresListener()
    m.set_listeners(pl)
    m.fit((x, y), epochs=2)
    assert all(np.isfinite(s) for _, s in pl.scores)


def test_fit_on_the_cpu_launches_no_kernel():
    _, m = _pair("sgd")
    before = (fa.flash_fwd_cuda.launches, fa.flash_bwd_dq_cuda.launches,
              fa.flash_bwd_dkv_cuda.launches)
    m.fit(_data(4), epochs=1)
    assert (fa.flash_fwd_cuda.launches, fa.flash_bwd_dq_cuda.launches,
            fa.flash_bwd_dkv_cuda.launches) == before


def test_fit_accepts_an_iterable_of_batches_and_a_callable():
    _, m = _pair("sgd")
    x, y = _data(6)
    batches = [(x[:3], y[:3]), {"features": x[3:], "labels": y[3:]}]
    m.fit(batches, epochs=1)
    m.fit(lambda: iter(batches), epochs=1)
    assert m.iteration == 4 and m.epoch == 2


def test_pad_fit_batch_scales_the_mask():
    x, y = _data(3)
    bucketing.telemetry().reset()
    px, py, fm, lm, ew = bucketing.pad_fit_batch(x, y, None, None, 4, site="t")
    assert px.shape == (4, SMALL["max_len"]) and (px[3] == x[0]).all()
    np.testing.assert_allclose(lm, [4 / 3] * 3 + [0.0])
    np.testing.assert_array_equal(ew, [1, 1, 1, 0])
    tx = bucketing.tile_pad(torch.from_numpy(x), 5)
    assert isinstance(tx, torch.Tensor) and tx.shape[0] == 8
    m = np.ones((3, SMALL["max_len"]), np.float32)
    np.testing.assert_allclose(bucketing.padded_label_mask(y, m, 2)[:, 0], [1.5, 1.5, 0.0])


@pytest.mark.parametrize("spec", [
    {"type": "max_norm", "max_norm": 0.3},
    {"type": "min_max_norm", "min_norm": 0.8, "max_norm": 1.2, "rate": 0.5},
    {"type": "unit_norm"},
    {"type": "non_negative", "apply_to_biases": True},
], ids=lambda s: s["type"])
def test_constraints_match_jax(spec):
    from deeplearning4j_tpu.nn.constraints import apply_constraints as japply
    from deeplearning4j_tpu_torch.nn.constraints import apply_constraints

    jm, m = _pair("sgd", edit=lambda l: dataclasses.replace(l, constraints=(spec,))
                  if isinstance(l, JTransformerBlock) else l)
    got = apply_constraints(m.layers[2], m.params[2])
    want = japply(jm.layers[2], jm.params[2])
    w, g = _flat([jax.tree_util.tree_map(np.asarray, want)]), _flat([_np(got)])
    for k in w:
        np.testing.assert_allclose(g[k], w[k], err_msg=k, rtol=1e-5, atol=1e-6)


def test_regularization_penalty_matches_jax():
    def edit(layer):
        return dataclasses.replace(layer, l1=1e-3, l2=2e-2)

    jm, m = _pair("sgd", edit=edit)
    for jl, jp, l, p in zip(jm.layers, jm.params, m.layers, m.params):
        np.testing.assert_allclose(float(l.regularization_penalty(p)),
                                   float(jl.regularization_penalty(jp)), rtol=1e-5)
        assert l.uses_rng() == jl.uses_rng()


def test_accum_gate_follows_the_jax_rule(monkeypatch):
    from deeplearning4j_tpu.nn import step_program as jsp
    from deeplearning4j_tpu_torch.nn import step_program as sp

    monkeypatch.setenv("DL4J_TPU_GRAD_ACCUM", "3")
    assert sp.grad_accum_from_env() == jsp.grad_accum_from_env() == 3
    for rows, ok in ((2, False), (6, True), (7, False)):
        batch = (np.zeros((rows, 4)), np.zeros((rows,)), None)
        tbatch = tuple(None if a is None else torch.from_numpy(a) for a in batch)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")    # both warn once per process
            assert sp.accum_applicable(3, tbatch) == jsp.accum_applicable(3, batch) == ok
