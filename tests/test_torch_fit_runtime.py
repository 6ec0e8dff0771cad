"""The port's runtime around ``fit`` on the CPU: chained K-step dispatch
(bit for bit against the per-step port path, dropout included, and within
1e-5 of the JAX package's chained fit), its gates, phase spans against the
fused step, per-block remat gradients against the plain ones with dropout
on (bit for bit, the generator left where a plain step leaves it),
``prefetch_to_device`` and ``DataSet`` / ``MultiDataSet`` input, and the
``ProfilerListener`` window."""

import dataclasses
import json
import os
import warnings

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.nn.input_type import InputType as JInputType
from deeplearning4j_tpu.nn.layers import Dense as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutputLayer
from deeplearning4j_tpu.nn.model import MultiLayerConfiguration as JConf
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JNetwork
from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.datasets import DataSet, MultiDataSet, prefetch_to_device
from deeplearning4j_tpu_torch.interop import params_from_numpy, params_to_numpy
from deeplearning4j_tpu_torch.models import TransformerLM
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph, ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.layers import TransformerBlock
from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration, MultiLayerNetwork
from deeplearning4j_tpu_torch.nn import step_program
from deeplearning4j_tpu_torch.nn.step_program import CHAIN_AUTO_PARAM_LIMIT, chain_k_from_env
from deeplearning4j_tpu_torch.train.listeners import CollectScoresListener, ProfilerListener
from deeplearning4j_tpu_torch.utils.tree import tree_leaves

# f32 on the CPU, the same math in two frameworks over 8 steps
CHAIN_VS_JAX = dict(rtol=1e-5, atol=1e-5)


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


def _jconf(dropout=0.0, updater=None):
    return JConf(layers=(JDense(n_out=16, activation="relu",
                                **({"dropout": dropout} if dropout else {})),
                         JDense(n_out=8, activation="tanh"),
                         JOutputLayer(n_out=4, activation="softmax")),
                 input_type=JInputType.feed_forward(6),
                 updater=updater or {"type": "adam", "lr": 1e-2}, seed=5)


def _mln(dropout=0.0, **kw):
    return MultiLayerNetwork(MultiLayerConfiguration.from_json(
        _jconf(dropout, **kw).to_json()), device="cpu").init()


def _data(n=64, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, 6).astype(np.float32),
            np.eye(4, dtype=np.float32)[rs.randint(0, 4, n)])


def _bits_equal(a, b):
    return all(torch.equal(u, v) for u, v in zip(tree_leaves(a), tree_leaves(b)))


@pytest.fixture
def chain_sizes(monkeypatch):
    """The size of every chain ``fit`` copies in one piece."""
    sizes = []
    orig = step_program._copy_chain
    monkeypatch.setattr(step_program, "_copy_chain",
                        lambda group, device: (sizes.append(len(group)), orig(group, device))[1])
    return sizes


# -- chained dispatch -----------------------------------------------------------

def test_chain_gate_matches_the_reference(monkeypatch):
    from deeplearning4j_tpu.nn.step_program import chain_k_from_env as jgate

    cases = [(False, 10), (True, 10), (False, CHAIN_AUTO_PARAM_LIMIT),
             (False, CHAIN_AUTO_PARAM_LIMIT - 1)]
    for env in ("auto", "0", "3", "bad"):
        monkeypatch.setenv("DL4J_TPU_CHAIN_STEPS", env)
        for uses_rng, n in cases:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")   # the reference's forced-chain warning
                assert chain_k_from_env(uses_rng, n) == jgate(uses_rng, n), (env, uses_rng, n)
    # unset, the port chains nothing (the JAX package reads "auto")
    monkeypatch.delenv("DL4J_TPU_CHAIN_STEPS")
    assert all(chain_k_from_env(uses_rng, n) == 0 for uses_rng, n in cases)
    monkeypatch.setenv("DL4J_TPU_CHAIN_STEPS", "auto")
    monkeypatch.setenv("DL4J_TPU_PHASE_SPANS", "1")
    assert chain_k_from_env(False, 10) == 0


def test_auto_chains_small_rng_free_models_only(monkeypatch):
    assert _mln()._chain_k() == 0   # unset: no chain
    monkeypatch.setenv("DL4J_TPU_CHAIN_STEPS", "auto")
    assert _mln()._chain_k() == 8
    assert _mln(dropout=0.2)._chain_k() == 0
    big = TransformerLM(vocab_size=2048, max_len=8, d_model=256, n_heads=2, n_blocks=2)
    assert MultiLayerNetwork(big, device="cpu").init()._chain_k() == 0


@pytest.mark.parametrize("dropout,k", [(0.0, "auto"), (0.3, "4")])
def test_chain_equals_the_per_step_path_bit_for_bit(dropout, k, monkeypatch, chain_sizes):
    """The chained run (K groups, the tail step by step) against the same
    fit with chaining off: the same params, updater state, generator state
    and iteration, bit for bit. With dropout the chain is forced
    (DL4J_TPU_CHAIN_STEPS=4): the draws come in the per-step order."""
    x, y = _data(72)   # 9 batches of 8: chains of K and a tail
    monkeypatch.setenv("DL4J_TPU_CHAIN_STEPS", k)
    chained = _mln(dropout)
    chained.fit((x, y), epochs=2, batch_size=8)
    assert chain_sizes and set(chain_sizes) == {int(chained._chain_k())}
    n_chains = len(chain_sizes)
    monkeypatch.setenv("DL4J_TPU_CHAIN_STEPS", "0")
    stepped = _mln(dropout)
    stepped.fit((x, y), epochs=2, batch_size=8)
    assert len(chain_sizes) == n_chains   # nothing chained with K = 0
    assert chained.iteration == stepped.iteration == 18
    assert _bits_equal(chained.params, stepped.params)
    assert _bits_equal(chained.opt_state, stepped.opt_state)
    assert torch.equal(chained._gen.get_state(), stepped._gen.get_state())


def test_chain_matches_the_jax_packages_chained_fit(monkeypatch, chain_sizes):
    monkeypatch.setenv("DL4J_TPU_CHAIN_STEPS", "auto")   # both packages
    x, y = _data(64)
    jm = JNetwork(_jconf()).init()
    m = _mln()
    params_from_numpy(m, jax.tree_util.tree_map(np.asarray, jm.params))
    jm.fit((x, y), epochs=1, batch_size=8)   # auto: one chain of 8
    m.fit((x, y), epochs=1, batch_size=8)
    assert chain_sizes == [8]
    assert m.iteration == jm.iteration == 8
    for a, b in zip(tree_leaves(params_to_numpy(m)), jax.tree_util.tree_leaves(jm.params)):
        np.testing.assert_allclose(a, np.asarray(b), **CHAIN_VS_JAX)


def test_listeners_turn_chaining_off(chain_sizes, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_CHAIN_STEPS", "auto")
    m = _mln()
    col = CollectScoresListener()
    m.set_listeners(col).fit(_data(32), epochs=1, batch_size=8)
    assert not chain_sizes and [i for i, _ in col.scores] == [1, 2, 3, 4]


def test_chain_batches_yields_every_batch_in_order(chain_sizes):
    """Runs of K chainable same-shape batches come out as views of one
    copy; a batch that may not chain, or whose shape differs, ends the run
    and passes through as it came, and so does the short tail."""
    rs = np.random.RandomState(3)
    a = [(rs.randn(4, 3).astype(np.float32), None, 1) for _ in range(7)]
    odd = (rs.randn(5, 3).astype(np.float32), None, 2)
    masked = (rs.randn(4, 3).astype(np.float32), "mask", 3)
    src = a[:2] + [masked] + a[2:5] + [odd] + a[5:]
    got = list(step_program.chain_batches(iter(src), 2, "cpu", lambda b: b[1] is None))
    assert chain_sizes == [2, 2, 2]   # a[:2], a[2:4], odd ends a[4:5], a[5:7]
    assert len(got) == len(src)
    for g, w in zip(got, src):
        assert g[1:] == w[1:]
        assert torch.equal(torch.as_tensor(g[0]), torch.as_tensor(w[0]))
    assert got[2] is masked and got[6] is odd


def test_device_prefetch_is_opt_in(monkeypatch):
    from deeplearning4j_tpu_torch.nn.model import _device_prefetch_enabled

    assert not _device_prefetch_enabled()
    monkeypatch.setenv("DL4J_TPU_DEVICE_PREFETCH", "1")
    assert _device_prefetch_enabled()


def test_graph_chain_equals_per_step(monkeypatch, chain_sizes):
    conf = (ComputationGraphConfiguration.builder().add_inputs("in")
            .set_input_types(MultiLayerConfiguration.from_json(
                _jconf().to_json()).input_type)
            .add_layer("h", MultiLayerConfiguration.from_json(_jconf().to_json()).layers[0], "in")
            .add_layer("out", MultiLayerConfiguration.from_json(
                _jconf().to_json()).layers[2], "h")
            .set_outputs("out").updater({"type": "adam", "lr": 1e-2}).seed(5).build())
    x, y = _data(80)
    monkeypatch.setenv("DL4J_TPU_CHAIN_STEPS", "auto")
    a = ComputationGraph(conf, device="cpu").init()
    assert a._chain_k() == 8
    a.fit((x, y), epochs=1, batch_size=8)
    assert chain_sizes == [8]   # 10 batches: one chain, a tail of 2
    monkeypatch.setenv("DL4J_TPU_CHAIN_STEPS", "0")
    b = ComputationGraph(conf, device="cpu").init()
    b.fit((x, y), epochs=1, batch_size=8)
    assert a.iteration == b.iteration == 10
    assert _bits_equal(a.params, b.params) and _bits_equal(a.opt_state, b.opt_state)


# -- phase spans ------------------------------------------------------------------

def test_phase_spans_equal_the_fused_step(monkeypatch):
    x, y = _data(32)
    fused = _mln(dropout=0.3)
    fused.fit((x, y), epochs=2, batch_size=8)
    monkeypatch.setenv("DL4J_TPU_PHASE_SPANS", "1")
    phased = _mln(dropout=0.3)
    n0 = len(obs.recent_spans())
    phased.fit((x, y), epochs=2, batch_size=8)
    assert _bits_equal(fused.params, phased.params)
    assert _bits_equal(fused.opt_state, phased.opt_state)
    assert torch.equal(fused._gen.get_state(), phased._gen.get_state())
    names = [s["span"] for s in obs.recent_spans()[n0:]]
    assert names[:4] == ["phase.fwd", "phase.bwd", "phase.update", "mln.fit_batch"]
    assert names.count("phase.bwd") == 8
    assert all(s["wall_s"] >= 0 for s in obs.recent_spans()[n0:])


def test_phase_spans_step_aside_for_the_guard(monkeypatch):
    from deeplearning4j_tpu_torch.train.resilience import DivergenceGuard

    monkeypatch.setenv("DL4J_TPU_PHASE_SPANS", "1")
    m = _mln().set_divergence_guard(DivergenceGuard("skip_batch"))
    n0 = len(obs.recent_spans())
    m.fit(_data(16), epochs=1, batch_size=8)
    assert "phase.fwd" not in [s["span"] for s in obs.recent_spans()[n0:]]


# -- per-block remat ---------------------------------------------------------------

def _lm(dropout):
    conf = TransformerLM(vocab_size=40, max_len=8, d_model=16, n_heads=2, n_blocks=2)
    conf = dataclasses.replace(conf, layers=tuple(
        dataclasses.replace(l, dropout=dropout) if isinstance(l, TransformerBlock) else l
        for l in conf.layers))
    return MultiLayerNetwork(conf, device="cpu").init()


def _lm_grads(remat, monkeypatch, dropout=0.25):
    monkeypatch.setenv("DL4J_TPU_REMAT_BLOCKS", "1" if remat else "0")
    m = _lm(dropout)
    ids = np.random.RandomState(0).randint(0, 40, (4, 8))
    loss, _, grads, _ = m._value_and_grad(m.state, m._features(ids),
                                          torch.as_tensor(np.roll(ids, -1, 1)), None, None, None)
    return loss, grads, m._gen.get_state()


def test_remat_gradients_equal_plain_ones_with_dropout(monkeypatch):
    loss0, g0, gen0 = _lm_grads(False, monkeypatch)
    loss1, g1, gen1 = _lm_grads(True, monkeypatch)
    assert torch.equal(loss0, loss1)
    assert _bits_equal(g0, g1)
    assert torch.equal(gen0, gen1)   # the generator ends where a plain step leaves it


def test_remat_without_the_generator_fix_would_differ(monkeypatch):
    """The check above has teeth: a recompute that draws from the model's
    generator again gives other dropout masks and other gradients."""
    from deeplearning4j_tpu_torch.nn.layers import attention

    def naive(self, params, x, train, rng, mask):
        return torch.utils.checkpoint.checkpoint(
            lambda xx: self._apply_inner(params, xx, train, rng, mask), x,
            use_reentrant=False, preserve_rng_state=False)

    _, g0, _ = _lm_grads(False, monkeypatch)
    monkeypatch.setattr(attention.TransformerBlock, "_apply_remat", naive)
    _, g1, _ = _lm_grads(True, monkeypatch)
    assert not _bits_equal(g0, g1)


def test_remat_training_run_equals_plain(monkeypatch):
    ids = np.random.RandomState(1).randint(0, 40, (8, 8))
    runs = []
    for remat in ("0", "1"):
        monkeypatch.setenv("DL4J_TPU_REMAT_BLOCKS", remat)
        m = _lm(0.1)
        m.fit((ids, np.roll(ids, -1, 1)), epochs=2, batch_size=4)
        runs.append(m)
        assert torch.equal(m.output(ids[:2]), m.output(ids[:2]))   # eval: no checkpoint
    assert _bits_equal(runs[0].params, runs[1].params)


# -- prefetch and DataSet input -----------------------------------------------------

def test_prefetch_yields_the_batches_unchanged():
    rs = np.random.RandomState(3)
    batches = [(rs.randn(4, 3).astype(np.float32), rs.randint(0, 5, 4), None, {"m": rs.rand(2)},
                DataSet(rs.randn(2, 2), rs.randn(2, 1))) for _ in range(5)]
    got = list(prefetch_to_device(iter(batches), depth=2, device="cpu"))
    assert len(got) == 5
    for (a, b, c, d, e), (ga, gb, gc, gd, ge) in zip(batches, got):
        assert isinstance(ga, torch.Tensor) and np.array_equal(ga.numpy(), a)
        assert np.array_equal(gb.numpy(), b) and gc is None
        assert np.array_equal(gd["m"].numpy(), d["m"])
        assert isinstance(ge, DataSet) and np.array_equal(ge.features.numpy(), e.features)


def test_prefetch_close_early_stops_the_producer_and_errors_reach_the_consumer():
    import threading

    def endless():
        i = 0
        while True:
            yield (np.full(2, i),)
            i += 1

    n0 = threading.active_count()
    gen = prefetch_to_device(endless(), depth=2, device="cpu")
    assert next(gen)[0][0] == 0
    gen.close()
    assert threading.active_count() <= n0

    def broken():
        yield (np.zeros(1),)
        raise RuntimeError("source failed")

    with pytest.raises(RuntimeError, match="source failed"):
        list(prefetch_to_device(broken(), device="cpu"))
    with pytest.raises(ValueError):
        next(prefetch_to_device(iter([]), depth=0, device="cpu"))


def test_dataset_input_equals_array_input():
    x, y = _data(40)
    a, b, c = _mln(), _mln(), _mln()
    a.fit((x, y), epochs=1, batch_size=16)
    b.fit(DataSet(x, y), epochs=1, batch_size=16)
    c.fit([DataSet(x[i:i + 16], y[i:i + 16]) for i in range(0, 40, 16)], epochs=1)
    assert _bits_equal(a.params, b.params)
    assert a.score(DataSet(x, y)) == b.score((x, y))
    assert c.iteration == 3
    conf = (ComputationGraphConfiguration.builder().add_inputs("in")
            .set_input_types(a.conf.input_type).add_layer("h", a.conf.layers[0], "in")
            .add_layer("out", a.conf.layers[2], "h").set_outputs("out").seed(5).build())
    g1 = ComputationGraph(conf, device="cpu").init()
    g2 = ComputationGraph(conf, device="cpu").init()
    g1.fit((x, y), epochs=1, batch_size=16)
    g2.fit(MultiDataSet([x], [y]), epochs=1, batch_size=16)
    assert _bits_equal(g1.params, g2.params)


# -- the profiler window ---------------------------------------------------------------

def test_profiler_listener_writes_a_trace_for_its_window(tmp_path):
    m = _mln()
    lis = ProfilerListener(str(tmp_path / "trace"), start=2, stop=3)
    m.set_listeners(lis).fit(_data(32), epochs=1, batch_size=8)
    assert lis.captured and os.path.isfile(lis.trace_path)
    events = json.loads(open(lis.trace_path).read())["traceEvents"]
    assert any("addmm" in str(e.get("name", "")) or "mm" in str(e.get("name", ""))
               for e in events)
    with pytest.raises(ValueError):
        ProfilerListener(str(tmp_path), start=3, stop=3)


def test_profiler_listener_closes_an_open_window(tmp_path):
    m = _mln()
    lis = ProfilerListener(str(tmp_path / "t"), start=1, stop=100)
    m.set_listeners(lis).fit(_data(16), epochs=1, batch_size=8)
    assert lis.captured and not lis._active and os.path.isfile(lis.trace_path)
