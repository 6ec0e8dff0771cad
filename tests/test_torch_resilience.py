"""The port's training resilience (train/resilience.py, train/checkpoint.py,
trainState.json in utils/serialization.py) held against the JAX package on
the CPU: checkpoints read across the packages in f32 (the JAX PRNG key left
alone), resume bit-exact against an uninterrupted port run (an MLP with
dropout, a tBPTT LSTM, a small graph), CheckpointListener retention and its
CRC index, corrupt-checkpoint fallback, the divergence guard's three
policies on the same score stream and the same NaN batch, and the chaos
grammar. Params go across with ``interop``; every tolerance is stated."""

import json
import os
import warnings
import zipfile

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.nn.graph import ComputationGraphConfiguration as JGraphConf
from deeplearning4j_tpu.nn.input_type import InputType as JInputType
from deeplearning4j_tpu.nn.layers import Dense as JDense
from deeplearning4j_tpu.nn.layers import GravesLSTM as JGravesLSTM
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutputLayer
from deeplearning4j_tpu.nn.layers import RnnOutputLayer as JRnnOutputLayer
from deeplearning4j_tpu.nn.model import MultiLayerConfiguration as JConf
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JNetwork
from deeplearning4j_tpu.train import resilience as jres
from deeplearning4j_tpu.train.checkpoint import CheckpointListener as JCheckpointListener
from deeplearning4j_tpu_torch.interop import params_from_numpy, params_to_numpy
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph, ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration, MultiLayerNetwork
from deeplearning4j_tpu_torch.train import resilience
from deeplearning4j_tpu_torch.train.checkpoint import CheckpointListener
from deeplearning4j_tpu_torch.train.resilience import (
    ChaosInjector,
    ChaosPreemption,
    DivergenceError,
    DivergenceGuard,
    corrupt_file,
    install_chaos,
)
from deeplearning4j_tpu_torch.utils import bucketing
from deeplearning4j_tpu_torch.utils import serialization as ser
from deeplearning4j_tpu_torch.utils.tree import tree_leaves

# f32 on the CPU, the same math in two frameworks: sums in other orders
F32 = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in list(os.environ):
        if k.startswith("DL4J_TPU_"):
            monkeypatch.delenv(k)
    yield
    install_chaos(None)
    jres.install_chaos(None)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _jconf(dropout=0.0, lr=1e-2, seed=3, updater="adam"):
    return JConf(
        layers=(JDense(n_out=8, activation="tanh", **({"dropout": dropout} if dropout else {})),
                JOutputLayer(n_out=3, activation="softmax")),
        input_type=JInputType.feed_forward(4), updater={"type": updater, "lr": lr}, seed=seed)


def _mln(dropout=0.0, seed=3, **kw):
    return MultiLayerNetwork(MultiLayerConfiguration.from_json(
        _jconf(dropout, seed=seed, **kw).to_json()), device="cpu").init()


def _pair(**kw):
    jm = JNetwork(_jconf(**kw)).init()
    m = MultiLayerNetwork(MultiLayerConfiguration.from_json(jm.conf.to_json()),
                          device="cpu").init()
    params_from_numpy(m, jax.tree_util.tree_map(np.asarray, jm.params))
    return jm, m


def _lstm(seed=3):
    conf = JConf(layers=(JGravesLSTM(n_out=6, activation="tanh", dropout=0.2),
                         JRnnOutputLayer(n_out=5, activation="softmax")),
                 input_type=JInputType.recurrent(5, 12), updater={"type": "rmsprop", "lr": 1e-2},
                 backprop_type="tbptt", tbptt_fwd_length=4, tbptt_back_length=4, seed=seed)
    return MultiLayerNetwork(MultiLayerConfiguration.from_json(conf.to_json()),
                             device="cpu").init()


def _graph(seed=3):
    conf = (JGraphConf.builder().add_inputs("in").set_input_types(JInputType.feed_forward(4))
            .add_layer("h", JDense(n_out=8, activation="tanh", dropout=0.2), "in")
            .add_layer("out", JOutputLayer(n_out=3, activation="softmax"), "h")
            .set_outputs("out").updater({"type": "adam", "lr": 1e-2}).seed(seed).build())
    return ComputationGraph(ComputationGraphConfiguration.from_json(conf.to_json()),
                            device="cpu").init()


def _data(n=48, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, 4).astype(np.float32),
            np.eye(3, dtype=np.float32)[rs.randint(0, 3, n)])


def _seq(n=16, seed=0):
    rs = np.random.RandomState(seed)
    eye = np.eye(5, dtype=np.float32)
    return eye[rs.randint(0, 5, (n, 12))], eye[rs.randint(0, 5, (n, 12))]


def _assert_bits(a, b, what=""):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb), what
    for u, v in zip(la, lb):
        assert torch.equal(u, v), what


def _guard_counts():
    return dict(bucketing.telemetry().snapshot().get("guard", {}))


# -- the chaos grammar ----------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "preempt@iter:8:kill, corrupt_ckpt@ckpt:2:truncate,nan_grad,slow_iter:0.01",
    "preempt@iter:4", "nan_grad@iter:3", "slow_iter@iter:2:0.5", "corrupt_ckpt:bitflip",
    "corrupt_ckpt@ckpt:1", " nan_grad , preempt@iter:0 "])
def test_chaos_grammar_parses_as_the_reference(spec):
    got = [(f.kind, f.at_iter, f.at_ckpt, f.arg) for f in ChaosInjector.parse(spec).faults]
    want = [(f.kind, f.at_iter, f.at_ckpt, f.arg) for f in jres.ChaosInjector.parse(spec).faults]
    assert got == want


@pytest.mark.parametrize("bad", ["explode", "preempt@step:3", "preempt@iter:", "nan_grad@iter"])
def test_chaos_grammar_errors_as_the_reference(bad):
    with pytest.raises(ValueError):
        jres.ChaosInjector.parse(bad)
    with pytest.raises(ValueError):
        ChaosInjector.parse(bad)


def test_chaos_hooks_fire_once():
    inj = ChaosInjector.parse("preempt@iter:5,nan_grad@iter:2")
    inj.maybe_preempt(4)
    with pytest.raises(ChaosPreemption):
        inj.maybe_preempt(7)
    inj.maybe_preempt(8)
    x = (np.ones((4, 3), np.float32), np.arange(4), torch.ones(2, 2), torch.arange(3))
    assert inj.maybe_nan_batch(1, x) is x
    bad = inj.maybe_nan_batch(2, x)
    assert np.isnan(bad[0]).all() and bad[0].dtype == np.float32
    assert torch.isnan(bad[2]).all()
    np.testing.assert_array_equal(bad[1], x[1])
    assert torch.equal(bad[3], x[3])
    assert inj.maybe_nan_batch(2, x) is x


def test_corrupt_file_modes(tmp_path):
    p = tmp_path / "blob.bin"
    payload = bytes(range(256)) * 8
    p.write_bytes(payload)
    crc0 = resilience.crc32_file(p)
    assert crc0 == jres.crc32_file(p)
    corrupt_file(str(p), mode="bitflip")
    assert os.path.getsize(p) == len(payload) and resilience.crc32_file(p) != crc0
    corrupt_file(str(p), mode="truncate")
    assert os.path.getsize(p) == len(payload) // 2
    with pytest.raises(ValueError):
        corrupt_file(str(p), mode="melt")


def test_install_override_beats_env(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_CHAOS", "slow_iter:0.001")
    inj = resilience.active_chaos()
    assert inj is not None and inj.faults[0].kind == "slow_iter"
    assert resilience.active_chaos() is inj
    override = install_chaos("nan_grad@iter:1")
    assert resilience.active_chaos() is override
    install_chaos(None)
    assert resilience.active_chaos() is inj


# -- checkpoints across the packages ----------------------------------------------

def test_port_checkpoint_read_by_the_jax_package(tmp_path):
    jm, m = _pair(dropout=0.2)
    x, y = _data()
    m.fit((x, y), epochs=1, batch_size=16)
    m.batch_in_epoch, m._lr_scale = 2, 0.25
    info = resilience.save_checkpoint(m, str(tmp_path / "p.zip"))
    assert info["crc"] == jres.crc32_file(info["path"]) and info["seconds"] >= 0
    assert jres.validate_checkpoint(info["path"], crc=info["crc"], size=info["size"])
    with zipfile.ZipFile(info["path"]) as zf:
        ts = json.loads(zf.read("trainState.json"))
        assert all(i.compress_type == zipfile.ZIP_STORED for i in zf.infolist())
    assert "rng" not in ts and ts["torch_rng_device"] == "cpu"
    key_before = np.asarray(jm._rng).copy()
    jres.load_state_into(jm, info["path"])
    np.testing.assert_array_equal(np.asarray(jm._rng), key_before)   # "rng" left alone
    for a, b in zip(tree_leaves(params_to_numpy(m)), jax.tree_util.tree_leaves(jm.params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(tree_leaves(m.opt_state), jax.tree_util.tree_leaves(jm.opt_state)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (jm.iteration, jm.epoch, jm.batch_in_epoch, jm._lr_scale) == (3, 1, 2, 0.25)


def test_jax_checkpoint_read_by_the_port(tmp_path):
    jm, m = _pair(dropout=0.2)
    jm.fit(_data(), epochs=1, batch_size=16)
    jm.batch_in_epoch, jm._lr_scale = 1, 0.5
    path = str(tmp_path / "j.zip")
    jres.save_checkpoint(jm, path)
    gen_before = m._gen.get_state()
    ser._JAX_KEY_WARNED = False
    with pytest.warns(UserWarning, match="JAX PRNG key"):
        resilience.load_state_into(m, path)
    assert torch.equal(m._gen.get_state(), gen_before)
    for a, b in zip(tree_leaves(params_to_numpy(m)), jax.tree_util.tree_leaves(jm.params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(tree_leaves(m.opt_state), jax.tree_util.tree_leaves(jm.opt_state)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (m.iteration, m.epoch, m.batch_in_epoch, m._lr_scale) == (3, 1, 1, 0.5)
    # the LR scale reached the rebuilt updaters
    assert m._updaters[0].spec["lr"] == pytest.approx(0.5e-2)


def test_full_state_round_trip_restores_the_generator(tmp_path):
    m = _mln(dropout=0.2)
    m.fit(_data(), epochs=1, batch_size=16)
    p = str(tmp_path / "full.zip")
    resilience.save_checkpoint(m, p)
    assert os.listdir(tmp_path) == ["full.zip"]   # no tmp left by the atomic write
    m2 = _mln(dropout=0.2, seed=99)
    resilience.load_state_into(m2, p)
    _assert_bits(m.params, m2.params)
    _assert_bits(m.opt_state, m2.opt_state)
    assert torch.equal(m._gen.get_state(), m2._gen.get_state())


# -- resume parity: preempted + resumed == uninterrupted, bit for bit ------------

def _preempt(model, data, ckdir, at_iter, epochs, batch_size):
    model.set_listeners(CheckpointListener(ckdir, save_every_n_iterations=2, keep_all=True,
                                           delete_existing=True))
    install_chaos(f"preempt@iter:{at_iter}")
    with pytest.raises(ChaosPreemption):
        model.fit(data, epochs=epochs, batch_size=batch_size)
    install_chaos(None)


@pytest.mark.parametrize("kind", ["mlp_dropout", "tbptt_lstm", "graph"])
def test_resume_is_bit_exact(kind, tmp_path):
    make, data, bs, at, total = {
        "mlp_dropout": (lambda s=3: _mln(dropout=0.2, seed=s), _data(64), 16, 6, 8),
        "tbptt_lstm": (_lstm, _seq(16), 8, 8, 12),   # 3 chunks a batch
        "graph": (_graph, _data(64), 16, 6, 8),
    }[kind]
    cont = make()
    cont.fit(data, epochs=2, batch_size=bs)
    m = make()
    _preempt(m, data, tmp_path, at, 2, bs)
    r = make(99)
    r.fit(data, epochs=2, batch_size=bs, resume_from=tmp_path)
    _assert_bits(cont.params, r.params, "params")
    _assert_bits(cont.opt_state, r.opt_state, "opt_state")
    assert torch.equal(cont._gen.get_state(), r._gen.get_state())
    assert r.iteration == cont.iteration == total and r.epoch == cont.epoch == 2


def test_resume_counts_epochs_as_the_total_budget(tmp_path):
    m = _mln()
    m.set_listeners(CheckpointListener(tmp_path, save_every_n_iterations=1, keep_all=True))
    m.fit(_data(), epochs=2, batch_size=16)
    r = _mln(seed=99)
    r.fit(_data(), epochs=2, batch_size=16, resume_from=tmp_path)
    _assert_bits(m.params, r.params)
    assert r.iteration == m.iteration == 6


def test_resume_from_empty_dir_warns_and_trains(tmp_path):
    m = _mln()
    with pytest.warns(UserWarning, match="no valid checkpoint"):
        m.fit(_data(), epochs=1, batch_size=16, resume_from=tmp_path)
    assert m.epoch == 1


# -- CheckpointListener: retention, index, corruption -----------------------------

@pytest.mark.parametrize("retention,kept", [
    (dict(keep_all=True), [0, 1, 2, 3, 4, 5]),
    (dict(keep_last=2), [4, 5]),
    (dict(keep_last_and_every=(1, 2)), [0, 2, 4, 5]),
])
def test_checkpoint_retention_and_index(retention, kept, tmp_path):
    m = _mln()
    lis = CheckpointListener(tmp_path, save_every_n_iterations=1, **retention)
    m.set_listeners(lis)
    m.fit(_data(), epochs=2, batch_size=16)   # 6 iterations, 6 saves
    cps = CheckpointListener.checkpoints(tmp_path)
    assert [c.number for c in cps] == kept
    assert sorted(f for f in os.listdir(tmp_path) if f.endswith(".zip")) == sorted(
        c.filename for c in cps)
    for c in cps:
        path = os.path.join(str(tmp_path), c.filename)
        assert c.size == os.path.getsize(path) and c.crc == resilience.crc32_file(path)
    assert [lis.saves[c.number]["size"] for c in cps] == [c.size for c in cps]
    # the JAX package reads the port's index the same way
    assert [c.number for c in JCheckpointListener.checkpoints(tmp_path)] == kept
    assert JCheckpointListener.last_valid_checkpoint(tmp_path).number == kept[-1]


def test_save_every_epochs_and_seconds(tmp_path):
    m = _mln()
    m.set_listeners(CheckpointListener(tmp_path / "e", save_every_n_epochs=2, keep_all=True))
    m.fit(_data(), epochs=4, batch_size=16)
    assert [c.epoch for c in CheckpointListener.checkpoints(tmp_path / "e")] == [1, 3]
    m.set_listeners(CheckpointListener(tmp_path / "s", save_every_seconds=1e-9, keep_all=True))
    m.fit(_data(), epochs=1, batch_size=16)
    assert len(CheckpointListener.checkpoints(tmp_path / "s")) == 3


@pytest.mark.parametrize("mode", ["bitflip", "truncate"])
def test_corrupt_newest_falls_back_to_the_last_valid(mode, tmp_path):
    m = _mln()
    m.set_listeners(CheckpointListener(tmp_path, save_every_n_iterations=2, keep_all=True))
    m.fit(_data(), epochs=2, batch_size=16)
    cps = CheckpointListener.checkpoints(tmp_path)
    assert len(cps) == 3
    corrupt_file(os.path.join(str(tmp_path), cps[-1].filename), mode=mode)
    assert CheckpointListener.last_valid_checkpoint(tmp_path).number == cps[-2].number
    r = _mln(seed=99)
    assert resilience.resume(r, tmp_path).number == cps[-2].number
    assert r.iteration == cps[-2].iteration
    back = CheckpointListener.load_last_valid_checkpoint(tmp_path, device="cpu")
    _assert_bits(back.params, r.params)


def test_chaos_corruption_lands_after_the_crc(tmp_path):
    install_chaos("corrupt_ckpt@ckpt:2:bitflip")
    m = _mln()
    m.set_listeners(CheckpointListener(tmp_path, save_every_n_iterations=2, keep_all=True))
    m.fit(_data(), epochs=2, batch_size=16)
    by = {c.number: c for c in CheckpointListener.checkpoints(tmp_path)}
    assert not resilience.validate_checkpoint(
        os.path.join(str(tmp_path), by[2].filename), crc=by[2].crc, size=by[2].size)
    assert CheckpointListener.last_valid_checkpoint(tmp_path).number == 1


# -- the divergence guard -------------------------------------------------------

def test_guard_policy_validation():
    with pytest.raises(ValueError):
        DivergenceGuard(policy="panic")
    with pytest.raises(ValueError):
        DivergenceGuard(policy="rollback")


@pytest.mark.parametrize("policy,limit", [("warn", None), ("skip_batch", None),
                                          ("warn", 1.0), ("skip_batch", 2.5)])
def test_guard_trips_as_the_reference_on_one_score_stream(policy, limit):
    stream = [0.5, 3.0, float("nan"), 0.7, float("inf"), 0.2, 2.0, 0.1, float("nan")]
    g = DivergenceGuard(policy, spike_limit=limit, flush_every=3)
    jg = jres.DivergenceGuard(policy, spike_limit=limit, flush_every=3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for v in stream:
            g.observe(None, torch.tensor(v))
            jg.observe(None, v)
        g.flush(None)
        jg.flush(None)
    assert g.trips == jg.trips > 0


@pytest.mark.parametrize("policy", ["warn", "skip_batch"])
def test_guard_on_a_nan_batch_matches_the_reference(policy):
    """The same NaN batch (chaos nan_grad at iteration 2) through both
    packages' fit under the same guard: the same trips, and params equal
    within F32 (skip_batch: finite; warn: NaN in the same leaves)."""
    jm, m = _pair(updater="sgd", lr=0.1)
    x, y = _data(64)
    for pkg, model in ((jres, jm), (resilience, m)):
        g = pkg.DivergenceGuard(policy, flush_every=4)
        model.set_divergence_guard(g)
        pkg.install_chaos("nan_grad@iter:2")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            model.fit((x, y), epochs=2, batch_size=16)
        pkg.install_chaos(None)
    assert m.divergence_guard.trips == jm.divergence_guard.trips >= 1
    for a, b in zip(tree_leaves(params_to_numpy(m)), jax.tree_util.tree_leaves(jm.params)):
        b = np.asarray(b)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b), **F32)


def test_rollback_matches_the_reference(tmp_path):
    """The same NaN batch under rollback in both packages: one retry, the
    same LR scale and iteration, and params equal within F32."""
    jm, m = _pair(updater="sgd", lr=0.1)
    x, y = _data(64)
    for pkg, model, lis, d in ((jres, jm, JCheckpointListener, tmp_path / "j"),
                               (resilience, m, CheckpointListener, tmp_path / "p")):
        model.set_listeners(lis(d, save_every_n_iterations=2, keep_all=True))
        model.set_divergence_guard(pkg.DivergenceGuard("rollback", checkpoint_dir=d))
        pkg.install_chaos("nan_grad@iter:5")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            model.fit((x, y), epochs=2, batch_size=16)
        pkg.install_chaos(None)
    g, jg = m.divergence_guard, jm.divergence_guard
    assert (g.trips, g.retries) == (jg.trips, jg.retries) == (1, 1)
    assert m._lr_scale == jm._lr_scale == 0.5 and m.iteration == jm.iteration
    for a, b in zip(tree_leaves(params_to_numpy(m)), jax.tree_util.tree_leaves(jm.params)):
        np.testing.assert_allclose(a, np.asarray(b), **F32)


def test_skip_batch_leaves_the_step_bit_equal():
    m = _mln(dropout=0.2)
    x, y = _data(16)
    m.fit((x, y), epochs=1)   # updater state exists
    before = [t.clone() for t in tree_leaves((m.params, m.opt_state, m.state))]
    m.set_divergence_guard(DivergenceGuard("skip_batch", spike_limit=0.0))
    it = m.iteration
    m.fit((x, y), epochs=2)
    for a, b in zip(before, tree_leaves((m.params, m.opt_state, m.state))):
        assert torch.equal(a, b)
    assert m.iteration == it + 2 and m.divergence_guard.trips >= 1


def test_rollback_restores_and_backs_off_the_rate(tmp_path):
    m = _mln()
    m.set_listeners(CheckpointListener(tmp_path, save_every_n_iterations=2, keep_all=True))
    g = DivergenceGuard("rollback", checkpoint_dir=tmp_path, lr_backoff=0.5)
    m.set_divergence_guard(g)
    install_chaos("nan_grad@iter:5")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m.fit(_data(64), epochs=2, batch_size=16)
    assert g.retries == 1 and m._lr_scale == pytest.approx(0.5)
    assert m._updaters[0].spec["lr"] == pytest.approx(0.5e-2)
    assert all(torch.isfinite(t).all() for t in tree_leaves(m.params))
    counts = _guard_counts()
    assert counts.get("rollback", 0) >= 1 and counts.get("rollback_restore", 0) >= 1


def test_rollback_exhausted_raises(tmp_path):
    m = _mln()
    m.set_divergence_guard(DivergenceGuard("rollback", checkpoint_dir=tmp_path,
                                           max_retries=0))
    install_chaos("nan_grad@iter:1")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(DivergenceError):
            m.fit(_data(), epochs=1, batch_size=16)


def test_note_score_warns_once_and_counts():
    resilience._INVALID_SCORE_WARNED = False
    before = _guard_counts().get("invalid_score", 0)
    with pytest.warns(UserWarning, match="non-finite"):
        resilience.note_score(float("nan"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        resilience.note_score(float("inf"))
        resilience.note_score(1.25)
    assert _guard_counts()["invalid_score"] == before + 2


def test_io_with_retries_retries_then_raises(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_CKPT_RETRY_BASE_S", "0")
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "done"

    assert resilience.io_with_retries(flaky) == "done" and len(calls) == 3
    monkeypatch.setenv("DL4J_TPU_CKPT_RETRIES", "1")
    with pytest.raises(OSError):
        resilience.io_with_retries(lambda: (_ for _ in ()).throw(OSError("down")))


def test_write_json_durable(tmp_path):
    p = tmp_path / "x.json"
    resilience.write_json_durable(str(p), {"a": 1})
    assert json.loads(p.read_text()) == {"a": 1} and os.listdir(tmp_path) == ["x.json"]
