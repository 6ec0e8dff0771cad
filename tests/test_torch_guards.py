"""The port's runtime guards against the JAX package's on the CPU.

The retrace guard (``analysis/retrace_guard.py``): the reference's
``TestRetraceGuard`` scenario (``tests/test_lint.py``), the same ladder and
the same streams of batch sizes through both packages, with equal compile
counts and equal predicted bounds; strict mode raises, the default warns
once per site, ``extra_allowed`` widens the bound, a padded ``fit`` is
clean in both packages (MultiLayerNetwork and ComputationGraph), and
``warm_serving``'s buckets count as predicted.

The donation guard (``analysis/donation_guard.py``): a normal step keeps
every param, updater-state and layer-state leaf in place (MultiLayerNetwork
with BatchNorm and Adam, ComputationGraph, the tBPTT path, a ParallelWrapper
step on a one-rank gloo group), a step that rebinds a leaf trips once,
counts, raises one event and leaves the old tensor NaN, and with the guard
off nothing is checked.
"""

import os

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.analysis import donation_guard as jdonation_guard
from deeplearning4j_tpu.analysis import retrace_guard as jretrace_guard
from deeplearning4j_tpu.nn.input_type import InputType as JInputType
from deeplearning4j_tpu.nn.layers import BatchNorm as JBatchNorm
from deeplearning4j_tpu.nn.layers import Dense as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutputLayer
from deeplearning4j_tpu.nn.model import MultiLayerConfiguration as JConf
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JNetwork
from deeplearning4j_tpu.utils import bucketing as jbucketing
from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.analysis import donation_guard, retrace_guard
from deeplearning4j_tpu_torch.nn import aot
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph, ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration, MultiLayerNetwork
from deeplearning4j_tpu_torch.utils import bucketing
from deeplearning4j_tpu_torch.utils.tree import tree_leaves

# the reference scenario: sizes 3..8 hit buckets {4, 8}; 9 and 12 hit 16
STREAM = (3, 4, 5, 6, 7, 8, 9, 12)


def _reset_all():
    for tel in (bucketing.telemetry(), jbucketing.telemetry()):
        tel.reset()
    for guard in (retrace_guard, jretrace_guard):
        guard.reset_warnings()
        guard.reset_aot_warmed()
    donation_guard.reset_warnings()
    jdonation_guard.reset_warnings()


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith("DL4J_TPU_"):
            monkeypatch.delenv(k)
    _reset_all()
    yield
    _reset_all()


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _jconf(updater=None):
    return JConf(
        layers=(JDense(n_out=16, activation="identity"), JBatchNorm(),
                JDense(n_out=8, activation="tanh"),
                JOutputLayer(n_out=2, activation="softmax")),
        input_type=JInputType.feed_forward(4),
        updater=updater or {"type": "sgd", "lr": 0.1}, seed=11)


def _pair(updater=None):
    jconf = _jconf(updater)
    return (JNetwork(jconf).init(),
            MultiLayerNetwork(MultiLayerConfiguration.from_json(jconf.to_json()),
                              device="cpu").init())


def _graph_conf(updater=None):
    layers = MultiLayerConfiguration.from_json(_jconf(updater).to_json()).layers
    return (ComputationGraphConfiguration.builder().add_inputs("in")
            .set_input_types(MultiLayerConfiguration.from_json(
                _jconf().to_json()).input_type)
            .add_layer("h", layers[0], "in").add_layer("bn", layers[1], "h")
            .add_layer("out", layers[3], "bn").set_outputs("out")
            .updater(updater or {"type": "sgd", "lr": 0.1}).seed(11).build())


def _xy(n, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, 4).astype(np.float32),
            np.eye(2, dtype=np.float32)[rs.randint(0, 2, n)])


class _FreshKey:
    """Hashable but never equal across instances: a new signature per call."""


# -- the retrace guard ------------------------------------------------------------

def test_output_stream_compiles_and_predicts_as_the_jax_package(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_RETRACE_GUARD", "1")
    jm, m = _pair()
    x, _ = _xy(12)
    for n in STREAM:
        jm.output(x[:n])
        m.output(x[:n])
    want = jbucketing.telemetry().compiles("mln.output")
    assert want == 3
    assert bucketing.telemetry().compiles("mln.output") == want
    assert (retrace_guard.predicted_compiles("mln.output")
            == jretrace_guard.predicted_compiles("mln.output") == 3)
    rep = retrace_guard.check("mln.output")
    assert rep.ok and rep.compiles == rep.predicted == 3


@pytest.mark.parametrize("padded", [False, True])
def test_retrace_guard_counts_equal_the_jax_guards(monkeypatch, padded):
    """One stream of batch sizes through both packages' RetraceGuard:
    unpadded, every distinct size is a compile (8 against a bound of 3);
    padded to its bucket by the caller, one per bucket."""
    site = f"guard.stream.{padded}"
    jg = jretrace_guard.RetraceGuard(lambda a: a * 2.0, site)
    g = retrace_guard.RetraceGuard(lambda a: a * 2.0, site)
    ladder = bucketing.ladder_from_env()
    for n in STREAM:
        rows = ladder.bucket(n) if padded else n
        x = np.ones((rows, 3), np.float32)
        jg(x)
        g(torch.from_numpy(x))
    want = jbucketing.telemetry().compiles(site)
    assert want == (3 if padded else len(STREAM))
    assert bucketing.telemetry().compiles(site) == want
    assert (retrace_guard.predicted_compiles(site)
            == jretrace_guard.predicted_compiles(site) == 3)
    assert g.report.ok == padded


def test_unpadded_stream_raises_under_strict(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_STRICT_RETRACE", "1")
    g = retrace_guard.RetraceGuard(lambda a: a + 1.0, "guard.strict")
    g(torch.ones(8, 3))                       # bucket 8, one compile: ok
    assert g.report.ok
    with pytest.raises(retrace_guard.RetraceError, match="guard.strict"):
        g(torch.ones(7, 3))                   # bucket 8 again, a second shape


def test_fresh_value_argument_raises_under_strict(monkeypatch):
    """The reference's unhashable-static case: an argument keyed by value
    that is new every call is a new signature every call."""
    monkeypatch.setenv("DL4J_TPU_STRICT_RETRACE", "1")
    monkeypatch.setenv("DL4J_TPU_BUCKETS", "8")
    g = retrace_guard.RetraceGuard(lambda a, key: a * 2.0, "guard.static",
                                   static_argnums=(1,))
    x = torch.ones(8, 3)
    g(x, _FreshKey())
    with pytest.raises(retrace_guard.RetraceError, match="guard.static"):
        g(x, _FreshKey())


def test_nonstrict_warns_once_per_site(monkeypatch):
    import warnings

    monkeypatch.setenv("DL4J_TPU_RETRACE_GUARD", "1")
    monkeypatch.setenv("DL4J_TPU_BUCKETS", "8")
    g = retrace_guard.RetraceGuard(lambda a, key: a + 1.0, "guard.warn",
                                   static_argnums=(1,))
    x = torch.ones(8, 3)
    g(x, _FreshKey())
    with pytest.warns(retrace_guard.RetraceWarning, match="guard.warn"):
        g(x, _FreshKey())
    with warnings.catch_warnings():
        warnings.simplefilter("error")        # the second violation is quiet
        g(x, _FreshKey())
    assert not g.report.ok


def test_extra_allowed_widens_the_bound(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_STRICT_RETRACE", "1")
    for tel, guard in ((bucketing.telemetry(), retrace_guard),
                       (jbucketing.telemetry(), jretrace_guard)):
        tel.record_hit("guard.budget", 4, 8)
        tel.record_trace("guard.budget", (8,))
        tel.record_trace("guard.budget", (8,))
        assert guard.check("guard.budget", extra_allowed=1).ok
        with pytest.raises(guard.RetraceError):
            guard.check("guard.budget")


def test_guard_is_off_by_default():
    assert not retrace_guard.enabled()
    assert retrace_guard.check_if_enabled("mln.output") is None


def test_padded_fit_is_clean_under_strict_in_both_packages(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_STRICT_RETRACE", "1")
    monkeypatch.setenv("DL4J_TPU_CHAIN_STEPS", "0")
    x, y = _xy(20)
    jm, m = _pair()
    jm.fit((x, y), epochs=2, batch_size=8)    # 20 % 8 != 0: a padded tail
    m.fit((x, y), epochs=2, batch_size=8)
    assert (bucketing.telemetry().compiles("mln.step")
            == jbucketing.telemetry().compiles("mln.step") == 1)
    assert retrace_guard.check("mln.step", hits_site="mln.fit").ok
    assert jretrace_guard.check("mln.step", hits_site="mln.fit").ok


def test_padded_graph_fit_is_clean_under_strict(monkeypatch):
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
    from deeplearning4j_tpu.nn.graph import ComputationGraphConfiguration as JGraphConf

    monkeypatch.setenv("DL4J_TPU_STRICT_RETRACE", "1")
    monkeypatch.setenv("DL4J_TPU_CHAIN_STEPS", "0")
    x, y = _xy(20)
    conf = _graph_conf()
    ComputationGraph(conf, device="cpu").init().fit((x, y), epochs=2, batch_size=8)
    JGraph(JGraphConf.from_json(conf.to_json())).init().fit((x, y), epochs=2, batch_size=8)
    assert (bucketing.telemetry().compiles("cg.step")
            == jbucketing.telemetry().compiles("cg.step") == 1)
    assert retrace_guard.check("cg.step", hits_site="cg.fit").ok
    assert jretrace_guard.check("cg.step", hits_site="cg.fit").ok


def test_warm_serving_buckets_count_as_predicted(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_STRICT_RETRACE", "1")
    _, m = _pair()
    n = aot.warm_serving(m, 8)
    buckets = bucketing.reachable_buckets(8)
    assert n == len(buckets) == 4
    assert aot.retrace_guard.aot_warmed_buckets("mln.output") == frozenset(buckets)
    tel = bucketing.telemetry()
    assert tel.compiles("mln.output") == retrace_guard.predicted_compiles("mln.output") == 4
    x, _ = _xy(8)
    for rows in (1, 3, 5, 8):                  # every bucket warm: no new signature
        m.output(x[:rows])
    assert tel.compiles("mln.output") == 4
    assert retrace_guard.check("mln.output").ok


def test_warm_fit_registers_its_bucket(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_STRICT_RETRACE", "1")
    _, m = _pair()
    x, y = _xy(20)
    assert aot.warm_fit(m, (x, y), batch_size=8) == 1
    assert retrace_guard.aot_warmed_buckets("mln.step") == frozenset({8})
    m.fit((x, y), epochs=1, batch_size=8)
    assert bucketing.telemetry().compiles("mln.step") == 1
    assert retrace_guard.check("mln.step", hits_site="mln.fit").ok


# -- the donation guard -----------------------------------------------------------

def _trips():
    return donation_guard._trips.value()


def _guarded(model, step):
    """Run ``step()`` between a snapshot and its check; returns the report."""
    snap = donation_guard.snapshot(model, "test.step")
    step()
    return donation_guard.check_after_step(snap, model)


def test_normal_steps_keep_every_leaf(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_DONATION_GUARD", "1")
    x, y = _xy(16)
    before = _trips()
    _, m = _pair({"type": "adam", "lr": 1e-2})
    m.fit((x, y), epochs=1, batch_size=8)          # the first step makes Adam's state
    rep = _guarded(m, lambda: m.fit((x, y), epochs=1, batch_size=8))
    n_leaves = sum(len(tree_leaves(getattr(m, k))) for k in donation_guard.KINDS)
    assert rep.trips == () and rep.advanced == n_leaves
    cg = ComputationGraph(_graph_conf({"type": "adam", "lr": 1e-2}), device="cpu").init()
    cg.fit((x, y), epochs=1, batch_size=8)
    rep = _guarded(cg, lambda: cg.fit((x, y), epochs=1, batch_size=8))
    assert rep.trips == () and rep.advanced > 0
    assert _trips() == before


def test_tbptt_steps_keep_every_leaf(monkeypatch):
    from deeplearning4j_tpu_torch.models import TextGenerationLSTM

    monkeypatch.setenv("DL4J_TPU_DONATION_GUARD", "1")
    conf = TextGenerationLSTM(vocab_size=5, timesteps=6, hidden=8, seed=3)
    conf.tbptt_fwd_length = conf.tbptt_back_length = 3
    m = MultiLayerNetwork(conf, device="cpu").init()
    ids = np.random.RandomState(0).randint(0, 5, (4, 6))
    eye = np.eye(5, dtype=np.float32)
    data = (eye[ids], eye[np.roll(ids, -1, axis=1)])
    before = _trips()
    m.fit(data, epochs=1)                          # 2 chunks: the state exists now
    rep = _guarded(m, lambda: m.fit(data, epochs=1))
    assert m.iteration == 4
    assert rep.trips == () and rep.advanced == len(tree_leaves(m.params)) + len(
        tree_leaves(m.opt_state))
    assert _trips() == before


def test_data_parallel_step_keeps_every_leaf(monkeypatch, tmp_path):
    from deeplearning4j_tpu_torch.parallel import (ParallelWrapper, init_distributed,
                                                   shutdown_distributed)

    monkeypatch.setenv("DL4J_TPU_DONATION_GUARD", "1")
    x, y = _xy(16)
    _, m = _pair({"type": "adam", "lr": 1e-2})
    reports = []
    check = donation_guard.check_after_step
    monkeypatch.setattr(donation_guard, "check_after_step",
                        lambda snap, model: reports.append(check(snap, model)) or reports[-1])
    before = _trips()
    init_distributed(f"file://{tmp_path}/store", 1, 0, device="cpu", timeout_s=60)
    try:
        pw = ParallelWrapper(m)
        pw.fit((x, y), epochs=1)
        rep = _guarded(m, lambda: pw.fit((x, y), epochs=1))
    finally:
        shutdown_distributed()
    steps = [r for r in reports if r.site == "dp.step"]
    assert len(steps) == 2 and all(r.trips == () and r.advanced for r in steps)
    # the exchange's layout is left in place too: the model's Adam state
    # leaves are the ones it had
    assert rep.trips == () and rep.advanced > 0
    assert _trips() == before


def test_a_rebinding_step_trips_once_and_poisons_the_old_leaf(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_DONATION_GUARD", "1")
    x, y = _xy(8)
    _, m = _pair()
    update = m._update_params

    def rebinding_update(grads, *a, **kw):
        update(grads, *a, **kw)
        m.params[0]["W"] = m.params[0]["W"].clone()   # a new tensor in the tree

    monkeypatch.setattr(m, "_update_params", rebinding_update)
    old = m.params[0]["W"]
    before = _trips()
    events0 = obs.event_log().counts().get("donation_guard", 0)
    m.fit((x, y), epochs=1, batch_size=8)
    assert _trips() == before + 1
    assert obs.event_log().counts().get("donation_guard", 0) == events0 + 1
    assert torch.isnan(old).all()
    assert torch.isfinite(m.params[0]["W"]).all()
    m.fit((x, y), epochs=1, batch_size=8)         # a second trip, no second event
    assert _trips() == before + 2
    assert obs.event_log().counts().get("donation_guard", 0) == events0 + 1


def test_assign_leaves_refuses_another_structure_shape_or_dtype():
    from deeplearning4j_tpu_torch.utils.tree import assign_leaves

    dst = {"W": torch.zeros(2, 3), "b": torch.zeros(3)}
    w = dst["W"]
    assert assign_leaves(dst, {"W": torch.ones(2, 3), "b": torch.ones(3)}) is dst
    assert dst["W"] is w and float(w.sum()) == 6.0
    for bad in ({"W": torch.ones(2, 3)}, {"W": torch.ones(3, 2), "b": torch.ones(3)},
                {"W": torch.ones(2, 3, dtype=torch.float64), "b": torch.ones(3)}):
        with pytest.raises(ValueError):
            assign_leaves(dst, bad)


def test_skip_batch_steps_keep_every_leaf(monkeypatch):
    """The divergence guard's skip_batch select writes into the leaves too."""
    from deeplearning4j_tpu_torch.train.resilience import DivergenceGuard

    monkeypatch.setenv("DL4J_TPU_DONATION_GUARD", "1")
    x, y = _xy(16)
    _, m = _pair({"type": "adam", "lr": 1e-2})
    m.set_divergence_guard(DivergenceGuard(policy="skip_batch"))
    m.fit((x, y), epochs=1, batch_size=8)
    before = _trips()
    rep = _guarded(m, lambda: m.fit((x, y), epochs=1, batch_size=8))
    n_leaves = sum(len(tree_leaves(getattr(m, k))) for k in donation_guard.KINDS)
    assert rep.trips == () and rep.advanced == n_leaves
    assert _trips() == before


@pytest.mark.parametrize("knob", ["DL4J_TPU_PHASE_SPANS", "DL4J_TPU_CHAIN_STEPS"])
def test_phase_and_chain_signatures_live_on_the_models_sites(monkeypatch, knob):
    """The phase path and the chains count their compiles on the model's
    own ``nn/aot.py`` sites: once per signature, checked after dispatch."""
    monkeypatch.setenv("DL4J_TPU_STRICT_RETRACE", "1")
    monkeypatch.setenv(knob, "1" if knob == "DL4J_TPU_PHASE_SPANS" else "2")
    x, y = _xy(16)
    _, m = _pair()
    m.fit((x, y), epochs=2, batch_size=8)
    sites = (("mln.phase.fwd", "mln.phase.bwd", "mln.phase.update")
             if knob == "DL4J_TPU_PHASE_SPANS" else ("mln.chain",))
    for site in sites:
        assert len(m._aot_fns[site].signatures()) == 1
        assert bucketing.telemetry().compiles(site) == 1


def test_solver_signatures_live_on_the_models_site(monkeypatch):
    from dataclasses import replace

    conf = replace(_jconf(), optimization_algo="lbfgs", solver_iterations=2)
    m = MultiLayerNetwork(MultiLayerConfiguration.from_json(conf.to_json()),
                          device="cpu").init()
    x, y = _xy(8)
    m.fit((x, y), epochs=2, batch_size=8)
    assert len(m._aot_fns["solver"].signatures()) == 1
    assert bucketing.telemetry().compiles("solver") == 1


def test_guard_off_checks_nothing(monkeypatch):
    x, y = _xy(8)
    _, m = _pair()
    assert not donation_guard.enabled()
    assert donation_guard.snapshot(m, "test.step") is None
    update = m._update_params

    def rebinding_update(grads, *a, **kw):
        update(grads, *a, **kw)
        m.params[0]["W"] = m.params[0]["W"].clone()

    monkeypatch.setattr(m, "_update_params", rebinding_update)
    old = m.params[0]["W"]
    before = _trips()
    m.fit((x, y), epochs=1, batch_size=8)
    assert _trips() == before and torch.isfinite(old).all()
    monkeypatch.setenv("DL4J_TPU_DONATION_GUARD", "0")
    assert not donation_guard.enabled()
