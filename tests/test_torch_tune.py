"""The port's tuner (``deeplearning4j_tpu_torch/tune``) against the JAX
package's: the knob registry is equal, either package reads the other's
tuning DB (entries intact, foreign rows kept, another toolchain's entry
stale), successive halving ranks a fake runner's results into the same
winner and history, one real trial runs in a subprocess on the CPU, and
``DL4J_TPU_TUNE=auto`` applies the DB's winner where the JAX package does:
``fit`` of both network classes, the serve registry, ``ParallelInference``
and ``MeshTrainer``."""

import json
import os
import zipfile

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu import tune as jtune
from deeplearning4j_tpu.nn import aot as jaot
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.graph import ComputationGraphConfiguration as JGraphConf
from deeplearning4j_tpu.nn.graph import MergeVertex as JMerge
from deeplearning4j_tpu.nn.input_type import InputType as JInputType
from deeplearning4j_tpu.nn.model import MultiLayerConfiguration as JConf
from deeplearning4j_tpu.tune import knobs as jknobs
from deeplearning4j_tpu.tune import search as jsearch
from deeplearning4j_tpu_torch import obs, tune
from deeplearning4j_tpu_torch.nn import aot
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph, ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration, MultiLayerNetwork
from deeplearning4j_tpu_torch.tune import knobs, search, trial


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch, tmp_path):
    for k in list(os.environ):
        if k.startswith("DL4J_TPU_"):
            monkeypatch.delenv(k)
    monkeypatch.setenv("DL4J_TPU_TUNE_DB", str(tmp_path / "tunedb.zip"))
    yield
    # maybe_apply writes the knobs into os.environ itself: drop them before
    # monkeypatch puts back what the process had
    for k in list(os.environ):
        if k.startswith("DL4J_TPU_"):
            del os.environ[k]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _jconf(seed=3):
    return JConf(layers=(jl.Dense(n_out=8, activation="tanh"),
                         jl.OutputLayer(n_out=3, activation="softmax")),
                 input_type=JInputType.feed_forward(5), seed=seed,
                 updater={"type": "adam", "lr": 1e-2})


def _model(seed=3):
    return MultiLayerNetwork(MultiLayerConfiguration.from_json(_jconf(seed).to_json()),
                             device="cpu").init()


def _data(n=16):
    rs = np.random.RandomState(0)
    return rs.rand(n, 5).astype(np.float32), np.eye(3, dtype=np.float32)[rs.randint(0, 3, n)]


def _events(kind):
    return obs.event_log().counts().get(kind, 0)


def test_the_knob_registry_equals_the_jax_package():
    assert knobs.registry_dict() == jknobs.registry_dict()
    assert [k.name for k in knobs.all_knobs("fit")] == [k.name for k in jknobs.all_knobs("fit")]
    assert [k.name for k in knobs.all_knobs("serve")] == [
        k.name for k in jknobs.all_knobs("serve")]
    assert set(knobs.INERT) == {"flash_block_q", "flash_block_k", "rnn_unroll"}
    assert knobs._mesh_axis_domain() == (0, 1, 2, 4, 8)
    k = knobs.get("chain_steps")
    assert k.validate("8") == "8" and k.format(16) == "16"
    with pytest.raises(ValueError, match="not in domain"):
        k.validate("3")
    with pytest.raises(ValueError, match="bad scope"):
        knobs.Knob("x", "X", "int", (1,), 1, "everywhere")
    assert knobs.Knob.from_dict(k.to_dict()) == k


def test_enumerate_configs_equals_the_jax_package():
    for names, overrides in ((("grad_accum", "chain_steps"), None),
                             (("grad_accum", "chain_steps"),
                              {"grad_accum": [1, 2], "chain_steps": ["0", "8"]}),
                             (("bucket_min", "kv_page_tokens"), {"bucket_min": [8, 1]})):
        assert search.enumerate_configs(names, overrides) == jsearch.enumerate_configs(
            names, overrides)
    with pytest.raises(KeyError):
        search.enumerate_configs(["nope"])


def _fake(table):
    def runner(spec, config, timeout_s=0.0):
        key = json.dumps(config, sort_keys=True)
        sps = table[key] * (1 + spec["steps"] / 1000.0)
        return search.TrialResult(config=dict(config), objective=sps, ok=sps > 0,
                                  error=None if sps > 0 else "boom")
    return runner


def _jfake(table):
    def runner(spec, config, timeout_s=0.0):
        key = json.dumps(config, sort_keys=True)
        sps = table[key] * (1 + spec["steps"] / 1000.0)
        return jsearch.TrialResult(config=dict(config), objective=sps, ok=sps > 0,
                                   error=None if sps > 0 else "boom")
    return runner


@pytest.mark.parametrize("eta", [2, 3])
def test_successive_halving_ranks_like_the_jax_package(eta):
    configs = search.enumerate_configs(("grad_accum", "chain_steps"))
    rs = np.random.RandomState(eta)
    table = {json.dumps(c, sort_keys=True): float(v) for c, v in
             zip(configs, rs.choice([0.0, 5.0, 10.0, 10.0, 20.0], len(configs)))}
    spec = {"steps": 8}
    w, hist = search.successive_halving(spec, configs, eta=eta, runner=_fake(table))
    jw, jhist = jsearch.successive_halving(spec, configs, eta=eta, runner=_jfake(table))
    assert w.config == jw.config and w.objective == jw.objective
    assert [(h.config, h.objective, h.ok) for h in hist] == [
        (h.config, h.objective, h.ok) for h in jhist]
    with pytest.raises(ValueError):
        search.successive_halving(spec, [], runner=_fake(table))


def test_a_db_written_by_either_package_reads_in_the_other(tmp_path):
    path = str(tmp_path / "shared.zip")
    jdb = jtune.TuningDB(path)
    jtc = jaot.toolchain_fingerprint()
    jdb.record("jaxsig", {"grad_accum": 2}, {"steps_per_sec": 3.0}, trials=4, toolchain=jtc)
    pdb = tune.TuningDB(path)
    entries = pdb.load()
    assert entries["jaxsig|cpu"]["knobs"] == {"grad_accum": 2}
    assert entries == jdb.load()
    ptc = aot.toolchain_fingerprint("cpu")
    pdb.record("portsig", {"chain_steps": "8"}, {"steps_per_sec": 5.0}, trials=6, toolchain=ptc)
    both = jdb.load()
    assert both["jaxsig|cpu"] == entries["jaxsig|cpu"]          # the foreign row kept
    assert both["portsig|cpu"]["knobs"] == {"chain_steps": "8"}
    assert pdb.lookup("portsig", toolchain=ptc)["trials"] == 6
    with zipfile.ZipFile(path) as zf:
        doc = json.loads(zf.read("tunedb.json"))
    assert doc["registry"] == jknobs.registry_dict() and doc["format_version"] == 1
    # another package's toolchain is stale here, and the other way round
    stale0 = obs.registry().counter("dl4j_tune_db_stale_total").value()
    assert pdb.lookup("jaxsig", toolchain=ptc) is None
    assert obs.registry().counter("dl4j_tune_db_stale_total").value() == stale0 + 1
    assert pdb.lookup("jaxsig", toolchain=ptc, allow_stale=True)["knobs"] == {"grad_accum": 2}
    assert jdb.lookup("portsig", toolchain=jtc) is None
    with pytest.raises(KeyError):
        pdb.record("x", {"nope": 1}, {}, trials=1, toolchain=ptc)


def test_a_corrupt_db_reads_empty(tmp_path):
    path = tmp_path / "bad.zip"
    path.write_bytes(b"not a zip")
    assert tune.TuningDB(str(path)).load() == {}
    assert tune.TuningDB(str(tmp_path / "none.zip")).load() == {}


def _record_winner(model, winner, scope="fit"):
    tune.TuningDB().record(aot.model_signature(model), winner, {"steps_per_sec": 1.0},
                           trials=1, toolchain=aot.toolchain_fingerprint("cpu"), scope=scope)


def test_maybe_apply_never_overrides_a_user_knob(monkeypatch):
    m = _model()
    _record_winner(m, {"grad_accum": 2, "chain_steps": "8", "bucket_min": 4,
                       "kv_page_tokens": 32})
    assert tune.maybe_apply(m, "fit") is None                   # DL4J_TPU_TUNE unset
    monkeypatch.setenv("DL4J_TPU_TUNE", "auto")
    monkeypatch.setenv("DL4J_TPU_CHAIN_STEPS", "0")             # the user's own
    before = _events("tune_applied")
    got = tune.maybe_apply(m, "fit")
    assert got == {"DL4J_TPU_GRAD_ACCUM": "2", "DL4J_TPU_BUCKET_MIN": "4"}
    assert os.environ["DL4J_TPU_CHAIN_STEPS"] == "0"           # explicit beats tuned
    assert "DL4J_TPU_KV_PAGE_TOKENS" not in os.environ          # scope serve, not fit
    assert _events("tune_applied") == before + 1
    assert tune.maybe_apply(m, "fit") is None                   # a second call: no-op
    assert tune.maybe_apply(_model(seed=99), "serve") == {"DL4J_TPU_KV_PAGE_TOKENS": "32"}
    other = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        _jconf().to_json().replace('"n_out": 8', '"n_out": 9')), device="cpu")
    assert tune.maybe_apply(other, "fit") is None               # another model


def test_one_real_trial_runs_in_a_subprocess():
    m = _model()
    x, y = _data()
    spec = trial.build_spec(m, x, y, steps=2, warmup_steps=1)
    assert spec["device"] == "cpu" and spec["model_class"] == "MultiLayerNetwork"
    r = search.run_subprocess_trial(spec, {"grad_accum": 2, "chain_steps": "0"},
                                    timeout_s=300)
    assert r.ok and r.error is None, r.error
    assert r.objective > 0 and r.raw["device"] == "cpu"
    assert r.raw["env"] == {"DL4J_TPU_GRAD_ACCUM": "2", "DL4J_TPU_CHAIN_STEPS": "0"}
    assert r.flops_total > 0 and r.bytes_total > 0
    bad = search.run_subprocess_trial(dict(spec, model_class="Nope"), {}, timeout_s=300)
    assert not bad.ok and "Nope" in bad.error


def test_tune_model_records_the_winner_and_refuses_inert_knobs(tmp_path):
    m = _model()
    x, y = _data()
    table = {json.dumps(c, sort_keys=True): v for c, v in zip(
        search.enumerate_configs(("grad_accum", "chain_steps"),
                                 {"grad_accum": [1, 2], "chain_steps": ["0", "8"]}),
        (1.0, 3.0, 2.0, 0.5))}
    db = tune.TuningDB(str(tmp_path / "t.zip"))
    e = tune.tune_model(m, x, y, overrides={"grad_accum": [1, 2], "chain_steps": ["0", "8"]},
                        db=db, runner=_fake(table))
    assert e["knobs"] == {"chain_steps": "0", "grad_accum": 2}
    assert len(e["history"]) == 6 and e["toolchain"] == aot.toolchain_fingerprint("cpu")
    assert db.lookup(aot.model_signature(m), toolchain=aot.toolchain_fingerprint("cpu"))
    for name in ("flash_block_q", "flash_block_k", "rnn_unroll"):
        with pytest.raises(ValueError, match="cannot be tuned in the PyTorch port"):
            tune.tune_model(m, x, y, knob_names=(name,), db=db, runner=_fake(table))


def test_tune_auto_acts_in_fit(monkeypatch):
    m = _model()
    x, y = _data()
    _record_winner(m, {"grad_accum": 2})
    monkeypatch.setenv("DL4J_TPU_TUNE", "auto")
    before = _events("tune_applied")
    m.fit((x, y), epochs=1, batch_size=8)
    assert os.environ.get("DL4J_TPU_GRAD_ACCUM") == "2"
    assert _events("tune_applied") == before + 1
    # the applied knob trains like the knob set by hand
    monkeypatch.delenv("DL4J_TPU_TUNE")
    ref = _model()
    ref.fit((x, y), epochs=1, batch_size=8)
    for a, b in zip(ref.params, m.params):
        for k in a:
            assert torch.equal(a[k], b[k])


def test_tune_auto_acts_in_graph_fit(monkeypatch):
    conf = (JGraphConf.builder().add_inputs("a", "b")
            .set_input_types(JInputType.feed_forward(3), JInputType.feed_forward(2))
            .add_layer("da", jl.Dense(n_out=4, activation="relu"), "a")
            .add_vertex("m", JMerge(), "da", "b")
            .add_layer("out", jl.OutputLayer(n_out=2, activation="softmax"), "m")
            .set_outputs("out").seed(2).build())
    cg = ComputationGraph(ComputationGraphConfiguration.from_json(conf.to_json()),
                          device="cpu").init()
    _record_winner(cg, {"chain_steps": "0", "grad_accum": 2})
    monkeypatch.setenv("DL4J_TPU_TUNE", "auto")
    rs = np.random.RandomState(1)
    cg.fit(((rs.rand(8, 3).astype(np.float32), rs.rand(8, 2).astype(np.float32)),
            np.eye(2, dtype=np.float32)[rs.randint(0, 2, 8)]), epochs=1, batch_size=4)
    assert os.environ.get("DL4J_TPU_GRAD_ACCUM") == "2"
    assert os.environ.get("DL4J_TPU_CHAIN_STEPS") == "0"


def test_tune_auto_acts_in_the_registry_and_parallel_inference(monkeypatch):
    from deeplearning4j_tpu_torch.parallel.inference import ParallelInference
    from deeplearning4j_tpu_torch.serve import ModelRegistry, ServeConfig

    m = _model()
    _record_winner(m, {"bucket_min": 4}, scope="serve")
    monkeypatch.setenv("DL4J_TPU_TUNE", "auto")
    reg = ModelRegistry(config=ServeConfig(max_batch=8, workers=1, max_wait_s=0.01),
                        device="cpu")
    try:
        reg.register("m", m)
        assert os.environ.get("DL4J_TPU_BUCKET_MIN") == "4"
        assert reg.describe()[0]["warm_buckets"] == [4, 8]   # the ladder read after the apply
    finally:
        reg.shutdown()
    monkeypatch.delenv("DL4J_TPU_BUCKET_MIN")
    before = _events("tune_applied")
    pi = ParallelInference(m, worker=False, warmup=True, max_batch_size=8)
    assert os.environ.get("DL4J_TPU_BUCKET_MIN") == "4"
    assert _events("tune_applied") == before + 1 and pi.warmed == [4, 8]


def test_tune_auto_acts_in_the_mesh_trainer(monkeypatch):
    from deeplearning4j_tpu_torch.parallel.mesh_step import MeshTrainer

    m = _model()
    _record_winner(m, {"mesh_data": 1, "grad_accum": 2})
    monkeypatch.setenv("DL4J_TPU_TUNE", "auto")
    tr = MeshTrainer(m)
    assert os.environ.get("DL4J_TPU_MESH_DATA") == "1"
    assert os.environ.get("DL4J_TPU_GRAD_ACCUM") == "2"
    assert tr.shape[0] == 1
