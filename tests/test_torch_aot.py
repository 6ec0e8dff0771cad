"""The port's warm layer and bundle sidecar (``deeplearning4j_tpu_torch/nn/aot.py``)
and kernel-library cache (``utils/compile_cache.py``) on the CPU.

Held against the JAX package: ``model_signature`` (MLN, CG, the
TransformerLM, the char-RNN, a vector index) and ``reachable_buckets``.
Then the port on its own terms: a bundle round trip restores the warmed
set with its costs; CRC, signature and format faults are rejected with the
counter and the event; a JAX-format bundle is rejected without any
unpickling, and the JAX package's ``restore_bundle`` rejects a port bundle
without raising; warms leave params, updater state and generator
bit-identical; the checkpoint sidecar, the distributed layout, the
registry's ``bundle=`` on every intake, ``DL4J_TPU_AOT`` in ``fit`` and
``DL4J_TPU_COMPILE_CACHE`` without nvcc."""

import json
import os
import pickle
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn import aot as jaot
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.graph import ComputationGraphConfiguration as JGraphConf
from deeplearning4j_tpu.nn.graph import MergeVertex as JMerge
from deeplearning4j_tpu.nn.input_type import InputType as JInputType
from deeplearning4j_tpu.nn.model import MultiLayerConfiguration as JConf
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JNetwork
from deeplearning4j_tpu.utils import bucketing as jbucketing
from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.nn import aot
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph, ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration, MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import _build
from deeplearning4j_tpu_torch.serve import GenerateConfig, ModelRegistry, ServeConfig
from deeplearning4j_tpu_torch.train.checkpoint import CheckpointListener
from deeplearning4j_tpu_torch.train.listeners import CollectScoresListener
from deeplearning4j_tpu_torch.utils import bucketing
from deeplearning4j_tpu_torch.utils.tree import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith("DL4J_TPU_"):
            monkeypatch.delenv(k)
    obs.reset()
    aot.reset_validation()
    yield
    obs.reset()


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def bundles(monkeypatch):
    """Bundles on: the CPU's default is off (``auto``)."""
    monkeypatch.setenv("DL4J_TPU_AOT_BUNDLE", "1")


def _jdense(seed=3, dropout=0.0):
    extra = {"dropout": dropout} if dropout else {}
    return JConf(layers=(jl.Dense(n_out=16, activation="tanh", **extra),
                         jl.OutputLayer(n_out=4, activation="softmax")),
                 input_type=JInputType.feed_forward(6), seed=seed,
                 updater={"type": "adam", "lr": 1e-2})


def _dense(seed=3, dropout=0.0):
    conf = MultiLayerConfiguration.from_json(_jdense(seed, dropout).to_json())
    return MultiLayerNetwork(conf, device="cpu").init()


def _jgraph():
    return (JGraphConf.builder().add_inputs("a", "b")
            .set_input_types(JInputType.feed_forward(3), JInputType.feed_forward(5))
            .add_layer("da", jl.Dense(n_out=4, activation="relu"), "a")
            .add_layer("db", jl.Dense(n_out=4, activation="relu"), "b")
            .add_vertex("m", JMerge(), "da", "db")
            .add_layer("out", jl.OutputLayer(n_out=2, activation="softmax"), "m")
            .set_outputs("out").seed(9).build())


def _data(n=24, seed=0):
    rs = np.random.RandomState(seed)
    return rs.rand(n, 6).astype(np.float32), np.eye(4, dtype=np.float32)[rs.randint(0, 4, n)]


def _leaves(tree):
    return [t.detach().clone() for t in tree_leaves(tree)]


def _equal(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _rejected(reason):
    return obs.registry().counter("dl4j_aot_bundle_rejected_total", "",
                                  ("reason",)).value(reason=reason)


# -- identity ---------------------------------------------------------------------------

def _pairs():
    jg = _jgraph()
    return {
        "mln": (JNetwork(_jdense()), MultiLayerNetwork(
            MultiLayerConfiguration.from_json(_jdense().to_json()), device="cpu")),
        "cg": (JGraph(jg), ComputationGraph(
            ComputationGraphConfiguration.from_json(jg.to_json()), device="cpu")),
        "transformer_lm": (JNetwork(jzoo.TransformerLM(vocab_size=64, max_len=8, d_model=16,
                                                       n_heads=2, n_blocks=1,
                                                       dtype="bfloat16")),
                           MultiLayerNetwork(zoo.TransformerLM(vocab_size=64, max_len=8,
                                                               d_model=16, n_heads=2,
                                                               n_blocks=1, dtype="bfloat16"),
                                             device="cpu")),
        "char_rnn": (JNetwork(jzoo.TextGenerationLSTM(hidden=128)),
                     MultiLayerNetwork(zoo.TextGenerationLSTM(hidden=128), device="cpu")),
    }


@pytest.mark.parametrize("kind", ["mln", "cg", "transformer_lm", "char_rnn"])
def test_model_signature_equals_the_jax_package(kind):
    jm, pm = _pairs()[kind]
    assert aot.model_signature(pm) == jaot.model_signature(jm)
    # the seed shapes values, not the program: it is not in the signature
    conf = json.loads(pm.conf.to_json())
    conf["seed"] = 777
    cls = type(pm.conf)
    other = type(pm)(cls.from_json(json.dumps(conf)), device="cpu")
    assert aot.model_signature(other) == aot.model_signature(pm)


def test_a_vector_index_signature_equals_the_jax_package():
    from deeplearning4j_tpu.search.index import IndexConfig as JIndexConfig
    from deeplearning4j_tpu.search.index import VectorIndex as JIndex
    from deeplearning4j_tpu_torch.search.index import IndexConfig, VectorIndex

    v = np.random.RandomState(1).rand(300, 8).astype(np.float32)
    a = VectorIndex.build(v, IndexConfig(dim=8, nlist=4), device="cpu")
    b = JIndex.build(v, JIndexConfig(dim=8, nlist=4))
    assert aot.model_signature(a) == jaot.model_signature(b)


@pytest.mark.parametrize("env", [{}, {"DL4J_TPU_BUCKET_MIN": "4"},
                                 {"DL4J_TPU_BUCKET_GROWTH": "1.5"},
                                 {"DL4J_TPU_BUCKETS": "3,10,33"}])
def test_reachable_buckets_match_the_jax_package(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for n in (1, 2, 7, 16, 33, 100):
        assert aot.reachable_buckets(n) == jaot.reachable_buckets(n)
    lad = bucketing.BucketLadder(rungs=(2, 5, 9))
    jlad = jbucketing.BucketLadder(rungs=(2, 5, 9))
    assert aot.reachable_buckets(12, lad) == jaot.reachable_buckets(12, jlad)


def test_signature_keys_round_trip_through_json():
    args = (torch.zeros(2, 3, dtype=torch.int64), None, {"b": torch.ones(4), "a": 1.5},
            [np.zeros((1, 2), np.float32), "x"])
    key = aot.signature_key(args, {"flag": True})
    assert aot._freeze(json.loads(json.dumps(key))) == key
    back, kw = aot._args_of(key, "cpu")
    assert aot.signature_key(back, kw) == key
    assert aot._sig_label(key) == aot._sig_label(aot._freeze(json.loads(json.dumps(key))))


def test_toolchain_fingerprint_and_gate(monkeypatch):
    fp = aot.toolchain_fingerprint("cpu")
    assert fp == {"torch_version": torch.__version__, "cuda_version": torch.version.cuda,
                  "device_name": "cpu", "backend": "cpu"}
    assert aot.persistence_allowed("cpu") is False            # auto: off on the CPU
    monkeypatch.setenv("DL4J_TPU_AOT_BUNDLE", "0")
    assert aot.persistence_allowed("cpu") is False
    monkeypatch.setenv("DL4J_TPU_AOT_BUNDLE", "1")
    assert aot.persistence_allowed("cpu") is True             # the self-test passed
    monkeypatch.setattr(aot, "_selftest", lambda backend: {"ok": False})
    aot.reset_validation()
    assert aot.persistence_allowed("cpu") is False


def test_auto_allows_cuda_bundles_without_the_selftest(monkeypatch):
    def refuse(backend):
        raise AssertionError("auto ran the self-test")

    monkeypatch.setattr(aot, "_selftest", refuse)
    aot.reset_validation()
    assert aot.persistence_allowed("cuda") is True            # auto: on for CUDA
    monkeypatch.setenv("DL4J_TPU_AOT_BUNDLE", "0")
    assert aot.persistence_allowed("cuda") is False


def test_the_cli_runs_the_selftest(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-m", "deeplearning4j_tpu_torch.nn.aot",
                           "--device", "cpu"], capture_output=True, text=True, cwd=REPO,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["ok"] and out["restored"] == out["entries"] == 3
    assert out["fingerprint"]["backend"] == "cpu"
    if not torch.cuda.is_available():
        proc = subprocess.run([sys.executable, "-m", "deeplearning4j_tpu_torch.nn.aot"],
                              capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
        assert proc.returncode == 2 and "CUDA" in proc.stdout


# -- warms ----------------------------------------------------------------------------

def test_warm_serving_prices_every_bucket_and_outputs_are_unchanged():
    m = _dense()
    x, _ = _data(5)
    want = m.output(x).clone()
    assert aot.warm_serving(m, 8) == 4
    fn = m._get_output_fn()
    assert fn.compiled_count == 4 and fn.site == "mln.output"
    assert sorted(obs.cost_report()["sites"]["mln.output"]) == ["b1", "b2", "b4", "b8"]
    assert torch.equal(m.output(x), want)
    hits = obs.registry().counter("dl4j_aot_warm_hits_total", "", ("site",))
    assert hits.value(site="mln.output") >= 1
    spans = obs.snapshot()["spans"]
    assert spans["compile"]["count"] >= 4


def test_warm_fit_never_trains(monkeypatch):
    m = _dense(dropout=0.5)
    x, y = _data(20)
    m.fit((x, y), epochs=1, batch_size=8)            # updater state exists now
    before = (_leaves(m.params), _leaves(m.opt_state), m._gen.get_state().clone(),
              m.iteration, m.epoch)
    assert aot.warm_fit(m, (x, y), 8) == 1
    assert aot.warm_fit(m, (x, y), 8) == 0            # a signature check the second time
    assert _equal(_leaves(m.params), before[0]) and _equal(_leaves(m.opt_state), before[1])
    assert torch.equal(m._gen.get_state(), before[2])
    assert (m.iteration, m.epoch) == before[3:]
    entry = obs.cost_report()["sites"]["mln.step"]["b8"]
    assert entry["flops"] > 0 and entry["source"] == "count"
    fresh = _dense()
    assert aot.warm_fit(fresh, (x, y), 8) == 1 and fresh.opt_state is None


def test_warm_fit_of_a_graph_never_trains():
    jg = _jgraph()
    cg = ComputationGraph(ComputationGraphConfiguration.from_json(jg.to_json()),
                          device="cpu").init()
    rs = np.random.RandomState(2)
    a, b = rs.rand(10, 3).astype(np.float32), rs.rand(10, 5).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rs.randint(0, 2, 10)]
    before = (_leaves(cg.params), cg._gen.get_state().clone())
    assert aot.warm_fit(cg, ((a, b), y), 4) == 1
    assert _equal(_leaves(cg.params), before[0]) and cg.opt_state is None
    assert torch.equal(cg._gen.get_state(), before[1]) and cg.iteration == 0
    assert "b4" in obs.cost_report()["sites"]["cg.step"]
    assert aot.warm_serving(cg, 4) == 3


def test_the_aot_env_warms_fit_without_changing_it(monkeypatch):
    x, y = _data(20)
    plain = _dense(dropout=0.3)
    plain.fit((x, y), epochs=2, batch_size=8)
    monkeypatch.setenv("DL4J_TPU_AOT", "1")
    warmed = _dense(dropout=0.3)
    warmed.fit((x, y), epochs=2, batch_size=8)
    assert _equal(_leaves(warmed.params), _leaves(plain.params))
    assert warmed._get_step_fn().compiled_count == 1
    assert "b8" in obs.cost_report()["sites"]["mln.step"]


def test_warm_dp_never_trains():
    from deeplearning4j_tpu_torch.parallel.grads import DataParallelStep
    from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    m = _dense()
    runner = DataParallelStep(m, make_mesh(MeshSpec(), device="cpu"))
    x, y = _data(8)
    before = _leaves(m.params)
    assert aot.warm_dp(runner, x, y) == 1
    assert _equal(_leaves(m.params), before) and m.iteration == 0
    assert aot.warm_dp(runner, x, y) == 0
    runner.fit_batch(x, y, None, None)
    assert m.iteration == 1 and not _equal(_leaves(m.params), before)
    # the warmed signature is the step's: one compile at the runner's site
    assert bucketing.telemetry().compiles("dp.step") == 1


def test_a_warm_restores_the_updater_state_into_its_own_tensors():
    m = _dense()
    x, y = _data(16)
    m.fit((x, y), epochs=1, batch_size=8)            # the updater state exists now
    held = tree_leaves(m.opt_state)
    values = _leaves(held)
    assert held and aot.warm_fit(m, (x[:4], y[:4]), 4) == 1
    assert all(a is b for a, b in zip(tree_leaves(m.opt_state), held))
    assert _equal(held, values)


# -- bundles ----------------------------------------------------------------------------

def test_bundle_round_trip_restores_the_warmed_set_and_costs(tmp_path, bundles):
    m = _dense()
    aot.warm_serving(m, 8)
    x, y = _data(20)
    m.fit((x, y), epochs=1, batch_size=8)             # mln.step seen lazily
    m.output(np.zeros((3, 6), np.float32)[:, None, :].reshape(3, 6))
    costs = obs.cost_report()["sites"]["mln.output"]
    info = aot.save_bundle(m, tmp_path / "m.aotbundle")
    n_sigs = len(m._get_output_fn().signatures()) + len(m._get_step_fn().signatures())
    assert info["entries"] == n_sigs and info["bytes"] > 0
    with zipfile.ZipFile(tmp_path / "m.aotbundle") as zf:
        names = zf.namelist()
        manifest = json.loads(zf.read("manifest.json"))
    assert names[0] == "manifest.json" and all(n.endswith(".json") for n in names)
    assert manifest["format_version"] == aot.BUNDLE_FORMAT_VERSION == jaot.BUNDLE_FORMAT_VERSION
    assert manifest["model_signature"] == aot.model_signature(m)
    obs.reset()
    r = _dense(seed=4)                                  # another seed: same program
    assert aot.restore_bundle(r, tmp_path / "m.aotbundle") == n_sigs
    assert sorted(map(json.dumps, r._get_output_fn().signatures())) == sorted(
        map(json.dumps, m._get_output_fn().signatures()))
    assert r._get_output_fn().compiled_count == 4      # replayed, priced by the bundle
    assert r._get_step_fn().signatures() == m._get_step_fn().signatures()
    assert r.iteration == 0 and r.opt_state is None     # a training site is not replayed
    got = obs.cost_report()["sites"]["mln.output"]
    assert {k: v["flops"] for k, v in got.items()} == {k: v["flops"] for k, v in costs.items()}
    assert aot.warm_serving(r, 8) == 4                  # nothing left to warm


@pytest.mark.parametrize("fault", ["crc", "signature", "format", "version", "backend",
                                   "garbage"])
def test_corrupt_or_mismatched_bundles_are_rejected(tmp_path, bundles, fault):
    m = _dense()
    aot.warm_serving(m, 2)
    path = tmp_path / "m.aotbundle"
    aot.save_bundle(m, path)
    with zipfile.ZipFile(path) as zf:
        files = {n: zf.read(n) for n in zf.namelist()}
    manifest = json.loads(files["manifest.json"])
    reason = {"crc": "crc_mismatch", "signature": "model_signature",
              "format": "format_version", "version": "version_mismatch",
              "backend": "backend_mismatch", "garbage": "load_error"}[fault]
    if fault == "crc":
        name = manifest["entries"][0]["name"]
        files[name] = files[name].replace(b"mln.output", b"mln.outpuX")
    elif fault == "signature":
        manifest["model_signature"] = "0" * 64
    elif fault == "format":
        manifest["format_version"] = 1
    elif fault == "version":
        manifest["torch_version"] = "0.0.1"
    elif fault == "backend":
        manifest["backend"] = "cuda"
    files["manifest.json"] = json.dumps(manifest).encode()
    if fault == "garbage":
        path.write_bytes(b"not a zip")
    else:
        with zipfile.ZipFile(path, "w") as zf:
            for n, b in files.items():
                zf.writestr(n, b)
    r = _dense()
    events0 = obs.event_log().counts().get("aot_bundle_rejected", 0)
    assert aot.restore_bundle(r, path) == 0
    assert _rejected(reason) == 1
    assert obs.event_log().counts().get("aot_bundle_rejected", 0) == events0 + 1
    assert r._get_output_fn().compiled_count == 0
    assert aot.warm_serving(r, 2) == 2                  # the ladder warms it instead


def test_bundles_are_gated_off_on_the_cpu_by_default(tmp_path):
    m = _dense()
    aot.warm_serving(m, 2)
    assert aot.save_bundle(m, tmp_path / "m.aotbundle") is None
    assert not (tmp_path / "m.aotbundle").exists()
    (tmp_path / "x.aotbundle").write_bytes(b"whatever")
    assert aot.restore_bundle(m, tmp_path / "x.aotbundle") == 0
    assert _rejected("persistence_disabled") == 1
    assert aot.restore_bundle(m, tmp_path / "missing.aotbundle") == 0


def _jax_bundle(path):
    jm = JNetwork(_jdense()).init()
    jaot.warm_serving(jm, 4)
    assert jaot.save_bundle(jm, str(path)) is not None


def test_a_jax_bundle_is_rejected_without_unpickling(tmp_path, bundles, monkeypatch):
    monkeypatch.setattr(jaot, "persistence_allowed", lambda *a, **k: True)
    path = tmp_path / "jax.aotbundle"
    _jax_bundle(path)
    calls = []
    monkeypatch.setattr(pickle, "loads", lambda *a, **k: calls.append(a) or None)
    monkeypatch.setattr(pickle, "load", lambda *a, **k: calls.append(a) or None)
    m = _dense()
    assert aot.restore_bundle(m, path) == 0
    assert _rejected("version_mismatch") == 1
    # the same pickled entries under the port's own fingerprint still read as
    # JSON only: a load error, never an unpickle
    with zipfile.ZipFile(path) as zf:
        files = {n: zf.read(n) for n in zf.namelist()}
    manifest = json.loads(files["manifest.json"])
    manifest.update(aot.toolchain_fingerprint("cpu"), model_signature=aot.model_signature(m))
    files["manifest.json"] = json.dumps(manifest).encode()
    forged = tmp_path / "forged.aotbundle"
    with zipfile.ZipFile(forged, "w") as zf:
        for n, b in files.items():
            zf.writestr(n, b)
    assert aot.restore_bundle(m, forged) == 0
    assert _rejected("load_error") == 1 and calls == []
    assert m._get_output_fn().compiled_count == 0


def test_the_jax_package_rejects_a_port_bundle_without_raising(tmp_path, bundles,
                                                               monkeypatch):
    from deeplearning4j_tpu import obs as jobs

    monkeypatch.setattr(jaot, "persistence_allowed", lambda *a, **k: True)
    m = _dense()
    aot.warm_serving(m, 4)
    path = tmp_path / "port.aotbundle"
    assert aot.save_bundle(m, path) is not None
    jm = JNetwork(_jdense()).init()
    counter = jobs.counter("dl4j_aot_bundle_rejected_total", "", ("reason",))
    before = counter.value(reason="version_mismatch")
    assert jaot.restore_bundle(jm, str(path)) == 0
    assert counter.value(reason="version_mismatch") == before + 1


def test_checkpoints_carry_and_resume_restores_the_sidecar(tmp_path, bundles):
    conf = zoo.TextGenerationLSTM(hidden=128, timesteps=8)
    rs = np.random.RandomState(3)
    ids = rs.randint(0, 77, (8, 16))
    eye = np.eye(77, dtype=np.float32)
    data = (eye[ids], eye[np.roll(ids, -1, axis=1)])
    a = MultiLayerNetwork(conf, device="cpu").init()
    sa = CollectScoresListener()
    a.set_listeners(sa).fit(data, epochs=2, batch_size=4)
    ck = tmp_path / "ck"
    m = MultiLayerNetwork(conf, device="cpu").init()
    m.set_listeners(CheckpointListener(str(ck), save_every_n_iterations=1, keep_last=1))
    m.fit(data, epochs=1, batch_size=4)
    sidecars = sorted(p.name for p in ck.glob("*.aotbundle"))
    # keep_last=1: the pruned checkpoints took their sidecars along
    assert sidecars == [z.name + ".aotbundle" for z in ck.glob("*.zip")]
    r = MultiLayerNetwork(conf, device="cpu").init()
    sr = CollectScoresListener()
    restored0 = obs.event_log().counts().get("aot_bundle_restored", 0)
    r.set_listeners(sr).fit(data, epochs=2, batch_size=4, resume_from=str(ck))
    assert obs.event_log().counts().get("aot_bundle_restored", 0) == restored0 + 1
    assert r._get_tbptt_fn().signatures() == m._get_tbptt_fn().signatures()
    assert sr.scores == sa.scores[-len(sr.scores):]
    assert _equal(_leaves(r.params), _leaves(a.params))


def test_save_checkpoint_returns_the_bundle_info(tmp_path, bundles):
    from deeplearning4j_tpu_torch.train import resilience

    m = _dense()
    aot.warm_serving(m, 2)
    info = resilience.save_checkpoint(m, str(tmp_path / "c.zip"))
    assert info["aot_bundle"]["entries"] == 2
    assert os.path.exists(aot.bundle_path_for(tmp_path / "c.zip"))


def test_distributed_bundles_fall_back_to_a_peer(tmp_path, bundles):
    m = _dense()
    aot.warm_serving(m, 4)
    base = tmp_path / "ckpt_00000004"
    for r in (0, 1):
        info = aot.save_distributed_bundle(m, base, r)
        assert info["manifest"]["rank"] == r
    man = aot.distributed_bundle_manifest(base)
    assert sorted(man) == [0, 1] and man[0]["model_signature"] == aot.model_signature(m)
    assert aot.distributed_bundle_path(base, 1).endswith("ckpt_00000004_r1.aotbundle")
    p1 = aot.distributed_bundle_path(base, 1)
    with open(p1, "r+b") as f:                       # rank 1's own bundle corrupt
        f.seek(40)
        f.write(b"\xff\xff\xff\xff")
    r = _dense()
    served0 = obs.event_log().counts().get("aot_bundle_served_by_peer", 0)
    assert aot.restore_distributed_bundle(r, base, 1) == 3
    assert obs.event_log().counts().get("aot_bundle_served_by_peer", 0) == served0 + 1
    assert _rejected("crc_mismatch") == 1
    assert aot.restore_distributed_bundle(_dense(), tmp_path / "none", 0) == 0


# -- the registry's bundle= ----------------------------------------------------------

def _cfg():
    return ServeConfig(max_batch=4, workers=1, max_wait_s=0.01)


def test_register_and_load_take_a_bundle(tmp_path, bundles):
    from deeplearning4j_tpu_torch.modelimport import export_dl4j_zip

    m = _dense()
    bundle = str(tmp_path / "m.aotbundle")
    reg = ModelRegistry(config=_cfg(), device="cpu")
    try:
        reg.register("m", m, bundle=bundle)
        row = reg.describe()[0]
        assert (row["restored"], row["warmed"], row["bundle"]) == (0, 3, bundle)
        assert os.path.exists(bundle)
        reg.register("m2", _dense(seed=9), bundle=bundle)
        row = [r for r in reg.describe() if r["model"] == "m2"][0]
        assert (row["restored"], row["warmed"]) == (3, 3)
        zpath = str(tmp_path / "m.zip")
        export_dl4j_zip(m, zpath)
        reg.load("m3", zpath)                          # default sidecar: <zip>.aotbundle
        assert os.path.exists(zpath + ".aotbundle")
        reg.load("m4", zpath)
        row = [r for r in reg.describe() if r["model"] == "m4"][0]
        assert row["restored"] == 3 and row["source"] == zpath
        x, _ = _data(2)
        np.testing.assert_array_equal(reg.worker("m4").submit(x), reg.worker("m").submit(x))
    finally:
        reg.shutdown()


def test_register_generate_takes_a_bundle(tmp_path, bundles):
    lm = MultiLayerNetwork(zoo.TransformerLM(vocab_size=64, max_len=32, d_model=16,
                                             n_heads=2, n_blocks=1), device="cpu").init()
    cfg = GenerateConfig(kv_page_tokens=8, decode_batch_max=2, prefill_chunk=8)
    bundle = str(tmp_path / "lm.aotbundle")
    reg = ModelRegistry(config=_cfg(), device="cpu")
    try:
        gw = reg.register_generate("lm", lm, bundle=bundle, config=cfg, capacity=32)
        grid = len(gw.program.signature_grid())
        row = reg.describe()[0]
        assert row["restored"] == 0 and row["warmed"] == grid and os.path.exists(bundle)
        lm2 = MultiLayerNetwork(lm.conf, device="cpu").init()
        reg.register_generate("lm2", lm2, bundle=bundle, config=cfg, capacity=32)
        row = [r for r in reg.describe() if r["model"] == "lm2"][0]
        assert row["restored"] == grid
        assert aot.grid_site(lm2, "decode.step").compiled_count == grid
        toks = list(reg.generator("lm2").submit([3, 4, 5], max_new=4, timeout_s=60))
        assert len(toks) == 4
    finally:
        reg.shutdown()


def test_register_index_takes_a_bundle(tmp_path, bundles):
    from deeplearning4j_tpu_torch.search.index import IndexConfig, VectorIndex

    v = np.random.RandomState(4).rand(200, 8).astype(np.float32)
    ix = VectorIndex.build(v, IndexConfig(dim=8, nlist=4, batch_max=2), device="cpu")
    bundle = str(tmp_path / "ix.aotbundle")
    reg = ModelRegistry(config=_cfg(), device="cpu")
    try:
        reg.register_index("ix", ix, bundle=bundle)
        row = reg.describe()[0]
        assert row["restored"] == 0 and row["warmed"] > 0 and os.path.exists(bundle)
        ix2 = VectorIndex.build(v, IndexConfig(dim=8, nlist=4, batch_max=2), device="cpu")
        reg.register_index("ix2", ix2, bundle=bundle)
        row = [r for r in reg.describe() if r["model"] == "ix2"][0]
        assert row["restored"] == row["warmed"]
        other = VectorIndex.build(v[:100], IndexConfig(dim=8, batch_max=2, ivf=False),
                                  device="cpu")
        reg.register_index("ix3", other, bundle=bundle)   # another layout: rejected
        row = [r for r in reg.describe() if r["model"] == "ix3"][0]
        assert row["restored"] == 0 and _rejected("model_signature") == 1
    finally:
        reg.shutdown()


# -- the kernel-library cache ---------------------------------------------------------

def test_the_compile_cache_moves_the_build_dir_and_checks_stamps(tmp_path, monkeypatch):
    from deeplearning4j_tpu_torch.utils import compile_cache

    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(_build, "VERIFY_STAMPS", False)
    monkeypatch.setattr(_build, "_ENV_READ", False)
    monkeypatch.setattr(_build, "NVCC_RUNS", [])

    def no_nvcc():
        raise RuntimeError("nvcc not found (test)")

    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    cache = tmp_path / "cache"
    monkeypatch.setenv("DL4J_TPU_COMPILE_CACHE", str(cache))
    digest = _build.source_digest("flash_fwd")
    lib = cache / f"libflash_fwd-{digest}.so"
    cache.mkdir()
    lib.write_bytes(b"a library built from these sources")
    lib.with_suffix(".stamp").write_text(json.dumps(
        {"digest": digest, "sha256": _build._file_sha256(lib)}))
    assert _build.build("flash_fwd") == lib               # loaded, no nvcc
    assert _build.BUILD_DIR == cache and _build.VERIFY_STAMPS and _build.NVCC_RUNS == []
    lib.write_bytes(b"tampered")                          # the stamp no longer matches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("flash_fwd")
    assert _build.NVCC_RUNS == []                         # never reached nvcc itself
    assert compile_cache.enable_compilation_cache_from_env() == str(cache)
    monkeypatch.delenv("DL4J_TPU_COMPILE_CACHE")
    assert compile_cache.enable_compilation_cache_from_env() is None
    other = tmp_path / "other"
    assert compile_cache.enable_compilation_cache(str(other)) == str(other)
    assert other.is_dir() and _build.BUILD_DIR == other
