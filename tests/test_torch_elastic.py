"""The port's elastic runtime (``parallel/elastic.py``,
``train/elastic.py``, the distributed half of ``train/resilience.py``)
against the JAX package, in process on the CPU.

- the unit tests of tests/test_elastic.py on the port's classes: the
  store's CRC frame and exclusive create (and its O_EXCL fallback), lease
  expiry and incarnations, views, bootstrap and shrink, the suspended
  heartbeat, the chaos grammar of the four distributed faults (held to the
  JAX injector's parse and targeting), checkpoint I/O retries and the
  distributed checkpoint loader's manifest fallback and dropped shard;
- ``mirror_ranks`` equal to the JAX function over a grid of (t, W, R,
  racks);
- parity at world 1: the same configuration in both packages, the JAX
  package's initial params copied into the port (``interop``), each
  package's ``ElasticTrainer`` at world 1 with 2 vshards on a FileStore
  for 2 epochs, compression off and on, for the CLI's MLP and a tiny
  GravesLSTM char-RNN (the plain LSTM on the CPU). Losses and final
  params are held at rtol 1e-5 / atol 1e-6 (f32: the two packages' f32
  kernels sum in other orders);
- the distributed checkpoints those runs write load through the other
  package's ``load_distributed_checkpoint``, with the fallback and the
  dropped shard.
"""

import os
import threading
import time
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JNetwork
from deeplearning4j_tpu.train import elastic as jtrain_elastic
from deeplearning4j_tpu.train import resilience as jresilience
from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.interop import params_from_numpy
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration, MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel.elastic import (
    ElasticRuntime, FileStore, Membership, MembershipChanged, View)
from deeplearning4j_tpu_torch.train import elastic as telastic
from deeplearning4j_tpu_torch.train import resilience
from deeplearning4j_tpu_torch.train.resilience import ChaosInjector

PARITY = dict(rtol=1e-5, atol=1e-6)   # f32, two packages' kernels


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith("DL4J_TPU_"):
            monkeypatch.delenv(k)


# -- membership runtime units ---------------------------------------------------

def test_filestore_crc_framing(tmp_path):
    store = FileStore(tmp_path)
    store.set("a/b", b"payload")
    assert store.get("a/b") == b"payload"
    assert store.get("missing") is None
    path = store._path("a/b")
    data = bytearray(open(path, "rb").read())
    data[-1] ^= 0x40
    open(path, "wb").write(bytes(data))
    assert store.get("a/b") is None


def test_filestore_exclusive_create(tmp_path):
    store = FileStore(tmp_path)
    assert store.set_exclusive("gen/1", b"first") is True
    assert store.set_exclusive("gen/1", b"second") is False
    assert store.get("gen/1") == b"first"


def test_set_exclusive_o_excl_fallback(tmp_path, monkeypatch):
    import deeplearning4j_tpu_torch.parallel.elastic as pe

    def no_link(src, dst):
        raise OSError(38, "Function not implemented")

    monkeypatch.setattr(os, "link", no_link)
    monkeypatch.setattr(pe, "_LINK_FALLBACK_WARNED", False)
    store = FileStore(tmp_path)
    with pytest.warns(RuntimeWarning, match="os.link unsupported"):
        assert store.set_exclusive("view/00000001", b"winner")
    assert not store.set_exclusive("view/00000001", b"loser")
    assert store.get("view/00000001") == b"winner"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert store.set_exclusive("view/00000002", b"x")


def test_lease_expiry_and_incarnation(tmp_path):
    store = FileStore(tmp_path)
    m = Membership(store, "w0", ttl=0.2, poll=0.05)
    m.join()
    try:
        inc1 = m.incarnation
        assert "w0" in m.live()
        m.suspend(10.0)
        deadline = time.monotonic() + 5.0
        while "w0" in m.live():
            assert time.monotonic() < deadline, "lease never expired"
            time.sleep(0.05)
        assert m.expired("w0")
    finally:
        m.leave()
    m2 = Membership(store, "w0", ttl=0.2, poll=0.05)
    m2.join()
    try:
        assert m2.incarnation != inc1
    finally:
        m2.leave()


def test_membership_suspend_blocks_renewal(tmp_path):
    store = FileStore(tmp_path)
    m = Membership(store, "w", ttl=0.4, poll=0.02)
    m.join()
    try:
        m.suspend(30.0)
        ts0 = m.lease("w")["ts"]
        time.sleep(0.6)
        lease = m.lease("w")
        assert lease["ts"] == ts0, "heartbeat renewed a suspended lease"
        assert not m._fresh(lease)
        m.heartbeat_now()
        assert m._fresh(m.lease("w"))
    finally:
        m.leave()
    assert m._thread is None


def test_view_holders_require_matching_incarnations():
    v = View(gen=3, members=("w0", "w1"), prev_members=("w0", "w1"),
             epoch=1, step=2, iteration=5, reason="grow", rejoined=(),
             incs={"w0": "a.1", "w1": "b.2"},
             prev_incs={"w0": "a.1", "w1": "b.STALE"})
    assert v.holders() == ("w0",)
    assert v.rank_of("w1") == 1
    assert View.from_json(v.to_json()) == v
    from deeplearning4j_tpu.parallel.elastic import View as JView

    assert JView.from_json(v.to_json()).to_json() == v.to_json()


def test_runtime_bootstrap_and_shrink(tmp_path):
    store = FileStore(tmp_path)
    a = ElasticRuntime(store, "a", ttl=0.3, poll=0.02)
    b = ElasticRuntime(store, "b", ttl=0.3, poll=0.02)
    try:
        views = {}
        tb = threading.Thread(target=lambda: views.setdefault("b", b.bootstrap(2, timeout=10)))
        tb.start()
        va = a.bootstrap(2, timeout=10)
        tb.join(timeout=10)
        assert va.members == ("a", "b") and va.gen == views["b"].gen
        b.membership.suspend(30.0)
        deadline = time.monotonic() + 5.0
        while True:
            try:
                a.poll_boundary((0, 0, 0))
                assert time.monotonic() < deadline, "shrink never proposed"
                time.sleep(0.05)
            except MembershipChanged as mc:
                assert mc.view.members == ("a",) and mc.view.reason == "shrink"
                break
    finally:
        a.leave()
        b.leave()


# -- chaos grammar: the four distributed faults, as the JAX package's -------------

SPECS = ["host_kill@iter:3:rank1,net_partition@iter:2:rank0:1.5",
         "slice_kill@iter:3:slice1,rack_partition@iter:2:rackA:1.5",
         "slow_iter@iter:4:rank0:2.5,host_kill@iter:1",
         "rack_partition@iter:0:1.25,net_partition@iter:0"]


@pytest.mark.parametrize("spec", SPECS)
def test_chaos_parse_matches_jax(spec):
    got, want = ChaosInjector.parse(spec), jresilience.ChaosInjector.parse(spec)
    assert [(f.kind, f.at_iter, f.at_ckpt, f.arg) for f in got.faults] == \
        [(f.kind, f.at_iter, f.at_ckpt, f.arg) for f in want.faults]


@pytest.mark.parametrize("arg", ["rank1:4.0", "rank2", "3.5", None, "slice2", "slice1:x",
                                 "rackB:1.0"])
def test_chaos_arg_splitters_match_jax(arg):
    J = jresilience.ChaosInjector
    assert ChaosInjector._rank_arg(arg) == J._rank_arg(arg)
    assert ChaosInjector._prefixed_arg(arg, "slice") == J._prefixed_arg(arg, "slice")


def test_chaos_targets_as_jax():
    """partition_seconds / rack_partition_seconds over iterations, ranks
    and racks, on fresh injectors of both packages: the same firing
    sequence (one-shot, targeted, default durations)."""
    def trace(mod):
        out = []
        inj = mod.ChaosInjector.parse("net_partition@iter:2:rank1:0.75")
        out += [inj.partition_seconds(it, rank=r) for it, r in
                ((1, 1), (2, 0), (2, 1), (3, 1))]
        inj = mod.ChaosInjector.parse("net_partition@iter:0")
        out.append(inj.partition_seconds(0, rank=4))
        inj = mod.ChaosInjector.parse("rack_partition@iter:2:rackB:0.75")
        out += [inj.rack_partition_seconds(it, rack=k) for it, k in
                ((1, "rackB"), (2, "rackA"), (2, "rackB"), (3, "rackB"))]
        out.append(mod.ChaosInjector.parse("rack_partition@iter:0:1.25")
                   .rack_partition_seconds(0, rack="anything"))
        out.append(mod.ChaosInjector.parse("rack_partition@iter:0")
                   .rack_partition_seconds(0, rack="r"))
        # host_kill and slice_kill aimed elsewhere never fire (a hit would SIGKILL)
        inj = mod.ChaosInjector.parse("host_kill@iter:3:rank1,slice_kill@iter:3:slice1")
        for it in range(6):
            inj.maybe_host_kill(it, rank=0)
            inj.maybe_slice_kill(it, slice_index=0)
        out.append([f.fired for f in inj.faults])
        return out

    assert trace(resilience) == trace(jresilience) == [
        0.0, 0.0, 0.75, 0.0, 5.0, 0.0, 0.0, 0.75, 0.0, 1.25, 5.0, [False, False]]


def test_chaos_slow_iter_targets_rank(monkeypatch):
    slept = []
    monkeypatch.setattr(resilience.time, "sleep", slept.append)
    inj = ChaosInjector.parse("slow_iter@iter:2:rank1:0.5")
    inj.maybe_slow(2, rank=0)
    inj.maybe_slow(2)
    inj.maybe_slow(2, rank=1)
    inj.maybe_slow(2, rank=1)
    assert slept == [0.5]


def test_chaos_unknown_kind_still_rejected():
    with pytest.raises(ValueError, match="unknown kind"):
        ChaosInjector.parse("soft_kill@iter:3")


# -- mirror placement ---------------------------------------------------------------

def test_mirror_ranks_match_jax_over_a_grid():
    rack_sets = {"uniform": lambda W: [""] * W,
                 "two": lambda W: ["A" if i < W // 2 else "B" for i in range(W)],
                 "three": lambda W: ["ABC"[i % 3] for i in range(W)],
                 "short": lambda W: ["A", "B"][:min(W, 2)]}
    n = 0
    for W in range(1, 8):
        for R in range(1, 5):
            for racks in rack_sets.values():
                for t in range(W):
                    assert telastic.mirror_ranks(t, W, R, racks(W)) == \
                        jtrain_elastic.mirror_ranks(t, W, R, racks(W))
                    n += 1
    assert n == 448 and telastic.mirror_ranks(0, 4, 2, [""] * 4) == [3]


# -- checkpoint I/O ---------------------------------------------------------------

def test_io_with_retries_backoff_and_counter(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_CKPT_RETRIES", "3")
    monkeypatch.setenv("DL4J_TPU_CKPT_RETRY_BASE_S", "0.0")
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return "ok"

    before = obs.counter("dl4j_ckpt_retries_total", "").value()
    assert resilience.io_with_retries(flaky, what="unit") == "ok"
    assert calls["n"] == 3
    assert obs.counter("dl4j_ckpt_retries_total", "").value() == before + 2


def _write_ckpt(d, tag, seed, res):
    rs = np.random.RandomState(seed)
    names = {}
    for r in range(2):
        name = f"shard_{tag}_r{r}.npz"
        res.write_bytes_durable(os.path.join(d, name),
                                telastic._pack_arrays({f"k0_t{r}": rs.rand(2, 4)}))
        names[r] = name
    pname = f"ckpt_{tag}_params.npz"
    res.write_bytes_durable(os.path.join(d, pname), telastic._pack_arrays({"p0_0": rs.rand(3)}))
    man = {"format": 1, "tag": tag, "iteration": int(tag), "epoch": 0, "step": 0,
           "world": 2, "members": ["w0", "w1"], "vshards": 2,
           "params": {"file": pname, "crc": res.crc32_file(os.path.join(d, pname)),
                      "size": os.path.getsize(os.path.join(d, pname))},
           "shards": {str(r): {"file": names[r],
                               "crc": res.crc32_file(os.path.join(d, names[r])),
                               "size": os.path.getsize(os.path.join(d, names[r])),
                               "rank": r, "wid": f"w{r}"} for r in range(2)}}
    res.write_json_durable(os.path.join(d, f"manifest_{tag}.json"), man)


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("reader", ["port", "jax"])
def test_load_distributed_checkpoint_manifest_fallback(writer, reader, tmp_path):
    """A manifest whose params file fails CRC falls back to the next-older
    manifest; a corrupt shard inside a valid manifest is dropped alone —
    for either package's writer and loader."""
    d = str(tmp_path)
    wres = resilience if writer == "port" else jresilience
    load = (resilience if reader == "port" else jresilience).load_distributed_checkpoint
    _write_ckpt(d, "00000002", 1, wres)
    _write_ckpt(d, "00000004", 2, wres)
    got = load(d)
    assert got["manifest"]["tag"] == "00000004" and sorted(got["shards"]) == [0, 1]
    rs = np.random.RandomState(2)
    want = [rs.rand(2, 4), rs.rand(2, 4), rs.rand(3)]
    np.testing.assert_array_equal(got["shards"][0]["k0_t0"], want[0])
    np.testing.assert_array_equal(got["shards"][1]["k0_t1"], want[1])
    np.testing.assert_array_equal(got["params"]["p0_0"], want[2])
    resilience.corrupt_file(os.path.join(d, "shard_00000004_r1.npz"))
    got = load(d)
    assert got["manifest"]["tag"] == "00000004" and sorted(got["shards"]) == [0]
    resilience.corrupt_file(os.path.join(d, "ckpt_00000004_params.npz"))
    assert load(d)["manifest"]["tag"] == "00000002"
    resilience.corrupt_file(os.path.join(d, "ckpt_00000002_params.npz"))
    assert load(d) is None


# -- refusals -------------------------------------------------------------------------

def _mlp_conf():
    from deeplearning4j_tpu_torch.nn.input_type import InputType
    from deeplearning4j_tpu_torch.nn.layers import Dense, OutputLayer

    return MultiLayerConfiguration(
        layers=(Dense(n_out=8, activation="tanh"), OutputLayer(n_out=3, activation="softmax")),
        input_type=InputType.feed_forward(4), updater={"type": "adam", "lr": 5e-3}, seed=7)


def test_slice_spec_of_two_ranks_outside_its_slice_group_raises(tmp_path):
    """A member of 2 ranks needs a process group of exactly its 2 ranks (the
    launcher's ``--slice-devices 2`` forms one); a spec of one rank needs
    none (elastic-of-slices: tests/test_torch_elastic_slices.py)."""
    model = MultiLayerNetwork(_mlp_conf(), device="cpu").init()
    with pytest.raises(ValueError, match="needs a process group of exactly those ranks"):
        telastic.ElasticTrainer(model, str(tmp_path), "w0", slice_spec="2")
    tr = telastic.ElasticTrainer(model, str(tmp_path), "w0", slice_spec="1,1")
    tr.close()


def test_worker_without_device_needs_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    args = telastic.parse_args(["worker", "--store", str(tmp_path / "s"),
                                "--outdir", str(tmp_path / "o"), "--id", "w0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        telastic.run_worker(args)


# -- parity with the JAX ElasticTrainer at world 1 ----------------------------------

def _charrnn_data(rows, T, V, seed):
    ids = np.random.RandomState(seed).randint(0, V, (rows, T + 1))
    eye = np.eye(V, dtype=np.float32)
    return eye[ids[:, :-1]], eye[ids[:, 1:]]


def _case(name):
    if name == "mlp":
        a = SimpleNamespace(features=4, hidden="8", classes=3, lr=5e-3, seed=7, n=24)
        jmodel = jtrain_elastic._build_model(a)
        model = telastic._build_model(SimpleNamespace(device="cpu", **vars(a)))
        x, y = telastic._make_data(a)
        return jmodel, model, x, y, 8
    kw = dict(vocab_size=11, timesteps=6, hidden=8, updater={"type": "rmsprop", "lr": 1e-2})
    jmodel = JNetwork(jzoo.TextGenerationLSTM(**kw)).init()
    model = MultiLayerNetwork(zoo.TextGenerationLSTM(**kw), device="cpu").init()
    x, y = _charrnn_data(12, 6, 11, 3)
    return jmodel, model, x, y, 6


@pytest.fixture(scope="module")
def parity_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("elastic_parity")
    out = {}
    for name in ("mlp", "lstm"):
        for compress in (False, True):
            jmodel, model, x, y, bs = _case(name)
            params_from_numpy(model, jax.tree_util.tree_map(np.asarray, jmodel.params))
            runs = {}
            for pkg, m, mod in (("jax", jmodel, jtrain_elastic), ("port", model, telastic)):
                tag = f"{name}_{int(compress)}_{pkg}"
                tr = mod.ElasticTrainer(m, str(root / tag / "store"), "w0", world=1,
                                        vshards=2, compress=compress, ttl=5.0, poll=0.02,
                                        ckpt_dir=str(root / tag / "ckpt"), ckpt_every=3)
                try:
                    res = tr.fit(x, y, epochs=2, batch_size=bs)
                finally:
                    tr.close()
                leaves = ([np.asarray(l) for l in jax.tree_util.tree_leaves(m.params)]
                          if pkg == "jax" else
                          [l.detach().numpy() for l in telastic.tree_leaves(m.params)])
                runs[pkg] = dict(res=res, leaves=leaves, ckpt=str(root / tag / "ckpt"))
            out[(name, compress)] = runs
    return out


@pytest.mark.parametrize("name", ["mlp", "lstm"])
@pytest.mark.parametrize("compress", [False, True], ids=["dense", "compressed"])
def test_world1_matches_jax_elastic_trainer(parity_runs, name, compress):
    runs = parity_runs[(name, compress)]
    j, p = runs["jax"], runs["port"]
    assert p["res"]["iteration"] == j["res"]["iteration"] > 0
    assert p["res"]["world"] == j["res"]["world"] == 1
    np.testing.assert_allclose(p["res"]["losses"], j["res"]["losses"], **PARITY)
    assert len(p["leaves"]) == len(j["leaves"])
    for a, b in zip(p["leaves"], j["leaves"]):
        np.testing.assert_allclose(a, b, **PARITY)


@pytest.mark.parametrize("name", ["mlp", "lstm"])
def test_trainers_checkpoints_load_in_either_package(parity_runs, name):
    """The distributed checkpoints the two trainers wrote (world 1, every 3
    iterations) load through the other package's loader with the same
    manifest fields and arrays; the port's records ``base_seed`` where the
    JAX package records its key."""
    runs = parity_runs[(name, False)]
    j = resilience.load_distributed_checkpoint(runs["jax"]["ckpt"])
    p = jresilience.load_distributed_checkpoint(runs["port"]["ckpt"])
    for k in ("tag", "iteration", "epoch", "step", "world", "members", "vshards"):
        assert j["manifest"][k] == p["manifest"][k]
    assert sorted(j["shards"]) == sorted(p["shards"]) == [0]
    assert set(j["shards"][0]) == set(p["shards"][0])
    for k, a in j["shards"][0].items():
        np.testing.assert_allclose(p["shards"][0][k], a, **PARITY)
    assert set(j["params"]) == set(p["params"])
    for k, a in j["params"].items():
        if k != "meta":
            np.testing.assert_allclose(p["params"][k], a, **PARITY)
    jm, pm = (telastic._array_to_json(c["params"]["meta"]) for c in (j, p))
    assert "base_rng" in jm and pm["base_seed"] == {"mlp": 7, "lstm": 12345}[name]
    np.testing.assert_allclose(pm["losses"], jm["losses"], **PARITY)
