"""ParallelWrapper, ShardedDataSetIterator, ParallelInference and the
trainer CLI's ``--data-parallel`` of the port against the JAX package.

4 gloo ranks (a FileStore under pytest's tmp dir, one thread each, joined
under ``RANK_TIMEOUT_S``) run the cases of tests/test_parallel.py's
``TestParallelWrapper`` and ``TestParallelWrapperGraph`` from the JAX
package's initial params, each rank passing its rows of the global batch
(the JAX package's multi-process contract): even and uneven batches (60
rows: 15 a rank, padded up the bucket ladder), rank-3 labels, BatchNorm
(params and running statistics), a two-input graph and a BatchNorm graph,
uneven rows per rank (17/15/14/14), the sharded weight update (against
the JAX package's dense wrapper: its explicit exchange takes BatchNorm's
statistics per replica, the port's takes the global batch's), Adam over
two ``fit`` calls, and the sharded output. Params are held to the JAX package's ParallelWrapper on
4 CPU devices at the JAX tests' rtol 2e-4 / atol 1e-5, and the ranks to
each other bit for bit. The CLI runs on 2 gloo ranks (torchrun's
environment variables) against the CLI without the flag.
"""

import concurrent.futures as cf
import dataclasses
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.graph import ComputationGraphConfiguration as JGraphConf
from deeplearning4j_tpu.nn.graph import MergeVertex as JMerge
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.input_type import InputType as JInputType
from deeplearning4j_tpu.nn.model import MultiLayerConfiguration as JConf
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JNetwork
from deeplearning4j_tpu.parallel import MeshSpec as JMeshSpec
from deeplearning4j_tpu.parallel import ParallelInference as JParallelInference
from deeplearning4j_tpu.parallel import ParallelWrapper as JParallelWrapper
from deeplearning4j_tpu.parallel import make_mesh as jmake_mesh
from deeplearning4j_tpu_torch.datasets import ShardedDataSetIterator
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.interop import params_from_numpy
from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration, MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import ParallelInference
from deeplearning4j_tpu_torch.parallel.launch import spawn_ranks
from deeplearning4j_tpu_torch.serve.scheduler import ShedError
from deeplearning4j_tpu_torch.utils.serialization import restore_network

REPO = Path(__file__).resolve().parent.parent
RANK_TIMEOUT_S = 150
TOL = dict(rtol=2e-4, atol=1e-5)      # the JAX tests' tolerance
SGD = {"type": "sgd", "lr": 0.1}


def _drop_knobs(mp):
    for k in list(os.environ):
        if k.startswith("DL4J_TPU_"):
            mp.delenv(k)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    _drop_knobs(monkeypatch)


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _mlp(seed, bn=False):
    layers = ((jl.Dense(n_out=16, activation="identity"), jl.BatchNorm(),
               jl.Dense(n_out=8, activation="tanh")) if bn
              else (jl.Dense(n_out=16, activation="tanh"),))
    return JConf(layers=layers + (jl.OutputLayer(n_out=2, activation="softmax"),),
                 input_type=JInputType.feed_forward(4), updater=SGD, seed=seed)


def _rnn():
    return JConf(layers=(jl.SimpleRnn(n_out=8, activation="tanh"),
                         jl.RnnOutputLayer(n_out=3, activation="softmax")),
                 input_type=JInputType.recurrent(4), updater=SGD, seed=7)


def _graph(bn):
    b = JGraphConf.builder()
    if bn:
        return (b.add_inputs("in").set_input_types(JInputType.feed_forward(4))
                .add_layer("d1", jl.Dense(n_out=16, activation="identity"), "in")
                .add_layer("bn", jl.BatchNorm(), "d1")
                .add_layer("d2", jl.Dense(n_out=8, activation="tanh"), "bn")
                .add_layer("out", jl.OutputLayer(n_out=2, activation="softmax"), "d2")
                .set_outputs("out").updater(SGD).seed(13).build())
    return (b.add_inputs("a", "b")
            .set_input_types(JInputType.feed_forward(4), JInputType.feed_forward(4))
            .add_layer("da", jl.Dense(n_out=8, activation="tanh"), "a")
            .add_layer("db", jl.Dense(n_out=8, activation="tanh"), "b")
            .add_vertex("m", JMerge(), "da", "db")
            .add_layer("out", jl.OutputLayer(n_out=2, activation="softmax"), "m")
            .set_outputs("out").updater({"type": "adam", "lr": 0.05}).build())


def _adam(conf):
    return dataclasses.replace(conf, updater={"type": "adam", "lr": 0.01})


def _data(n, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 4).astype(np.float32)
    return x, np.eye(2, dtype=np.float32)[(x.sum(axis=1) > 0).astype(int)]


def _cases():
    """name -> (JAX conf, graph?, global data, epochs, rows per rank or None,
    wrapper kwargs)."""
    rs = np.random.RandomState(1)
    xr = rs.randn(20, 6, 4).astype(np.float32)
    yr = np.eye(3, dtype=np.float32)[rs.randint(0, 3, (20, 6))]
    rs = np.random.RandomState(0)
    xa, xb = rs.randn(60, 4).astype(np.float32), rs.randn(60, 4).astype(np.float32)
    yg = np.eye(2, dtype=np.float32)[((xa + xb).sum(1) > 0).astype(int)]
    return {
        "even": (_mlp(5), False, _data(64), 5, None, {}),
        "uneven": (_mlp(5), False, _data(60), 5, None, {}),
        "rnn": (_rnn(), False, (xr, yr), 3, None, {}),
        "bn": (_mlp(11, bn=True), False, _data(60), 4, None, {}),
        "graph": (_graph(False), True, ((xa, xb), yg), 5, None, {}),
        "graph_bn": (_graph(True), True, _data(60), 4, None, {}),
        "ranks_uneven": (_mlp(5), False, _data(60), 5, [17, 15, 14, 14], {}),
        "sharded": (_mlp(11, bn=True), False, _data(60), 4, None, {"sharded_update": True}),
        # fit called twice: the updater state must carry from one call to the next
        "adam_refit": (_adam(_mlp(5)), False, _data(64), 2, None, {"_calls": 2}),
        "adam_refit_sharded": (_adam(_mlp(5)), False, _data(64), 2, None,
                               {"_calls": 2, "sharded_update": True}),
    }


# -- gloo ranks ----------------------------------------------------------------

WORKER = r'''
import pickle, sys
import numpy as np
import torch

torch.set_num_threads(1)
rank, world, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
from deeplearning4j_tpu_torch.interop import params_from_numpy, state_from_numpy
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph, ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration, MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import ParallelWrapper, init_distributed, shutdown_distributed
from deeplearning4j_tpu_torch.utils.tree import tree_leaves

init_distributed(f"file://{root}/store", world, rank, device="cpu", timeout_s=90)
with open(f"{root}/inputs.pkl", "rb") as f:
    inp = pickle.load(f)
res = {}
for name, (conf, is_graph, params, data, epochs, split, kw) in inp.items():
    if is_graph:
        model = ComputationGraph(ComputationGraphConfiguration.from_json(conf), device="cpu").init()
        for k in model.params:
            for t, v in zip(tree_leaves(model.params[k]), tree_leaves(params[k])):
                t.copy_(torch.from_numpy(np.asarray(v)))
    else:
        model = MultiLayerNetwork(MultiLayerConfiguration.from_json(conf), device="cpu")
        params_from_numpy(model, params)
    x, y = data
    n = len(y)
    counts = split or [n // world + (r < n % world) for r in range(world)]
    lo = sum(counts[:rank])
    sl = slice(lo, lo + counts[rank])
    xs = tuple(a[sl] for a in x) if isinstance(x, tuple) else x[sl]
    calls = kw.pop("_calls", 1)
    pw = ParallelWrapper(model, **kw)
    for _ in range(calls):
        pw.fit((xs, y[sl]), epochs=epochs)
    out = pw.output(xs)
    leaves = (lambda t: [v.detach().numpy().copy() for k in sorted(t) for v in tree_leaves(t[k])]
              if is_graph else [v.detach().numpy().copy() for v in tree_leaves(t)])
    res[name] = dict(params=leaves(model.params), state=leaves(model.state),
                     output=(out[0] if isinstance(out, (tuple, list)) else out).numpy(),
                     iteration=model.iteration)
with open(f"{root}/rank{rank}.pkl", "wb") as f:
    pickle.dump(res, f)
shutdown_distributed()
'''


def _jleaves(tree, is_graph):
    if is_graph:
        return [np.asarray(v) for k in sorted(tree) for v in jax.tree_util.tree_leaves(tree[k])]
    return _leaves(tree)


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        _drop_knobs(mp)
        root = tmp_path_factory.mktemp("pw")
        inputs, jref = {}, {}
        mesh = jmake_mesh(JMeshSpec(data=4), jax.devices()[:4])
        for name, (jconf, is_graph, data, epochs, split, kw) in _cases().items():
            jm = (JGraph(jconf) if is_graph else JNetwork(jconf)).init()
            params = jax.tree_util.tree_map(np.asarray, jm.params)
            inputs[name] = (jconf.to_json(), is_graph, params, data, epochs, split, kw)
            # the JAX reference is always the dense wrapper (the single-device
            # fit): the JAX package's explicit exchange takes BatchNorm's
            # statistics per replica, the port's those of the global batch
            pw = JParallelWrapper(jm, mesh=mesh)
            for _ in range(kw.get("_calls", 1)):
                pw.fit(data, epochs=epochs)
            out = pw.output(data[0])
            jref[name] = dict(params=_jleaves(jm.params, is_graph),
                              state=_jleaves(jm.state, is_graph),
                              output=np.asarray(out[0] if isinstance(out, (tuple, list))
                                                else out), iteration=jm.iteration)
        with open(root / "inputs.pkl", "wb") as f:
            pickle.dump(inputs, f)
        env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
        spawn_ranks([sys.executable, "-c", WORKER], 4, root, RANK_TIMEOUT_S, env=env,
                    cwd=str(REPO))
        ranks = []
        for r in range(4):
            with open(root / f"rank{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
        return ranks, jref


CASES = sorted(_cases())


@pytest.mark.parametrize("name", CASES)
def test_wrapper_matches_jax(gloo_run, name):
    ranks, jref = gloo_run
    want = jref[name]
    for res in ranks:
        got = res[name]
        assert got["iteration"] == want["iteration"]
        for a, b in zip(got["params"] + got["state"], want["params"] + want["state"]):
            np.testing.assert_allclose(a.ravel(), b.ravel(), **TOL)
        assert got["output"].shape == want["output"].shape
        np.testing.assert_allclose(got["output"], want["output"], rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("name", CASES)
def test_wrapper_ranks_are_bit_equal(gloo_run, name):
    ranks, _ = gloo_run
    for res in ranks[1:]:
        for a, b in zip(ranks[0][name]["params"] + ranks[0][name]["state"],
                        res[name]["params"] + res[name]["state"]):
            np.testing.assert_array_equal(a, b)


# -- the CLI -----------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli_inputs(tmp_path):
    conf = _mlp(5)
    (tmp_path / "conf.json").write_text(conf.to_json())
    x, y = _data(64)
    np.savez(tmp_path / "d.npz", x=x, y=y)
    return tmp_path / "conf.json", tmp_path / "d.npz"


def _cli(args, env, cwd):
    return subprocess.run([sys.executable, "-m", "deeplearning4j_tpu_torch.train", *args],
                          env=env, cwd=cwd, capture_output=True, text=True, timeout=120)


def test_cli_data_parallel_on_two_gloo_ranks_equals_one_process(tmp_path):
    conf, data = _cli_inputs(tmp_path)
    base = ["--data", str(data), "--epochs", "2", "--batch-size", "16", "--device", "cpu"]
    env = {k: v for k, v in os.environ.items() if not k.startswith("DL4J_TPU_")}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    single = _cli([str(conf), *base, "--output", str(tmp_path / "one.zip")], env, str(REPO))
    assert single.returncode == 0, single.stderr[-2000:]
    port = _free_port()
    procs = []
    for r in range(2):
        e = dict(env, RANK=str(r), WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "deeplearning4j_tpu_torch.train", str(conf), *base,
             "--data-parallel", "--output", str(tmp_path / "dp.zip")],
            env=e, cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=RANK_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), outs
    a = restore_network(str(tmp_path / "one.zip"), device="cpu")
    b = restore_network(str(tmp_path / "dp.zip"), device="cpu")
    assert a.iteration == b.iteration == 8
    for pa, pb in zip(jax.tree_util.tree_leaves(a.params), jax.tree_util.tree_leaves(b.params)):
        np.testing.assert_allclose(pb.numpy(), pa.numpy(), **TOL)


def test_cli_data_parallel_world_of_one_is_bit_equal(tmp_path, capsys):
    from deeplearning4j_tpu_torch.train import __main__ as cli

    conf, data = _cli_inputs(tmp_path)
    base = [str(conf), "--data", str(data), "--batch-size", "16", "--device", "cpu",
            "--listener-frequency", "1"]
    a = cli.run(base + ["--output", str(tmp_path / "a.zip")])
    b = cli.run(base + ["--data-parallel", "--output", str(tmp_path / "b.zip")])
    for pa, pb in zip(jax.tree_util.tree_leaves(a.params), jax.tree_util.tree_leaves(b.params)):
        np.testing.assert_array_equal(pa.numpy(), pb.numpy())
    assert not torch.distributed.is_initialized()   # the CLI left the group it formed


# -- in one process ------------------------------------------------------------------

def test_sharded_iterator_deals_groups_and_drops_ragged_ones():
    xs = [np.full((4, 2), i, np.float32) for i in range(7)] + [np.zeros((3, 2), np.float32)]
    base = [DataSet(x, x) for x in xs]
    got = [[int(b.features[0, 0]) for b in ShardedDataSetIterator(base, p, 3)]
           for p in range(3)]
    assert got == [[0, 3], [1, 4], [2, 5]]      # (6, 7, tail) dropped everywhere
    assert [int(b.features[0, 0]) for b in ShardedDataSetIterator(base)] == list(range(7)) + [0]
    with pytest.raises(ValueError, match="both"):
        ShardedDataSetIterator(base, process_index=0)


def _served():
    jm = JNetwork(_mlp(3)).init()
    m = MultiLayerNetwork(MultiLayerConfiguration.from_json(_mlp(3).to_json()), device="cpu")
    params_from_numpy(m, jax.tree_util.tree_map(np.asarray, jm.params))
    return jm, m


def test_inference_inplace_matches_jax():
    jm, m = _served()
    x, _ = _data(16)
    want = np.asarray(JParallelInference(jm, mode="inplace").output(x))
    np.testing.assert_allclose(ParallelInference(m, mode="inplace").output(x), want,
                               rtol=1e-6, atol=1e-7)


def test_inference_batched_coalesces_threads():
    jm, m = _served()
    x, _ = _data(24)
    pi = ParallelInference(m, mode="batched", max_batch_size=8, warmup=True)
    assert pi.warmed == [1, 2, 4, 8]         # every bucket a coalesced batch can hit
    try:
        with cf.ThreadPoolExecutor(8) as ex:
            outs = [f.result(timeout=30) for f in
                    [ex.submit(pi.output, x[i:i + 3]) for i in range(0, 24, 3)]]
    finally:
        pi.shutdown()
    np.testing.assert_allclose(np.concatenate(outs), np.asarray(jm.output(x)),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(RuntimeError, match="shut down"):
        pi.output(x[:1])


def test_inference_sheds_an_expired_deadline_and_refuses_the_tuner(monkeypatch):
    _, m = _served()
    x, _ = _data(4)
    pi = ParallelInference(m, mode="batched", worker=False)
    pi._thread = object()          # requests queue; the test drains them
    try:
        with cf.ThreadPoolExecutor(1) as ex:
            fut = ex.submit(pi.output, x, 0.001)
            while pi._queue.empty():
                pass
            import time
            time.sleep(0.01)
            assert pi._drain() == []
            with pytest.raises(ShedError):
                fut.result(timeout=10)
    finally:
        pi._thread = None
    monkeypatch.setenv("DL4J_TPU_TUNE", "1")
    with pytest.raises(NotImplementedError, match="item 9"):
        ParallelInference(m)
