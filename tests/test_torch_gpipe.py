"""GPipe and the pipeline runner of the port (``parallel/gpipe.py``,
``parallel/pipeline.py``) against the JAX package.

In one process: ``partition_layers`` against the JAX package's.

Across processes: 4 gloo ranks (a FileStore under pytest's tmp dir, one
thread each, joined under ``RANK_TIMEOUT_S``) train the cases of
tests/test_gpipe.py that need no JAX random stream, from the JAX package's
initial params, 3 epochs of full batches with ``n_micro`` 2 or 4: the MLP
with SGD and Adam on data=2 x pipe=2 (also against the JAX package's
GPipeTrainer on 4 CPU devices), an LSTM char-RNN (the fused LSTM in every
stage), BatchNorm micro-batched on pipe=2 (seq=2 replicas) against the JAX
package's GPipeTrainer (per-micro-batch statistics, running statistics
chained), per-layer learning rates and a frozen layer, masked sequences,
gradient normalization and constraints, a token-id TransformerLM, and PP x
TP (the head column-sharded over model=2). Params of ``to_model()`` are
held to the reference at the JAX tests' rtol 2e-4 / atol 2e-5; the ranks
agree bit for bit. Dropout and weight noise draw from torch generators, so
those runs are held to the port's single-device run that micro-batches the
same way (``microbatched_reference``), bit for bit on the CPU.
``PipelineParallel`` runs a two-stage linear pipeline against the same
SGD step on one process.
"""

import dataclasses
import os
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.input_type import InputType as JInputType
from deeplearning4j_tpu.nn.model import MultiLayerConfiguration as JConf
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JNetwork
from deeplearning4j_tpu.parallel import MeshSpec as JMeshSpec
from deeplearning4j_tpu.parallel import make_mesh as jmake_mesh
from deeplearning4j_tpu.parallel.gpipe import GPipeTrainer as JGPipeTrainer
from deeplearning4j_tpu.parallel.gpipe import partition_layers as jpartition_layers
from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration
from deeplearning4j_tpu_torch.parallel.gpipe import microbatched_reference, partition_layers
from deeplearning4j_tpu_torch.parallel.launch import spawn_ranks
from deeplearning4j_tpu_torch.utils.tree import tree_leaves

REPO = Path(__file__).resolve().parent.parent
RANK_TIMEOUT_S = 150
TOL = dict(rtol=2e-4, atol=2e-5)


def _drop_knobs(mp):
    for k in list(os.environ):
        if k.startswith("DL4J_TPU_"):
            mp.delenv(k)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    _drop_knobs(monkeypatch)


@pytest.mark.parametrize("counts,n", [([100] * 4, 2), ([1000, 1, 1, 1], 3), ([5, 9, 2, 7, 1], 3),
                                      ([0, 0, 0], 2)])
def test_partition_layers_equals_jax(counts, n):
    assert partition_layers(counts, n) == jpartition_layers(counts, n)


def test_partition_refuses_more_stages_than_layers():
    with pytest.raises(ValueError):
        partition_layers([1, 2], 3)


# -- the configurations -----------------------------------------------------------

def _mlp(updater, **kw):
    dense = [jl.Dense(n_out=12, activation="tanh"), jl.Dense(n_out=10, activation="relu"),
             jl.Dense(n_out=8, activation="tanh")]
    for i, extra in kw.get("per_layer", {}).items():
        dense[i] = dataclasses.replace(dense[i], **extra)
    return JConf(layers=tuple(dense) + (jl.OutputLayer(n_out=4, activation="softmax"),),
                 input_type=JInputType.feed_forward(6), updater=updater, seed=9)


def _mlp_data(n=16):
    rs = np.random.RandomState(0)
    return (rs.rand(n, 6).astype(np.float32),
            np.eye(4, dtype=np.float32)[rs.randint(0, 4, n)])


def _bn():
    # a BatchNorm in each stage (the JAX package's stage switch needs both)
    return JConf(layers=(jl.Dense(n_out=12, activation="tanh"), jl.BatchNorm(),
                         jl.Dense(n_out=8, activation="relu"), jl.BatchNorm(),
                         jl.OutputLayer(n_out=4, activation="softmax")),
                 input_type=JInputType.feed_forward(6), updater={"type": "sgd", "lr": 0.05},
                 seed=9)


def _lstm(T=6):
    return JConf(layers=(jl.LSTM(n_out=8, activation="tanh"), jl.LSTM(n_out=8, activation="tanh"),
                         jl.RnnOutputLayer(n_out=5, activation="softmax")),
                 input_type=JInputType.recurrent(5, T), updater={"type": "adam", "lr": 0.01},
                 seed=3)


def _seq_data(B=8, T=6, masked=False):
    rs = np.random.RandomState(1)
    ids = rs.randint(0, 5, (B, T))
    x = np.eye(5, dtype=np.float32)[ids]
    y = np.eye(5, dtype=np.float32)[np.roll(ids, -1, 1)]
    if not masked:
        return (x, y)
    m = np.ones((B, T), np.float32)
    m[1, 4:] = 0
    m[5, 2:] = 0
    return (x, y, m, m)


def _noisy(kind):
    drop = (jl.DropoutLayer(dropout=0.3),) if kind == "dropout" else ()
    noise = {"weight_noise": {"type": "dropconnect", "p": 0.8}} if kind == "noise" else {}
    return JConf(layers=(jl.Dense(n_out=12, activation="tanh", **noise),) + drop
                 + (jl.Dense(n_out=8, activation="tanh"),
                    jl.OutputLayer(n_out=4, activation="softmax")),
                 input_type=JInputType.feed_forward(6), updater={"type": "sgd", "lr": 0.05},
                 seed=21)


LM = dict(vocab_size=300, max_len=8, d_model=16, n_heads=2, n_blocks=2, dtype="float32",
          updater={"type": "sgd", "lr": 0.05})


def _lm_data():
    rs = np.random.RandomState(2)
    ids = rs.randint(0, 300, (8, 8))
    return ids, np.roll(ids, -1, axis=1)


def _cases():
    """name -> (JAX conf, mesh (data, seq, model, pipe), tp axis, n_micro,
    data, reference: "single" | "gpipe" | "gpipe_pipe_only" | "port")."""
    sgd, adam = {"type": "sgd", "lr": 0.05}, {"type": "adam", "lr": 5e-3}
    gn = _mlp(sgd, per_layer={1: {"gradient_normalization": "clip_l2_per_layer",
                                  "gradient_normalization_threshold": 0.1},
                              2: {"constraints": ({"type": "max_norm", "max_norm": 0.5},)}})
    return {
        "mlp_sgd": (_mlp(sgd), (2, 1, 1, 2), None, 4, _mlp_data(), "gpipe"),
        "mlp_adam": (_mlp(adam), (2, 1, 1, 2), None, 4, _mlp_data(), "single"),
        "lstm": (_lstm(), (2, 1, 1, 2), None, 2, _seq_data(), "gpipe"),
        "bn": (_bn(), (1, 2, 1, 2), None, 2, _mlp_data(), "gpipe_pipe_only"),
        "per_layer": (_mlp(sgd, per_layer={0: {"updater": {"type": "sgd", "lr": 0.2}},
                                           1: {"trainable": False}}),
                      (1, 2, 1, 2), None, 2, _mlp_data(), "single"),
        "masked": (_lstm(), (1, 2, 1, 2), None, 2, _seq_data(masked=True), "single"),
        "gn_constraints": (gn, (1, 2, 1, 2), None, 2, _mlp_data(), "single"),
        "lm_ids": (jzoo.TransformerLM(**LM), (2, 1, 1, 2), None, 2, _lm_data(), "single"),
        "pp_tp": (jzoo.TransformerLM(**LM), (1, 1, 2, 2), "model", 2, _lm_data(), "single"),
        "dropout": (_noisy("dropout"), (1, 2, 1, 2), None, 2, _mlp_data(), "port"),
        "noise": (_noisy("noise"), (1, 2, 1, 2), None, 2, _mlp_data(), "port"),
    }


WORKER = r'''
import pickle, sys
import numpy as np
import torch

torch.set_num_threads(1)
rank, world, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration
from deeplearning4j_tpu_torch.parallel import (
    GPipeTrainer, MeshSpec, PipelineParallel, init_distributed, make_mesh, shutdown_distributed,
    stack_stage_params)
from deeplearning4j_tpu_torch.utils.tree import tree_leaves

init_distributed(f"file://{root}/store", world, rank, device="cpu", timeout_s=90)
with open(f"{root}/inputs.pkl", "rb") as f:
    inp = pickle.load(f)
res = {}


class Count:
    n = 0

    def on_epoch_start(self, *a): pass
    def on_epoch_end(self, *a): pass
    def iteration_done(self, model, it, score, n):
        Count.n += 1


for name, (conf, (d, s, m, p), tp_axis, n_micro, data, params) in inp["cases"].items():
    tr = GPipeTrainer(MultiLayerConfiguration.from_json(conf),
                      make_mesh(MeshSpec(data=d, seq=s, model=m, pipe=p)), n_micro=n_micro,
                      tp_axis=tp_axis)
    if params is not None:
        for t, v in zip(tree_leaves(tr._ref.params), params):
            t.copy_(torch.from_numpy(np.asarray(v)).reshape(t.shape) if t.shape == v.shape
                    else torch.from_numpy(np.asarray(v)).chunk(m, dim=1)[tr._tp.index])
    tr.set_listeners(Count())
    losses = []
    for _ in range(3):
        losses.append(float(tr.fit_batch(*data)))
    model = tr.to_model()
    res[name] = dict(losses=losses, params=[t.numpy().copy() for t in tree_leaves(model.params)],
                     state=[t.numpy().copy() for t in tree_leaves(model.state)])
tr.fit([inp["cases"]["mlp_sgd"][4][:2]], epochs=1)
res["listened"] = Count.n

# PipelineParallel: two linear stages, MSE
mesh = make_mesh(MeshSpec(data=2, pipe=2))
W, x, y = (torch.from_numpy(a) for a in inp["pp"])
stacked = stack_stage_params([{"W": W[0]}, {"W": W[1]}])
pp = PipelineParallel(lambda prm, xx: torch.tanh(xx @ prm["W"]), 2, mesh,
                      loss_fn=lambda out, yy: ((out - yy) ** 2).mean(), learning_rate=0.1)
out = []
for _ in range(2):
    stacked, loss = pp.fit_batch(stacked, x, y, n_micro=2)
    out.append(float(loss))
res["pp"] = (out, stacked["W"].numpy())
with open(f"{root}/rank{rank}.pkl", "wb") as f:
    pickle.dump(res, f)
shutdown_distributed()
'''


def _jparams(jconf):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(JNetwork(jconf).init().params)]


def _reference(jconf, shape, n_micro, data, kind):
    """The reference params and state after 3 full-batch steps."""
    if kind.startswith("gpipe"):
        # the JAX package's BatchNorm stages run on a pipe-only mesh alone
        d, s, m, p = (1, 1, 1, shape[3]) if kind == "gpipe_pipe_only" else shape
        tr = JGPipeTrainer(jconf, jmake_mesh(JMeshSpec(data=d, seq=s, model=m, pipe=p),
                                             jax.devices()[:d * s * m * p]), n_micro=n_micro)
        for _ in range(3):
            tr.fit_batch(*data)
        model = tr.to_model()
    elif kind == "single":
        model = JNetwork(jconf).init()
        for _ in range(3):
            model.fit(data, epochs=1)
    else:
        ref = microbatched_reference(MultiLayerConfiguration.from_json(jconf.to_json()),
                                     n_micro, device="cpu")
        for _ in range(3):
            ref.fit_batch(*data)
        model = ref.to_model()
        return ([t.numpy() for t in tree_leaves(model.params)],
                [t.numpy() for t in tree_leaves(model.state)])
    return ([np.asarray(a) for a in jax.tree_util.tree_leaves(model.params)],
            [np.asarray(a) for a in jax.tree_util.tree_leaves(model.state)])


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        _drop_knobs(mp)
        root = tmp_path_factory.mktemp("gpipe")
        cases, refs = {}, {}
        for name, (jconf, shape, tp_axis, n_micro, data, kind) in _cases().items():
            params = None if kind == "port" else _jparams(jconf)
            cases[name] = (jconf.to_json(), shape, tp_axis, n_micro, data, params)
            refs[name] = _reference(jconf, shape, n_micro, data, kind)
        rs = np.random.RandomState(5)
        pp = (rs.randn(2, 4, 4).astype(np.float32) * 0.5, rs.randn(8, 4).astype(np.float32),
              rs.randn(8, 4).astype(np.float32))
        with open(root / "inputs.pkl", "wb") as f:
            pickle.dump({"cases": cases, "pp": pp}, f)
        env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
        spawn_ranks([sys.executable, "-c", WORKER], 4, root, RANK_TIMEOUT_S, env=env,
                    cwd=str(REPO))
        ranks = []
        for r in range(4):
            with open(root / f"rank{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
        return ranks, refs, pp


CASES = sorted(_cases())


@pytest.mark.parametrize("name", CASES)
def test_gpipe_matches_its_reference(gloo_run, name):
    ranks, refs, _ = gloo_run
    want_p, want_s = refs[name]
    exact = _cases()[name][-1] == "port"
    for res in ranks:
        got = res[name]
        assert all(np.isfinite(got["losses"]))
        for a, b in zip(got["params"] + got["state"], want_p + want_s):
            if exact:
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(a.ravel(), b.ravel(), **TOL)


@pytest.mark.parametrize("name", CASES)
def test_gpipe_ranks_are_bit_equal(gloo_run, name):
    ranks = gloo_run[0]
    for res in ranks[1:]:
        assert res[name]["losses"] == ranks[0][name]["losses"]
        for a, b in zip(res[name]["params"], ranks[0][name]["params"]):
            np.testing.assert_array_equal(a, b)


def test_listeners_fire_every_iteration(gloo_run):
    for res in gloo_run[0]:
        assert res["listened"] == 1


def test_pipeline_parallel_equals_one_process_sgd(gloo_run):
    ranks, _, (W, x, y) = gloo_run
    Wt = torch.from_numpy(W.copy())
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    losses = []
    for _ in range(2):
        Wt.requires_grad_(True)
        loss = ((torch.tanh(torch.tanh(xt @ Wt[0]) @ Wt[1]) - yt) ** 2).mean()
        (g,) = torch.autograd.grad(loss, Wt)
        losses.append(float(loss.detach()))
        Wt = (Wt - 0.1 * g).detach()
    for res in ranks:
        got_losses, got_W = res["pp"]
        np.testing.assert_allclose(got_losses, losses, rtol=1e-5)
        np.testing.assert_allclose(got_W, Wt.numpy(), rtol=1e-5, atol=1e-6)
