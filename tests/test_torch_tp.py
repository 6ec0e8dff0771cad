"""Tensor and expert parallelism of the port (``parallel/tp.py``) against
the JAX package.

In one process: ``tp_param_shardings`` leaf for leaf against the JAX
package's ``NamedSharding.spec`` (TransformerLM, the MoE TransformerLM, a
dense net either side of ``TP_DENSE_SHARD_MIN_ELEMS``), the same MoE
divisibility error, and the head-wise layout of ``Wqkv`` (a rank's shard
is its heads' columns of q, k and v; gathering gives the JAX layout back).

Across processes: 4 gloo ranks (a FileStore under pytest's tmp dir,
``torch.set_num_threads(1)``, joined under ``RANK_TIMEOUT_S``) run
``ShardedTrainer`` for 3 SGD steps from the JAX package's params on
data=2 x model=2 (TransformerLM; the MoE TransformerLM; a net whose dense
weight is column-sharded), model=2 x seq=2 (sequence-parallel attention on
the local heads, ``head_axis``), BatchNorm over data=4, and an LSTM under
data=2 x seq=2 (the time axis gathered around it), and the TransformerLM
with each of the five gradient normalization modes on every layer with
params (thresholds that clip; the norm of a tensor-sharded layer spans its
shards) on data=2 x model=2; then ranks 0 and 1 form a world of two for
model=2 alone. Losses and gathered params are held to
the JAX package's ``ShardedTrainer`` on as many CPU devices at rtol 2e-4,
and the ranks to each other bit for bit.
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
from deeplearning4j_tpu.parallel import ShardedTrainer as JShardedTrainer
from deeplearning4j_tpu.parallel import make_mesh as jmake_mesh
from deeplearning4j_tpu.parallel import tp_param_shardings as jtp_param_shardings
from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration, MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import tp
from deeplearning4j_tpu_torch.parallel.launch import spawn_ranks
from deeplearning4j_tpu_torch.parallel.mesh import Mesh

REPO = Path(__file__).resolve().parent.parent
RANK_TIMEOUT_S = 150
RTOL = dict(rtol=2e-4, atol=2e-5)
SGD = {"type": "sgd", "lr": 0.1}
LM = dict(vocab_size=16, max_len=8, d_model=16, n_heads=2, n_blocks=1, dtype="float32",
          updater=SGD)
# gradient normalization (mode, threshold): thresholds below the layers'
# gradient norms and entries, so the clip modes clip
GN = {"gn_renorm_layer_d2m2": ("renormalize_l2_per_layer", 1.0),
      "gn_renorm_ptype_d2m2": ("renormalize_l2_per_param_type", 1.0),
      "gn_clip_elem_d2m2": ("clip_elementwise_absolute_value", 0.01),
      "gn_clip_layer_d2m2": ("clip_l2_per_layer", 0.05),
      "gn_clip_ptype_d2m2": ("clip_l2_per_param_type", 0.02)}


def _gn_lm(mode, threshold):
    conf = jzoo.TransformerLM(**LM)
    layers = tuple(dataclasses.replace(l, gradient_normalization=mode,
                                       gradient_normalization_threshold=threshold)
                   for l in conf.layers)
    return dataclasses.replace(conf, layers=layers)


def _drop_knobs(mp):
    for k in list(os.environ):
        if k.startswith("DL4J_TPU_"):
            mp.delenv(k)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    _drop_knobs(monkeypatch)


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _confs():
    """name -> (JAX conf, mesh (data, model, seq), batch)."""
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 16, (4, 8))
    lm_batch = (ids, np.eye(16, dtype=np.float32)[rs.randint(0, 16, (4, 8))])
    moe = JConf(layers=(jl.EmbeddingSequence(n_in=16, n_out=16),
                        jl.TransformerBlock(n_heads=2), jl.MixtureOfExperts(
                            n_experts=2, capacity_factor=4.0),
                        jl.RnnOutputLayer(n_out=16, activation="softmax")),
                input_type=JInputType.recurrent(16, 8), updater=SGD, seed=5, dtype="float32")
    dense = JConf(layers=(jl.Dense(n_out=256, activation="tanh"),
                          jl.Dense(n_out=256, activation="tanh"),
                          jl.OutputLayer(n_out=4, activation="softmax")),
                  input_type=JInputType.feed_forward(256), updater=SGD, seed=6)
    xd = rs.randn(8, 256).astype(np.float32) * 0.1
    yd = np.eye(4, dtype=np.float32)[rs.randint(0, 4, 8)]
    bn = JConf(layers=(jl.Dense(n_out=16, activation="identity"), jl.BatchNorm(),
                       jl.Dense(n_out=8, activation="tanh"),
                       jl.OutputLayer(n_out=2, activation="softmax")),
               input_type=JInputType.feed_forward(4), updater=SGD, seed=11)
    xb = rs.randn(16, 4).astype(np.float32)
    yb = np.eye(2, dtype=np.float32)[(xb.sum(1) > 0).astype(int)]
    lstm = JConf(layers=(jl.LSTM(n_out=8, activation="tanh"),
                         jl.RnnOutputLayer(n_out=5, activation="softmax")),
                 input_type=JInputType.recurrent(5, 8), updater=SGD, seed=3)
    xi = rs.randint(0, 5, (4, 8))
    lstm_batch = (np.eye(5, dtype=np.float32)[xi],
                  np.eye(5, dtype=np.float32)[np.roll(xi, -1, 1)])
    return {
        "lm_d2m2": (jzoo.TransformerLM(**LM), (2, 2, 1), lm_batch),
        "lm_m2s2": (jzoo.TransformerLM(**LM, sequence_parallel=True), (1, 2, 2), lm_batch),
        "moe_d2m2": (moe, (2, 2, 1), lm_batch),
        "dense_d2m2": (dense, (2, 2, 1), (xd, yd)),
        "bn_d4": (bn, (4, 1, 1), (xb, yb)),
        "lstm_d2s2": (lstm, (2, 1, 2), lstm_batch),
        "lm_m2": (jzoo.TransformerLM(**LM), (1, 2, 1), lm_batch),
        **{name: (_gn_lm(*gn), (2, 2, 1), lm_batch) for name, gn in GN.items()},
    }


# -- one process ---------------------------------------------------------------

def _jspecs(jconf, shape):
    jm = JNetwork(jconf).init()
    n = int(np.prod(shape))
    mesh = jmake_mesh(JMeshSpec(data=shape[0], model=shape[1], seq=shape[2]),
                      jax.devices()[:n])
    return jax.tree_util.tree_map(lambda s: tuple(s.spec), jtp_param_shardings(jm, mesh),
                                  is_leaf=lambda s: hasattr(s, "spec"))


def _port(jconf, device="cpu"):
    return MultiLayerNetwork(MultiLayerConfiguration.from_json(jconf.to_json()),
                             device=device).init()


def _fake_mesh(d, m, s):
    return Mesh(np.arange(d * m * s).reshape(d, m, s, 1), 0, torch.device("cpu"), {})


@pytest.mark.parametrize("name", ["lm_d2m2", "moe_d2m2", "dense_d2m2", "bn_d4"])
def test_tp_param_shardings_equal_the_jax_specs(name):
    jconf, shape, _ = _confs()[name]
    want = _jspecs(jconf, shape)
    got = tp.tp_param_shardings(_port(jconf), _fake_mesh(*shape))
    assert got == want


@pytest.mark.parametrize("n_in", [255, 256])
def test_dense_threshold_matches_jax(n_in):
    conf = JConf(layers=(jl.Dense(n_out=256), jl.OutputLayer(n_out=2)),
                 input_type=JInputType.feed_forward(n_in), updater=SGD)
    got = tp.tp_param_shardings(_port(conf), _fake_mesh(4, 2, 1))
    assert got == _jspecs(conf, (4, 2, 1))
    assert got[0]["W"] == ((None, "model") if n_in * 256 >= tp.TP_DENSE_SHARD_MIN_ELEMS else ())


def test_moe_expert_axis_must_divide_the_model_axis():
    conf = jzoo.TransformerLM(**dict(LM, n_blocks=2), moe_experts=3)
    jm = JNetwork(conf).init()
    with pytest.raises(ValueError, match="n_experts a multiple") as jerr:
        jtp_param_shardings(jm, jmake_mesh(JMeshSpec(data=4, model=2)))
    with pytest.raises(ValueError, match="n_experts a multiple") as perr:
        tp.tp_param_shardings(_port(conf), _fake_mesh(4, 2, 1))
    assert str(perr.value) == str(jerr.value)


def test_wqkv_shards_are_the_heads_columns_and_gather_back():
    C, H, m = 8, 4, 2
    W = torch.arange(C * 3 * C, dtype=torch.float32).reshape(C, 3 * C)
    parts = [tp._shard(W, ("qkv",), m, r) for r in range(m)]
    D = C // H
    for r, p in enumerate(parts):
        for j in range(3):   # q, k, v: rank r holds heads [r H/m, (r+1) H/m)
            cols = slice(j * C + r * (C // m), j * C + (r + 1) * (C // m))
            torch.testing.assert_close(p[:, j * (C // m):(j + 1) * (C // m)], W[:, cols])
    torch.testing.assert_close(tp._unshard(parts, ("qkv",)), W, rtol=0, atol=0)
    assert D * (H // m) == C // m


# -- gloo ranks ----------------------------------------------------------------

WORKER = r'''
import pickle, sys
import numpy as np
import torch

torch.set_num_threads(1)
rank, world, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
from deeplearning4j_tpu_torch.interop import params_from_numpy
from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration, MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import (
    MeshSpec, ShardedTrainer, init_distributed, make_mesh, shutdown_distributed)
from deeplearning4j_tpu_torch.utils.tree import tree_leaves

with open(f"{root}/inputs.pkl", "rb") as f:
    inp = pickle.load(f)


def run(name):
    conf, params, (d, m, s), (x, y) = inp[name]
    model = MultiLayerNetwork(MultiLayerConfiguration.from_json(conf), device="cpu")
    params_from_numpy(model, params)
    tr = ShardedTrainer(model, make_mesh(MeshSpec(data=d, model=m, seq=s)))
    losses = [float(tr.fit_batch(x, y)) for _ in range(3)]
    whole = [t.detach().numpy().copy() for t in tree_leaves(tr.gathered_params())]
    state = [t.detach().numpy().copy() for t in tree_leaves(model.state)]
    return dict(losses=losses, params=whole, state=state, output=tr.output(x).numpy())


res = {}
init_distributed(f"file://{root}/store", world, rank, device="cpu", timeout_s=90)
for name in inp["four"]:
    res[name] = run(name)
shutdown_distributed()
if rank < 2:        # a world of two for model=2 alone
    init_distributed(f"file://{root}/store2", 2, rank, device="cpu", timeout_s=90)
    res["lm_m2"] = run("lm_m2")
    shutdown_distributed()
with open(f"{root}/rank{rank}.pkl", "wb") as f:
    pickle.dump(res, f)
'''


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        _drop_knobs(mp)
        root = tmp_path_factory.mktemp("tp")
        confs = _confs()
        inputs, jref = {"four": [n for n in confs if n != "lm_m2"]}, {}
        for name, (jconf, shape, (x, y)) in confs.items():
            jm = JNetwork(jconf).init()
            inputs[name] = (jconf.to_json(), jax.tree_util.tree_map(np.asarray, jm.params),
                            shape, (x, y))
            n = int(np.prod(shape))
            jtr = JShardedTrainer(jm, jmake_mesh(
                JMeshSpec(data=shape[0], model=shape[1], seq=shape[2]), jax.devices()[:n]))
            losses = [float(jtr.fit_batch(x, y)) for _ in range(3)]
            jref[name] = dict(losses=losses, params=_leaves(jm.params), state=_leaves(jm.state),
                              output=np.asarray(jtr.output(x)))
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


CASES = ["lm_d2m2", "lm_m2s2", "moe_d2m2", "dense_d2m2", "bn_d4", "lstm_d2s2", "lm_m2", *GN]


def _ranks_of(ranks, name):
    return [r[name] for r in ranks if name in r]


@pytest.mark.parametrize("name", CASES)
def test_sharded_trainer_matches_jax(gloo_run, name):
    ranks, jref = gloo_run
    want = jref[name]
    for got in _ranks_of(ranks, name):
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-4)
        for a, b in zip(got["params"], want["params"]):
            np.testing.assert_allclose(a.ravel(), b.ravel(), **RTOL)
        for a, b in zip(got["state"], want["state"]):
            np.testing.assert_allclose(a.ravel(), b.ravel(), **RTOL)
        np.testing.assert_allclose(got["output"], want["output"], rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("name", CASES)
def test_ranks_are_bit_equal(gloo_run, name):
    ranks, _ = gloo_run
    first, *rest = _ranks_of(ranks, name)
    assert rest
    for other in rest:
        assert first["losses"] == other["losses"]
        for a, b in zip(first["params"] + first["state"], other["params"] + other["state"]):
            np.testing.assert_array_equal(a, b)
