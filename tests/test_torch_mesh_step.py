"""The named-mesh trainer of the port (``parallel/mesh_step.py``) against
the JAX package.

In one process: ``shard_update_spec`` on the cases of
tests/test_mesh_step.py (as tuples), ``mesh_shape_from_env`` against the
JAX package's on every knob setting, ``MeshSlice``'s spec arithmetic, and
the tuning DB's refusal.

Across processes: 4 gloo ranks (a FileStore under pytest's tmp dir, one
thread each, joined under ``RANK_TIMEOUT_S``) run the mesh shapes of
tests/test_mesh_step.py:191-300 that fit 4 ranks: data=4, data=2 x model=2
and data=2 x pipe=2, 3 Adam steps each from the JAX package's params. The
losses and the params after ``finish`` are held to the JAX package's
MeshTrainer on as many CPU devices (rtol 2e-4) and to each other (the JAX
test's rtol 1e-5); each rank holds 1/(d·s) of every Adam moment; training
goes on from the gathered state on one device; a batch that does not divide
the data axis and compression on a tensor mesh are refused; the compressed
path trains.
"""

import os
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.input_type import InputType as JInputType
from deeplearning4j_tpu.nn.model import MultiLayerConfiguration as JConf
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JNetwork
from deeplearning4j_tpu.nn.step_program import mesh_shape_from_env as jmesh_shape_from_env
from deeplearning4j_tpu.parallel import MeshSpec as JMeshSpec
from deeplearning4j_tpu.parallel import MeshTrainer as JMeshTrainer
from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration, MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.step_program import mesh_shape_from_env
from deeplearning4j_tpu_torch.parallel import MeshTrainer, shard_update_spec
from deeplearning4j_tpu_torch.parallel.launch import spawn_ranks
from deeplearning4j_tpu_torch.parallel.mesh import Mesh
from deeplearning4j_tpu_torch.parallel.mesh_step import MeshSlice

REPO = Path(__file__).resolve().parent.parent
RANK_TIMEOUT_S = 150
ADAM = {"type": "adam", "lr": 0.01}
SHAPES = {"d4": (4, 1, 1), "d2t2": (2, 2, 1), "d2s2": (2, 1, 2)}


def _drop_knobs(mp):
    for k in list(os.environ):
        if k.startswith("DL4J_TPU_"):
            mp.delenv(k)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    _drop_knobs(monkeypatch)


def _fake_mesh(d, t, s):
    return Mesh(np.arange(d * t * s).reshape(d, t, 1, s), 0, torch.device("cpu"), {})


def test_shard_update_spec_prefers_joint_combo():
    mesh = _fake_mesh(2, 2, 2)
    assert shard_update_spec((), (8, 3), mesh) == (("data", "pipe"), None)
    assert shard_update_spec(("model", None), (2, 8), mesh) == ("model", ("data", "pipe"))
    assert shard_update_spec((), (3, 5), mesh) == ()
    assert shard_update_spec((), (), mesh) == ()
    assert shard_update_spec((), (4, 4), _fake_mesh(4, 1, 2)) == ("data", None)


@pytest.mark.parametrize("knobs", [{}, {"DL4J_TPU_MESH_MODEL": "2"},
                                   {"DL4J_TPU_MESH_PIPE": "2", "DL4J_TPU_MESH_MODEL": "2"},
                                   {"DL4J_TPU_MESH_DATA": "2", "DL4J_TPU_MESH_PIPE": "4"},
                                   {"DL4J_TPU_MESH_MODEL": "3"},
                                   {"DL4J_TPU_MESH_DATA": "3"}, {"DL4J_TPU_MESH_DATA": "x"}])
def test_mesh_shape_from_env_equals_jax(monkeypatch, knobs):
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    try:
        want = jmesh_shape_from_env(8)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            mesh_shape_from_env(8)
        assert str(got.value) == str(e)
        return
    assert mesh_shape_from_env(8) == want


def test_mesh_slice_spec_arithmetic():
    assert MeshSlice.parse_spec("2") == (2, 1, 1)
    assert MeshSlice.parse_spec((2, 2)) == (2, 2, 1)
    with pytest.raises(ValueError, match="1-3 positive"):
        MeshSlice.parse_spec("0,1")
    s = MeshSlice("1", device="cpu")
    assert s.round_rows(5) == 5 and s.mesh.shape["data"] == 1


def test_the_tuning_db_is_refused(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_TUNE", "1")
    m = MultiLayerNetwork(MultiLayerConfiguration.from_json(_conf(3).to_json()), device="cpu")
    with pytest.raises(NotImplementedError, match="item 9"):
        MeshTrainer(m)


# -- gloo ranks ------------------------------------------------------------------

def _conf(seed, hidden=16):
    return JConf(layers=(jl.Dense(n_out=hidden, activation="tanh"),
                         jl.OutputLayer(n_out=2, activation="softmax")),
                 input_type=JInputType.feed_forward(4), updater=ADAM, seed=seed)


def _data(n=64, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 4).astype(np.float32)
    return x, np.eye(2, dtype=np.float32)[(x.sum(axis=1) > 0).astype(int)]


WORKER = r'''
import pickle, sys
import numpy as np
import torch

torch.set_num_threads(1)
rank, world, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
from deeplearning4j_tpu_torch.interop import params_from_numpy
from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration, MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import MeshSpec, MeshTrainer, init_distributed, shutdown_distributed
from deeplearning4j_tpu_torch.utils.tree import tree_leaves

init_distributed(f"file://{root}/store", world, rank, device="cpu", timeout_s=90)
with open(f"{root}/inputs.pkl", "rb") as f:
    inp = pickle.load(f)
x, y = inp["data"]


def model():
    m = MultiLayerNetwork(MultiLayerConfiguration.from_json(inp["conf"]), device="cpu")
    params_from_numpy(m, inp["params"])
    return m


res = {}
for name, (d, t, s) in inp["shapes"].items():
    m = model()
    tr = MeshTrainer(m, MeshSpec(data=d, model=t, pipe=s))
    losses = [float(tr.fit_batch(x, y)) for _ in range(3)]
    R = d * s
    moments = [(leaf.numel(), e.n) for k, e in tr._dp._entries.items()
               for leaf in tree_leaves(tr._dp._opt_flat[k])]
    out = tr.output(x).numpy()
    tr.finish()
    whole = [p.detach().numpy().copy() for p in tree_leaves(m.params)]
    opt = [o.shape for o in tree_leaves(m.opt_state)]
    m._fit_batch(x, y, None, None)      # plain training goes on from the gathered state
    res[name] = dict(losses=losses, params=whole, moments=moments, R=R, out=out,
                     opt=opt, after=float(m.score((x, y))))
m = model()
tr = MeshTrainer(m, MeshSpec(data=4))
try:
    tr.fit_batch(x[:62], y[:62])
except ValueError as e:
    res["divide"] = str(e)
try:
    MeshTrainer(model(), MeshSpec(data=2, model=2), compress=True)
except ValueError as e:
    res["compress_tp"] = str(e)
m = model()
tr = MeshTrainer(m, MeshSpec(data=4), compress=True)
res["compressed"] = [float(tr.fit_batch(x, y)) for _ in range(10)]
with open(f"{root}/rank{rank}.pkl", "wb") as f:
    pickle.dump(res, f)
shutdown_distributed()
'''


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        _drop_knobs(mp)
        root = tmp_path_factory.mktemp("mesh")
        x, y = _data()
        params = jax.tree_util.tree_map(np.asarray, JNetwork(_conf(17)).init().params)
        jref = {}
        for name, (d, t, s) in SHAPES.items():
            jm = JNetwork(_conf(17)).init()
            tr = JMeshTrainer(jm, JMeshSpec(data=d, model=t, pipe=s),
                              devices=jax.devices()[:4])
            losses = [float(tr.fit_batch(x, y)) for _ in range(3)]
            tr.finish()
            jref[name] = dict(losses=losses, params=[np.asarray(a) for a in
                                                     jax.tree_util.tree_leaves(jm.params)])
        with open(root / "inputs.pkl", "wb") as f:
            pickle.dump({"conf": _conf(17).to_json(), "params": params, "data": (x, y),
                         "shapes": SHAPES}, f)
        env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
        spawn_ranks([sys.executable, "-c", WORKER], 4, root, RANK_TIMEOUT_S, env=env,
                    cwd=str(REPO))
        ranks = []
        for r in range(4):
            with open(root / f"rank{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
        return ranks, jref


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_mesh_trainer_matches_jax(gloo_run, name):
    ranks, jref = gloo_run
    for res in ranks:
        np.testing.assert_allclose(res[name]["losses"], jref[name]["losses"], rtol=2e-4)
        for a, b in zip(res[name]["params"], jref[name]["params"]):
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-6)


@pytest.mark.parametrize("name", ["d2t2", "d2s2"])
def test_shape_parity_vs_pure_dp(gloo_run, name):
    for res in gloo_run[0]:
        np.testing.assert_allclose(res[name]["losses"], res["d4"]["losses"], rtol=1e-5,
                                   atol=1e-6)
        for a, b in zip(res[name]["params"], res["d4"]["params"]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(res[name]["out"], res["d4"]["out"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_moments_shard_over_the_spare_axes(gloo_run, name):
    for res in gloo_run[0]:
        r = res[name]
        assert r["moments"]
        for numel, n in r["moments"]:
            assert numel == -(-n // r["R"])


def test_finish_round_trips_to_one_device(gloo_run):
    for res in gloo_run[0]:
        for name in SHAPES:
            assert res[name]["opt"] == res["d4"]["opt"]
            assert np.isfinite(res[name]["after"])


def test_refusals_and_the_compressed_path(gloo_run):
    for res in gloo_run[0]:
        assert "divide the data axis" in res["divide"]
        assert "pure data mesh" in res["compress_tp"]
        c = res["compressed"]
        assert all(np.isfinite(c)) and c[-1] < c[0]
