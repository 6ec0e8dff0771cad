"""The compressed gradient exchange of the port (``parallel/compress.py``,
``parallel/grads.py``) against the JAX package.

In one process: the ternary codec bit for bit and byte for byte against
the JAX package's functions on the same numpy inputs (values on the
threshold, lengths that are not a multiple of 4, the batched unpack, the
fixed-order decode).

Across processes: 4 gloo ranks (a FileStore under pytest's tmp dir, one
thread each, joined under ``RANK_TIMEOUT_S``) train through
ParallelWrapper with ``grad_compress``: the losses of 3 full-batch steps
against the JAX package's compressed ParallelWrapper on 4 CPU devices
(rtol 2e-4; the same gradients quantize the same), the sharded update on
top of compression against the replicated update (rtol 2e-4, atol 1e-6, as
tests/test_grad_compress.py:244 holds it), every step's decoded sum plus
the new residuals against the dense gradient sum plus the old residuals
(f32 rounding: atol 1e-6), two runs bit for bit, and ``comm_stats`` with
its telemetry; the residuals through a checkpoint and back.
"""

import os
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.input_type import InputType as JInputType
from deeplearning4j_tpu.nn.model import MultiLayerConfiguration as JConf
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JNetwork
from deeplearning4j_tpu.parallel import MeshSpec as JMeshSpec
from deeplearning4j_tpu.parallel import ParallelWrapper as JParallelWrapper
from deeplearning4j_tpu.parallel import compress as jc
from deeplearning4j_tpu.parallel import make_mesh as jmake_mesh
from deeplearning4j_tpu_torch.parallel import compress as pc
from deeplearning4j_tpu_torch.parallel.launch import spawn_ranks

REPO = Path(__file__).resolve().parent.parent
RANK_TIMEOUT_S = 150
THR = 1e-2


def _drop_knobs(mp):
    for k in list(os.environ):
        if k.startswith("DL4J_TPU_"):
            mp.delenv(k)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    _drop_knobs(monkeypatch)


# -- the codec -------------------------------------------------------------------

def _grad(n, seed):
    rs = np.random.RandomState(seed)
    g = (rs.randn(n) * 0.02).astype(np.float32)
    g[::7] = THR                       # on the threshold
    g[3::11] = -THR
    return g, (rs.randn(n) * 0.005).astype(np.float32)


@pytest.mark.parametrize("n", [1, 3, 4, 5, 17, 64, 1001])
def test_encode_and_pack_are_bit_and_byte_equal(n):
    g, r = _grad(n, n)
    jq, jr = jc.threshold_encode(jnp.asarray(g), jnp.asarray(r), THR)
    pq, pr = pc.threshold_encode(torch.from_numpy(g), torch.from_numpy(r), THR)
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
    jp, jr2 = jc.encode_packed(jnp.asarray(g), jnp.asarray(r), THR)
    pp, pr2 = pc.encode_packed(torch.from_numpy(g), torch.from_numpy(r), THR)
    assert pp.dtype == torch.uint8 and pp.numpy().tobytes() == np.asarray(jp).tobytes()
    np.testing.assert_array_equal(pr2.numpy(), np.asarray(jr2))
    assert pc.packed_nbytes(n) == jc.packed_nbytes(n) == pp.numel()
    np.testing.assert_array_equal(pc.unpack_ternary(pp, n).numpy(),
                                  np.asarray(jc.unpack_ternary(jp, n)))


def test_batched_unpack_and_decode_are_equal():
    n, R = 37, 4
    packed = []
    for r in range(R):
        g, res = _grad(n, 100 + r)
        packed.append(np.asarray(jc.encode_packed(jnp.asarray(g), jnp.asarray(res), THR)[0]))
    gathered = np.stack(packed)
    np.testing.assert_array_equal(pc.unpack_ternary(torch.from_numpy(gathered), n).numpy(),
                                  np.asarray(jc.unpack_ternary(jnp.asarray(gathered), n)))
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = pc.decode_gathered(torch.from_numpy(gathered), n, THR, dt).float().numpy()
        want = np.asarray(jc.decode_gathered(jnp.asarray(gathered), n, THR, jdt),
                          np.float32)
        np.testing.assert_array_equal(got, want)
    t = torch.zeros(5)
    np.testing.assert_array_equal(pc.threshold_decode(torch.ones(5), t).numpy(), np.ones(5))


# -- gloo ranks --------------------------------------------------------------------

def _conf():
    return JConf(layers=(jl.Dense(n_out=16, activation="tanh"),
                         jl.OutputLayer(n_out=2, activation="softmax")),
                 input_type=JInputType.feed_forward(4), updater={"type": "sgd", "lr": 0.1},
                 seed=9)


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
from deeplearning4j_tpu_torch.parallel import ParallelWrapper, init_distributed, shutdown_distributed
from deeplearning4j_tpu_torch.parallel import comm, grads
from deeplearning4j_tpu_torch.train.checkpoint import CheckpointListener
from deeplearning4j_tpu_torch.utils import bucketing
from deeplearning4j_tpu_torch.utils.tree import tree_leaves

init_distributed(f"file://{root}/store", world, rank, device="cpu", timeout_s=90)
with open(f"{root}/inputs.pkl", "rb") as f:
    inp = pickle.load(f)
x, y = inp["data"]
sl = slice(rank * len(x) // world, (rank + 1) * len(x) // world)
xs, ys = x[sl], y[sl]


def model():
    m = MultiLayerNetwork(MultiLayerConfiguration.from_json(inp["conf"]), device="cpu")
    params_from_numpy(m, inp["params"])
    return m


def leaves(m):
    return [t.detach().numpy().copy() for t in tree_leaves(m.params)]


res = {}
# 3 full-batch steps, the losses
m = model()
pw = ParallelWrapper(m, grad_compress=True, compress_threshold=inp["thr"])
runner = pw._exchange_runner()
runner.begin()
res["losses"] = [float(runner.fit_batch(xs, ys, None, None)) for _ in range(3)]
runner.finish()
res["stats"] = runner.comm_stats()
res["telemetry"] = bucketing.telemetry().snapshot()["comm"]

# the conservation of every step: decoded sum + new residuals = dense sum + old residuals
decoded = []
real = grads.compression.decode_gathered
grads.compression.decode_gathered = lambda *a: decoded.append(real(*a)) or decoded[-1]
m = model()
run = grads.DataParallelStep(m, pw.mesh, compress=True, threshold=inp["thr"])
run.begin()
gaps = []
for _ in range(3):
    old = {k: v.clone() for k, v in run._residual.items()}
    _, _, g, _ = m._value_and_grad(m.state, m._features(xs), torch.from_numpy(ys), None, None, None)
    decoded.clear()
    run.fit_batch(xs, ys, None, None)
    for i, key in enumerate(run._entries):
        e = run._entries[key]
        flat = grads._pad_flat(grads._flat(g[key]).float(), e.n_pad)
        lhs = decoded[i] + comm.all_reduce(run._residual[key].clone(), run.sub)
        rhs = comm.all_reduce(flat + old[key], run.sub)
        gaps.append(float((lhs - rhs).abs().max()))
res["gaps"] = gaps
grads.compression.decode_gathered = real

# compressed, replicated vs sharded update; two runs bit for bit
for name, kw in (("replicated", {}), ("sharded", {"sharded_update": True}),
                 ("again", {})):
    m = model()
    ParallelWrapper(m, grad_compress=True, compress_threshold=inp["thr"], **kw).fit(
        (xs, ys), epochs=5, batch_size=4)
    res[name] = leaves(m)

# the residuals through a checkpoint: 2 steps, a resumed run of the other 2
ck = f"{root}/ck{rank}"
m = model()
m.set_listeners(CheckpointListener(ck, save_every_n_iterations=1, keep_last=1,
                                   delete_existing=True))
pw = ParallelWrapper(m, grad_compress=True, compress_threshold=inp["thr"])
pw.fit((xs[:8], ys[:8]), epochs=2, batch_size=4)
res["saved_residuals"] = pw._runner.export_residuals()
r = model()
pw2 = ParallelWrapper(r, grad_compress=True, compress_threshold=inp["thr"])
pw2.fit((xs[:8], ys[:8]), epochs=4, batch_size=4, resume_from=ck)
res["resumed"] = leaves(r)
m = model()
ParallelWrapper(m, grad_compress=True, compress_threshold=inp["thr"]).fit(
    (xs[:8], ys[:8]), epochs=4, batch_size=4)
res["straight"] = leaves(m)
with open(f"{root}/rank{rank}.pkl", "wb") as f:
    pickle.dump(res, f)
shutdown_distributed()
'''


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        _drop_knobs(mp)
        root = tmp_path_factory.mktemp("gc")
        jm = JNetwork(_conf()).init()
        params = jax.tree_util.tree_map(np.asarray, jm.params)
        x, y = _data()
        with open(root / "inputs.pkl", "wb") as f:
            pickle.dump({"conf": _conf().to_json(), "params": params, "data": (x, y),
                         "thr": THR}, f)
        pw = JParallelWrapper(jm, mesh=jmake_mesh(JMeshSpec(data=4), jax.devices()[:4]),
                              grad_compress=True, compress_threshold=THR)
        runner = pw._exchange_runner()
        runner.begin()
        jlosses = [float(runner.fit_batch(pw._shard(x), pw._shard(y), None, None))
                   for _ in range(3)]
        runner.finish()
        env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
        spawn_ranks([sys.executable, "-c", WORKER], 4, root, RANK_TIMEOUT_S, env=env,
                    cwd=str(REPO))
        ranks = []
        for r in range(4):
            with open(root / f"rank{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
        return ranks, jlosses


def test_compressed_losses_match_jax(gloo_run):
    ranks, jlosses = gloo_run
    for res in ranks:
        np.testing.assert_allclose(res["losses"], jlosses, rtol=2e-4)


def test_decoded_sum_plus_residuals_conserves_the_dense_gradient(gloo_run):
    for res in gloo_run[0]:
        assert res["gaps"] and max(res["gaps"]) <= 1e-6


def test_compressed_sharded_matches_replicated_update(gloo_run):
    for res in gloo_run[0]:
        for a, b in zip(res["replicated"], res["sharded"]):
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-6)


def test_compressed_runs_repeat_and_ranks_agree_bit_for_bit(gloo_run):
    ranks = gloo_run[0]
    for res in ranks:
        for a, b in zip(res["replicated"], res["again"]):
            np.testing.assert_array_equal(a, b)
    for res in ranks[1:]:
        for a, b in zip(ranks[0]["replicated"], res["replicated"]):
            np.testing.assert_array_equal(a, b)


def test_comm_stats_and_telemetry(gloo_run):
    for res in gloo_run[0]:
        s = res["stats"]
        assert s["compressed_entries"] == s["n_entries"] == 2
        assert s["dense_bytes"] == 4 * (4 * 16 + 16 + 16 * 2 + 2)
        assert s["dense_bytes"] >= 4 * s["wire_bytes"]
        assert res["telemetry"]["dp.grads"]["wire_bytes"] == s["wire_bytes"]
        assert res["telemetry"]["dp.grads"]["dense_bytes"] == s["dense_bytes"]


def test_residuals_survive_a_checkpoint(gloo_run):
    for res in gloo_run[0]:
        saved = res["saved_residuals"]
        assert set(saved) == {"0", "1"}
        assert all(a.shape[0] == 4 and np.abs(a).max() > 0 for a in saved.values())
        for a, b in zip(res["resumed"], res["straight"]):
            np.testing.assert_array_equal(a, b)
