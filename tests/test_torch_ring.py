"""Ring attention and the sharded trainer of the port (``parallel/``) on the
CPU, in two parts.

In one process: the port's ring shard routines (the einsum ring and the
flash ring over the chunk entries' plain versions) run for every virtual
shard of a sequence (``ring_in_one_process``) against the JAX package's
``ring_self_attention`` on the conftest's 8 CPU devices (data=2 seq=4 and
data=1 seq=8; causal and not; key masks; gradients) — the cases of
tests/test_longcontext.py — and the mesh, trainer and layer rules.

Across processes: 4 gloo ranks (data 2 x seq 2) rendezvous through a
FileStore under ``tmp_path`` (so that test workers never share a port),
each with ``torch.set_num_threads(1)``. Their ``ring_self_attention`` must
equal the in-process result, and 3 SGD steps of ``ShardedTrainer`` on a
sequence-parallel TransformerLM must give the losses of the JAX package's
``ShardedTrainer`` on 4 devices (rtol 2e-4, as test_longcontext.py holds
its sharded step to the single-device one), with the ranks' params bit-equal
to each other. The ranks are joined under a timeout of their own
(``RANK_TIMEOUT_S``); when it runs out they are killed and the test fails.
"""

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JNetwork
from deeplearning4j_tpu.parallel import MeshSpec as JMeshSpec
from deeplearning4j_tpu.parallel import ShardedTrainer as JShardedTrainer
from deeplearning4j_tpu.parallel import make_mesh as jmake_mesh
from deeplearning4j_tpu.parallel.ring import local_attention as jlocal
from deeplearning4j_tpu.parallel.ring import ring_self_attention as jring
from deeplearning4j_tpu_torch.interop import params_from_numpy, params_to_numpy
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.nn.layers import PositionalEmbedding
from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration, MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import (
    MeshSpec,
    ShardedTrainer,
    global_array,
    make_mesh,
    ring_self_attention,
    use_mesh,
)
from deeplearning4j_tpu_torch.parallel import ring
from deeplearning4j_tpu_torch.parallel.mesh import Mesh

REPO = Path(__file__).resolve().parent.parent
F32 = dict(rtol=0.0, atol=2e-5)       # the JAX tests' forward tolerance
GRAD = dict(rtol=0.0, atol=1e-4)      # and their gradient tolerance
RANK_TIMEOUT_S = 120                  # the 4 gloo ranks together, rendezvous included
LM = dict(vocab_size=16, max_len=8, d_model=16, n_heads=2, n_blocks=1,
          sequence_parallel=True, dtype="float32")
SGD = {"type": "sgd", "lr": 0.1}


def _drop_knobs(mp):
    # another test module may leave tuning knobs (DL4J_TPU_GRAD_ACCUM, ...)
    # in os.environ; both packages' fit paths read them
    for k in list(os.environ):
        if k.startswith("DL4J_TPU_"):
            mp.delenv(k)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    _drop_knobs(monkeypatch)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _qkv(seed, B, T, H, D):
    rs = np.random.RandomState(seed)
    return [rs.randn(B, T, H, D).astype(np.float32) for _ in range(3)]


def _lens_mask(lens, T):
    return (np.arange(T)[None, :] < np.asarray(lens)[:, None]).astype(np.float32)


def _port_ring(q, k, v, data, seq, causal, kmask=None, flash=False, dtype=torch.float32):
    """The port's ring over virtual shards: the batch cut over ``data``,
    each part's sequence over ``seq`` shards run by ring_in_one_process."""
    fn = ring._ring_flash_shard if flash else ring._ring_attention_shard
    rows = []
    for part in range(data):
        sl = slice(part * q.shape[0] // data, (part + 1) * q.shape[0] // data)
        qs, ks, vs = (x[sl].to(dtype).chunk(seq, 1) for x in (q, k, v))
        kms = kmask[sl].chunk(seq, 1) if kmask is not None else None
        rows.append(torch.cat(ring.ring_in_one_process(fn, qs, ks, vs, kms, causal=causal), 1))
    return torch.cat(rows, 0)


def _jax_ring(q, k, v, data, seq, causal, kmask=None, flash=False, dtype=jnp.float32):
    """The JAX package's ring under ``jax.jit``, as its callers run it (one
    compile instead of an eager shard_map and Pallas interpreter pass)."""
    mesh = jmake_mesh(JMeshSpec(data=data, seq=seq), jax.devices()[:data * seq])
    km = jnp.asarray(kmask) if kmask is not None else None
    ring_fn = jax.jit(lambda a, b, c: jring(a, b, c, mesh, causal=causal, kmask=km,
                                            use_flash=flash))
    return ring_fn(*(jnp.asarray(x, dtype) for x in (q, k, v)))


RING_CASES = [
    # (data, seq, B, T, H, D, causal, lens or None, flash): the JAX ring's
    # route; both of the port's routes are held to it
    (2, 4, 4, 32, 2, 8, False, None, False),
    (2, 4, 2, 16, 2, 4, False, [10, 16], False),
    (2, 4, 4, 32, 2, 8, True, None, True),
    (2, 4, 2, 64, 2, 8, True, None, True),
    (2, 4, 4, 32, 2, 8, True, [32, 20, 9, 28], True),
    (1, 8, 2, 16, 2, 4, True, None, True),
]


_JAX_RINGS = {}


@pytest.mark.parametrize("case", RING_CASES)
@pytest.mark.parametrize("port_flash", [False, True])
def test_ring_shards_match_the_jax_ring(case, port_flash):
    data, seq, B, T, H, D, causal, lens, flash = case
    q, k, v = _qkv(sum(case[:6]), B, T, H, D)
    km = _lens_mask(lens, T) if lens is not None else None
    got = _port_ring(*(torch.from_numpy(x) for x in (q, k, v)), data, seq, causal,
                     torch.from_numpy(km) if km is not None else None, port_flash)
    key = repr(case)
    if key not in _JAX_RINGS:   # one JAX run (a shard_map compile) for both routes
        _JAX_RINGS[key] = np.asarray(_jax_ring(q, k, v, data, seq, causal, km, flash))
    w = km[:, :, None, None] if km is not None else 1.0   # rows with a valid key
    np.testing.assert_allclose(got.numpy() * w, _JAX_RINGS[key] * w, **F32)


def _ring_grad_case(flash, data, seq, lens):
    B, T = 2, 16
    q = np.random.RandomState(1).randn(B, T, 2, 4).astype(np.float32)
    km = _lens_mask(lens, T) if lens is not None else None
    w = km[:, :, None, None] if km is not None else np.ones((1, 1, 1, 1), np.float32)
    qt = torch.from_numpy(q).requires_grad_(True)
    out = _port_ring(qt, qt, qt, data, seq, True,
                     torch.from_numpy(km) if km is not None else None, flash)
    (out * torch.from_numpy(w)).square().sum().backward()
    kmj = jnp.asarray(km) if km is not None else None
    g_loc = jax.jit(jax.grad(
        lambda x: jnp.sum((jlocal(x, x, x, causal=True, kmask=kmj) * w) ** 2)))(jnp.asarray(q))
    np.testing.assert_allclose(qt.grad.numpy(), np.asarray(g_loc), **GRAD)
    return q, kmj, w, qt.grad.numpy()


@pytest.mark.parametrize("flash,lens", [(False, None), (True, [16, 11])])
def test_ring_grads_match_the_jax_ring(flash, lens):
    """sum((ring(q, q, q) * w)^2) differentiated through every shard, the
    rotation included, against JAX's ring on data=2 x seq=4 (causal) and
    the JAX package's local attention."""
    q, kmj, w, got = _ring_grad_case(flash, 2, 4, lens)
    mesh = jmake_mesh(JMeshSpec(data=2, seq=4), jax.devices()[:8])
    g = jax.jit(jax.grad(lambda x: jnp.sum((jring(x, x, x, mesh, causal=True, kmask=kmj,
                                          use_flash=flash) * w) ** 2)))(jnp.asarray(q))
    np.testing.assert_allclose(got, np.asarray(g), **GRAD)


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("lens", [None, [16, 11]])
def test_ring_grads_over_eight_shards_match_local_attention(flash, lens):
    """data=1 x seq=8: the gradients against the JAX package's local
    attention (JAX's own ring grads are held to it in test_longcontext.py)."""
    _ring_grad_case(flash, 1, 8, lens)


def test_flash_ring_bf16_matches_local():
    B, T, H, D = 2, 32, 2, 8
    q, k, v = _qkv(3, B, T, H, D)
    got = _port_ring(*(torch.from_numpy(x) for x in (q, k, v)), 2, 4, True, flash=True,
                     dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jlocal(*(jnp.asarray(x) for x in (q, k, v)), causal=True))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=3e-2, atol=3e-2)


# -- the mesh, the trainer's rules, the layers ------------------------------

def test_world_of_one_mesh_without_a_process_group():
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1, "seq": 1, "pipe": 1}
    assert mesh.rank == 0 and mesh.device == torch.device("cpu")
    assert mesh.axis_ranks("seq") == [0] and mesh.group("seq") is None


def test_make_mesh_and_trainer_refuse_tensor_parallelism():
    # tensor parallelism is ported (test_torch_tp.py): what stays refused is
    # a mesh the ranks do not cover and a head axis the mesh does not have;
    # head_axis="model" runs the ring on the local heads as they are
    with pytest.raises(ValueError, match="does not cover"):
        make_mesh(MeshSpec(model=2), device="cpu")
    q = torch.randn(1, 4, 2, 4, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="head_axis"):
        ring_self_attention(q, q, q, make_mesh(device="cpu"), head_axis="heads")
    out = ring_self_attention(q, q, q, make_mesh(device="cpu"), head_axis="model")
    torch.testing.assert_close(out, ring.local_attention(q, q, q, causal=False))


def test_trainer_refuses_layers_that_mix_time_steps():
    seq_mesh = Mesh(np.arange(2).reshape(1, 1, 2, 1), 0, torch.device("cpu"), {})
    plain = MultiLayerNetwork(zoo.TransformerLM(**dict(LM, sequence_parallel=False)),
                              device="cpu")
    with pytest.raises(ValueError, match="sequence_parallel"):
        ShardedTrainer(plain, seq_mesh)
    with pytest.raises(ValueError, match="shard_time"):
        ShardedTrainer(MultiLayerNetwork(zoo.TransformerLM(**LM), device="cpu"), seq_mesh,
                       shard_time=False)


def test_global_array_cuts_this_ranks_shard():
    grid = np.arange(8).reshape(2, 1, 4, 1)
    mesh = Mesh(grid, 6, torch.device("cpu"), {})       # data 1, seq 2
    x = np.arange(4 * 8 * 3).reshape(4, 8, 3)
    np.testing.assert_array_equal(global_array(mesh, x, ("data", "seq")), x[2:4, 4:6])
    np.testing.assert_array_equal(global_array(mesh, x), x[2:4])
    with pytest.raises(ValueError, match="divide"):
        global_array(mesh, x[:, :6], ("data", "seq"))


def test_positional_embedding_takes_the_chunks_positions():
    layer = PositionalEmbedding(max_len=8)
    params = {"pos": torch.arange(8 * 2, dtype=torch.float32).reshape(8, 2)}
    x = torch.zeros(1, 4, 2)
    mesh = Mesh(np.arange(2).reshape(1, 1, 2, 1), 1, torch.device("cpu"), {})
    with use_mesh(mesh):
        out, _ = layer.apply(params, {}, x)
    torch.testing.assert_close(out[0], params["pos"][4:8])
    out, _ = layer.apply(params, {}, x)        # no mesh: positions 0..3
    torch.testing.assert_close(out[0], params["pos"][:4])


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _lm_batch(seed=0, B=4, T=8, V=16):
    rs = np.random.RandomState(seed)
    return rs.randint(0, V, (B, T)), np.eye(V, dtype=np.float32)[rs.randint(0, V, (B, T))]


@pytest.mark.parametrize("masked", [False, True])
def test_world_of_one_trainer_equals_fit_batch_bit_for_bit(masked):
    x, y = _lm_batch(2)
    fm = np.ones((4, 8), np.float32)
    if masked:
        fm[1, 5:] = 0.0
    conf = zoo.TransformerLM(**LM, updater=SGD)
    a = MultiLayerNetwork(conf, device="cpu").init()
    b = MultiLayerNetwork(conf, device="cpu").init()
    tr = ShardedTrainer(b, make_mesh(device="cpu"))
    la = [float(a._fit_batch(x, y, fm if masked else None, fm if masked else None))
          for _ in range(3)]
    lb = [float(tr.fit_batch(x, y, fm if masked else None, fm if masked else None))
          for _ in range(3)]
    assert la == lb
    for pa, pb in zip(_leaves(params_to_numpy(a)), _leaves(params_to_numpy(b))):
        np.testing.assert_array_equal(pa, pb)


# -- 4 gloo ranks -------------------------------------------------------------

WORKER = r'''
import pickle, sys
import numpy as np
import torch

torch.set_num_threads(1)
rank, world, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
from deeplearning4j_tpu_torch.interop import params_from_numpy, params_to_numpy
from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration, MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import (
    MeshSpec, ShardedTrainer, global_array, init_distributed, make_mesh,
    ring_self_attention, shutdown_distributed)

init_distributed(f"file://{root}/store", world, rank, device="cpu", timeout_s=90)
mesh = make_mesh(MeshSpec(data=2, seq=2))
with open(f"{root}/inputs.pkl", "rb") as f:
    inp = pickle.load(f)
res = {"coords": mesh.coords}
spec = ("data", "seq")
for name, (q, k, v, km, causal, flash) in inp["ring"].items():
    qt, kt, vt = (torch.from_numpy(np.ascontiguousarray(global_array(mesh, x, spec)))
                  .requires_grad_(True) for x in (q, k, v))
    kmt = torch.from_numpy(np.ascontiguousarray(global_array(mesh, km, spec))) if km is not None else None
    out = ring_self_attention(qt, kt, vt, mesh, causal=causal, kmask=kmt, use_flash=flash)
    w = kmt[:, :, None, None] if kmt is not None else 1.0
    (out * w).square().sum().backward()
    res[name] = [t.detach().numpy() for t in (out, qt.grad, kt.grad, vt.grad)]
model = MultiLayerNetwork(MultiLayerConfiguration.from_json(inp["conf"]), device="cpu")
params_from_numpy(model, inp["params"])
trainer = ShardedTrainer(model, mesh)
x, y = inp["x"], inp["y"]
res["losses"] = [float(trainer.fit_batch(x, y)) for _ in range(3)]
res["params"] = params_to_numpy(model)
res["output"] = trainer.output(x).numpy()
with open(f"{root}/rank{rank}.pkl", "wb") as f:
    pickle.dump(res, f)
shutdown_distributed()
'''

GLOO_RING = {
    # name: (seed, B, T, H, D, causal, lens, flash)
    "plain_causal": (11, 4, 16, 2, 8, True, None, False),
    "plain_masked": (12, 4, 16, 2, 8, False, [16, 11, 3, 9], False),
    "flash_causal": (13, 4, 16, 2, 8, True, None, True),
    "flash_causal_masked": (14, 4, 16, 2, 8, True, [16, 11, 3, 9], True),
}


def _spawn_ranks(root: Path, world: int):
    """Start ``world`` worker processes and join them under one deadline;
    kill them all and fail when it runs out or a rank fails."""
    # the ranks are local: gloo binds to the loopback device, no host lookup
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    procs = []
    for r in range(world):
        log = open(root / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", WORKER, str(r), str(world), str(root)],
            cwd=str(REPO), env=env, stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        for p, _ in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        for p, _ in procs:
            p.kill()
        for p, _ in procs:
            p.wait()
        pytest.fail(f"gloo ranks did not finish within {RANK_TIMEOUT_S} s: "
                    + (root / "rank0.log").read_text()[-2000:])
    finally:
        for _, log in procs:
            log.close()
    for r, (p, _) in enumerate(procs):
        if p.returncode != 0:
            pytest.fail(f"rank {r} exited {p.returncode}:\n"
                        + (root / f"rank{r}.log").read_text()[-4000:])


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    """The 4-rank run and its inputs: JAX params for the TransformerLM, the
    batch, and the ring cases."""
    with pytest.MonkeyPatch.context() as mp:
        _drop_knobs(mp)
        return _gloo_run(tmp_path_factory.mktemp("gloo"))


def _gloo_run(root: Path) -> dict:
    jconf = jzoo.TransformerLM(**LM, updater=SGD)
    jm = JNetwork(jconf).init()
    params = jax.tree_util.tree_map(np.asarray, jm.params)
    x, y = _lm_batch(0)
    cases = {}
    for name, (seed, B, T, H, D, causal, lens, flash) in GLOO_RING.items():
        q, k, v = _qkv(seed, B, T, H, D)
        cases[name] = (q, k, v, _lens_mask(lens, T) if lens else None, causal, flash)
    with open(root / "inputs.pkl", "wb") as f:
        pickle.dump({"ring": cases, "conf": jconf.to_json(), "params": params,
                     "x": x, "y": y}, f)
    _spawn_ranks(root, 4)
    ranks = []
    for r in range(4):
        with open(root / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    # the JAX package's ShardedTrainer on data=2 x seq=2 devices, same params
    jtr = JShardedTrainer(jm, jmake_mesh(JMeshSpec(data=2, seq=2), jax.devices()[:4]))
    jlosses = [float(jtr.fit_batch(x, y)) for _ in range(3)]
    return dict(ranks=ranks, cases=cases, params=params, jlosses=jlosses,
                jparams=jax.tree_util.tree_map(np.asarray, jm.params),
                joutput=np.asarray(jtr.output(x)), x=x, y=y, conf=jconf.to_json())


def _assemble(ranks, pick):
    """Join the 4 ranks' [B/2, T/2, ...] pieces into the global array."""
    grid = [[None, None], [None, None]]
    for res in ranks:
        grid[res["coords"]["data"]][res["coords"]["seq"]] = pick(res)
    return np.concatenate([np.concatenate(row, axis=1) for row in grid], axis=0)


@pytest.mark.parametrize("name", sorted(GLOO_RING))
def test_gloo_ring_equals_the_in_process_ring(gloo_run, name):
    q, k, v, km, causal, flash = gloo_run["cases"][name]
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    kmt = torch.from_numpy(km) if km is not None else None
    out = _port_ring(qt, kt, vt, 2, 2, causal, kmt, flash)
    w = kmt[:, :, None, None] if kmt is not None else 1.0
    (out * w).square().sum().backward()
    want = [out.detach().numpy(), qt.grad.numpy(), kt.grad.numpy(), vt.grad.numpy()]
    ranks = gloo_run["ranks"]
    for i, ref in enumerate(want):
        got = _assemble(ranks, lambda res: res[name][i])
        wm = km[:, :, None, None] if (km is not None and i == 0) else 1.0
        np.testing.assert_allclose(got * wm, ref * wm, **(F32 if i == 0 else GRAD))


def test_gloo_sharded_trainer_losses_match_jax(gloo_run):
    for res in gloo_run["ranks"]:
        np.testing.assert_allclose(res["losses"], gloo_run["jlosses"], rtol=2e-4)


def test_gloo_ranks_keep_bit_equal_params(gloo_run):
    first = _leaves(gloo_run["ranks"][0]["params"])
    for res in gloo_run["ranks"][1:]:
        for pa, pb in zip(first, _leaves(res["params"])):
            np.testing.assert_array_equal(pa, pb)


def test_gloo_params_and_output_match_jax_after_the_steps(gloo_run):
    for pa, pb in zip(_leaves(gloo_run["ranks"][0]["params"]), _leaves(gloo_run["jparams"])):
        np.testing.assert_allclose(pa.ravel(), pb.ravel(), rtol=2e-4, atol=2e-5)
    for res in gloo_run["ranks"]:
        assert res["output"].shape == (4, 8, 16)
        np.testing.assert_allclose(res["output"], gloo_run["joutput"], rtol=2e-4, atol=1e-6)


def test_gloo_losses_equal_one_process_on_the_global_batch(gloo_run):
    """The sharded loss is the global average score: the same 3 steps on
    one process, the whole batch at once, from the same params."""
    m = MultiLayerNetwork(MultiLayerConfiguration.from_json(gloo_run["conf"]), device="cpu")
    params_from_numpy(m, gloo_run["params"])
    single = [float(m._fit_batch(gloo_run["x"], gloo_run["y"], None, None)) for _ in range(3)]
    np.testing.assert_allclose(gloo_run["ranks"][0]["losses"], single, rtol=2e-5)
