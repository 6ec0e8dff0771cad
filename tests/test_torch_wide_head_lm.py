"""The wide-head path (head dims past 256) on the CPU: a TransformerLM
whose heads are 320 and 300 wide (d_model 640 and 600, 2 heads) against
the JAX package's under ``jax.jit``, forward and one Adam step from the
same numpy weights (``interop.params_from_numpy``); and the launch plan of
the wide-head kernels (``ops/flash_attention.py`` ``wide_plan``) for every
head dim the route takes from 320 to 8192: the column groups cover D, each
layout fits one block's shared memory, and no consumer warpgroup holds
more f32 accumulator registers than the budget."""

import os

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JNetwork
from deeplearning4j_tpu_torch.interop import params_from_numpy, params_to_numpy
from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration, MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import flash_attention as fa

VOCAB, T, ROWS = 64, 16, 2
# f32 on the CPU: the JAX package attends through XLA, the port through the
# flash plain version; both sum a 300-320 wide head in f32, in other orders
F32 = dict(rtol=1e-5, atol=1e-6)
ADAM = {"type": "adam", "lr": 1e-3}
SMEM_LIMIT = 232448


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    # another test module may leave tuning knobs in os.environ
    for k in list(os.environ):
        if k.startswith("DL4J_TPU_"):
            monkeypatch.delenv(k)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _pair(d_model):
    """(JAX network, port network) of a 1-block TransformerLM with 2 heads
    of d_model / 2 columns, the same f32 weights in both."""
    jconf = jzoo.TransformerLM(vocab_size=VOCAB, max_len=T, d_model=d_model, n_heads=2,
                               n_blocks=1, dtype="float32", seed=7, updater=ADAM)
    jm = JNetwork(jconf).init()
    m = MultiLayerNetwork(MultiLayerConfiguration.from_json(jconf.to_json()),
                          device="cpu").init()
    params_from_numpy(m, jax.tree_util.tree_map(np.asarray, jm.params))
    return jm, m


def _flat(tree):
    out = {}

    def walk(d, path):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(v, f"{path}.{k}")
            else:
                out[f"{path}.{k}"] = np.asarray(v)

    for i, layer in enumerate(tree):
        walk(layer, str(i))
    return out


@pytest.mark.parametrize("d_model", [640, 600], ids=["D320", "D300"])
def test_wide_head_lm_output_matches_jax(d_model):
    jm, m = _pair(d_model)
    x = np.random.RandomState(1).randint(0, VOCAB, (ROWS, T))
    got = m.output(x)
    assert fa.kernel_head_dim(d_model // 2, torch.bfloat16) == 320
    assert got.shape == (ROWS, T, VOCAB) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.jit(jm.output)(x)), **F32)


# Adam's first step is lr * g / (|g| + eps): where a gradient is within ~100x
# of the f32 noise of the sums that make it (~1e-7 here), the step turns on
# that noise (it read up to 0.12 lr apart at |g| = 1.2e-6, and the key third
# of bqkv, whose gradient is pure noise, at random signs). Those entries are
# held through their gradients; the rest through the stepped params.
# gradients: f32 sums of ~640-wide products in other orders (a position
# embedding's entry read 2.7e-6 apart at D = 320)
GRAD_TOL = dict(rtol=1e-4, atol=5e-6)
WELL_CONDITIONED = 1e-5


@pytest.mark.parametrize("d_model", [640, 600], ids=["D320", "D300"])
def test_wide_head_lm_adam_step_matches_jax(d_model):
    """Gradients of one batch against ``jax.grad`` under ``jax.jit``, then
    one Adam step in each package (the JAX package's jitted ``_fit_batch``)
    and the params after it."""
    jm, m = _pair(d_model)
    x = np.random.RandomState(2).randint(0, VOCAB, (ROWS, T))
    y = np.roll(x, -1, axis=1)
    before = {k: v.copy() for k, v in _flat(params_to_numpy(m)).items()}
    jgrads = jax.jit(jax.grad(lambda p: jm._loss(p, jm.state, x, y, None, None, None)[0]))(
        jm.params)
    _, _, grads, _ = m._value_and_grad(m.state, torch.from_numpy(x), torch.from_numpy(y),
                                       None, None, None)
    gj = _flat(jax.tree_util.tree_map(np.asarray, jgrads))
    gp = _flat(tuple(jax.tree_util.tree_map(lambda g: g.detach().numpy(), g) for g in grads))
    assert gp.keys() == gj.keys()
    for key in gj:
        np.testing.assert_allclose(gp[key], gj[key], err_msg=key, **GRAD_TOL)

    jm._fit_batch(x, y, None, None)
    m._fit_batch(torch.from_numpy(x), torch.from_numpy(y), None, None)
    want = _flat(jax.tree_util.tree_map(np.asarray, jm.params))
    got = _flat(params_to_numpy(m))
    assert got.keys() == want.keys()
    held = total = 0
    for key in want:
        keep = np.abs(gj[key]) >= WELL_CONDITIONED
        held += int(keep.sum())
        total += keep.size
        np.testing.assert_allclose(got[key][keep], want[key][keep], err_msg=key, **F32)
        assert np.all(got[key][keep] != before[key][keep]), key   # the step moved them
    assert held >= 0.99 * total, (held, total)


# -- the wide-head launch plan ---------------------------------------------------

WIDE_DIMS = range(320, 8192 + 1, 64)
DTYPES = [torch.bfloat16, torch.float16, torch.float32]


@pytest.mark.parametrize("kernel", fa.WIDE_KERNELS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f16", "f32"])
def test_wide_plan_covers_fits_and_keeps_the_register_budget(kernel, dtype):
    route = "wgmma" if dtype != torch.float32 else "tiles"
    for D in WIDE_DIMS:
        plan = fa.wide_plan(kernel, D, dtype)
        assert plan.kernel == kernel and plan.route == route, D
        assert sum(plan.groups) == D, (D, plan)
        assert all(g > 0 and g % 64 == 0 for g in plan.groups), (D, plan)
        # as even as 64-column boxes allow: all but the last equal, the last no wider
        assert all(g == plan.group_width for g in plan.groups[:-1]), (D, plan)
        assert plan.groups[-1] <= plan.group_width, (D, plan)
        assert plan.smem_bytes <= SMEM_LIMIT, (D, plan)
        if route == "wgmma":
            # a forward or dq warpgroup sums at most 256 output columns for
            # its own 64 rows (64 x 256 f32: 128 registers a thread, 128
            # rows a block); a dk/dv warpgroup 128 columns of dK and of dV
            # for the block's 64 key rows (2 x 64 x 128 f32: 128 registers)
            assert plan.rows == (64 if kernel == "dkv" else 128)
            assert plan.group_width <= 256, (D, plan)
            assert 0 < plan.acc_registers <= fa.WIDE_ACC_REGISTERS, (D, plan)
            assert plan.acc_registers == (128 if kernel == "dkv" else plan.group_width // 2)
            # a score step's boxes and the previous step's: the forward's 4
            # resident chunks of K; dq's 2 chunks of Q (both row halves) and
            # K; dk/dv's 8
            assert plan.slots >= {"fwd": 4, "dq": 12, "dkv": 8}[kernel], (D, plan)
            # dq streams Q (resident it left 8 slots and ran slower)
            assert plan.resident == (D <= 512 and kernel != "dq"), (D, plan)
        else:
            # blocks of 256 threads, the output tile in registers: the
            # forward's O and dq's dQ for 64 query rows (64 x G / 256 f32 a
            # thread), dk/dv's dK and dV for 32 key rows (2 x 32 x G / 256):
            # 128 at G = 512; every operand streams through a ring of slots
            # of two 64 x 64 f32 chunks (dk/dv: two chunks of 32 K rows and
            # of 64 Q rows), 3 for the forward, 2 for dq and dk/dv
            assert plan.rows == (32 if kernel == "dkv" else 64), (D, plan)
            assert plan.slots == (3 if kernel == "fwd" else 2), (D, plan)
            assert not plan.resident, (D, plan)
            assert plan.group_width <= 512, (D, plan)
            assert len(plan.groups) == -(-D // 512), (D, plan)
            assert 0 < plan.acc_registers <= fa.WIDE_ACC_REGISTERS, (D, plan)
            assert plan.acc_registers == plan.group_width // 4, (D, plan)
            # ring, four groups' partial scores, p and two f32 a row (lse and
            # delta; the forward's running max and sum), or dk/dv's p^T and
            # ds^T of 32 keys
            ring = 2 * 2 * 96 * 68 * 4 if kernel == "dkv" else plan.slots * 2 * 17408
            rest = 2 * 32 * 72 * 4 if kernel == "dkv" else 64 * 72 * 4 + 512
            assert plan.smem_bytes == ring + 4 * 18432 + rest, (D, plan)


def test_wide_plan_at_the_flagship_widths():
    """D = 512 (the 4-head flagship): the 16-bit forward, dq and dk/dv each
    in two groups of 256 columns that recompute the scores (the forward
    1.5x its products, dq 1.67x), the forward's Q (128 rows) and dk/dv's K
    and V resident, dq's Q streamed; the bytes the layouts take; the f32
    forward, dq and dk/dv on register tiles in one group of 512 columns."""
    fwd = fa.wide_plan("fwd", 512, torch.bfloat16)
    assert (fwd.rows, fwd.groups, fwd.resident, fwd.slots) == (128, (256, 256), True, 12)
    assert fwd.smem_bytes == 131072 + 12 * 8192 + 25 * 8 + 1024
    dkv = fa.wide_plan("dkv", 512, torch.bfloat16)
    assert (dkv.rows, dkv.groups, dkv.resident, dkv.slots) == (64, (256, 256), True, 10)
    assert dkv.smem_bytes == 131072 + 16384 + 10 * 8192 + 21 * 8 + 1024
    dq = fa.wide_plan("dq", 512, torch.bfloat16)
    assert (dq.route, dq.rows, dq.groups, dq.resident, dq.slots) == ("wgmma", 128, (256, 256),
                                                                     False, 24)
    # each consumer thread's 32 f32 of p, the ring, the barriers
    assert dq.smem_bytes == 32768 + 24 * 8192 + 49 * 8 + 1024
    assert dq.acc_registers == 128
    assert fa.wide_plan("dq", 512, torch.float16) == dq
    f32 = fa.wide_plan("fwd", 512, torch.float32)
    assert (f32.route, f32.rows, f32.groups, f32.resident, f32.slots) == ("tiles", 64,
                                                                          (512,), False, 3)
    # 3 slots of a K and a Q chunk, four partial score tiles, p, m and l
    assert f32.smem_bytes == 3 * 2 * 17408 + 5 * 18432 + 512 and f32.acc_registers == 128
    f32dq = fa.wide_plan("dq", 512, torch.float32)
    assert (f32dq.route, f32dq.rows, f32dq.groups, f32dq.slots) == ("tiles", 64, (512,), 2)
    # the forward's layout with one slot fewer
    assert f32dq.smem_bytes == f32.smem_bytes - 2 * 17408 and f32dq.acc_registers == 128
    f32dkv = fa.wide_plan("dkv", 512, torch.float32)
    # 32 own key rows: dK and dV 2 x 32 x 512 f32 over 256 threads; 2 slots
    # of two K and two Q chunks; p^T and ds^T (2 x 32 rows) where the
    # forward and dq keep p (64 rows) and two f32 a row
    assert (f32dkv.route, f32dkv.rows, f32dkv.groups, f32dkv.slots) == ("tiles", 32, (512,), 2)
    assert f32dkv.smem_bytes == 2 * 52224 + 4 * 18432 + 2 * 32 * 72 * 4
    assert f32dkv.acc_registers == 128 and f32dkv.smem_bytes <= SMEM_LIMIT
    assert fa.wide_plan("dkv", 320, torch.float16).groups == (192, 128)


@pytest.mark.parametrize("kernel,D,dtype", [("dq", 256, torch.bfloat16),
                                            ("fwd", 330, torch.bfloat16),
                                            ("fwd", 512, torch.float64),
                                            ("dkv_", 512, torch.bfloat16)])
def test_wide_plan_refuses_what_the_route_does_not_take(kernel, D, dtype):
    with pytest.raises(ValueError):
        fa.wide_plan(kernel, D, dtype)
