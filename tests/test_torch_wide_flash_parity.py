"""The port's flash attention at head dims past 256 (the wide-head route's
width: D = 320, and D = 300, which the kernels zero-pad to 320) on the CPU,
where it runs the plain versions (``flash_attention_reference`` and
``flash_attention_bwd_reference``), against the JAX package's Pallas
kernels in interpret mode (blocks of 16): the forward's out and lse
through the chunk entry ``flash_attention_block``, the gradients of
``flash_attention`` (``bwd="pallas"``), and the chunk entry's gradients
under both cotangents (out's and the lse's) with Tq != Tk and offsets. The
same numpy inputs go into both, in float32 and bfloat16, causal and with a
key mask."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.ops.flash_attention import flash_attention as jflash
from deeplearning4j_tpu.ops.flash_attention import flash_attention_block as jblock
from deeplearning4j_tpu.ops.flash_attention import flash_attention_block_grad as jblock_grad
from deeplearning4j_tpu_torch.ops import flash_attention as fa

# f32: the Pallas kernels sum blockwise, the plain versions over the whole
# row (as in tests/test_torch_flash_backward.py)
F32 = dict(rtol=1e-5, atol=2e-5)
# bf16: both round p and ds to bf16 before their products and the results
# to bf16, in other orders: about one bf16 ulp of an O(1) value
BF16 = dict(rtol=0.0, atol=2e-2)
TOL = {torch.float32: F32, torch.bfloat16: BF16}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
B, T, H = 2, 24, 1
BLOCK = dict(block_q=16, block_k=16, interpret=True)
# (causal, key mask): causal alone; a variable-length mask (lengths >= 1);
# causal with the first 5 keys of batch 0 masked, so its first 5 queries
# see no key at all
CASES = {"causal": (True, None), "varlen": (False, "varlen"), "leading": (True, "leading")}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _inputs(seed, D, Tq=T, Tk=T):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, Tq, H, D).astype(np.float32) * 0.5
    k = rs.randn(B, Tk, H, D).astype(np.float32) * 0.5
    v = rs.randn(B, Tk, H, D).astype(np.float32)
    do = rs.randn(B, Tq, H, D).astype(np.float32)
    return q, k, v, do


def _kmask(kind, Tk=T):
    if kind is None:
        return None
    km = np.ones((B, Tk), np.float32)
    if kind == "varlen":
        km[0, 17:] = 0.0
        km[1, 9:] = 0.0
    else:
        km[0, :5] = 0.0
    return km


def _rows_with_a_key(km, causal):
    """[B, T] 1.0 where a query row sees a valid key (queries and keys
    aligned, offsets 0)."""
    if km is None:
        return np.ones((B, T), np.float32)
    valid = km > 0
    seen = np.maximum.accumulate(valid, axis=1) if causal else valid.any(1, keepdims=True)
    return np.broadcast_to(seen, (B, T)).astype(np.float32)


def _np(x):
    return np.asarray(x.astype(jnp.float32)) if isinstance(x, jax.Array) else x.float().numpy()


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [320, 300])
def test_wide_forward_matches_the_pallas_kernel(D, dtype, case):
    causal, kind = CASES[case]
    q, k, v, _ = _inputs(D, D)
    km = _kmask(kind)
    jout, jlse = jblock(
        *(jnp.asarray(a, JDT[dtype]) for a in (q, k, v)),
        kmask=None if km is None else jnp.asarray(km), causal=causal, **BLOCK)
    out, lse = fa.flash_attention_block(
        *(torch.from_numpy(a).to(dtype) for a in (q, k, v)),
        kmask=None if km is None else torch.from_numpy(km), causal=causal)
    assert fa.kernel_head_dim(D, dtype) == 320
    assert out.shape == (B, T, H, D) and out.dtype == dtype and lse.dtype == torch.float32
    rows = _rows_with_a_key(km, causal)
    np.testing.assert_allclose(_np(out) * rows[:, :, None, None],
                               _np(jout) * rows[:, :, None, None], **TOL[dtype])
    np.testing.assert_allclose(_np(lse) * rows[:, None, :], _np(jlse) * rows[:, None, :],
                               rtol=1e-5, atol=1e-4)
    # rows that see no key: an lse the merge weighs with exactly 0, in both
    assert np.all(_np(lse)[rows[:, None, :].repeat(H, 1) == 0] <= -1e29)
    assert np.all(_np(jlse)[rows[:, None, :].repeat(H, 1) == 0] <= -1e29)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [320, 300])
def test_wide_grads_match_the_pallas_backward(D, dtype, case):
    causal, kind = CASES[case]
    q, k, v, do = _inputs(D + 1, D)
    km = _kmask(kind)
    jargs = [jnp.asarray(a, JDT[dtype]) for a in (q, k, v)]
    jkm = None if km is None else jnp.asarray(km)
    _, vjp = jax.vjp(lambda *a: jflash(*a, kmask=jkm, causal=causal, bwd="pallas", **BLOCK),
                     *jargs)
    want = vjp(jnp.asarray(do, JDT[dtype]))
    t = [torch.from_numpy(a).to(dtype).requires_grad_(True) for a in (q, k, v)]
    out = fa.flash_attention(*t, kmask=None if km is None else torch.from_numpy(km),
                             causal=causal)
    out.backward(torch.from_numpy(do).to(dtype))
    for name, a, b in zip("qkv", t, want):
        assert a.grad.dtype == dtype
        np.testing.assert_allclose(_np(a.grad), _np(b), err_msg=f"d{name}", **TOL[dtype])
    if kind == "leading":   # queries that see no key get exactly 0
        assert not t[0].grad[0, :5].float().any()


@pytest.mark.parametrize("D", [320, 300])
def test_wide_chunk_entry_grads_with_the_lse_cotangent(D):
    """The chunk entry as the ring calls it (Tq != Tk, queries at offset 40,
    keys at 16, causal, a key mask): gradients under the cotangents of both
    out and lse (delta_eff = rowsum(do * out) - dlse), f32."""
    Tq, Tk, q_off, k_off = 20, 28, 40, 16
    q, k, v, do = _inputs(D + 2, D, Tq, Tk)
    km = np.ones((B, Tk), np.float32)
    km[1, 21:] = 0.0
    dlse = np.random.RandomState(D).randn(B, H, Tq).astype(np.float32)
    kw = dict(q_offset=q_off, k_offset=k_off, causal=True)
    _, vjp = jax.vjp(lambda *a: jblock_grad(*a, kmask=jnp.asarray(km), **kw, **BLOCK),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    t = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out, lse = fa.flash_attention_block_grad(*t, kmask=torch.from_numpy(km), **kw)
    torch.autograd.backward((out, lse), (torch.from_numpy(do), torch.from_numpy(dlse)))
    for name, a, b in zip("qkv", t, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), err_msg=f"d{name}", **F32)
