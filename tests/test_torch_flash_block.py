"""The port's chunk entries of flash attention on the CPU (their plain
versions) against the JAX package's ``flash_attention_block`` and
``flash_attention_block_grad`` run in interpret mode, and
``merge_attention_blocks`` against JAX's: the cases of
tests/test_flash_attention.py (two-chunk merge, ring-style causal offsets, a
fully masked future chunk, merged-chunk gradients, a chunked key mask) plus
Tq != Tk with both offsets nonzero, gradients taken with both cotangents
(out and lse). Same numpy inputs into both packages."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu_torch.ops import flash_attention as fa

# the module (deeplearning4j_tpu.ops exports a function of the same name)
jfa = importlib.import_module("deeplearning4j_tpu.ops.flash_attention")

# f32: summation order differs (the TPU kernel streams 16-key blocks)
F32 = dict(rtol=1e-5, atol=2e-5)
F32_GRAD = dict(rtol=1e-4, atol=1e-4)
# bf16: both sides round the output to bf16 and the TPU kernel also p
BF16 = dict(rtol=0.0, atol=2e-2)
BLOCKS = dict(block_q=16, block_k=16, interpret=True)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _arrays(seed, *shapes):
    rs = np.random.RandomState(seed)
    return [rs.randn(*s).astype(np.float32) for s in shapes]


def _qkv(seed, B, Tq, Tk, H, D):
    q, k, v = _arrays(seed, (B, Tq, H, D), (B, Tk, H, D), (B, Tk, H, D))
    return q * 0.5, k * 0.5, v


def _t(*xs, dtype=torch.float32):
    return [None if x is None else torch.from_numpy(x).to(dtype) for x in xs]


def _j(*xs, dtype=jnp.float32):
    return [None if x is None else jnp.asarray(x, dtype) for x in xs]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _jblock(q, k, v, kmask=None, **kw):
    out, lse = jfa.flash_attention_block(*_j(q, k, v), kmask=_j(kmask)[0], **BLOCKS, **kw)
    return _np(out), _np(lse)


def _pblock(q, k, v, kmask=None, dtype=torch.float32, **kw):
    qt, kt, vt = _t(q, k, v, dtype=dtype)
    km = _t(kmask)[0]
    out, lse = fa.flash_attention_block(qt, kt, vt, kmask=km, **kw)
    return _np(out), _np(lse)


def _valid_rows(Tq, Tk, q_offset, k_offset, causal, kmask):
    """[B or 1, Tq]: query rows with at least one valid key."""
    ok = np.ones((Tq, Tk), bool)
    if causal:
        ok = (k_offset + np.arange(Tk))[None, :] <= (q_offset + np.arange(Tq))[:, None]
    ok = ok[None]
    if kmask is not None:
        ok = ok & (kmask[:, None, :] > 0)
    return ok.any(-1)


BLOCK_CASES = [
    # (B, Tq, Tk, H, D, q_offset, k_offset, causal, masked)
    (2, 32, 32, 2, 16, 0, 0, True, False),       # the ring's diagonal block
    (2, 32, 32, 2, 16, 32, 0, True, False),      # a past block under causal
    (2, 32, 32, 2, 16, 0, 0, False, True),       # the off-diagonal block, kmask
    (2, 24, 40, 2, 16, 40, 16, True, False),     # Tq != Tk, both offsets nonzero
    (1, 40, 24, 2, 8, 8, 20, True, True),        # Tq > Tk, shifted diagonal, kmask
    (2, 20, 36, 3, 16, 0, 36, True, False),      # a chunk wholly in the future
]


def _mask_for(B, Tk, seed):
    rs = np.random.RandomState(seed)
    lens = rs.randint(1, Tk + 1, B)
    return (np.arange(Tk)[None, :] < lens[:, None]).astype(np.float32)


@pytest.mark.parametrize("case", BLOCK_CASES)
def test_block_forward_matches_the_jax_kernel(case):
    B, Tq, Tk, H, D, qo, ko, causal, masked = case
    q, k, v = _qkv(1, B, Tq, Tk, H, D)
    km = _mask_for(B, Tk, 1) if masked else None
    kw = dict(q_offset=qo, k_offset=ko, causal=causal)
    got, got_lse = _pblock(q, k, v, km, **kw)
    want, want_lse = _jblock(q, k, v, km, **kw)
    assert got.shape == (B, Tq, H, D) and got_lse.shape == (B, H, Tq)
    rows = _valid_rows(Tq, Tk, qo, ko, causal, km)            # [B or 1, Tq]
    w = np.broadcast_to(rows, (B, Tq))[:, :, None, None]
    np.testing.assert_allclose(got * w, want * w, **F32)
    wl = np.broadcast_to(rows, (B, Tq))[:, None, :]
    np.testing.assert_allclose(got_lse * wl, want_lse * wl, rtol=1e-5, atol=1e-4)
    # a row with no valid key: lse at or below -1e29 on both sides (weight 0)
    dead = np.broadcast_to(~rows, (B, Tq))[:, None, :].repeat(H, 1)
    assert np.all(got_lse[dead] <= -1e29) and np.all(want_lse[dead] <= -1e29)
    assert np.all(np.isfinite(got))


@pytest.mark.parametrize("case", [BLOCK_CASES[0], BLOCK_CASES[3]])
def test_block_forward_bf16_matches_the_jax_kernel(case):
    B, Tq, Tk, H, D, qo, ko, causal, _ = case
    q, k, v = _qkv(2, B, Tq, Tk, H, D)
    kw = dict(q_offset=qo, k_offset=ko, causal=causal)
    got, got_lse = _pblock(q, k, v, dtype=torch.bfloat16, **kw)
    out, lse = jfa.flash_attention_block(*_j(q, k, v, dtype=jnp.bfloat16), **BLOCKS, **kw)
    np.testing.assert_allclose(got, _np(out), **BF16)
    np.testing.assert_allclose(got_lse, _np(lse), rtol=0, atol=2e-2)


def _jvjp(q, k, v, kmask, do, dlse, dtype=jnp.float32, **kw):
    def f(q, k, v):
        return jfa.flash_attention_block_grad(q, k, v, kmask=_j(kmask)[0], **BLOCKS, **kw)
    _, vjp = jax.vjp(f, *_j(q, k, v, dtype=dtype))
    return [_np(g) for g in vjp((jnp.asarray(do, dtype), jnp.asarray(dlse)))]


def _pvjp(q, k, v, kmask, do, dlse, dtype=torch.float32, **kw):
    qt, kt, vt = (x.requires_grad_(True) for x in _t(q, k, v, dtype=dtype))
    out, lse = fa.flash_attention_block_grad(qt, kt, vt, kmask=_t(kmask)[0], **kw)
    torch.autograd.backward((out, lse), (torch.from_numpy(do).to(dtype),
                                         torch.from_numpy(dlse)))
    return [_np(x.grad) for x in (qt, kt, vt)]


@pytest.mark.parametrize("case", BLOCK_CASES)
def test_block_grad_with_both_cotangents_matches_jax(case):
    B, Tq, Tk, H, D, qo, ko, causal, masked = case
    q, k, v = _qkv(3, B, Tq, Tk, H, D)
    km = _mask_for(B, Tk, 3) if masked else None
    do, dlse = _arrays(4, (B, Tq, H, D), (B, H, Tq))
    kw = dict(q_offset=qo, k_offset=ko, causal=causal)
    got = _pvjp(q, k, v, km, do, dlse, **kw)
    want = _jvjp(q, k, v, km, do, dlse, **kw)
    for a, b, shape in zip(got, want, ((B, Tq, H, D), (B, Tk, H, D), (B, Tk, H, D))):
        assert a.shape == shape
        np.testing.assert_allclose(a, b, **F32_GRAD)
    rows = np.broadcast_to(_valid_rows(Tq, Tk, qo, ko, causal, km), (B, Tq))
    assert np.all(got[0][~rows] == 0.0)        # no valid key: dq exactly 0


def test_block_grad_bf16_matches_jax():
    B, Tq, Tk, H, D, qo, ko, causal, _ = BLOCK_CASES[3]
    q, k, v = _qkv(5, B, Tq, Tk, H, D)
    do, dlse = _arrays(6, (B, Tq, H, D), (B, H, Tq))
    kw = dict(q_offset=qo, k_offset=ko, causal=causal)
    got = _pvjp(q, k, v, None, do, dlse, dtype=torch.bfloat16, **kw)
    want = _jvjp(q, k, v, None, do, dlse, dtype=jnp.bfloat16, **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-2 * max(1.0, np.abs(b).max()))


def _full_reference(q, k, v, causal, kmask=None):
    return _np(jfa._reference(*_j(q, k, v), causal, kmask=_j(kmask)[0]))


def test_two_chunk_merge_equals_full():
    B, T, H, D = 2, 64, 2, 16
    q, k, v = _qkv(0, B, T, T, H, D)
    h = T // 2
    qt, kt, vt = _t(q, k, v)
    parts = [fa.flash_attention_block(qt, kt[:, :h], vt[:, :h], q_offset=0, k_offset=0),
             fa.flash_attention_block(qt, kt[:, h:], vt[:, h:], q_offset=0, k_offset=h)]
    merged = _np(fa.merge_attention_blocks(parts))
    np.testing.assert_allclose(merged, _full_reference(q, k, v, False), **F32)
    jparts = [jfa.flash_attention_block(*_j(q, k[:, :h], v[:, :h]), q_offset=0,
                                        k_offset=0, **BLOCKS),
              jfa.flash_attention_block(*_j(q, k[:, h:], v[:, h:]), q_offset=0,
                                        k_offset=h, **BLOCKS)]
    np.testing.assert_allclose(merged, _np(jfa.merge_attention_blocks(jparts)), **F32)


def test_causal_offsets_ring_style():
    """The second shard's queries (offset T/2) attend chunk 0 fully and
    chunk 1 causally; merged, they equal those rows of full causal
    attention."""
    B, T, H, D = 2, 64, 2, 16
    q, k, v = _qkv(1, B, T, T, H, D)
    h = T // 2
    qt, kt, vt = _t(q[:, h:], k, v)
    parts = [fa.flash_attention_block(qt, kt[:, :h], vt[:, :h], q_offset=h, k_offset=0,
                                      causal=True),
             fa.flash_attention_block(qt, kt[:, h:], vt[:, h:], q_offset=h, k_offset=h,
                                      causal=True)]
    merged = _np(fa.merge_attention_blocks(parts))
    np.testing.assert_allclose(merged, _full_reference(q, k, v, True)[:, h:], **F32)


def test_fully_masked_future_chunk_vanishes():
    B, T, H, D = 1, 32, 2, 16
    q, k, v = _qkv(2, B, T, T, H, D)
    qt, kt, vt = _t(q, k, v)
    own = fa.flash_attention_block(qt, kt, vt, q_offset=0, k_offset=0, causal=True)
    future = fa.flash_attention_block(qt, kt, vt, q_offset=0, k_offset=T, causal=True)
    assert bool((future[1] <= -1e29).all())
    merged = _np(fa.merge_attention_blocks([own, future]))
    assert np.all(np.isfinite(merged))
    np.testing.assert_allclose(merged, _full_reference(q, k, v, True), **F32)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T", [64, 40])     # 40: chunks of 20
def test_merged_chunk_grads_equal_full(causal, T):
    B, H, D = 2, 2, 16
    q, k, v = _qkv(0, B, T, T, H, D)
    h = T // 2
    qt, kt, vt = (x.requires_grad_(True) for x in _t(q, k, v))
    parts = [fa.flash_attention_block_grad(qt, kt[:, :h], vt[:, :h], q_offset=0,
                                           k_offset=0, causal=causal),
             fa.flash_attention_block_grad(qt, kt[:, h:], vt[:, h:], q_offset=0,
                                           k_offset=h, causal=causal)]
    fa.merge_attention_blocks(parts).square().sum().backward()

    def loss_chunked(q, k, v):
        p0 = jfa.flash_attention_block_grad(q, k[:, :h], v[:, :h], q_offset=0,
                                            k_offset=0, causal=causal, **BLOCKS)
        p1 = jfa.flash_attention_block_grad(q, k[:, h:], v[:, h:], q_offset=0,
                                            k_offset=h, causal=causal, **BLOCKS)
        return jnp.sum(jfa.merge_attention_blocks([p0, p1]) ** 2)

    def loss_full(q, k, v):
        return jnp.sum(jfa._reference(q, k, v, causal) ** 2)

    chunked = jax.jit(jax.grad(loss_chunked, argnums=(0, 1, 2)))(*_j(q, k, v))
    full = jax.jit(jax.grad(loss_full, argnums=(0, 1, 2)))(*_j(q, k, v))
    for x, a, b in zip((qt, kt, vt), chunked, full):
        np.testing.assert_allclose(_np(x.grad), _np(a), **F32_GRAD)
        np.testing.assert_allclose(_np(x.grad), _np(b), rtol=2e-4, atol=5e-4)


def test_chunked_block_kmask_merge_equals_full():
    B, T, H, D = 2, 32, 2, 8
    q, k, v = _qkv(11, B, T, T, H, D)
    km = _mask_for(B, T, 11)
    h = T // 2
    qt, kt, vt, kmt = _t(q, k, v, km)
    parts = [fa.flash_attention_block_grad(qt, kt[:, :h], vt[:, :h], kmask=kmt[:, :h]),
             fa.flash_attention_block_grad(qt, kt[:, h:], vt[:, h:], kmask=kmt[:, h:],
                                           k_offset=h)]
    out = _np(fa.merge_attention_blocks(parts))
    w = km[:, :, None, None]
    np.testing.assert_allclose(out * w, _full_reference(q, k, v, False, km) * w,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_attention_blocks_matches_jax(dtype):
    B, T, H, D, N = 2, 12, 3, 8, 3
    rs = np.random.RandomState(9)
    outs = [rs.randn(B, T, H, D).astype(np.float32) for _ in range(N)]
    lses = [rs.randn(B, H, T).astype(np.float32) * 3 for _ in range(N)]
    lses[2][:, :, :4] = -1e30                  # a part with rows of weight 0
    got = fa.merge_attention_blocks(
        [(torch.from_numpy(o).to(getattr(torch, dtype)), torch.from_numpy(l))
         for o, l in zip(outs, lses)])
    want = jfa.merge_attention_blocks(
        [(jnp.asarray(o, getattr(jnp, dtype)), jnp.asarray(l)) for o, l in zip(outs, lses)])
    assert got.dtype == getattr(torch, dtype)
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_block_entries_count_no_launch_on_the_cpu():
    q, k, v = _t(*_qkv(0, 1, 8, 8, 1, 8))
    before = dict(fa.CHUNK_LAUNCHES)
    fa.flash_attention_block(q, k, v, causal=True)
    fa.flash_attention_block_grad(q.requires_grad_(True), k, v)[0].sum().backward()
    assert fa.CHUNK_LAUNCHES == before


def test_kmask_gets_no_gradient_and_dlse_none_reads_as_zero():
    B, T, H, D = 1, 16, 2, 8
    q, k, v = _qkv(7, B, T, T, H, D)
    qt, kt, vt = (x.requires_grad_(True) for x in _t(q, k, v))
    km = torch.ones(B, T, requires_grad=True)
    out, lse = fa.flash_attention_block_grad(qt, kt, vt, kmask=km, causal=True)
    out.sum().backward()        # lse unused: its cotangent reads as 0
    assert km.grad is None
    do, dlse = np.ones((B, T, H, D), np.float32), np.zeros((B, H, T), np.float32)
    want = _jvjp(q, k, v, np.ones((B, T), np.float32), do, dlse, causal=True)
    for x, b in zip((qt, kt, vt), want):
        np.testing.assert_allclose(_np(x.grad), b, **F32_GRAD)
