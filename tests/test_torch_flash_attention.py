"""The port's flash attention on the CPU (its plain version) against the JAX
package's Pallas kernel in interpret mode, the kernel's logsumexp, and the
non-flash ``local_attention`` path — same numpy inputs into both."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.ops.flash_attention import _flash_raw, _reference
from deeplearning4j_tpu.ops.flash_attention import flash_attention as jflash
from deeplearning4j_tpu.parallel.ring import local_attention as jlocal
from deeplearning4j_tpu_torch.ops import flash_attention as fa

# the shapes of tests/test_flash_attention.py, blocks of 32 there
SHAPES = [(2, 16, 2, 8), (1, 64, 4, 16), (2, 50, 3, 32), (1, 130, 2, 64)]
# f32: as in the JAX package's own kernel tests (summation order differs)
F32 = dict(rtol=1e-5, atol=2e-5)
# bf16: both sides get the same bf16 inputs; the TPU kernel rounds p to
# bf16 before the PV product and the plain version does not, and both
# round the output to bf16 (one ulp is 2**-7 ~= 8e-3 for outputs in [1, 2))
BF16 = dict(rtol=0.0, atol=2e-2)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _qkv(seed, B, T, H, D, scale=0.5):
    rs = np.random.RandomState(seed)
    return tuple(rs.randn(B, T, H, D).astype(np.float32) * s
                 for s in (scale, scale, 1.0))


def _mask(seed, B, T):
    # variable-length padding: every row keeps >= 1 valid key
    rs = np.random.RandomState(seed)
    lens = rs.randint(1, T + 1, B)
    return (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)


def _jax(q, k, v, dtype=jnp.float32, **kw):
    out = jflash(*(jnp.asarray(a, dtype) for a in (q, k, v)), block_q=32,
                 block_k=32, interpret=True, **kw)
    return np.asarray(out.astype(jnp.float32))


def _port(q, k, v, dtype=torch.float32, kmask=None, **kw):
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    km = torch.from_numpy(kmask) if kmask is not None else None
    return fa.flash_attention(*t, kmask=km, **kw).float().numpy()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal", [False, True])
def test_f32_matches_the_jax_kernel(shape, causal):
    q, k, v = _qkv(0, *shape)
    np.testing.assert_allclose(_port(q, k, v, causal=causal),
                               _jax(q, k, v, causal=causal), **F32)


@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[2]])
@pytest.mark.parametrize("causal", [False, True])
def test_kmask_valid_rows_match(shape, causal):
    q, k, v = _qkv(7, *shape)
    km = _mask(7, shape[0], shape[1])
    got = _port(q, k, v, kmask=km, causal=causal)
    want = _jax(q, k, v, kmask=jnp.asarray(km), causal=causal)
    w = km[:, :, None, None]  # padded query rows are unspecified
    np.testing.assert_allclose(got * w, want * w, **F32)


@pytest.mark.parametrize("shape", [SHAPES[1], SHAPES[3]])
@pytest.mark.parametrize("causal", [False, True])
def test_bf16_matches_the_jax_kernel(shape, causal):
    q, k, v = _qkv(3, *shape)
    got = _port(q, k, v, dtype=torch.bfloat16, causal=causal)
    want = _jax(q, k, v, dtype=jnp.bfloat16, causal=causal)
    np.testing.assert_allclose(got, want, **BF16)


@pytest.mark.parametrize("causal", [False, True])
def test_lse_matches_the_kernel_residual(causal):
    B, T, H, D = 2, 50, 3, 32
    q, k, v = _qkv(5, B, T, H, D)
    km = _mask(5, B, T)
    out_j, lse_j = _flash_raw(*(jnp.asarray(a) for a in (q, k, v)),
                              jnp.asarray(km), causal, 32, 32, True,
                              with_lse=True)
    lse_j = np.asarray(lse_j)[:, 0, :T].reshape(B, H, T)
    out, lse = fa.flash_attention_with_lse(
        *(torch.from_numpy(a) for a in (q, k, v)), kmask=torch.from_numpy(km),
        causal=causal)
    assert lse.shape == (B, H, T) and lse.dtype == torch.float32
    w = km[:, None, :]
    np.testing.assert_allclose(lse.numpy() * w, lse_j * w, **F32)
    wo = km[:, :, None, None]
    np.testing.assert_allclose(out.numpy() * wo, np.asarray(out_j) * wo, **F32)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_local_attention_matches_ring_local_attention(causal, masked):
    B, T, H, D = 2, 24, 2, 16
    q, k, v = _qkv(9, B, T, H, D)
    km = _mask(9, B, T) if masked else None
    got = fa.local_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             causal=causal,
                             kmask=torch.from_numpy(km) if masked else None)
    want = jlocal(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                  kmask=jnp.asarray(km) if masked else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("causal", [True, False])
def test_rows_without_a_valid_key_stay_finite_and_match_the_reference(causal):
    # the leading keys of batch 0 are masked (under a causal mask its first
    # 5 queries see no valid key) and batch 1 has no valid key at all:
    # masked scores are -1e30, never -inf, so those rows are finite (the
    # uniform mix of v) and equal the JAX package's _reference on every row,
    # as the CUDA kernel is held to finiteness there on the card
    B, T, H, D = 2, 24, 2, 16
    q, k, v = _qkv(11, B, T, H, D)
    km = np.ones((B, T), np.float32)
    km[0, :5] = 0.0
    km[1] = 0.0
    out, lse = fa.flash_attention_with_lse(
        *(torch.from_numpy(a) for a in (q, k, v)), kmask=torch.from_numpy(km),
        causal=causal)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert (lse[1] < -1e29).all()
    want = _reference(*(jnp.asarray(a) for a in (q, k, v)), causal,
                      kmask=jnp.asarray(km))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0.0, atol=1e-5)


def test_cpu_call_runs_the_plain_version_without_launching():
    before = fa.flash_fwd_cuda.launches
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 16, 2, 8))
    out = fa.flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(
        out, fa.flash_attention_reference(q, k, v, causal=True))
    assert fa.flash_fwd_cuda.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    # no fallback: the wrapper takes CUDA tensors or raises
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 16, 2, 32))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_fwd_cuda(q, k, v)
