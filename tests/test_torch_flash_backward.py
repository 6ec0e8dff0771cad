"""The port's differentiable flash attention on the CPU (its plain backward,
``flash_attention_bwd_reference``, behind ``_FlashAttention``) against
``jax.vjp`` of the JAX package's Pallas kernels in interpret mode
(``bwd="pallas"``, blocks of 16) — the same numpy q, k, v and cotangent
into both."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.ops.flash_attention import flash_attention as jflash
from deeplearning4j_tpu_torch.ops import flash_attention as fa

# f32: summation order differs (the kernels sum blockwise, the plain version
# over the whole row), as in the JAX package's own backward tests
F32 = dict(rtol=1e-5, atol=2e-5)
# bf16: both sides round p and ds to bf16 before their products and the
# grads to bf16; they sum in other orders, which moves a grad of order 1
# by about one bf16 ulp (2**-7 ~= 8e-3 in [1, 2))
BF16 = dict(rtol=0.0, atol=2e-2)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _inputs(seed, B, T, H, D):
    rs = np.random.RandomState(seed)
    q, k = (rs.randn(B, T, H, D).astype(np.float32) * 0.5 for _ in range(2))
    v, do = (rs.randn(B, T, H, D).astype(np.float32) for _ in range(2))
    return q, k, v, do


def _jax_grads(q, k, v, do, dtype, kmask=None, causal=False):
    args = [jnp.asarray(a, dtype) for a in (q, k, v)]
    km = jnp.asarray(kmask) if kmask is not None else None

    def f(q_, k_, v_):
        return jflash(q_, k_, v_, kmask=km, causal=causal, block_q=16,
                      block_k=16, interpret=True, bwd="pallas")

    _, vjp = jax.vjp(f, *args)
    return [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(do, dtype))]


def _port_grads(q, k, v, do, dtype, kmask=None, causal=False):
    t = [torch.from_numpy(a).to(dtype).requires_grad_(True) for a in (q, k, v)]
    km = torch.from_numpy(kmask) if kmask is not None else None
    out = fa.flash_attention(*t, kmask=km, causal=causal)
    out.backward(torch.from_numpy(do).to(dtype))
    return [x.grad.float().numpy() for x in t]


# T=20 and T=37 are not multiples of the 16-row blocks
@pytest.mark.parametrize("shape", [(2, 20, 2, 8), (1, 37, 3, 16)])
@pytest.mark.parametrize("causal", [False, True])
def test_f32_grads_match_the_pallas_backward(shape, causal):
    q, k, v, do = _inputs(0, *shape)
    got = _port_grads(q, k, v, do, torch.float32, causal=causal)
    want = _jax_grads(q, k, v, do, jnp.float32, causal=causal)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, b, err_msg=f"d{name}", **F32)


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_grads_match_the_pallas_backward(causal):
    q, k, v, do = _inputs(1, 2, 24, 2, 16)
    got = _port_grads(q, k, v, do, torch.bfloat16, causal=causal)
    want = _jax_grads(q, k, v, do, jnp.bfloat16, causal=causal)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, b, err_msg=f"d{name}", **BF16)


@pytest.mark.parametrize("causal", [False, True])
def test_rows_without_valid_keys_get_exact_zero_grads(causal):
    B, T, H, D = 2, 21, 2, 8
    q, k, v, do = _inputs(2, B, T, H, D)
    km = np.ones((B, T), np.float32)
    km[0, :4] = 0.0      # causal: queries 0-3 of batch 0 see no valid key
    km[0, 15:] = 0.0     # variable-length padding
    km[1] = 0.0          # batch 1 has no valid key at all
    got = _port_grads(q, k, v, do, torch.float32, kmask=km, causal=causal)
    want = _jax_grads(q, k, v, do, jnp.float32, kmask=km, causal=causal)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, b, err_msg=f"d{name}", **F32)
    dq, dk, dv = got
    assert not dq[1].any() and not dk[1].any() and not dv[1].any()
    assert not dk[0, :4].any() and not dv[0, 15:].any()
    if causal:
        assert not dq[0, :4].any()


def test_bwd_reference_matches_autograd_where_every_row_has_a_key():
    # without fully masked rows the kernels' formulas are the exact
    # gradient of the plain forward
    q, k, v, do = (torch.from_numpy(a).double() for a in _inputs(3, 2, 19, 2, 8))
    km = torch.from_numpy((np.arange(19)[None, :] < np.array([[19], [11]])).astype(np.float32))
    for causal in (False, True):
        out, lse = fa.flash_attention_reference(q, k, v, causal=causal, kmask=km,
                                                with_lse=True)
        got = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, km, causal)
        qa, ka, va = (x.clone().requires_grad_(True) for x in (q, k, v))
        ref = fa.flash_attention_reference(qa, ka, va, causal=causal, kmask=km)
        want = torch.autograd.grad(ref, (qa, ka, va), do)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_cpu_backward_launches_no_kernel():
    before = (fa.flash_fwd_cuda.launches, fa.flash_bwd_dq_cuda.launches,
              fa.flash_bwd_dkv_cuda.launches)
    q, k, v = (torch.from_numpy(a).requires_grad_(True)
               for a in _inputs(4, 1, 16, 2, 8)[:3])
    fa.flash_attention(q, k, v, causal=True).sum().backward()
    assert q.grad is not None and k.grad is not None and v.grad is not None
    assert (fa.flash_fwd_cuda.launches, fa.flash_bwd_dq_cuda.launches,
            fa.flash_bwd_dkv_cuda.launches) == before


def test_serving_under_inference_mode_keeps_its_output():
    q, k, v = (torch.from_numpy(a) for a in _inputs(5, 2, 16, 2, 8)[:3])
    with torch.inference_mode():
        out = fa.flash_attention(q, k, v, causal=True)
    assert not out.requires_grad
    torch.testing.assert_close(out, fa.flash_attention_reference(q, k, v, causal=True),
                               rtol=0, atol=0)


def test_backward_kernel_wrappers_refuse_cpu_tensors():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(6, 1, 16, 2, 32))
    lse = torch.zeros(1, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_bwd_dq_cuda(q, k, v, do, lse, lse)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_bwd_dkv_cuda(q, k, v, do, lse, lse)
