"""The hand-written CUDA kernels against their plain PyTorch versions on the
GPU: flash attention (forward #1, its 16-bit wgmma kernel at ragged T, B*H
= 1, on fused-qkv views, repeated and with rows without a valid key; every
head dim up to 256 in bf16 and f16, zero-padded ones included, and the
wide-head route past 256 (its f32 forward on register tiles and 16-bit
dq on wgmma included), in column groups past 2880; backward #2 dq and
#3 dk/dv; the chunk entries with Tq != Tk, offsets and an lse cotangent,
and the flash ring shard by shard) with a tiny TransformerLM served and
trained through them, the
fused LSTM (forward #4, backward #5; the cluster, wide and step routes, H up
to 2048, f32, bf16 and f16) with a tiny TextGenerationLSTM and a seq2seq
ComputationGraph trained and sampled through them, and LeNet-5 and a
ResNet50 step against the CPU; and the embedding steps (Word2Vec's five,
GloVe's, the epoch scan against its loop, plain torch) on the card
against the CPU, Word2Vec's default device, and the raise of every
embedding entry point without a device. Every test needs an
NVIDIA card (marker ``cuda``) and skips without one; on a GPU host run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest sets up JAX, which a GPU host
serving the port need not have). This file imports no JAX.
"""

import ctypes
import math

import pytest
import torch

from deeplearning4j_tpu_torch.interop import params_from_numpy, params_to_numpy
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.nn.model import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import flash_attention as fa
from deeplearning4j_tpu_torch.ops import fused_lstm as fl

pytestmark = pytest.mark.cuda

# f32: summation order differs from the plain version's
F32 = dict(rtol=1e-4, atol=1e-5)
# bf16: the kernel rounds p to bf16 for the PV product and the output to
# bf16; ~2 bf16 ulps of outputs of order 1
BF16 = dict(rtol=0.0, atol=2e-2)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(dev, B, T, H, D, dtype, strided, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    if strided:   # the fused-qkv split views the attention layer passes
        qkv = torch.randn(B, T, 3 * H, D, generator=g, device=dev).to(dtype)
        return qkv.split(H, dim=2)
    return tuple(torch.randn(B, T, H, D, generator=g, device=dev).to(dtype)
                 for _ in range(3))


def _varlen(dev, B, T, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    lens = torch.randint(1, T + 1, (B,), generator=g, device=dev)
    return (torch.arange(T, device=dev)[None, :] < lens[:, None]).float()


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_kernel_matches_plain_version(cuda, D, dtype, causal, masked):
    B, T, H = 2, 200, 3          # T not a multiple of the 64-row tiles
    q, k, v = _qkv(cuda, B, T, H, D, dtype, strided=masked)
    km = _varlen(cuda, B, T) if masked else None
    out, lse = fa.flash_fwd_cuda(q, k, v, kmask=km, causal=causal)
    ref, ref_lse = fa.flash_attention_with_lse(
        q.cpu(), k.cpu(), v.cpu(), kmask=km.cpu() if masked else None,
        causal=causal)
    w = km.cpu()[:, :, None, None] if masked else 1.0   # valid query rows
    tol = F32 if dtype == torch.float32 else BF16
    torch.testing.assert_close(out.cpu().float() * w, ref.float() * w, **tol)
    wl = km.cpu()[:, None, :] if masked else 1.0
    torch.testing.assert_close(lse.cpu() * wl, ref_lse * wl, rtol=1e-5, atol=1e-4)


def test_long_sequence_bf16(cuda):
    q, k, v = _qkv(cuda, 1, 1000, 4, 128, torch.bfloat16, strided=True, seed=3)
    out = fa.flash_attention(q, k, v, causal=True)
    ref = fa.flash_attention_reference(q, k, v, causal=True)
    torch.testing.assert_close(out.float(), ref.float(), **BF16)


def test_each_launch_counts_once(cuda):
    q, k, v = _qkv(cuda, 1, 64, 2, 64, torch.bfloat16, strided=False)
    before = fa.flash_fwd_cuda.launches
    fa.flash_attention(q, k, v)
    fa.flash_attention(q, k, v, causal=True)
    assert fa.flash_fwd_cuda.launches == before + 2


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v = _qkv(cuda, 1, 32, 2, 64, torch.bfloat16, strided=False)
    bad = [
        ((q.double(), k.double(), v.double()), {}),                # float64
        ((q[..., ::2], k[..., ::2], v[..., ::2]), {}),             # strided D
        ((q, k, v.float()), {}),                                   # mixed dtype
        ((q, k.cpu(), v), {}),                                     # mixed device
        ((q, k, v), {"kmask": torch.ones(1, 32)}),                 # CPU kmask
        ((q, k, v), {"kmask": torch.ones(1, 31, device=cuda)}),    # kmask shape
    ]
    before = fa.flash_fwd_cuda.launches
    for args, kw in bad:
        with pytest.raises(ValueError):
            fa.flash_fwd_cuda(*args, **kw)
    assert fa.flash_fwd_cuda.launches == before
    # D=16 (zero-padded to 32), float16 and D=264 (the wide-head route,
    # zero-padded to 320) run, held to the plain version
    w264 = tuple(torch.randn(1, 32, 2, 264, device=cuda).to(torch.bfloat16) for _ in range(3))
    for args in ((q[..., :16], k[..., :16], v[..., :16]), (q.half(), k.half(), v.half()), w264):
        out, lse = fa.flash_fwd_cuda(*args, causal=True)
        ref, ref_lse = fa.flash_attention_reference(*args, causal=True, with_lse=True)
        assert out.shape == args[0].shape and out.dtype == args[0].dtype
        torch.testing.assert_close(out.float(), ref.float(), **BF16)
        torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-4)
    assert fa.flash_fwd_cuda.launches == before + 3


# -- head dims the wrappers zero-pad, D = 256, float16 -------------------------

F16 = dict(rtol=0.0, atol=4e-3)   # ~2 f16 ulps of outputs of order 2


@pytest.mark.parametrize("D,dtype", [(16, torch.bfloat16), (96, torch.bfloat16),
                                     (200, torch.bfloat16), (256, torch.bfloat16),
                                     (256, torch.float16), (128, torch.float16),
                                     (48, torch.float16), (16, torch.float32),
                                     (96, torch.float32), (200, torch.float32),
                                     (256, torch.float32), (20, torch.bfloat16),
                                     (100, torch.bfloat16), (50, torch.float32)])
@pytest.mark.parametrize("causal,masked", [(True, False), (False, True)])
def test_every_head_dim_up_to_256_matches_plain_version(cuda, D, dtype, causal, masked):
    B, T, H = 2, 200, 3
    q, k, v, out, lse, do, km = _bwd_case(cuda, B, T, H, D, dtype, causal, masked, D)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, causal=causal, kmask=km,
                                                with_lse=True)
    w = km[:, :, None, None] if masked else 1.0
    tol = {torch.float32: F32, torch.bfloat16: BF16, torch.float16: F16}[dtype]
    assert out.shape == (B, T, H, D) and out.dtype == dtype
    torch.testing.assert_close(out.float() * w, ref.float() * w, **tol)
    wl = km[:, None, :] if masked else 1.0
    torch.testing.assert_close(lse * wl, ref_lse * wl, rtol=1e-5, atol=1e-4)
    got = fa.flash_bwd_cuda(q, k, v, out, lse, do, km, causal)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, km, causal)
    for a, b in zip(got, want):
        assert a.shape == (B, T, H, D) and a.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
        else:
            _close_rel(a, b, 2e-2)
            _close_per_tile(a, b, 1e-2)
    again = fa.flash_bwd_cuda(q, k, v, out, lse, do, km, causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# -- the wide-head route (csrc/flash_wide.cu): D past 256 ----------------------

@pytest.mark.parametrize("D,dtype", [(320, torch.float32), (320, torch.bfloat16),
                                     (512, torch.float32), (512, torch.bfloat16),
                                     (300, torch.float16), (1024, torch.bfloat16)])
@pytest.mark.parametrize("causal,masked", [(True, False), (False, True)])
def test_wide_head_dims_match_plain_version(cuda, D, dtype, causal, masked):
    """Forward (out, lse) and backward (dq, dk, dv) of the wide-head route
    on fused-qkv views against the plain versions, each launch counted once
    on its wrapper, the backward repeated bit for bit."""
    B, T, H = 2, 200, 3
    before = (fa.flash_fwd_cuda.launches, fa.flash_bwd_dq_cuda.launches,
              fa.flash_bwd_dkv_cuda.launches)
    q, k, v, out, lse, do, km = _bwd_case(cuda, B, T, H, D, dtype, causal, masked, D)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, causal=causal, kmask=km,
                                                with_lse=True)
    w = km[:, :, None, None] if masked else 1.0
    tol = {torch.float32: F32, torch.bfloat16: BF16, torch.float16: F16}[dtype]
    assert out.shape == (B, T, H, D) and out.dtype == dtype
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    torch.testing.assert_close(out.float() * w, ref.float() * w, **tol)
    wl = km[:, None, :] if masked else 1.0
    torch.testing.assert_close(lse * wl, ref_lse * wl, rtol=1e-5, atol=1e-4)
    got = fa.flash_bwd_cuda(q, k, v, out, lse, do, km, causal)
    assert (fa.flash_fwd_cuda.launches, fa.flash_bwd_dq_cuda.launches,
            fa.flash_bwd_dkv_cuda.launches) == tuple(n + 1 for n in before)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, km, causal)
    for a, b in zip(got, want):
        assert a.shape == (B, T, H, D) and a.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
        else:
            _close_rel(a, b, 2e-2)
            _close_per_tile(a, b, 1e-2)
    again = fa.flash_bwd_cuda(q, k, v, out, lse, do, km, causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_layer_at_head_dim_320_runs_on_the_card(cuda, dtype):
    # MultiHeadAttention(n_heads=2) at d_model 640 (D = 320) through the
    # layer a model builds, held to the same layer on the CPU (bf16: cuBLAS
    # and the CPU round the two 640-wide projections at other places, ~1
    # bf16 ulp of the largest output)
    from deeplearning4j_tpu_torch.nn.layers.attention import MultiHeadAttention
    from deeplearning4j_tpu_torch.nn.input_type import InputType

    dt = getattr(torch, dtype)
    layer = MultiHeadAttention(n_heads=2, causal=True)
    it = InputType.recurrent(640, 24)
    params = layer.init(torch.Generator().manual_seed(5), it, dt, torch.device("cpu"))
    x = torch.randn(2, 24, 640, generator=torch.Generator().manual_seed(6)).to(dt)
    before = fa.flash_fwd_cuda.launches
    got, _ = layer.apply({k: p.to(cuda) for k, p in params.items()}, {}, x.to(cuda))
    assert fa.flash_fwd_cuda.launches == before + 1
    want, _ = layer.apply(params, {}, x)
    if dtype == "float32":
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)
    else:
        _close_rel(got.cpu(), want, 2e-2)


# -- kernel #1's bf16 wgmma kernel: 128-row query blocks, 128-key tiles ------

def _fwd_close(dev, q, k, v, km, causal):
    """Kernel #1 against flash_attention_reference on the rows that see a
    valid key; every output and lse entry finite. Returns (out, lse)."""
    out, lse = fa.flash_fwd_cuda(q, k, v, kmask=km, causal=causal)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, causal=causal, kmask=km,
                                                with_lse=True)
    B, T = q.shape[:2]
    w = torch.ones(B, T, device=dev)
    if km is not None:
        valid = km > 0
        w = (valid.cummax(dim=1).values if causal
             else valid.any(dim=1, keepdim=True).expand(B, T)).float()
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    tol = BF16 if q.dtype == torch.bfloat16 else F32
    torch.testing.assert_close(out.float() * w[:, :, None, None],
                               ref.float() * w[:, :, None, None], **tol)
    torch.testing.assert_close(lse * w[:, None, :], ref_lse * w[:, None, :],
                               rtol=1e-5, atol=1e-4)
    return out, lse


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("T", [1, 65, 129])
@pytest.mark.parametrize("causal", [False, True])
def test_fwd_ragged_lengths_bf16(cuda, T, D, causal):
    # T past 64- and 128-row boxes: rows at or past T arrive as zeros, are
    # masked as keys and never stored as queries
    q, k, v = _qkv(cuda, 2, T, 3, D, torch.bfloat16, strided=True, seed=20 + T + D)
    _fwd_close(cuda, q, k, v, None, causal)


@pytest.mark.parametrize("causal", [False, True])
def test_fwd_one_batch_head_bf16(cuda, causal):
    q, k, v = _qkv(cuda, 1, 200, 1, 128, torch.bfloat16, strided=True, seed=21)
    _fwd_close(cuda, q, k, v, _varlen(cuda, 1, 200, 21), causal)


@pytest.mark.parametrize("D", [32, 64, 128])
def test_fwd_fused_views_equal_contiguous_bf16(cuda, D):
    q, k, v = _qkv(cuda, 2, 300, 4, D, torch.bfloat16, strided=True, seed=22)
    assert q.stride(1) == 3 * 4 * D and not q.is_contiguous()
    got = fa.flash_fwd_cuda(q, k, v, causal=True)
    again = fa.flash_fwd_cuda(*(x.contiguous() for x in (q, k, v)), causal=True)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fwd_repeats_bit_for_bit(cuda, dtype):
    q, k, v = _qkv(cuda, 2, 300, 3, 64, dtype, strided=True, seed=23)
    km = _varlen(cuda, 2, 300, 23)
    first = fa.flash_fwd_cuda(q, k, v, kmask=km, causal=True)
    second = fa.flash_fwd_cuda(q, k, v, kmask=km, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("D", [32, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_fwd_rows_without_valid_keys_are_finite_bf16(cuda, D, causal):
    # causal: the first 37 queries of batch 0 see no valid key; batch 1 has
    # no valid key at all. Their output is unspecified but finite, their lse
    # near -1e30 (as on the TPU), and every other row is still right
    B, T, H = 3, 300, 2
    q, k, v = _qkv(cuda, B, T, H, D, torch.bfloat16, strided=True, seed=24)
    km = torch.ones(B, T, device=cuda)
    km[0, :37] = 0.0
    km[1] = 0.0
    _, lse = _fwd_close(cuda, q, k, v, km, causal)
    assert (lse[1] < -1e29).all()
    if causal:
        assert (lse[0, :, :37] < -1e29).all()


def _bwd_case(dev, B, T, H, D, dtype, causal, masked, seed):
    """Inputs of the backward kernels: fused-qkv views, the forward kernel's
    out and lse, a cotangent of order 1, an optional variable-length mask."""
    q, k, v = _qkv(dev, B, T, H, D, dtype, strided=True, seed=seed)
    km = _varlen(dev, B, T, seed) if masked else None
    out, lse = fa.flash_fwd_cuda(q, k, v, kmask=km, causal=causal)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    do = torch.randn(B, T, H, D, generator=g, device=dev).to(dtype)
    return q, k, v, out, lse, do, km


def _close_rel(got, want, rel):
    """max |got - want| <= rel * max |want|, per tensor (bf16: ~2 ulps of
    the largest gradient; the products' inputs were rounded to bf16)."""
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rel * want.float().abs().max().item() + 1e-6, err


def _close_per_tile(got, want, rel, atol=1e-3, rows=64):
    """||got - want|| <= rel * (||want|| + atol * sqrt(n)) over each (batch,
    head, 64-row tile) block of [B, T, H, D] gradients, so a tile of small
    gradients (late causal rows) is held to its own scale; ``atol`` is an
    RMS floor per element for tiles of pure rounding noise."""
    B, T, H, D = want.shape
    pad = (0, 0, 0, 0, 0, (-T) % rows)
    d = torch.nn.functional.pad(got.float() - want.float(), pad).view(B, -1, rows, H, D)
    w = torch.nn.functional.pad(want.float(), pad).view(B, -1, rows, H, D)
    worst = (d.square().sum((2, 4)).sqrt()
             / (w.square().sum((2, 4)).sqrt() + atol * (rows * D) ** 0.5)).max().item()
    assert worst <= rel, worst


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_bwd_kernels_match_plain_version(cuda, D, dtype, causal, masked):
    B, T, H = 2, 200, 3
    q, k, v, out, lse, do, km = _bwd_case(cuda, B, T, H, D, dtype, causal, masked, 5)
    before = (fa.flash_bwd_dq_cuda.launches, fa.flash_bwd_dkv_cuda.launches)
    got = fa.flash_bwd_cuda(q, k, v, out, lse, do, km, causal)
    assert (fa.flash_bwd_dq_cuda.launches, fa.flash_bwd_dkv_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, km, causal)
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == (B, T, H, D)
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
        else:
            _close_rel(a, b, 2e-2)
            _close_per_tile(a, b, 1e-2)


def _bwd_matches(got, want, dtype):
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        _close_rel(a, b, 2e-2)
        _close_per_tile(a, b, 1e-2)


def test_bwd_fused_qkv_views_bf16(cuda):
    # q/k/v are the split views of one [B, T, 3H, D] projection (row stride
    # 3*H*D), as the attention layer passes them: read in place, no copy
    B, T, H, D = 2, 384, 4, 128
    q, k, v, out, lse, do, km = _bwd_case(cuda, B, T, H, D, torch.bfloat16, True,
                                          False, 11)
    assert q.stride(1) == 3 * H * D and not q.is_contiguous()
    got = fa.flash_bwd_cuda(q, k, v, out, lse, do, km, True)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, km, True)
    _bwd_matches(got, want, torch.bfloat16)
    # the same values as contiguous tensors give the same gradients
    again = fa.flash_bwd_cuda(*(x.contiguous() for x in (q, k, v)), out, lse, do, km, True)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("T", [1, 65, 129])
def test_bwd_ragged_lengths_bf16(cuda, T, D):
    # T past 64- and 128-row tiles: rows at or past T arrive as zeros and
    # are masked; T = 1 leaves one key, where dq and dk are exactly 0 and
    # both versions return f32 rounding noise (held to the exact 0)
    q, k, v, out, lse, do, km = _bwd_case(cuda, 2, T, 3, D, torch.bfloat16, True,
                                          False, 12 + T)
    got = fa.flash_bwd_cuda(q, k, v, out, lse, do, km, True)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, km, True)
    if T == 1:
        assert got[0].float().abs().max().item() <= 1e-5
        assert got[1].float().abs().max().item() <= 1e-5
        got, want = got[2:], want[2:]
    _bwd_matches(got, want, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_repeats_bit_for_bit(cuda, dtype):
    # no atomics: every gradient row is summed by one block in one order
    q, k, v, out, lse, do, km = _bwd_case(cuda, 2, 300, 3, 64, dtype, True, True, 13)
    first = fa.flash_bwd_cuda(q, k, v, out, lse, do, km, True)
    second = fa.flash_bwd_cuda(q, k, v, out, lse, do, km, True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("causal", [False, True])
def test_bwd_one_batch_head_bf16(cuda, causal):
    # B*H = 1: one (batch, head) slice, a grid of one block per row tile
    q, k, v, out, lse, do, km = _bwd_case(cuda, 1, 200, 1, 128, torch.bfloat16, causal,
                                          True, 14)
    got = fa.flash_bwd_cuda(q, k, v, out, lse, do, km, causal)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, km, causal)
    _bwd_matches(got, want, torch.bfloat16)


def test_bwd_rows_without_valid_keys_get_zero_grads(cuda):
    B, T, H, D = 2, 96, 2, 64
    q, k, v = _qkv(cuda, B, T, H, D, torch.float32, strided=False, seed=7)
    km = torch.ones(B, T, device=cuda)
    km[0, :5] = 0.0      # causal: queries 0-4 of batch 0 see no key
    km[1] = 0.0          # batch 1 has no key at all
    out, lse = fa.flash_fwd_cuda(q, k, v, kmask=km, causal=True)
    do = torch.randn_like(q)
    dq, dk, dv = fa.flash_bwd_cuda(q, k, v, out, lse, do, km, True)
    assert torch.count_nonzero(dq[0, :5]) == 0 and torch.count_nonzero(dq[1]) == 0
    assert torch.count_nonzero(dk[1]) == 0 and torch.count_nonzero(dv[1]) == 0
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, km, True)
    for a, b in zip((dq, dk, dv), want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("D,strided,masked", [(64, False, False), (128, True, True)])
def test_autograd_runs_the_backward_kernels(cuda, D, strided, masked):
    # each call launches kernels #1, #2 and #3 once; strided: the fused-qkv
    # views the attention layer passes
    q, k, v = (x.detach().requires_grad_(True) for x in
               _qkv(cuda, 2, 130, 2, D, torch.bfloat16, strided=strided, seed=8))
    km = _varlen(cuda, 2, 130, 8) if masked else None
    before = (fa.flash_fwd_cuda.launches, fa.flash_bwd_dq_cuda.launches,
              fa.flash_bwd_dkv_cuda.launches)
    for _ in range(2):
        out = fa.flash_attention(q, k, v, kmask=km, causal=True)
        out.float().square().sum().backward()
    assert (fa.flash_fwd_cuda.launches, fa.flash_bwd_dq_cuda.launches,
            fa.flash_bwd_dkv_cuda.launches) == tuple(b + 2 for b in before)
    assert all(torch.isfinite(x.grad.float()).all() for x in (q, k, v))


def test_bwd_wrapper_refuses_what_the_kernels_do_not_take(cuda):
    q, k, v, out, lse, do, _ = _bwd_case(cuda, 1, 32, 2, 64, torch.bfloat16,
                                         True, False, 9)
    delta = fa._delta(out, do)
    bad = [
        dict(do=do.float()),                     # do dtype
        dict(lse=lse[:, :, :31]),                # lse shape
        dict(delta=delta.to(torch.bfloat16)),    # delta dtype
    ]
    before = fa.flash_bwd_dq_cuda.launches
    for kw in bad:
        args = dict(q=q, k=k, v=v, do=do, lse=lse, delta=delta)
        args.update(kw)
        with pytest.raises(ValueError):
            fa.flash_bwd_dq_cuda(**args)
    assert fa.flash_bwd_dq_cuda.launches == before
    # D=16 runs zero-padded to 32, held to the plain version
    q16, k16, v16, do16 = (x[..., :16] for x in (q, k, v, do))
    out16, lse16 = fa.flash_fwd_cuda(q16, k16, v16, causal=True)
    dq = fa.flash_bwd_dq_cuda(q16, k16, v16, do16, lse16, fa._delta(out16, do16), None, True)
    want = fa.flash_attention_bwd_reference(q16, k16, v16, out16, lse16, do16, None, True)[0]
    assert dq.shape == q16.shape
    _close_rel(dq, want, 2e-2)


# bf16: cuBLAS and the CPU GEMMs round the logits at other places; a logit
# difference d moves a probability p by about p*d (a few percent for a few
# bf16 ulps of logits of order 1-4)
@pytest.mark.parametrize("dtype,tol", [("float32", dict(rtol=1e-4, atol=1e-5)),
                                       ("bfloat16", dict(rtol=2 ** -5, atol=2 ** -10))])
def test_tiny_transformer_lm_gpu_matches_cpu(cuda, dtype, tol):
    conf = zoo.TransformerLM(vocab_size=64, max_len=64, d_model=64, n_heads=2,
                             n_blocks=2, dtype=dtype)
    cpu = MultiLayerNetwork(conf, device="cpu").init()
    gpu = params_from_numpy(MultiLayerNetwork(conf), params_to_numpy(cpu))
    assert gpu.device.type == "cuda"
    x = torch.randint(0, 64, (3, 64), generator=torch.Generator().manual_seed(0))
    before = fa.flash_fwd_cuda.launches
    got = gpu.output(x)
    assert fa.flash_fwd_cuda.launches == before + 2      # one per block
    torch.testing.assert_close(got.cpu().float(), cpu.output(x).float(), **tol)
    assert math.isclose(float(got.float().sum(-1).mean()), 1.0, abs_tol=1e-2)


def test_tiny_transformer_lm_trains_alike_on_gpu_and_cpu(cuda):
    # f32: cuBLAS and the kernels sum in other orders than the CPU
    from deeplearning4j_tpu_torch.train.listeners import CollectScoresListener
    from deeplearning4j_tpu_torch.utils.tree import tree_leaves

    conf = zoo.TransformerLM(vocab_size=64, max_len=64, d_model=64, n_heads=2,
                             n_blocks=2, dtype="float32",
                             updater={"type": "adam", "lr": 1e-3})
    cpu = MultiLayerNetwork(conf, device="cpu").init()
    gpu = params_from_numpy(MultiLayerNetwork(conf), params_to_numpy(cpu))
    x = torch.randint(0, 64, (6, 64), generator=torch.Generator().manual_seed(2))
    y = torch.roll(x, -1, dims=1)
    scores = []
    for m in (cpu, gpu):
        lis = CollectScoresListener()
        m.set_listeners(lis)
        m.fit((x, y), epochs=1, batch_size=4)        # 4 rows, then 2 padded to 4
        scores.append([s for _, s in lis.scores])
    torch.testing.assert_close(torch.tensor(scores[1]), torch.tensor(scores[0]),
                               rtol=1e-4, atol=1e-5)
    C = 64
    for a, b in zip(tree_leaves(gpu.params), tree_leaves(cpu.params)):
        a = a.cpu()
        if a.shape == (3 * C,):   # bqkv: Adam amplifies its key third's noise
            a, b = torch.cat([a[:C], a[2 * C:]]), torch.cat([b[:C], b[2 * C:]])
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_bf16_training_step_runs_the_kernels(cuda):
    conf = zoo.TransformerLM(vocab_size=128, max_len=128, d_model=128, n_heads=2,
                             n_blocks=3, dtype="bfloat16")
    m = MultiLayerNetwork(conf).init()
    x = torch.randint(0, 128, (4, 128), generator=torch.Generator().manual_seed(3))
    before = (fa.flash_fwd_cuda.launches, fa.flash_bwd_dq_cuda.launches,
              fa.flash_bwd_dkv_cuda.launches)
    loss = m._fit_batch(x, torch.roll(x, -1, dims=1), None, None)
    assert (fa.flash_fwd_cuda.launches, fa.flash_bwd_dq_cuda.launches,
            fa.flash_bwd_dkv_cuda.launches) == tuple(b + 3 for b in before)
    assert math.isfinite(float(loss))
    assert all(p.dtype == torch.bfloat16 for p in m.params[2].values()
               if isinstance(p, torch.Tensor))
    assert m.opt_state[2]["m"]["Wi"].dtype == torch.float32


# -- the fused LSTM kernels (#4 forward, #5 backward) ------------------------

def _lstm_case(dev, B, T, H, dtype, peep, masked, seed):
    """Kernel operands of order 1 from a seed, nonzero carries and final-carry
    cotangents; ``masked``: random lengths with row 0 masked throughout."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s, k=1.0: torch.randn(*s, generator=g, device=dev) * k   # noqa: E731
    mask = None
    if masked:
        lens = torch.randint(1, T + 1, (B,), generator=g, device=dev)
        lens[0] = 0
        mask = (torch.arange(T, device=dev)[None, :] < lens[:, None]).float()
    return dict(zx=r(B, T, 4 * H, k=0.5).to(dtype), wh=r(H, 4 * H, k=H ** -0.5).to(dtype),
                h0=r(B, H, k=0.5).to(dtype), c0=r(B, H, k=0.5).to(dtype), mask=mask,
                peephole=r(3 * H, k=0.3).to(dtype) if peep else None,
                dout=r(B, T, H), dhT=r(B, H), dcT=r(B, H))


# 16-bit LSTM limits (per tensor, per step; chip_smoke.py LSTM_LIMITS): f16
# keeps 11 significant bits, and a kernel that rounded h or dz to bf16
# instead reads 4e-4 to 1.1e-3 per step
LSTM_LIMITS = {torch.bfloat16: (2e-2, 1e-2), torch.float16: (1.5e-3, 2e-4)}


def _lstm_close(got, want, dtype):
    """f32: elementwise (summation order only); bf16 and f16: per tensor
    within a share of max |ref| and, with a time axis, per step ||err||
    within a share of (||ref|| + 1e-3 sqrt(n)) (LSTM_LIMITS)."""
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
        return
    rel, step_rel = LSTM_LIMITS[dtype]
    _close_rel(got, want, rel)
    if want.dim() == 3:
        d = (got.float() - want.float()).transpose(0, 1).reshape(want.shape[1], -1)
        w = want.float().transpose(0, 1).reshape(want.shape[1], -1)
        worst = (d.norm(dim=1) / (w.norm(dim=1) + 1e-3 * w.shape[1] ** 0.5)).max().item()
        assert worst <= step_rel, worst


@pytest.mark.parametrize("B,T,H", [(1, 1, 256), (32, 1, 256), (3, 37, 256),
                                   (33, 9, 128), (40, 6, 512), (300, 4, 256),
                                   (128, 50, 256), (24, 7, 384), (20, 5, 640),
                                   (12, 4, 1024)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("peep,masked", [(True, True), (False, False)])
def test_lstm_kernels_match_plain_versions(cuda, B, T, H, dtype, peep, masked):
    c = _lstm_case(cuda, B, T, H, dtype, peep, masked, seed=B + T + H)
    args = (c["zx"], c["wh"], c["h0"], c["c0"], c["mask"], c["peephole"])
    before = (fl.fused_lstm_fwd_cuda.launches, fl.fused_lstm_bwd_cuda.launches)
    got = fl.fused_lstm_fwd_cuda(*args)
    for a, b in zip(got, fl.fused_lstm_reference(*args)):
        assert a.dtype == dtype
        _lstm_close(a, b, dtype)
    hs, gates, cs = got[:3]
    cprev, hprev, m, dhs = fl.bwd_operands(hs, cs, c["h0"], c["c0"], c["mask"],
                                           c["dout"], c["dhT"])
    bargs = (gates, cs, cprev, hprev, c["wh"], m, dhs, c["dcT"], c["peephole"])
    bgot = fl.fused_lstm_bwd_cuda(*bargs)
    assert (fl.fused_lstm_fwd_cuda.launches, fl.fused_lstm_bwd_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    for a, b in zip(bgot, fl.fused_lstm_bwd_reference(*bargs)):
        assert (a is None) == (b is None)
        if b is not None:
            assert a.dtype == torch.float32
            _lstm_close(a, b, dtype)
    # no atomics: a second run repeats bit for bit
    for a, b in zip(bgot, fl.fused_lstm_bwd_cuda(*bargs)):
        assert a is None or torch.equal(a, b)


@pytest.mark.parametrize("B,T,H,peep,masked", [(128, 50, 256, True, False),
                                                (9, 4, 128, True, True),
                                                (24, 7, 384, False, True),
                                                (40, 6, 512, True, False)])
def test_lstm_kernels_float16(cuda, B, T, H, peep, masked):
    # f16 takes the cluster route up to H=512, like bf16
    c = _lstm_case(cuda, B, T, H, torch.float16, peep, masked, seed=B + H)
    args = (c["zx"], c["wh"], c["h0"], c["c0"], c["mask"], c["peephole"])
    got = fl.fused_lstm_fwd_cuda(*args)
    for a, b in zip(got, fl.fused_lstm_reference(*args)):
        assert a.dtype == torch.float16
        _lstm_close(a, b, torch.float16)
    hs, gates, cs = got[:3]
    cprev, hprev, m, dhs = fl.bwd_operands(hs, cs, c["h0"], c["c0"], c["mask"],
                                           c["dout"], c["dhT"])
    bargs = (gates, cs, cprev, hprev, c["wh"], m, dhs, c["dcT"], c["peephole"])
    bgot = fl.fused_lstm_bwd_cuda(*bargs)
    for a, b in zip(bgot, fl.fused_lstm_bwd_reference(*bargs)):
        if b is not None:
            _lstm_close(a, b, torch.float16)
    for a, b in zip(bgot, fl.fused_lstm_bwd_cuda(*bargs)):
        assert a is None or torch.equal(a, b)


@pytest.mark.parametrize("H", [1152, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_lstm_step_route_matches_plain_versions(cuda, H, dtype):
    """Widths past the wide route's 1024 take the step route (one launch a
    step) in both kernels: B=32, T=20, peepholes and a mask with a row
    masked throughout, against the plain recurrence; the backward repeated
    bit for bit."""
    assert fl.lstm_route(H, dtype, "fwd") == fl.lstm_route(H, dtype, "bwd") == ("step", 0)
    c = _lstm_case(cuda, 32, 20, H, dtype, True, True, seed=H)
    args = (c["zx"], c["wh"], c["h0"], c["c0"], c["mask"], c["peephole"])
    before = (fl.fused_lstm_fwd_cuda.launches, fl.fused_lstm_bwd_cuda.launches)
    got = fl.fused_lstm_fwd_cuda(*args)
    for a, b in zip(got, fl.fused_lstm_reference(*args)):
        assert a.dtype == dtype
        _lstm_close(a, b, dtype)
    hs, gates, cs = got[:3]
    cprev, hprev, m, dhs = fl.bwd_operands(hs, cs, c["h0"], c["c0"], c["mask"],
                                           c["dout"], c["dhT"])
    bargs = (gates, cs, cprev, hprev, c["wh"], m, dhs, c["dcT"], c["peephole"])
    bgot = fl.fused_lstm_bwd_cuda(*bargs)
    assert (fl.fused_lstm_fwd_cuda.launches, fl.fused_lstm_bwd_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    for a, b in zip(bgot, fl.fused_lstm_bwd_reference(*bargs)):
        assert a.dtype == torch.float32
        _lstm_close(a, b, dtype)
    for a, b in zip(bgot, fl.fused_lstm_bwd_cuda(*bargs)):
        assert torch.equal(a, b)


# bf16: cuBLAS and the CPU GEMMs round the input projection at other places
@pytest.mark.parametrize("dtype,tol", [("float32", dict(rtol=1e-4, atol=1e-5)),
                                       ("bfloat16", dict(rtol=2 ** -5, atol=2 ** -10))])
def test_graves_lstm_640_and_lstm_1024_layers_run_on_the_card(cuda, dtype, tol):
    # widths past the old 512 cap, through the layers a model builds: the
    # wide route in both kernels, held to the plain versions on the CPU
    from deeplearning4j_tpu_torch.nn.input_type import InputType
    from deeplearning4j_tpu_torch.nn.layers import recurrent
    from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration

    V, T = 11, 6
    conf = MultiLayerConfiguration(
        layers=(recurrent.GravesLSTM(n_out=640), recurrent.LSTM(n_out=1024),
                recurrent.RnnOutputLayer(n_out=V, activation="softmax", loss="mcxent")),
        input_type=InputType.recurrent(V, T), dtype=dtype, seed=3)
    cpu = MultiLayerNetwork(conf, device="cpu").init()
    gpu = params_from_numpy(MultiLayerNetwork(conf), params_to_numpy(cpu))
    ids = torch.randint(0, V, (3, T), generator=torch.Generator().manual_seed(4))
    x = torch.eye(V)[ids]
    before = (fl.fused_lstm_fwd_cuda.launches, fl.fused_lstm_bwd_cuda.launches)
    got = gpu.output(x)
    assert fl.fused_lstm_fwd_cuda.launches == before[0] + 2
    torch.testing.assert_close(got.cpu().float(), cpu.output(x).float(), **tol)
    gpu.fit((x, torch.eye(V)[torch.roll(ids, -1, dims=1)]), epochs=1)
    assert fl.fused_lstm_bwd_cuda.launches == before[1] + 2
    from deeplearning4j_tpu_torch.utils.tree import tree_leaves
    assert all(torch.isfinite(p.float()).all() for p in tree_leaves(gpu.params))


def test_lstm_masked_row_carries_state_through(cuda):
    c = _lstm_case(cuda, 4, 9, 128, torch.float32, True, True, seed=3)
    out, (hT, cT) = fl.fused_lstm(c["zx"], c["wh"], c["h0"], c["c0"], c["mask"],
                                  c["peephole"])
    assert torch.count_nonzero(out[0]) == 0            # row 0 masked throughout
    torch.testing.assert_close(hT[0], c["h0"][0])
    torch.testing.assert_close(cT[0], c["c0"][0])


def test_lstm_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    c = _lstm_case(cuda, 2, 3, 128, torch.float32, True, False, seed=4)
    z, w, h0, c0 = c["zx"], c["wh"], c["h0"], c["c0"]
    bad = [
        (z[..., :400], w[:100, :400], h0[:, :100], c0[:, :100]),   # H=100
        (torch.zeros(2, 3, 4000, device=cuda), torch.zeros(1000, 4000, device=cuda),
         torch.zeros(2, 1000, device=cuda), torch.zeros(2, 1000, device=cuda)),  # H=1000
        (z.double(), w.double(), h0, c0),                          # float64
        (z, w.to(torch.bfloat16), h0, c0),                         # mixed dtype
        (z.cpu(), w.cpu(), h0.cpu(), c0.cpu()),                    # CPU tensors
        (z, w, h0.cpu(), c0),                                      # mixed device
        (z, w, h0[:1], c0),                                        # carry shape
    ]
    before = fl.fused_lstm_fwd_cuda.launches
    for args in bad:
        with pytest.raises(ValueError):
            fl.fused_lstm_fwd_cuda(*args)
    with pytest.raises(ValueError):
        fl.fused_lstm_fwd_cuda(z, w, h0, c0, torch.ones(2, 4, device=cuda))   # mask shape
    assert fl.fused_lstm_fwd_cuda.launches == before
    hs, gates, cs, _, _ = fl.fused_lstm_fwd_cuda(z, w, h0, c0)
    cprev, hprev, m, dhs = fl.bwd_operands(hs, cs, h0, c0, None, c["dout"], c["dhT"])
    with pytest.raises(ValueError):
        fl.fused_lstm_bwd_cuda(gates, cs, cprev.to(torch.bfloat16), hprev, w, m, dhs,
                               c["dcT"])
    with pytest.raises(ValueError):
        fl.fused_lstm_bwd_cuda(gates, cs, cprev, hprev, w, m[:, :2], dhs, c["dcT"])


def test_fused_lstm_on_cuda_never_runs_the_plain_versions(cuda, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")

    monkeypatch.setattr(fl, "fused_lstm_reference", boom)
    monkeypatch.setattr(fl, "fused_lstm_bwd_reference", boom)
    c = _lstm_case(cuda, 3, 5, 256, torch.float32, True, True, seed=6)
    zx, wh, pe = (c[k].requires_grad_(True) for k in ("zx", "wh", "peephole"))
    before = (fl.fused_lstm_fwd_cuda.launches, fl.fused_lstm_bwd_cuda.launches)
    out, (hT, cT) = fl.fused_lstm(zx, wh, c["h0"], c["c0"], c["mask"], pe)
    (out.square().sum() + hT.sum() + 0.5 * cT.sum()).backward()
    assert (fl.fused_lstm_fwd_cuda.launches, fl.fused_lstm_bwd_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    assert all(torch.isfinite(x.grad).all() for x in (zx, wh, pe))


def _char_rnn(hidden=128, T=12, tbptt=4, vocab=20, seed=7):
    conf = zoo.TextGenerationLSTM(vocab_size=vocab, timesteps=T, hidden=hidden, seed=seed)
    conf.tbptt_fwd_length = conf.tbptt_back_length = tbptt
    ids = torch.randint(0, vocab, (6, T), generator=torch.Generator().manual_seed(seed))
    eye = torch.eye(vocab)
    return conf, eye[ids], eye[torch.roll(ids, -1, dims=1)]


def test_tiny_char_rnn_trains_alike_on_gpu_and_cpu(cuda):
    # f32: cuBLAS and the kernels sum in other orders than the CPU
    from deeplearning4j_tpu_torch.train.listeners import CollectScoresListener
    from deeplearning4j_tpu_torch.utils.tree import tree_leaves

    conf, x, y = _char_rnn()
    cpu = MultiLayerNetwork(conf, device="cpu").init()
    gpu = params_from_numpy(MultiLayerNetwork(conf), params_to_numpy(cpu))
    torch.testing.assert_close(gpu.output(x).cpu(), cpu.output(x), rtol=1e-4, atol=1e-5)
    scores = []
    before = (fl.fused_lstm_fwd_cuda.launches, fl.fused_lstm_bwd_cuda.launches)
    for m in (cpu, gpu):
        lis = CollectScoresListener()
        m.set_listeners(lis)
        m.fit((x, y), epochs=2)                    # 3 tBPTT chunks a batch
        scores.append([s for _, s in lis.scores])
    # 2 GravesLSTM layers: 2 forward and 2 backward launches per chunk
    assert (fl.fused_lstm_fwd_cuda.launches, fl.fused_lstm_bwd_cuda.launches) == (
        before[0] + 12, before[1] + 12)
    torch.testing.assert_close(torch.tensor(scores[1]), torch.tensor(scores[0]),
                               rtol=1e-4, atol=1e-5)
    for a, b in zip(tree_leaves(gpu.params), tree_leaves(cpu.params)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)


def test_rnn_time_step_on_gpu_matches_the_full_forward(cuda):
    conf, x, _ = _char_rnn(hidden=256)
    m = MultiLayerNetwork(conf).init()
    full = m.output(x)
    before = fl.fused_lstm_fwd_cuda.launches
    steps = [m.rnn_time_step(x[:, t]) for t in range(x.shape[1])]
    assert fl.fused_lstm_fwd_cuda.launches == before + 2 * x.shape[1]
    assert m._rnn_carries[0][0].device.type == "cuda"
    torch.testing.assert_close(torch.stack(steps, 1), full, rtol=1e-4, atol=1e-5)


# -- LeNet-5: cuDNN convolutions and pooling, no hand-written kernel ---------

def test_lenet5_forward_and_step_on_the_card_match_the_cpu(cuda):
    """LeNet-5 at 28 x 28 x 1 from the same weights on the card and on the
    CPU (f32, TF32 off): the output, then one SGD step's loss and params
    (cuDNN and the CPU sum the convolutions in other orders; SGD, because
    Adam's first step moves an entry whose gradient is rounding noise by
    +-lr whatever the noise)."""
    import numpy as np

    from deeplearning4j_tpu_torch.utils.tree import tree_leaves

    conf = zoo.LeNet5(updater={"type": "sgd", "lr": 0.1})
    cpu = MultiLayerNetwork(conf, device="cpu").init()
    gpu = params_from_numpy(MultiLayerNetwork(conf), params_to_numpy(cpu))
    rs = np.random.RandomState(3)
    x = rs.rand(16, 28, 28, 1).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rs.randint(0, 10, 16)]
    torch.testing.assert_close(gpu.output(x).cpu(), cpu.output(x), rtol=1e-4, atol=1e-5)
    before = (fa.flash_fwd_cuda.launches, fl.fused_lstm_fwd_cuda.launches)
    gpu.fit((x, y), epochs=1)
    cpu.fit((x, y), epochs=1)
    assert (fa.flash_fwd_cuda.launches, fl.fused_lstm_fwd_cuda.launches) == before
    np.testing.assert_allclose(gpu.score((x, y)), cpu.score((x, y)), rtol=1e-4)
    for a, b in zip(tree_leaves(gpu.params), tree_leaves(cpu.params)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)


# -- flash attention past D = 2880: column groups ----------------------------

def _rel_close(got, want, rel):
    got, want = got.float(), want.float()
    assert (got - want).abs().max().item() <= rel * want.abs().max().item()


def _bwd_float64(q, k, v, do, km, causal):
    """(dq, dk, dv) of attention computed in float64 on the card, from the
    float64 scores (its own lse and out; every row must see a key)."""
    qd, kd, vd, dod = (x.double() for x in (q, k, v, do))
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kd) * scale
    p = torch.softmax(s.masked_fill(~fa._valid_pairs(q, k, causal, km), -math.inf), -1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vd)
    delta = (dod * out).sum(-1).transpose(1, 2)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dod, vd) - delta[..., None])
    return (torch.einsum("bhqk,bkhd->bqhd", ds, kd) * scale,
            torch.einsum("bhqk,bqhd->bkhd", ds, qd) * scale,
            torch.einsum("bhqk,bqhd->bkhd", p, dod))


@pytest.mark.parametrize("D,dtype", [(2881, torch.bfloat16), (3072, torch.bfloat16),
                                     (3072, torch.float32), (4096, torch.bfloat16)])
@pytest.mark.parametrize("causal,masked", [(True, False), (False, True)])
def test_wide_head_past_2880_matches_plain_version(cuda, D, dtype, causal, masked):
    """Heads too wide for one block's accumulators run in column groups
    (flash_wide_groups > 1 for dq): out, lse, dq, dk and dv against the
    plain versions, through the same wrappers, with no refusal."""
    B, T, H = 1, 256, 2
    lib = fa._wide_kernel_lib()
    code = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}[dtype]
    d = fa.kernel_head_dim(D, dtype)
    assert lib.flash_wide_groups(1, code, d, fa.wide_plan("dq", d, dtype).c_plan()) >= 2
    q, k, v = _qkv(cuda, B, T, H, D, dtype, strided=not masked, seed=D)
    km = _varlen(cuda, B, T, seed=D) if masked else None
    out, lse = fa.flash_fwd_cuda(q, k, v, kmask=km, causal=causal)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, causal=causal, kmask=km,
                                                with_lse=True)
    tol = F32 if dtype == torch.float32 else BF16
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-4)
    g = torch.Generator(device=cuda).manual_seed(1)
    do = torch.randn(B, T, H, D, generator=g, device=cuda).to(dtype)
    got = fa.flash_bwd_cuda(q, k, v, out, lse, do, km, causal)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, km, causal)
    # a mask with one valid key (seed 3072): p = 1 and dp - delta = 0, so dk is
    # 0 in exact arithmetic and both versions return the f32 rounding noise of
    # dp - delta (sums of magnitude ~55 over D = 3072 columns, whose f32 ulp is
    # 4e-6), times scale * q summed over the 256 queries: the wgmma dk/dv's
    # tensor-core sums read 2.3e-4 on the card, the reference's 3e-5. dk is
    # held to 5e-4, about 2x that. dq is 0 in exact arithmetic too: each row
    # gets scale * (dp - delta) * k of its one key, one term, no sum over
    # queries. The noise of dp - delta is that of two f32 sums of the same
    # 3072 products in other orders, ~sqrt(D) * 2^-24 * sum |do v| ~ 6e-3 at
    # most (sum |do v| ~ 2000), times scale (0.018) and |k| (< 4.5): under
    # 5e-4. The wgmma dq's tensor-core sums read 4.6e-5 on the card, the
    # reference's 1.1e-5 (the FMA dq it replaced read 0.0, so the relative
    # check held): dq is held to 1e-4, about 2x what it read.
    one_key = km is not None and bool((km.sum(1) == 1).all())
    # In f32 with that one key, dq and dk (0 in exact arithmetic) and dv
    # (each query's p = exp of a rounding difference, ~1 +- 1e-6, summed
    # over 256 queries) are f32 rounding of sums over D = 3072 on both
    # sides: the plain version's cuBLAS products sum over D in the order the
    # FMA kernels of the route did (they agreed to 1e-11), the register
    # tiles over split columns. Both are held to a float64 truth instead,
    # the kernel no further from it than the plain version (on an H100 the
    # tiles read 8.7e-6, 2.0e-5 and 4.2e-5 from it, the plain version
    # 1.9e-5, 6.7e-5 and 7.3e-5).
    truth = _bwd_float64(q, k, v, do, km, causal) if one_key else (None,) * 3
    for name, a, b, t in zip(("dq", "dk", "dv"), got, want, truth):
        if dtype == torch.float32 and one_key:
            assert ((a.double() - t).abs().max().item()
                    <= (b.double() - t).abs().max().item()), name
        elif dtype == torch.float32:
            torch.testing.assert_close(a, b, **F32)
        elif one_key and name == "dk":
            assert a.float().abs().max().item() <= 5e-4, name
        elif one_key and name == "dq":
            assert a.float().abs().max().item() <= 1e-4, name
        else:
            _rel_close(a, b, 2e-2)


def test_wide_head_one_group_up_to_2880(cuda):
    """The f32 kernels on register tiles (forward, dq, dk/dv) take one
    column group up to 512 columns and groups of at most 512 past it (so D
    = 2880 runs in 6), the 16-bit kernels on wgmma groups of at most 256;
    under each of the wrapper's plans (wide_plan) the library's layouts
    take the shared memory and groups the plan says, and it refuses a plan
    that does not fit or that names slots, residency or a group width the
    kernel does not take."""
    lib = fa._wide_kernel_lib()

    def groups(w, code, D):
        dtype = (torch.float32, torch.bfloat16, torch.float16)[code]
        return lib.flash_wide_groups(w, code, D, fa.wide_plan(fa.WIDE_KERNELS[w], D,
                                                              dtype).c_plan())

    for D in (320, 512, 1024, 2048, 2880):
        assert [groups(w, 0, D) for w in range(3)] == [-(-D // 512)] * 3, D
        assert [groups(w, c, D) for w in range(3) for c in (1, 2)] == [-(-D // 256)] * 6, D
    assert groups(1, 0, 2880) == 6
    for w, kernel in enumerate(fa.WIDE_KERNELS):
        for code, dtype in enumerate((torch.float32, torch.bfloat16, torch.float16)):
            for D in (320, 512, 576, 1024, 1088, 2880, 3072, 4096, 8192):
                plan = fa.wide_plan(kernel, D, dtype)
                assert (lib.flash_wide_smem_bytes(w, code, D, plan.c_plan()),
                        lib.flash_wide_groups(w, code, D, plan.c_plan())
                        ) == (plan.smem_bytes, len(plan.groups)), (kernel, dtype, D)
    # {G, slots, resident}: 576 columns in one group of the f32 dq's (or
    # the forward's) tiles, 320 in one group of the wgmma dq, a ring depth
    # other than the register-tile kernel's own (dk/dv's 3 slots would
    # also exceed 232,448 bytes), resident operands on the tiles route and
    # a group width not a multiple of 64 are refused; dk/dv at 256 columns
    # is taken
    plan = ctypes.c_int * 3
    for w, code, D, pl in ((1, 0, 576, (576, 2, 0)), (0, 0, 576, (576, 3, 0)),
                           (1, 1, 320, (320, 18, 1)), (2, 0, 512, (256, 3, 0)),
                           (1, 0, 512, (512, 3, 0)), (1, 0, 512, (512, 4, 0)),
                           (0, 0, 512, (512, 4, 0)), (2, 0, 512, (512, 2, 1)),
                           (2, 0, 512, (480, 2, 0))):
        assert lib.flash_wide_smem_bytes(w, code, D, plan(*pl)) == -1, (w, code, D, pl)
    assert lib.flash_wide_smem_bytes(2, 0, 512, plan(256, 2, 0)) == 196608
    assert lib.flash_wide_groups(2, 0, 512, plan(256, 2, 0)) == 2
    assert lib.flash_wide_smem_bytes(1, 0, 512, plan(512, 2, 0)) == 162304


# -- the wide-head wgmma kernels (16-bit forward and dk/dv past D = 256) ---------

WIDE16_CHUNKS = [
    # (B, Tq, Tk, H, D, q_offset, k_offset, causal, masked), as the chunk entries pass them
    (2, 200, 328, 2, 512, 328, 64, True, False),   # Tq != Tk, both offsets, ragged T
    (1, 300, 130, 2, 320, 40, 100, True, True),    # Tq > Tk, shifted diagonal, kmask
    (2, 128, 256, 2, 512, 0, 256, True, False),    # wholly in the future: no row sees a key
    (1, 96, 160, 2, 300, 160, 0, False, True),     # D zero-padded to 320, off-diagonal, kmask
]


@pytest.mark.parametrize("case", WIDE16_CHUNKS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_wide_wgmma_chunk_entries_match_plain_version(cuda, case, dtype):
    """The chunk entries through the wgmma kernels: out and lse against the
    plain version (rows without a valid key: lse <= -1e29, finite out),
    then dq, dk and dv under both cotangents (do and the lse's) against the
    plain backward; masked keys get exactly 0 in dk and dv, rows without a
    key exactly 0 in dq; both runs repeat bit for bit."""
    q, k, v, km, do, dlse, kw = _chunk_case(cuda, case, dtype, seed=31)
    out, lse = fa.flash_attention_block(q, k, v, kmask=km, **kw)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, kmask=km, with_lse=True, **kw)
    rows = _rows_with_a_key(case, km, cuda)
    w = rows[:, :, None, None].float()
    tol = BF16 if dtype == torch.bfloat16 else F16
    torch.testing.assert_close(out.float() * w, ref.float() * w, **tol)
    wl = rows[:, None, :].float()
    torch.testing.assert_close(lse * wl, ref_lse * wl, rtol=1e-5, atol=1e-4)
    assert bool((lse[~rows[:, None, :].expand_as(lse)] <= -1e29).all())
    assert bool(torch.isfinite(out.float()).all())
    again = fa.flash_attention_block(q, k, v, kmask=km, **kw)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])

    grads = []
    for _ in range(2):
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
        o, l = fa.flash_attention_block_grad(qg, kg, vg, kmask=km, **kw)
        torch.autograd.backward((o, l), (do, dlse))
        grads.append((qg.grad, kg.grad, vg.grad))
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, km, dlse=dlse, **kw)
    assert torch.count_nonzero(grads[0][0][~rows]) == 0
    if km is not None:
        dead = km <= 0
        assert torch.count_nonzero(grads[0][1][dead]) == 0
        assert torch.count_nonzero(grads[0][2][dead]) == 0
    for got, ref_g in zip(grads[0], want):
        assert got.shape == ref_g.shape and got.dtype == dtype
        _close_rel(got, ref_g, 2e-2)
        _close_per_tile(got, ref_g, 1e-2)


@pytest.mark.parametrize("T", [1, 65, 129, 300])
@pytest.mark.parametrize("D,dtype,kmask", [(512, torch.bfloat16, None),
                                           (320, torch.float16, "varlen"),
                                           (576, torch.bfloat16, "leading")])
def test_wide_wgmma_ragged_T_and_masks(cuda, T, D, dtype, kmask):
    """T not a multiple of the 64-row blocks, the key mask, rows that see
    no key (the first 37 keys of batch 0 masked, causal): forward and
    backward against the plain versions, repeated bit for bit."""
    B, H = 2, 2
    q, k, v = _qkv(cuda, B, T, H, D, dtype, strided=True, seed=T + D)
    km = None
    if kmask == "varlen":
        km = _varlen(cuda, B, T, seed=T)
    elif kmask == "leading":
        km = torch.ones(B, T, device=cuda)
        km[0, :37] = 0.0
    out, lse = fa.flash_fwd_cuda(q, k, v, kmask=km, causal=True)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, causal=True, kmask=km, with_lse=True)
    seen = torch.ones(B, T, device=cuda) if km is None else (km > 0).cummax(1).values.float()
    tol = BF16 if dtype == torch.bfloat16 else F16
    torch.testing.assert_close(out.float() * seen[:, :, None, None],
                               ref.float() * seen[:, :, None, None], **tol)
    torch.testing.assert_close(lse * seen[:, None], ref_lse * seen[:, None], rtol=1e-5, atol=1e-4)
    assert bool(torch.isfinite(out.float()).all() and torch.isfinite(lse).all())
    g = torch.Generator(device=cuda).manual_seed(T)
    do = torch.randn(B, T, H, D, generator=g, device=cuda).to(dtype)
    got = fa.flash_bwd_cuda(q, k, v, out, lse, do, km, True)
    again = fa.flash_bwd_cuda(q, k, v, out, lse, do, km, True)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(out, fa.flash_fwd_cuda(q, k, v, kmask=km, causal=True)[0])
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, km, True)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        if T == 1 and name != "dv":
            # one key: p = 1 and dp - delta = 0, so dq and dk are 0 up to f32
            # rounding noise (~1e-6), held 3 orders below a bf16 ulp of O(1)
            assert a.float().abs().max().item() <= 1e-5, name
            continue
        _close_rel(a, b, 2e-2)
        _close_per_tile(a, b, 1e-2)


@pytest.mark.parametrize("D", [3072, 4096])
def test_wide_wgmma_column_groups_see_the_same_p(cuda, D):
    """Past 512 columns (dk/dv: 256) the grid runs column groups that each
    recompute the scores, and inside a group two warpgroups sum their own
    columns: with v (and do, and q) repeating every 128 columns, every
    128-column slice of out, dv and dk must be bit-equal to the first, which
    holds only if every group and warpgroup used the same p and ds."""
    B, T, H, dtype = 1, 256, 2, torch.bfloat16
    g = torch.Generator(device=cuda).manual_seed(D)

    def periodic():
        return torch.randn(B, T, H, 128, generator=g, device=cuda).to(dtype).repeat(
            1, 1, 1, D // 128)

    q, v, do = periodic(), periodic(), periodic()
    k = torch.randn(B, T, H, D, generator=g, device=cuda).to(dtype)
    out, lse = fa.flash_fwd_cuda(q, k, v, causal=True)
    ref = fa.flash_attention_reference(q, k, v, causal=True)
    torch.testing.assert_close(out.float(), ref.float(), **BF16)
    delta = fa._delta(out, do)
    dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, None, True)
    for name, x in (("out", out), ("dk", dk), ("dv", dv)):
        slices = x.view(B, T, H, D // 128, 128)
        assert torch.equal(slices, slices[:, :, :, :1].expand_as(slices)), name
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, None, True)
    _close_rel(dk, want[1], 2e-2)
    _close_rel(dv, want[2], 2e-2)


# -- the wide-head f32 forward on register tiles, the 16-bit dq on wgmma -------

@pytest.mark.parametrize("T", [1, 65, 129, 300])
@pytest.mark.parametrize("D,kmask", [(512, None), (320, "varlen"), (300, "leading")])
def test_wide_f32_tiles_forward_ragged_T_and_masks(cuda, T, D, kmask):
    """The f32 forward on register tiles (wide_plan route "tiles"): T not a
    multiple of its 64 rows, the key mask, rows that see no key (the first
    37 keys of batch 0 masked, causal), D = 300 zero-padded to 320: out and
    lse against the plain version, rows without a key finite with lse at or
    below -1e29, a second run bit-equal; the f32 backward on top."""
    B, H, dtype = 2, 2, torch.float32
    assert fa.wide_plan("fwd", fa.kernel_head_dim(D, dtype), dtype).route == "tiles"
    q, k, v = _qkv(cuda, B, T, H, D, dtype, strided=True, seed=T + D)
    km = None
    if kmask == "varlen":
        km = _varlen(cuda, B, T, seed=T)
    elif kmask == "leading":
        km = torch.ones(B, T, device=cuda)
        km[0, :37] = 0.0
    before = fa.WIDE_LAUNCHES["flash_wide_fwd"]
    out, lse = fa.flash_fwd_cuda(q, k, v, kmask=km, causal=True)
    assert fa.WIDE_LAUNCHES["flash_wide_fwd"] == before + 1
    ref, ref_lse = fa.flash_attention_reference(q, k, v, causal=True, kmask=km, with_lse=True)
    seen = torch.ones(B, T, device=cuda) if km is None else (km > 0).cummax(1).values.float()
    torch.testing.assert_close(out * seen[:, :, None, None], ref * seen[:, :, None, None], **F32)
    torch.testing.assert_close(lse * seen[:, None], ref_lse * seen[:, None], rtol=1e-5, atol=1e-4)
    assert bool(torch.isfinite(out).all() and torch.isfinite(lse).all())
    assert bool((lse[(seen == 0)[:, None].expand_as(lse)] <= -1e29).all())
    again = fa.flash_fwd_cuda(q, k, v, kmask=km, causal=True)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    g = torch.Generator(device=cuda).manual_seed(T)
    do = torch.randn(B, T, H, D, generator=g, device=cuda)
    got = fa.flash_bwd_cuda(q, k, v, out, lse, do, km, True)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, km, True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **F32)


@pytest.mark.parametrize("case", WIDE16_CHUNKS)
def test_wide_f32_chunk_entries_match_plain_version(cuda, case):
    """The chunk entries in f32 (the forward, dq and dk/dv on register
    tiles) with Tq != Tk, offsets, the key mask and D = 300:
    out and lse against the plain version, then dq, dk and dv under both
    cotangents (do and the lse's) against the plain backward; rows without
    a key get exactly 0 in dq; both runs repeat bit for bit."""
    dtype = torch.float32
    q, k, v, km, do, dlse, kw = _chunk_case(cuda, case, dtype, seed=37)
    out, lse = fa.flash_attention_block(q, k, v, kmask=km, **kw)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, kmask=km, with_lse=True, **kw)
    rows = _rows_with_a_key(case, km, cuda)
    w = rows[:, :, None, None].float()
    torch.testing.assert_close(out * w, ref * w, **F32)
    wl = rows[:, None, :].float()
    torch.testing.assert_close(lse * wl, ref_lse * wl, rtol=1e-5, atol=1e-4)
    assert bool((lse[~rows[:, None, :].expand_as(lse)] <= -1e29).all())
    assert bool(torch.isfinite(out).all())
    again = fa.flash_attention_block(q, k, v, kmask=km, **kw)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    grads = []
    for _ in range(2):
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
        o, l = fa.flash_attention_block_grad(qg, kg, vg, kmask=km, **kw)
        torch.autograd.backward((o, l), (do, dlse))
        grads.append((qg.grad, kg.grad, vg.grad))
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    assert torch.count_nonzero(grads[0][0][~rows]) == 0
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, km, dlse=dlse, **kw)
    for got, ref_g in zip(grads[0], want):
        torch.testing.assert_close(got, ref_g, **F32)


@pytest.mark.parametrize("D", [3072, 4096])
def test_wide_dq_and_f32_forward_column_groups_see_the_same_p(cuda, D):
    """The wgmma dq's column groups each recompute S and dP over all of D,
    the f32 forward's, dq's and dk/dv's groups the scores: with q, k, v and
    do repeating every 128 columns, every 128-column slice of dq (bf16),
    and of out, dq, dk and dv (f32) must be bit-equal to the first, which
    holds only if every group used the same p and ds; each against its
    plain version."""
    B, T, H = 1, 256, 2
    g = torch.Generator(device=cuda).manual_seed(D)

    def periodic(dtype, scale=1.0):
        return (scale * torch.randn(B, T, H, 128, generator=g, device=cuda)).to(dtype).repeat(
            1, 1, 1, D // 128)

    # q and k scaled by (128 / D) ** 0.25 give the scaled scores of
    # periodic inputs the spread of random ones (about 1)
    a = (128 / D) ** 0.25
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do = periodic(dtype, a), periodic(dtype, a), periodic(dtype), periodic(dtype)
        out, lse = fa.flash_fwd_cuda(q, k, v, causal=True)
        ref = fa.flash_attention_reference(q, k, v, causal=True)
        torch.testing.assert_close(out.float(), ref.float(),
                                   **(F32 if dtype == torch.float32 else BF16))
        checks = [("out", out)]
        if dtype == torch.bfloat16:
            assert fa.wide_plan("dq", D, dtype).route == "wgmma"
            dq = fa.flash_bwd_dq_cuda(q, k, v, do, lse, fa._delta(out, do), None, True)
            want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, None, True)[0]
            _close_rel(dq, want, 2e-2)
            _close_per_tile(dq, want, 1e-2)
            checks.append(("dq", dq))
        else:
            # f32 dq, dk and dv on register tiles, in groups of 512 columns.
            # With do and v repeating D / 128 times, dp and delta are sums of
            # magnitude ~D / 128 * 11 whose f32 rounding (two orders, ~1e-3)
            # reaches dq, dk and dv as ~1e-5 wherever they are: held to 1e-4
            # of their largest entry (~1), not entry by entry
            assert {fa.wide_plan(kern, D, dtype).route for kern in fa.WIDE_KERNELS} == {"tiles"}
            got = fa.flash_bwd_cuda(q, k, v, out, lse, do, None, True)
            want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, None, True)
            for name, a, b in zip(("dq", "dk", "dv"), got, want):
                _rel_close(a, b, 1e-4)
                checks.append((name, a))
        for name, x in checks:
            slices = x.view(B, T, H, D // 128, 128)
            assert torch.equal(slices, slices[:, :, :, :1].expand_as(slices)), (name, dtype)


# -- the wide-head f32 dq and dk/dv on register tiles ---------------------------

@pytest.mark.parametrize("T", [1, 65, 129, 300])
@pytest.mark.parametrize("D,kmask", [(512, None), (320, "varlen"), (576, "leading"),
                                     (300, "leading")])
def test_wide_f32_tiles_backward_ragged_T_and_masks(cuda, T, D, kmask):
    """The f32 dq and dk/dv on register tiles (wide_plan route "tiles"): T
    not a multiple of their 64 (dk/dv: 32) rows, the key mask, rows that see no key (the first 37 keys of batch 0
    masked, causal), D = 576 in two column groups and 300 zero-padded to
    320: dq, dk and dv against the plain backward, dq of a row without a
    key and dk, dv of a masked key exactly 0, one launch of each kernel,
    a second run bit-equal."""
    B, H, dtype = 2, 2, torch.float32
    d = fa.kernel_head_dim(D, dtype)
    assert [fa.wide_plan(kern, d, dtype).route for kern in ("dq", "dkv")] == ["tiles"] * 2
    q, k, v = _qkv(cuda, B, T, H, D, dtype, strided=True, seed=3 * T + D)
    km = None
    if kmask == "varlen":
        km = _varlen(cuda, B, T, seed=T + 1)
    elif kmask == "leading":
        km = torch.ones(B, T, device=cuda)
        km[0, :37] = 0.0
    out, lse = fa.flash_fwd_cuda(q, k, v, kmask=km, causal=True)
    g = torch.Generator(device=cuda).manual_seed(T + 5)
    do = torch.randn(B, T, H, D, generator=g, device=cuda)
    before = dict(fa.WIDE_LAUNCHES)
    got = fa.flash_bwd_cuda(q, k, v, out, lse, do, km, True)
    assert [fa.WIDE_LAUNCHES[n] - before[n] for n in ("flash_wide_bwd_dq",
                                                      "flash_wide_bwd_dkv")] == [1, 1]
    again = fa.flash_bwd_cuda(q, k, v, out, lse, do, km, True)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, km, True)
    for a, b in zip(got, want):
        assert a.shape == (B, T, H, D) and a.dtype == dtype
        torch.testing.assert_close(a, b, **F32)
    if km is not None:
        seen = (km > 0).cummax(1).values > 0
        assert torch.count_nonzero(got[0][~seen]) == 0
        assert torch.count_nonzero(got[1][km <= 0]) == 0
        assert torch.count_nonzero(got[2][km <= 0]) == 0


def test_wide_f32_chunk_entries_register_tiles(cuda):
    """The chunk entries' f32 backward on register tiles (Tq != Tk,
    offsets, the lse cotangent folded into delta, the key mask), against
    the plain backward; masked keys get exactly 0."""
    for case in WIDE16_CHUNKS:
        q, k, v, km, do, dlse, kw = _chunk_case(cuda, case, torch.float32, seed=41)
        out, lse = fa.flash_attention_block(q, k, v, kmask=km, **kw)
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
        o, l = fa.flash_attention_block_grad(qg, kg, vg, kmask=km, **kw)
        torch.autograd.backward((o, l), (do, dlse))
        want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, km, dlse=dlse, **kw)
        for got, ref_g in zip((qg.grad, kg.grad, vg.grad), want):
            torch.testing.assert_close(got, ref_g, **F32)
        if km is not None:
            assert torch.count_nonzero(kg.grad[km <= 0]) == 0
            assert torch.count_nonzero(vg.grad[km <= 0]) == 0


@pytest.mark.parametrize("D", [512, 576])
def test_wide_f32_backward_repeats_bit_for_bit(cuda, D):
    """dq and dk/dv on register tiles sum in a fixed order with no atomics:
    two runs give the same bits, and so do the single-kernel wrappers."""
    B, T, H, dtype = 2, 512, 4, torch.float32
    q, k, v = _qkv(cuda, B, T, H, D, dtype, strided=True, seed=D)
    out, lse = fa.flash_fwd_cuda(q, k, v, causal=True)
    do = torch.randn(B, T, H, D, generator=torch.Generator(device=cuda).manual_seed(2),
                     device=cuda)
    first = fa.flash_bwd_cuda(q, k, v, out, lse, do, None, True)
    assert all(torch.equal(a, b)
               for a, b in zip(first, fa.flash_bwd_cuda(q, k, v, out, lse, do, None, True)))
    delta = fa._delta(out, do)
    assert torch.equal(first[0], fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, None, True))
    assert all(torch.equal(a, b) for a, b in zip(
        first[1:], fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, None, True)))
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, None, True)
    for a, b in zip(first, want):
        torch.testing.assert_close(a, b, **F32)


# -- ComputationGraph ---------------------------------------------------------

def _seq2seq(hidden, vocab=11, T=8):
    from deeplearning4j_tpu_torch.nn.graph import (
        ComputationGraphConfiguration,
        DuplicateToTimeSeriesVertex,
        LastTimeStepVertex,
        MergeVertex,
    )
    from deeplearning4j_tpu_torch.nn.input_type import InputType
    from deeplearning4j_tpu_torch.nn.layers import GravesLSTM, RnnOutputLayer

    return (ComputationGraphConfiguration.builder()
            .add_inputs("enc_in", "dec_in")
            .set_input_types(InputType.recurrent(vocab), InputType.recurrent(vocab))
            .add_layer("enc", GravesLSTM(n_out=hidden), "enc_in")
            .add_vertex("last", LastTimeStepVertex(), "enc")
            .add_vertex("dup", DuplicateToTimeSeriesVertex(), "last", "dec_in")
            .add_vertex("merge", MergeVertex(), "dec_in", "dup")
            .add_layer("dec", GravesLSTM(n_out=hidden), "merge")
            .add_layer("out", RnnOutputLayer(n_out=vocab, activation="softmax"), "dec")
            .set_outputs("out").updater({"type": "rmsprop", "lr": 1e-3}).tbptt(4).build())


def test_graph_lstm_launches_the_fused_kernels_and_matches_the_cpu(cuda):
    """A seq2seq graph with two GravesLSTM(256) vertices: on the card, a
    tBPTT fit (T = 8 in chunks of 4) launches kernels #4 and #5 twice a
    chunk, rnn_time_step kernel #4 twice a call, and the losses, params and
    streamed outputs match the same graph on the CPU."""
    import numpy as np

    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.utils.tree import tree_leaves

    conf = _seq2seq(256)
    cpu = ComputationGraph(conf, device="cpu").init()
    gpu = params_from_numpy(ComputationGraph(conf), params_to_numpy(cpu))
    rs = np.random.RandomState(0)
    eye = np.eye(11, dtype=np.float32)
    enc, dec = eye[rs.randint(0, 11, (6, 8))], eye[rs.randint(0, 11, (6, 8))]
    y = eye[rs.randint(0, 11, (6, 8))]
    before = (fl.fused_lstm_fwd_cuda.launches, fl.fused_lstm_bwd_cuda.launches)
    gpu.fit(((enc, dec), y), epochs=2)
    cpu.fit(((enc, dec), y), epochs=2)
    assert (fl.fused_lstm_fwd_cuda.launches, fl.fused_lstm_bwd_cuda.launches) == (
        before[0] + 8, before[1] + 8)
    assert gpu.iteration == cpu.iteration == 4
    for a, b in zip(tree_leaves(gpu.params), tree_leaves(cpu.params)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)
    before = fl.fused_lstm_fwd_cuda.launches
    steps = [gpu.rnn_time_step(enc[:, t], dec[:, t]) for t in range(8)]
    assert fl.fused_lstm_fwd_cuda.launches == before + 16
    want = [cpu.rnn_time_step(enc[:, t], dec[:, t]) for t in range(8)]
    torch.testing.assert_close(torch.stack(steps, 1).cpu(), torch.stack(want, 1),
                               rtol=1e-4, atol=1e-5)


def test_resnet50_step_on_the_card_matches_the_cpu(cuda):
    """ResNet50 at 64 x 64 (5 classes, batch 4) from the same weights: the
    f32 eval output (TF32 off), then one SGD step in float64 on both
    devices (in f32 the step is chaotic: train-mode BatchNorm over few rows
    magnifies regrouped sums until a ReLU near zero flips), its loss,
    params and BatchNorm statistics."""
    import numpy as np

    from deeplearning4j_tpu_torch.models import ResNet50
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.utils.tree import tree_leaves

    rs = np.random.RandomState(2)
    x = rs.rand(4, 64, 64, 3)
    y = np.eye(5)[rs.randint(0, 5, 4)]
    conf = ResNet50(height=64, width=64, num_classes=5)
    cpu = ComputationGraph(conf, device="cpu").init()
    gpu = params_from_numpy(ComputationGraph(conf), params_to_numpy(cpu))
    torch.testing.assert_close(gpu.output(x.astype(np.float32)).cpu(),
                               cpu.output(x.astype(np.float32)), rtol=1e-3, atol=1e-6)
    conf64 = ResNet50(height=64, width=64, num_classes=5, dtype="float64",
                      updater={"type": "sgd", "lr": 0.05})
    cpu = ComputationGraph(conf64, device="cpu").init()
    gpu = params_from_numpy(ComputationGraph(conf64), params_to_numpy(cpu))
    loss_gpu, loss_cpu = float(gpu.fit_batch((x, y))), float(cpu.fit_batch((x, y)))
    np.testing.assert_allclose(loss_gpu, loss_cpu, rtol=1e-9)
    for tree_g, tree_c in ((gpu.params, cpu.params), (gpu.state, cpu.state)):
        for a, b in zip(tree_leaves(tree_g), tree_leaves(tree_c)):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-8, atol=1e-9 * b.abs().max().item())


# -- the training runtime on the card (remat, the guard, resume, prefetch) ----

def _tiny_lm(dev, dropout, dtype="float32"):
    import dataclasses

    conf = zoo.TransformerLM(vocab_size=64, max_len=32, d_model=64, n_heads=2, n_blocks=2,
                             dtype=dtype)
    conf = dataclasses.replace(conf, layers=tuple(
        dataclasses.replace(l, dropout=dropout) if type(l).__name__ == "TransformerBlock"
        else l for l in conf.layers))
    return MultiLayerNetwork(conf, device=dev).init()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_gradients_equal_plain_ones_with_dropout_on_the_card(cuda, dtype, monkeypatch):
    import numpy as np

    from deeplearning4j_tpu_torch.utils.tree import tree_leaves

    ids = torch.as_tensor(np.random.RandomState(0).randint(0, 64, (4, 32)), device=cuda)
    out = []
    for remat in ("0", "1"):
        monkeypatch.setenv("DL4J_TPU_REMAT_BLOCKS", remat)
        m = _tiny_lm(cuda, 0.2, dtype)
        n0 = fa.flash_fwd_cuda.launches
        loss, _, grads, _ = m._value_and_grad(m.state, ids, ids.roll(-1, 1), None, None, None)
        torch.cuda.synchronize()
        out.append((loss, tree_leaves(grads), m._gen.get_state(),
                    fa.flash_fwd_cuda.launches - n0))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    assert torch.equal(out[0][2], out[1][2])
    assert (out[0][3], out[1][3]) == (2, 4)   # kernel #1 runs again in each block's recompute


def test_skip_batch_leaves_params_bit_equal_on_the_card(cuda):
    import numpy as np

    from deeplearning4j_tpu_torch.train.resilience import DivergenceGuard
    from deeplearning4j_tpu_torch.utils.tree import tree_leaves

    m = _tiny_lm(cuda, 0.0)
    ids = np.random.RandomState(1).randint(0, 64, (4, 32))
    m.fit((ids, np.roll(ids, -1, 1)), epochs=1)
    before = [t.clone() for t in tree_leaves((m.params, m.opt_state))]
    m.set_divergence_guard(DivergenceGuard("skip_batch", spike_limit=0.0))
    n0 = fa.flash_bwd_dq_cuda.launches
    m.fit((ids, np.roll(ids, -1, 1)), epochs=2)
    assert fa.flash_bwd_dq_cuda.launches - n0 == 4
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves((m.params, m.opt_state))))


def test_small_resume_is_bit_exact_on_the_card(cuda, tmp_path):
    import numpy as np

    from deeplearning4j_tpu_torch.train.checkpoint import CheckpointListener
    from deeplearning4j_tpu_torch.train.resilience import ChaosPreemption, install_chaos
    from deeplearning4j_tpu_torch.utils.tree import tree_leaves

    ids = np.random.RandomState(2).randint(0, 64, (24, 32))
    data = (ids, np.roll(ids, -1, 1))
    cont = _tiny_lm(cuda, 0.1)
    cont.fit(data, epochs=2, batch_size=4)            # 12 steps, dropout drawn on the card
    m = _tiny_lm(cuda, 0.1)
    m.set_listeners(CheckpointListener(tmp_path, save_every_n_iterations=3, keep_last=1))
    install_chaos("preempt@iter:8")
    try:
        with pytest.raises(ChaosPreemption):
            m.fit(data, epochs=2, batch_size=4)
    finally:
        install_chaos(None)
    r = _tiny_lm(cuda, 0.1)
    r.fit(data, epochs=2, batch_size=4, resume_from=tmp_path)
    assert r.iteration == 12
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves((cont.params, cont.opt_state)),
                                                 tree_leaves((r.params, r.opt_state))))
    assert torch.equal(cont._gen.get_state(), r._gen.get_state())


def test_prefetch_on_a_side_stream_gives_the_batches_unchanged(cuda):
    import numpy as np

    from deeplearning4j_tpu_torch.datasets import prefetch_to_device

    rs = np.random.RandomState(3)
    batches = [(rs.randn(64, 128).astype(np.float32), rs.randint(0, 9, 64), None)
               for _ in range(12)]
    seen = []
    for x, y, none in prefetch_to_device(iter(batches), depth=2, device=cuda):
        assert x.device.type == "cuda" and none is None
        # compute on the consumer's stream while later copies are in flight
        seen.append(((x * 2).sum().item(), x.cpu().numpy(), y.cpu().numpy()))
    assert len(seen) == 12
    for (s, x, y), (hx, hy, _) in zip(seen, batches):
        np.testing.assert_array_equal(x, hx)
        np.testing.assert_array_equal(y, hy)


def test_chained_batches_reach_the_card_unchanged(cuda):
    """A chain's stacked copy from page-locked memory, not waited for: the
    batches that come out equal the host's, in order."""
    import numpy as np

    from deeplearning4j_tpu_torch.nn.step_program import chain_batches

    rs = np.random.RandomState(4)
    batches = [(rs.randn(64, 128).astype(np.float32), rs.randint(0, 9, 64), None, 64)
               for _ in range(11)]
    got = list(chain_batches(iter(batches), 4, cuda, lambda b: True))
    assert len(got) == 11
    for (x, y, none, n), (hx, hy, _, hn) in zip(got, batches):
        assert none is None and n == hn
        if isinstance(x, torch.Tensor):
            assert x.device.type == "cuda"
            x, y = x.cpu().numpy(), y.cpu().numpy()
        np.testing.assert_array_equal(x, hx)
        np.testing.assert_array_equal(y, hy)
    assert all(isinstance(b[0], torch.Tensor) for b in got[:8])   # two chains, a tail of 3


# -- the chunk entries (row 6): kernels #1-#3 with Tq != Tk, offsets and an
# lse cotangent, the cases of tests/test_torch_flash_block.py at kernel shapes

CHUNK_CASES = [
    # (B, Tq, Tk, H, D, q_offset, k_offset, causal, masked)
    (2, 256, 256, 2, 64, 0, 0, True, False),      # the ring's diagonal block
    (2, 256, 256, 2, 128, 256, 0, True, False),   # a past block under causal
    (2, 192, 192, 3, 64, 0, 0, False, True),      # an off-diagonal block, kmask
    (2, 200, 328, 2, 128, 328, 64, True, False),  # Tq != Tk, both offsets nonzero
    (1, 300, 130, 2, 32, 40, 100, True, True),    # Tq > Tk, shifted diagonal, kmask
    (2, 128, 256, 2, 64, 0, 256, True, False),    # a chunk wholly in the future
    (1, 96, 160, 2, 320, 160, 0, True, False),    # the wide-head route
]


def _chunk_case(dev, case, dtype, seed=21):
    B, Tq, Tk, H, D, qo, ko, causal, masked = case
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, Tq, H, D, generator=g, device=dev).to(dtype)
    k, v = (torch.randn(B, Tk, H, D, generator=g, device=dev).to(dtype) for _ in range(2))
    km = _varlen(dev, B, Tk, seed) if masked else None
    do = torch.randn(B, Tq, H, D, generator=g, device=dev).to(dtype)
    dlse = torch.randn(B, H, Tq, generator=g, device=dev)
    return q, k, v, km, do, dlse, dict(q_offset=qo, k_offset=ko, causal=causal)


def _rows_with_a_key(case, km, dev):
    """[B, Tq] bool: query rows with at least one valid key."""
    B, Tq, Tk, H, D, qo, ko, causal, _ = case
    ok = torch.ones(Tq, Tk, dtype=torch.bool, device=dev)
    if causal:
        ok = (ko + torch.arange(Tk, device=dev))[None] <= (qo + torch.arange(Tq, device=dev))[:, None]
    ok = ok[None].expand(B, Tq, Tk)
    if km is not None:
        ok = ok & (km[:, None, :] > 0)
    return ok.any(-1)


@pytest.mark.parametrize("case", CHUNK_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunk_forward_kernel_matches_plain_version(cuda, case, dtype):
    q, k, v, km, _, _, kw = _chunk_case(cuda, case, dtype)
    before = (fa.flash_fwd_cuda.launches, fa.CHUNK_LAUNCHES["flash_fwd"])
    out, lse = fa.flash_attention_block(q, k, v, kmask=km, **kw)
    assert (fa.flash_fwd_cuda.launches, fa.CHUNK_LAUNCHES["flash_fwd"]) == (
        before[0] + 1, before[1] + 1)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, kmask=km, with_lse=True, **kw)
    rows = _rows_with_a_key(case, km, cuda)
    w = rows[:, :, None, None].float()
    tol = F32 if dtype == torch.float32 else BF16
    torch.testing.assert_close(out.float() * w, ref.float() * w, **tol)
    wl = rows[:, None, :].float()
    torch.testing.assert_close(lse * wl, ref_lse * wl, rtol=1e-5, atol=1e-4)
    dead = ~rows[:, None, :].expand_as(lse)
    assert bool((lse[dead] <= -1e29).all()) and bool(torch.isfinite(out.float()).all())
    again = fa.flash_attention_block(q, k, v, kmask=km, **kw)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])


@pytest.mark.parametrize("case", CHUNK_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunk_backward_kernels_match_plain_version(cuda, case, dtype):
    q, k, v, km, do, dlse, kw = _chunk_case(cuda, case, dtype, seed=22)
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
    before = dict(fa.CHUNK_LAUNCHES)
    out, lse = fa.flash_attention_block_grad(qg, kg, vg, kmask=km, **kw)
    torch.autograd.backward((out, lse), (do, dlse))
    assert fa.CHUNK_LAUNCHES == {n: c + 1 for n, c in before.items()}
    want = fa.flash_attention_bwd_reference(q, k, v, out.detach(), lse.detach(), do, km,
                                            dlse=dlse, **kw)
    rows = _rows_with_a_key(case, km, cuda)
    assert torch.count_nonzero(qg.grad[~rows]) == 0      # no valid key: dq exactly 0
    for got, ref in zip((qg.grad, kg.grad, vg.grad), want):
        assert got.shape == ref.shape and got.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)
        else:
            _close_rel(got, ref, 2e-2)
            _close_per_tile(got, ref, 1e-2)


def test_chunk_kmask_of_zeros_gets_weight_zero(cuda):
    q, k, v, _, do, dlse, kw = _chunk_case(cuda, CHUNK_CASES[2], torch.bfloat16, seed=23)
    km = torch.zeros(q.shape[0], k.shape[1], device=cuda)
    out, lse = fa.flash_attention_block(q, k, v, kmask=km, **kw)
    assert bool((lse <= -1e29).all()) and bool(torch.isfinite(out.float()).all())
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
    o, l = fa.flash_attention_block_grad(qg, kg, vg, kmask=km, **kw)
    torch.autograd.backward((o, l), (do, dlse))
    for x in (qg, kg, vg):
        assert torch.count_nonzero(x.grad) == 0


@pytest.mark.parametrize("causal,masked", [(True, False), (True, True), (False, True)])
def test_flash_ring_on_the_card_matches_flash_attention(cuda, causal, masked):
    from deeplearning4j_tpu_torch.parallel import ring

    B, T, H, D, s = 2, 512, 2, 64, 4
    q, k, v = (x.detach().requires_grad_(True) for x in
               _qkv(cuda, B, T, H, D, torch.bfloat16, strided=False, seed=24))
    km = _varlen(cuda, B, T, 24) if masked else None
    parts = ring.ring_in_one_process(
        ring._ring_flash_shard, q.chunk(s, 1), k.chunk(s, 1), v.chunk(s, 1),
        km.chunk(s, 1) if masked else None, causal=causal)
    out = torch.cat(parts, 1)
    ref = fa.flash_attention(q, k, v, kmask=km, causal=causal)
    w = km[:, :, None, None] if masked else 1.0
    torch.testing.assert_close(out.float() * w, ref.float() * w, **BF16)
    do = torch.randn_like(out) * (w if masked else 1.0)
    got = torch.autograd.grad(out, (q, k, v), do)
    want = torch.autograd.grad(ref, (q, k, v), do)
    for a, b in zip(got, want):
        _close_rel(a, b, 2e-2)


# -- the decode path and the mixture of experts (slice 11) -------------------

def _tiny_gen_lm(dev, dtype="float32", moe=0):
    conf = zoo.TransformerLM(vocab_size=29, max_len=64, d_model=32, n_heads=4,
                             n_blocks=2, moe_experts=moe, dtype=dtype, seed=5)
    cpu = MultiLayerNetwork(conf, device="cpu").init()
    gpu = MultiLayerNetwork(conf, device=dev).init()
    params_from_numpy(gpu, params_to_numpy(cpu))
    return cpu, gpu


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_on_the_card_matches_the_cpu(cuda, dtype):
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(3, n, 4, 32, generator=g).to(dtype) for n in (5, 40, 40))
    pos = torch.tensor([[0, 1, 2, 3, 4], [9, 10, 11, 12, 13], [35, 36, 37, 38, 39]])
    want = fa.decode_attention(q, k, v, pos).float()
    got = fa.decode_attention(q.to(cuda), k.to(cuda), v.to(cuda), pos.to(cuda)).float().cpu()
    torch.testing.assert_close(got, want, **(F32 if dtype == torch.float32 else BF16))


def _drive(prog, prompt, n_gen):
    import numpy as np

    npb = prog.ladder.bucket(prog.max_pages) if prog.paged else None
    table = (np.arange(npb)[None] + 1 if prog.paged else np.zeros(1, np.int64))
    if prog.paged:
        table[:, prog.max_pages:] = 0
    cached, out, logits = 0, [], []
    for i in range(0, len(prompt), prog.prefill_chunk):
        chunk = prompt[i:i + prog.prefill_chunk]
        tc = prog.ladder.bucket(len(chunk)) if len(chunk) > 1 else 1
        toks = np.zeros((1, tc), np.int64)
        toks[0, :len(chunk)] = chunk
        lg, ids = prog.dispatch(table, [cached], toks, [len(chunk)])
        cached += len(chunk)
    for j in range(n_gen):
        if j:
            lg, ids = prog.dispatch(table, [cached], [[out[-1]]], [1])
            cached += 1
        out.append(int(ids[0]))
        logits.append(lg.float().cpu())
    return out, torch.cat(logits)


@pytest.mark.parametrize("paged", [True, False])
def test_decode_program_on_the_card_matches_the_cpu(cuda, paged):
    from deeplearning4j_tpu_torch.nn.decode import DecodeProgram

    cpu, gpu = _tiny_gen_lm(cuda)
    kw = dict(page_tokens=8, max_batch=4, prefill_chunk=8, paged=paged)
    prompt = [int(t) for t in torch.randint(0, 29, (19,), generator=torch.Generator().manual_seed(4))]
    gp = DecodeProgram(gpu, **kw)
    assert gp.pools[0]["k"].device.type == cuda.type
    want_ids, want = _drive(DecodeProgram(cpu, **kw), prompt, 6)
    got_ids, got = _drive(gp, prompt, 6)
    assert got_ids == want_ids
    torch.testing.assert_close(got, want, **F32)


def test_generate_worker_on_the_card_matches_the_cpu(cuda):
    from deeplearning4j_tpu_torch.serve import GenerateConfig, ModelRegistry

    cpu, gpu = _tiny_gen_lm(cuda)
    cfg = GenerateConfig(decode_batch_max=4, kv_page_tokens=8, prefill_chunk=16)
    prompts = [[int(t) for t in torch.randint(0, 29, (n,), generator=torch.Generator().manual_seed(n))]
               for n in (4, 11, 19, 26)]
    got = []
    for model in (cpu, gpu):
        reg = ModelRegistry(device=model.device)
        try:
            gw = reg.register_generate("lm", model, config=cfg)
            streams = [gw.submit(p, max_new=6, timeout_s=120) for p in prompts]
            got.append([list(s) for s in streams])
            assert gw.program.off_grid_dispatches == 0
        finally:
            reg.shutdown()
    assert got[1] == got[0]


def test_moe_forward_and_backward_on_the_card_match_the_cpu(cuda):
    import numpy as np

    cpu, gpu = _tiny_gen_lm(cuda, moe=2)
    x = np.random.RandomState(6).randint(0, 29, (3, 64))
    y = np.roll(x, -1, axis=1)
    torch.testing.assert_close(gpu.output(x).cpu(), cpu.output(x), **F32)
    grads = []
    for m in (cpu, gpu):
        loss, _, g, _ = m._value_and_grad(m.state, torch.as_tensor(x, device=m.device),
                                          torch.as_tensor(y, device=m.device), None, None,
                                          None)
        grads.append((float(loss), [t.cpu() for t in _leaves(g)]))
    assert math.isclose(grads[0][0], grads[1][0], rel_tol=1e-4)
    for a, b in zip(grads[0][1], grads[1][1]):
        torch.testing.assert_close(b, a, **F32)


def _leaves(tree):
    from deeplearning4j_tpu_torch.utils.tree import tree_leaves

    return tree_leaves(tree)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_of_a_row_does_not_depend_on_the_batch(cuda, dtype):
    from deeplearning4j_tpu_torch.nn.layers.normalization import layer_norm

    g = torch.Generator(device=cuda).manual_seed(8)
    x = (torch.randn(8, 1, 2048, generator=g, device=cuda) * 3 + 1).to(dtype)
    gam, bet = (torch.randn(2048, generator=g, device=cuda).to(dtype) for _ in range(2))
    full = layer_norm(x, gam, bet)
    for b in (1, 2, 4):
        for r in range(0, 8, b):
            assert torch.equal(layer_norm(x[r:r + b], gam, bet), full[r:r + b])


# -- the embedding steps (nlp/embeddings.py, nlp/glove.py): plain PyTorch on
# the card against the same on the CPU. index_add_ on the card adds repeated
# ids with atomics in no fixed order, so the tables agree to f32 rounding:
# EMB_TOL on entries of order 1

EMB_TOL = dict(rtol=1e-5, atol=1e-6)


def _emb_case(kind, seed, V=50, B=256, D=16, K=5, W=6, L=7):
    import numpy as np

    rs = np.random.RandomState(seed)
    hs = kind in ("sg_hs", "cbow_hs")
    params = {"syn0": rs.rand(V, D) - 0.5,
              ("syn1" if hs else "syn1neg"): rs.rand(V - 1 if hs else V, D) - 0.5}
    win = rs.randint(0, V, (B, W))
    wmask = (np.arange(W)[None, :] < rs.randint(0, W + 1, B)[:, None]).astype(np.float32)
    ids, ids2, negs = rs.randint(0, V, B), rs.randint(0, V, B), rs.randint(0, V, (B, K))
    hmask = (np.arange(L)[None, :] < rs.randint(1, L + 1, B)[:, None]).astype(np.float32)
    codes = (rs.rand(B, L) < 0.5).astype(np.float32) * hmask
    points = rs.randint(0, V - 1, (B, L)) * hmask.astype(np.int64)
    args = {"sg_ns": (ids, ids2, negs), "cbow_ns": (win, wmask, ids, negs),
            "dm_ns": (ids2, win, wmask, ids, negs),
            "cbow_hs": (win, wmask, codes, points, hmask),
            "sg_hs": (ids, codes, points, hmask)}[kind]
    return ({k: torch.from_numpy(v.astype(np.float32)) for k, v in params.items()},
            [torch.from_numpy(a) if a.dtype == np.float32 else torch.from_numpy(a.astype(np.int64))
             for a in args])


@pytest.mark.parametrize("kind", ["sg_ns", "cbow_ns", "dm_ns", "cbow_hs", "sg_hs"])
def test_embedding_step_on_the_card_matches_the_cpu(cuda, kind):
    from deeplearning4j_tpu_torch.nlp import embeddings as E

    params, args = _emb_case(kind, 0)
    step = getattr(E, f"_{kind}_step")
    gp, gl = step({k: v.to(cuda, copy=True) for k, v in params.items()},
                  *(a.to(cuda) for a in args), 0.05)
    cp, cl = step({k: v.clone() for k, v in params.items()}, *args, 0.05)
    assert math.isclose(float(gl), float(cl), rel_tol=1e-5)
    for k in cp:
        torch.testing.assert_close(gp[k].cpu(), cp[k], **EMB_TOL)


def test_glove_step_on_the_card_matches_the_cpu(cuda):
    import numpy as np

    from deeplearning4j_tpu_torch.nlp.glove import _glove_step

    rs = np.random.RandomState(1)
    V, B, D = 40, 512, 16
    params = {k: torch.from_numpy((rs.rand(*s) - (0.5 if k in ("W", "Wc", "b", "bc") else 0))
                                  .astype(np.float32))
              for k, s in (("W", (V, D)), ("Wc", (V, D)), ("b", (V,)), ("bc", (V,)),
                           ("hW", (V, D)), ("hWc", (V, D)), ("hb", (V,)), ("hbc", (V,)))}
    wi, wj = (torch.from_numpy(rs.randint(0, V, B)) for _ in range(2))
    x = torch.from_numpy((rs.rand(B) * 150 + 0.1).astype(np.float32))
    gp, gl = _glove_step({k: v.to(cuda, copy=True) for k, v in params.items()}, wi.to(cuda), wj.to(cuda),
                         x.to(cuda), 0.05, x_max=100.0, alpha=0.75)
    cp, cl = _glove_step({k: v.clone() for k, v in params.items()}, wi, wj, x, 0.05,
                         x_max=100.0, alpha=0.75)
    assert math.isclose(float(gl), float(cl), rel_tol=1e-5)
    for k in cp:
        torch.testing.assert_close(gp[k].cpu(), cp[k], **EMB_TOL)


def test_embedding_scan_on_the_card_matches_the_loop(cuda):
    from deeplearning4j_tpu_torch.nlp import embeddings as E

    params, (c, t, _) = _emb_case("sg_ns", 2, B=4 * 256)
    cum = torch.cumsum(torch.rand(50, generator=torch.Generator().manual_seed(3)), 0)
    cum = (cum / cum[-1]).to(cuda)
    c2, t2 = c.view(4, 256).to(cuda), t.view(4, 256).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(11)
    sp, sl = E._sg_ns_epoch_scan({k: v.to(cuda, copy=True) for k, v in params.items()}, c2, t2, cum, gen,
                                 0.025, 1e-4, 0.0, 4096.0, negative=5)
    gen = torch.Generator(device=cuda).manual_seed(11)
    lp, seen = {k: v.to(cuda, copy=True) for k, v in params.items()}, torch.zeros((), device=cuda)
    for i in range(4):
        negs = E._device_negatives(cum, gen, 256, 5)
        assert int(negs.max()) < 50
        lr = torch.clamp(0.025 * (1.0 - torch.clamp(seen / 4096.0, max=1.0)), min=1e-4)
        lp, loss = E._sg_ns_step(lp, c2[i], t2[i], negs, lr)
        torch.testing.assert_close(sl[i], loss, rtol=1e-5, atol=0)
        seen = seen + 256
    for k in lp:
        torch.testing.assert_close(sp[k], lp[k], **EMB_TOL)


def test_word2vec_trains_on_the_card_by_default_and_matches_the_cpu(cuda):
    from deeplearning4j_tpu_torch.nlp.embeddings import Word2Vec

    corpus = ["the quick brown fox jumps over the lazy dog"] * 20 + ["a cat sat on the mat"] * 10
    kw = dict(layer_size=8, min_word_frequency=1, epochs=2, seed=3, batch_size=64)
    g = Word2Vec(**kw).fit(corpus)
    assert g.params["syn0"].device.type == "cuda"
    c = Word2Vec(device="cpu", **kw).fit(corpus)
    torch.testing.assert_close(torch.from_numpy(g.syn0), torch.from_numpy(c.syn0), **EMB_TOL)
    s = Word2Vec(pair_backend="numpy", scan_batches=2, **kw).fit(corpus)
    assert torch.isfinite(s.params["syn0"]).all()


def test_embedding_entry_points_raise_without_a_device(cuda, monkeypatch):
    from deeplearning4j_tpu_torch.graph import DeepWalk, Node2Vec
    from deeplearning4j_tpu_torch.nlp.distributed import DistributedWord2Vec
    from deeplearning4j_tpu_torch.nlp.embeddings import ParagraphVectors, Word2Vec
    from deeplearning4j_tpu_torch.nlp.glove import Glove

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (Word2Vec, ParagraphVectors, Glove, DeepWalk, Node2Vec, DistributedWord2Vec):
        with pytest.raises(RuntimeError):
            make()
