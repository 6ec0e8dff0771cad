"""What the CUDA kernels take, decided on the host and checked on the CPU:
the head dim flash attention runs a head at (zero-padded up to the next
built one, or past 256 to the wide-head route's next multiple of 64, with
the real 1/sqrt(D)), shown exact through the plain versions forward and
backward; and the route the fused-LSTM kernels take for each hidden width
and dtype (cluster, wide, or past 1024 step), with the shared memory it
needs."""

import math

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops import flash_attention as fa
from deeplearning4j_tpu_torch.ops import fused_lstm as fl

F32 = dict(rtol=1e-6, atol=1e-6)   # the padded columns add exact zeros; sums regroup


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


# -- flash attention: head dims -----------------------------------------------

@pytest.mark.parametrize("D,want", [(1, 32), (16, 32), (32, 32), (33, 64), (48, 64),
                                    (64, 64), (96, 128), (128, 128), (129, 256),
                                    (200, 256), (256, 256), (257, 320), (300, 320),
                                    (320, 320), (512, 512), (1000, 1024), (2880, 2880),
                                    (2881, 2944), (3072, 3072), (4000, 4032), (4096, 4096)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_kernel_head_dim_16bit(D, want, dtype):
    assert fa.kernel_head_dim(D, dtype) == want


@pytest.mark.parametrize("D,want", [(16, 32), (48, 64), (96, 128), (128, 128), (129, 256),
                                    (256, 256), (264, 320), (300, 320), (512, 512)])
def test_kernel_head_dim_f32(D, want):
    assert fa.kernel_head_dim(D, torch.float32) == want


@pytest.mark.parametrize("D,dtype", [(2881, torch.bfloat16), (4096, torch.float16),
                                     (2881, torch.float32), (0, torch.bfloat16),
                                     (64, torch.float64)])
def test_kernel_head_dim_refuses_past_the_limit(D, dtype):
    """The head-dim cap is gone (the wide-head route splits a head too wide
    for one block into column groups): past 2880 a head routes to the next
    multiple of 64; only D < 1 and a dtype outside f32/bf16/f16 are
    refused."""
    if D >= 1 and dtype in (torch.float32, torch.bfloat16, torch.float16):
        assert fa.kernel_head_dim(D, dtype) == -(-D // 64) * 64
        return
    with pytest.raises(ValueError, match="head dims from 1|float32, bfloat16 or float16"):
        fa.kernel_head_dim(D, dtype)


def _qkv(B, T, H, D, seed):
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.randn(B, T, H, D).astype(np.float32))
                 for _ in range(4))


def _kmask(B, T, seed):
    lens = np.random.RandomState(seed).randint(1, T + 1, (B,))
    return torch.from_numpy((np.arange(T)[None] < lens[:, None]).astype(np.float32))


@pytest.mark.parametrize("D", [16, 20, 48, 50, 96, 100, 200, 300, 320, 2900])
@pytest.mark.parametrize("causal,masked", [(True, False), (False, True)])
def test_padding_is_exact_forward(D, causal, masked):
    """pad -> plain version at the kernels' head dim with the real scale ->
    slice equals the plain version at the real D; the padded output columns
    are exactly zero."""
    B, T, H = 2, 9, 3
    q, k, v, _ = _qkv(B, T, H, D, D)
    km = _kmask(B, T, D) if masked else None
    d = fa.kernel_head_dim(D, torch.bfloat16)
    qp, kp, vp = (fa.pad_head_dim(x, d) for x in (q, k, v))
    assert qp.shape == (B, T, H, d) and torch.equal(qp[..., :D], q)
    out_p, lse_p = fa.flash_attention_reference(qp, kp, vp, causal=causal, kmask=km,
                                                with_lse=True, scale=1.0 / math.sqrt(D))
    out, lse = fa.flash_attention_reference(q, k, v, causal=causal, kmask=km,
                                            with_lse=True)
    torch.testing.assert_close(out_p[..., :D], out, **F32)
    torch.testing.assert_close(lse_p, lse, **F32)
    assert torch.count_nonzero(out_p[..., D:]) == 0


@pytest.mark.parametrize("D", [16, 20, 48, 50, 96, 100, 200, 300, 320, 2900])
@pytest.mark.parametrize("causal,masked", [(True, False), (False, True)])
def test_padding_is_exact_backward(D, causal, masked):
    """The backward's plain version on padded q, k, v, do (out and lse from
    the padded forward) sliced to D equals it at the real D; the padded
    gradient columns are exactly zero."""
    B, T, H = 2, 9, 3
    q, k, v, do = _qkv(B, T, H, D, 100 + D)
    km = _kmask(B, T, D) if masked else None
    d = fa.kernel_head_dim(D, torch.float16)
    scale = 1.0 / math.sqrt(D)
    qp, kp, vp, dop = (fa.pad_head_dim(x, d) for x in (q, k, v, do))
    out_p, lse_p = fa.flash_attention_reference(qp, kp, vp, causal=causal, kmask=km,
                                                with_lse=True, scale=scale)
    got = fa.flash_attention_bwd_reference(qp, kp, vp, out_p, lse_p, dop, km, causal,
                                           scale=scale)
    out, lse = fa.flash_attention_reference(q, k, v, causal=causal, kmask=km, with_lse=True)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, km, causal)
    # gradients reach ~10, and a row with one valid key has dq = dk = 0
    # exactly, computed as f32 noise: regrouped sums are held to ulps of the
    # largest gradient
    scale = max(1.0, *(b.abs().max().item() for b in want))
    for a, b in zip(got, want):
        torch.testing.assert_close(a[..., :D], b, rtol=F32["rtol"], atol=F32["atol"] * scale)
        assert torch.count_nonzero(a[..., D:]) == 0
    # the same gradients through autograd of the plain forward
    qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
    o = fa.flash_attention_reference(qg, kg, vg, causal=causal, kmask=km)
    o.backward(do)
    for a, g in zip(got, (qg.grad, kg.grad, vg.grad)):
        torch.testing.assert_close(a[..., :D], g, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("D", [20, 50, 100])
def test_padded_operands_are_contiguous_and_aligned(D):
    """A head dim off the 16-byte grid (bf16 D=20, 100; f32 D=50) reaches
    the kernels padded: a fresh contiguous tensor whose rows are 16-byte
    aligned, from strided views too (the fused-qkv split)."""
    for dtype in (torch.bfloat16, torch.float32):
        qkv = torch.randn(2, 9, 3 * 3, D).to(dtype)
        d = fa.kernel_head_dim(D, dtype)
        for x in qkv.split(3, dim=2) + (qkv.permute(0, 2, 1, 3)[:, :3],):
            p = fa.pad_head_dim(x, d)
            assert p.is_contiguous() and p.shape[-1] == d
            assert all((s * p.element_size()) % 16 == 0 for s in p.stride()[:3])
            assert torch.equal(p[..., :D], x)


# -- fused LSTM: routes ---------------------------------------------------------

ROUTES = {
    # (H, dtype): (forward, backward)
    (128, torch.float32): (("cluster", 4), ("cluster", 4)),
    (256, torch.float32): (("cluster", 8), ("cluster", 8)),
    (384, torch.float32): (("cluster", 16), ("wide", 0)),
    (512, torch.float32): (("wide", 0), ("wide", 0)),
    (640, torch.float32): (("wide", 0), ("wide", 0)),
    (1024, torch.float32): (("wide", 0), ("wide", 0)),
    (256, torch.bfloat16): (("cluster", 8), ("cluster", 8)),
    (384, torch.bfloat16): (("cluster", 16), ("cluster", 16)),
    (512, torch.bfloat16): (("cluster", 16), ("cluster", 16)),
    (640, torch.bfloat16): (("wide", 0), ("wide", 0)),
    (1024, torch.bfloat16): (("wide", 0), ("wide", 0)),
    (256, torch.float16): (("cluster", 8), ("cluster", 8)),
    (512, torch.float16): (("cluster", 16), ("cluster", 16)),
    (768, torch.float16): (("wide", 0), ("wide", 0)),
    # past the wide route's 1024: one launch a step, in every dtype
    (1152, torch.float32): (("step", 0), ("step", 0)),
    (1152, torch.bfloat16): (("step", 0), ("step", 0)),
    (2048, torch.float32): (("step", 0), ("step", 0)),
    (2048, torch.float16): (("step", 0), ("step", 0)),
}


@pytest.mark.parametrize("H,dtype", list(ROUTES))
def test_lstm_route(H, dtype):
    fwd, bwd = ROUTES[(H, dtype)]
    assert fl.lstm_route(H, dtype, "fwd") == fwd
    assert fl.lstm_route(H, dtype, "bwd") == bwd


@pytest.mark.parametrize("H", list(range(128, 2 * fl.WIDE_MAX_HIDDEN + 1, 128)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
def test_lstm_cluster_route_fits_a_block(H, dtype, kernel):
    """A cluster route's CTA holds U <= 32 units (a multiple of 8) within
    227 KB; a width that takes the wide (up to 1024) or step route has no
    cluster size that would."""
    route, C = fl.lstm_route(H, dtype, kernel)
    es = torch.empty((), dtype=dtype).element_size()
    fits = [c for c in (4, 8, 16) if H % c == 0 and H // c <= 32 and (H // c) % 8 == 0
            and fl.cluster_smem_bytes(kernel, H, H // c, es) <= 232448]
    if route == "cluster":
        assert C == fits[0]
        assert C * (H // C) == H
    else:
        want = "wide" if H <= fl.WIDE_MAX_HIDDEN else "step"
        assert (route, C) == (want, 0) and not fits


def test_lstm_char_rnn_width_takes_clusters_in_every_dtype():
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for kernel in ("fwd", "bwd"):
            assert fl.lstm_route(256, dtype, kernel) == ("cluster", 8)


@pytest.mark.parametrize("H,dtype", [(100, torch.float32), (1000, torch.bfloat16),
                                     (64, torch.float16), (256, torch.float64)])
def test_lstm_route_refuses(H, dtype):
    with pytest.raises(ValueError, match="multiple of 128|float32, bfloat16 or float16"):
        fl.lstm_route(H, dtype, "fwd")


@pytest.mark.parametrize("H", [1152, 2048, 4096])
def test_lstm_widths_past_1024_route_to_the_step_kernels(H):
    """H = 1152 and 2048 (and wider) take the step route in every dtype
    and both kernels, where the wide route's grid would not be co-resident;
    the wrappers' shape checks take them."""
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for kernel in ("fwd", "bwd"):
            assert fl.lstm_route(H, dtype, kernel) == ("step", 0)
    assert fl._check_shapes(torch.empty(2, 3, 4 * H), torch.empty(H, 4 * H), "t") == (2, 3, H)
    assert fl._route_code("step", 0) == -1 and fl._route_code("wide", 0) == 0
    assert fl._route_code("cluster", 8) == 8


def test_lstm_rows_layouts():
    """More rows a cluster (the launch's choice when clusters would not all
    run at once) grow the layout; 9 rows still fit at the char-RNN width in
    f32, the shape whose 16 clusters of 8 rows would not all run at once."""
    for kernel in ("fwd", "bwd"):
        sizes = [fl.cluster_smem_bytes(kernel, 256, 32, 4, rows) for rows in (8, 9)]
        assert sizes == sorted(sizes)
        assert sizes[1] <= 232448


def test_lstm_bf16_rounding_control_fails_the_f16_limits():
    """The plain versions' ``round_to`` control (h and dz rounded to bf16
    in an f16 case) moves the results by more than the f16 limits the
    kernels are held to on the card (per step ||err|| / ||ref|| <= 2e-4),
    and ``round_to=None`` is the plain version itself."""
    g = torch.Generator().manual_seed(57)
    B, T, H = 9, 6, 128
    r = lambda *s, k=1.0: torch.randn(*s, generator=g) * k   # noqa: E731
    f16 = torch.float16
    args = (r(B, T, 4 * H, k=0.5).to(f16), r(H, 4 * H, k=H ** -0.5).to(f16),
            r(B, H, k=0.5).to(f16), r(B, H, k=0.5).to(f16), None, r(3 * H, k=0.3).to(f16))
    want = fl.fused_lstm_reference(*args)
    for a, b in zip(fl.fused_lstm_reference(*args, round_to=None), want):
        assert torch.equal(a, b)
    ctl = fl.fused_lstm_reference(*args, round_to=torch.bfloat16)
    hs, gates, cs = want[:3]
    cprev, hprev, m, dhs = fl.bwd_operands(hs, cs, args[2], args[3], None, r(B, T, H), r(B, H))
    bargs = (gates, cs, cprev, hprev, args[1], m, dhs, r(B, H), args[5])
    bwant = fl.fused_lstm_bwd_reference(*bargs)
    bctl = fl.fused_lstm_bwd_reference(*bargs, round_to=torch.bfloat16)

    def step_rel(a, b):
        d = (a.float() - b.float()).transpose(0, 1).reshape(T, -1)
        w = b.float().transpose(0, 1).reshape(T, -1)
        return (d.norm(dim=1) / (w.norm(dim=1) + 1e-3 * w.shape[1] ** 0.5)).max().item()

    assert step_rel(ctl[0], want[0]) > 2e-4      # hs
    assert step_rel(bctl[0], bwant[0]) > 2e-4    # dzx
