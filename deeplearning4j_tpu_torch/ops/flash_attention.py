"""Flash attention: the hand-written CUDA kernels and their plain versions.

Counterpart of ``deeplearning4j_tpu/ops/flash_attention.py``. The TPU
package runs three Pallas kernels that compute attention blockwise so the
[T, T] score matrix never reaches device memory: the forward ``_kernel``
and the backward pair ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel`` behind a
custom VJP. Here they are ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu``,
CUDA C++ for Hopper (``sm_90a``) built at first use and bound through
ctypes (``ops/_build.py``), for head dims up to 256; past 256 the same
wrappers launch the wide-head route of ``csrc/flash_wide.cu`` (the head
dim a run-time loop over 64-column chunks, f32 accumulators in shared
memory, and past what one block's accumulators hold a grid axis over
column groups of the outputs), so every head dim runs on the card, bounded
by device memory alone, as in the JAX package. Their design notes and bounds sit at the top of each source.

Dispatch follows one rule, with no fallback: a tensor on the CPU goes to
the plain version, a CUDA tensor goes to the kernel or raises.

- :func:`flash_attention` — [B, T, H, D] -> [B, T, H, D], differentiable
  through :class:`_FlashAttention`: forward kernel #1, backward kernels #2
  (dq) and #3 (dk/dv) on CUDA tensors; :func:`flash_attention_reference`
  and :func:`flash_attention_bwd_reference` on CPU tensors.
- :func:`flash_attention_with_lse` — also the per-row logsumexp [B, H, T]
  (forward only).
- :func:`flash_attention_block` and :func:`flash_attention_block_grad` —
  the chunk entries (the TPU package's ``flash_attention_block`` and
  ``flash_attention_block_grad``): attention of a query chunk at absolute
  offset ``q_offset`` over one key chunk at ``k_offset``, Tq and Tk free,
  returning ``(out, lse)``; the second is differentiable in both through
  :class:`_FlashBlock`, whose backward takes the lse cotangent too
  (``delta_eff = rowsum(do * out) - dlse``). On CUDA tensors they launch
  kernels #1-#3 with the offsets and count each launch in
  :data:`CHUNK_LAUNCHES` as well as on the kernel's own wrapper.
- :func:`merge_attention_blocks` — the partial attentions over disjoint key
  chunks merged by their lse weights (plain torch ops, as in JAX).
- :func:`flash_fwd_cuda`, :func:`flash_bwd_cuda` (with
  :func:`flash_bwd_dq_cuda` and :func:`flash_bwd_dkv_cuda`, one kernel
  each) — the kernel wrappers, each counting its launches.
- :func:`flash_attention_reference` — f32 scores and softmax, masked
  scores clamped at -1e30 (the JAX package's ``_reference``).
- :func:`flash_attention_bwd_reference` — the backward kernels' formulas
  over a materialised [B, H, T, T].
- :func:`local_attention` — the non-flash path (``use_flash=False``),
  scores in the operand dtype (the JAX package's
  ``parallel/ring.py local_attention``).
- :func:`decode_attention` — a short query chunk against a gathered KV
  cache (the decode path, ``nn/decode.py``). Plain torch ops by design, as
  the JAX package's is plain XLA: its score tensor is [B, H, Tc, K] with
  Tc at most one prefill chunk, so there is no [T, T] matrix to keep out
  of device memory and no kernel to port.

Query rows whose keys are all masked get an unspecified but finite
forward value from the kernel, as from the TPU kernel (masked scores are
-1e30, never -inf), and an lse at or below -1e29, so their weight in
:func:`merge_attention_blocks` is exactly 0; callers compare only rows
with a valid key. Their gradients are exactly 0 in both backward
versions: p is masked by validity, never through the scores.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch.obs import profile as _profile
from deeplearning4j_tpu_torch.ops import _build

__all__ = [
    "SUPPORTED_HEAD_DIMS",
    "WIDE_HEAD_DIM_STEP",
    "CHUNK_LAUNCHES",
    "flash_attention",
    "flash_attention_block",
    "flash_attention_block_grad",
    "flash_attention_bwd_reference",
    "flash_attention_reference",
    "flash_attention_with_lse",
    "flash_bwd_cuda",
    "flash_bwd_dkv_cuda",
    "flash_bwd_dq_cuda",
    "flash_fwd_cuda",
    "decode_attention",
    "kernel_head_dim",
    "local_attention",
    "merge_attention_blocks",
    "pad_head_dim",
]

_NEG_BIG = -1e30
# head dims kernels #1-#3 are built for; a head dim between them runs
# zero-padded up to the next (kernel_head_dim)
SUPPORTED_HEAD_DIMS = (32, 64, 128, 256)
# past 256 the wide-head route (csrc/flash_wide.cu) takes any multiple of
# WIDE_HEAD_DIM_STEP; a head whose f32 accumulators (16 query rows x D for
# the forward and dq, 2 x 8 key rows x D for dk/dv) do not fit one block's
# 227 KB beside the staging tiles (dq: past 2880) runs in column groups
WIDE_HEAD_DIM_STEP = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the kernels take positions and offsets as 32-bit ints
_MAX_OFFSET = 2 ** 30
# kernel launches made by the chunk entries (flash_attention_block and
# flash_attention_block_grad), by kernel; each also counts on the kernel's
# own wrapper (flash_fwd_cuda.launches, ...)
CHUNK_LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
_lib = None
_bwd_lib = None
_wide_lib = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("flash_fwd")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # q, k, v, kmask, out, lse; B, Tq, Tk, H, D, dtype, causal, q_off,
        # k_off; scale; the 9 strides; the stream
        lib.flash_fwd.argtypes = (
            [ptr] * 6 + [i32] * 9 + [ctypes.c_float] + [i64] * 9 + [ptr])
        lib.flash_fwd.restype = i32
        lib.flash_fwd_error_string.argtypes = [i32]
        lib.flash_fwd_error_string.restype = ctypes.c_char_p
        lib.flash_fwd_smem_bytes.argtypes = [i32, i32]
        lib.flash_fwd_smem_bytes.restype = i64
        _lib = lib
    return _lib


def _bwd_kernel_lib() -> ctypes.CDLL:
    global _bwd_lib
    if _bwd_lib is None:
        lib = _build.load("flash_bwd")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        head = [ptr] * 7                      # q, k, v, do, lse, delta, kmask
        # B, Tq, Tk, H, D, dtype, causal, q_off, k_off, scale, the 12
        # strides, the stream
        dims = [i32] * 9 + [ctypes.c_float, ctypes.POINTER(i64), ptr]
        lib.flash_bwd_dq.argtypes = head + [ptr] + dims
        lib.flash_bwd_dq.restype = i32
        lib.flash_bwd_dkv.argtypes = head + [ptr, ptr] + dims
        lib.flash_bwd_dkv.restype = i32
        lib.flash_bwd_error_string.argtypes = [i32]
        lib.flash_bwd_error_string.restype = ctypes.c_char_p
        lib.flash_bwd_smem_bytes.argtypes = [i32, i32, i32]
        lib.flash_bwd_smem_bytes.restype = i64
        _bwd_lib = lib
    return _bwd_lib


def _wide_kernel_lib() -> ctypes.CDLL:
    global _wide_lib
    if _wide_lib is None:
        lib = _build.load("flash_wide")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # the same arguments as flash_fwd, flash_bwd_dq and flash_bwd_dkv
        lib.flash_wide_fwd.argtypes = (
            [ptr] * 6 + [i32] * 9 + [ctypes.c_float] + [i64] * 9 + [ptr])
        lib.flash_wide_fwd.restype = i32
        head = [ptr] * 7
        dims = [i32] * 9 + [ctypes.c_float, ctypes.POINTER(i64), ptr]
        lib.flash_wide_bwd_dq.argtypes = head + [ptr] + dims
        lib.flash_wide_bwd_dq.restype = i32
        lib.flash_wide_bwd_dkv.argtypes = head + [ptr, ptr] + dims
        lib.flash_wide_bwd_dkv.restype = i32
        lib.flash_wide_error_string.argtypes = [i32]
        lib.flash_wide_error_string.restype = ctypes.c_char_p
        lib.flash_wide_smem_bytes.argtypes = [i32, i32]
        lib.flash_wide_smem_bytes.restype = i64
        lib.flash_wide_groups.argtypes = [i32, i32]
        lib.flash_wide_groups.restype = i32
        _wide_lib = lib
    return _wide_lib


def kernel_head_dim(D: int, dtype: torch.dtype) -> int:
    """The head dim the kernels run a D-wide head at: up to 256 the
    smallest of :data:`SUPPORTED_HEAD_DIMS` not below D (kernels #1-#3);
    past 256 the next multiple of :data:`WIDE_HEAD_DIM_STEP` (the wide-head
    route). The wrappers zero-pad q, k, v (and the backward's do) up to it
    and pass the real ``1/sqrt(D)``; the padded columns add exact zeros to
    every product and are sliced off the outputs, so the result is the
    D-wide attention's. No head dim is too wide: past what one block holds
    the wide-head route splits the outputs' columns into groups. Raises a
    ValueError for D < 1 or a dtype other than float32, bfloat16 and
    float16."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"flash attention kernels take float32, bfloat16 or float16, "
                         f"got {dtype}")
    if D < 1:
        raise ValueError(f"flash attention kernels take head dims from 1, got {D}")
    if D <= SUPPORTED_HEAD_DIMS[-1]:
        return next(d for d in SUPPORTED_HEAD_DIMS if d >= D)
    return -(-D // WIDE_HEAD_DIM_STEP) * WIDE_HEAD_DIM_STEP


def _wide(d: int) -> bool:
    """Does a kernel head dim take the wide-head route?"""
    return d > SUPPORTED_HEAD_DIMS[-1]


def pad_head_dim(x: torch.Tensor, d: int) -> torch.Tensor:
    """``x`` [..., D] zero-padded to a contiguous [..., d] (``x`` itself
    when D == d)."""
    D = x.shape[-1]
    return x if D == d else torch.nn.functional.pad(x, (0, d - D)).contiguous()


def _check_operands(q, k, v, kmask, who="flash_fwd", q_offset=0, k_offset=0, **extra):
    """Raise on anything the kernels do not take: q [B, Tq, H, D], k and v
    [B, Tk, H, D] (Tk may differ from Tq, as the chunk entries pass them),
    ``kmask`` [B, Tk], and offsets that keep every absolute position a
    32-bit int. ``extra`` names further operands of q's shape (the
    backward's ``do``)."""
    named = (("q", q), ("k", k), ("v", v)) + tuple(extra.items())
    if (any(x.dim() != 4 for _, x in named) or k.shape != v.shape
            or k.shape[0] != q.shape[0] or k.shape[2:] != q.shape[2:]
            or any(x.shape != q.shape for x in extra.values())):
        raise ValueError(f"{', '.join(n for n, _ in named)} must be [B, Tq, H, D] "
                         f"(q{''.join(', ' + n for n in extra)}) and [B, Tk, H, D] "
                         f"(k, v), got {[tuple(x.shape) for _, x in named]}")
    for name, x in named:
        if x.device != q.device or x.device.type != "cuda":
            raise ValueError(f"{name} must lie on q's CUDA device, got {x.device}")
        if x.dtype != q.dtype:
            raise ValueError(f"{name} is {x.dtype}, q is {q.dtype}")
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    padded = kernel_head_dim(D, q.dtype) != D
    if Tq < 1 or Tk < 1 or B * H < 1 or B * H > 65535:
        raise ValueError(f"{who} needs Tq, Tk >= 1 and 1 <= B*H <= 65535, got "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}")
    for name, off, n in (("q_offset", q_offset, Tq), ("k_offset", k_offset, Tk)):
        if not isinstance(off, int) or abs(off) + n > _MAX_OFFSET:
            raise ValueError(f"{name} must be an int with |{name}| + length <= "
                             f"{_MAX_OFFSET}, got {off!r}")
    esize = q.element_size()
    for name, x in named:
        # rows are read in 16-byte chunks through the B/T/H strides: the head
        # dim must be contiguous and every row start 16-byte aligned (padded
        # operands are fresh contiguous copies, aligned whatever D is)
        if not padded and (x.stride(3) != 1 or x.data_ptr() % 16 or any(
                (s * esize) % 16 for s in x.stride()[:3])):
            raise ValueError(
                f"{name} must have a contiguous head dim and 16-byte aligned "
                f"rows (strides {x.stride()}, {x.dtype})")
    if kmask is not None:
        if tuple(kmask.shape) != (B, Tk):
            raise ValueError(f"kmask must be [B, Tk] = {(B, Tk)}, got {tuple(kmask.shape)}")
        if kmask.device != q.device:
            raise ValueError(f"kmask must lie on {q.device}, got {kmask.device}")


def _padded(D, dtype, *xs):
    """The operands padded to the kernels' head dim, and that dim."""
    d = kernel_head_dim(D, dtype)
    return d, [pad_head_dim(x, d) for x in xs]


def flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kmask: Optional[torch.Tensor] = None, causal: bool = False,
                   q_offset: int = 0, k_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel #1 (``csrc/flash_fwd.cu``: the wgmma/TMA kernel for
    bf16 and f16, the FMA kernel for f32), or past D = 256 the wide-head
    forward (``csrc/flash_wide.cu``), on PyTorch's current stream.

    q [B, Tq, H, D] and k/v [B, Tk, H, D] CUDA tensors (f32, bf16 or f16,
    any D; a D the kernels are not built for runs zero-padded,
    :func:`kernel_head_dim`; head dim contiguous; other strides are read as
    they are, so the fused-qkv split views need no copy); ``kmask`` [B, Tk]
    key validity (>0 = real key); ``q_offset`` and ``k_offset`` the
    absolute positions of query 0 and key 0, which the causal mask compares
    (``k_offset + k <= q_offset + q``). Returns ``(out [B, Tq, H, D] in q's
    dtype, lse [B, H, Tq] f32)``. Raises on anything the kernel does not
    take, on a tensor map libcuda refuses and on a failed launch. Each
    launch adds one to ``flash_fwd_cuda.launches``."""
    _check_operands(q, k, v, kmask, q_offset=q_offset, k_offset=k_offset)
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    d, (q, k, v) = _padded(D, q.dtype, q, k, v)
    if _wide(d):
        lib = _wide_kernel_lib()
        launch, error_string = lib.flash_wide_fwd, lib.flash_wide_error_string
    else:
        lib = _kernel_lib()
        launch, error_string = lib.flash_fwd, lib.flash_fwd_error_string
    out = torch.empty((B, Tq, H, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    km = None
    if kmask is not None:
        km = kmask.to(torch.float32).contiguous()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            km.data_ptr() if km is not None else None,
            out.data_ptr(), lse.data_ptr(),
            B, Tq, Tk, H, d, _DTYPE_CODES[q.dtype], int(bool(causal)),
            q_offset, k_offset, 1.0 / math.sqrt(D),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed ({rc}, head dim {d}): "
                           f"{error_string(rc).decode()}")
    flash_fwd_cuda.launches += 1
    counter = _profile.active_counter()
    if counter is not None:   # a counting pass (obs/profile.py) is running
        counter.kernel("flash_fwd", *_profile.attention_fwd_cost(
            B, Tq, Tk, H, D, causal, q.element_size(), kmask is not None,
            q_offset, k_offset))
    return (out if d == D else out[..., :D].contiguous()), lse


flash_fwd_cuda.launches = 0


def _bwd_operands(q, k, v, do, lse, delta, kmask, who, q_offset, k_offset):
    """Check the backward kernels' operands; ``do`` comes back contiguous
    (it is read through its strides, but autograd may hand any layout) and
    ``kmask`` as contiguous f32."""
    do = do.contiguous()
    _check_operands(q, k, v, kmask, who=who, q_offset=q_offset, k_offset=k_offset, do=do)
    B, Tq, H, _ = q.shape
    for name, x in (("lse", lse), ("delta", delta)):
        if (tuple(x.shape) != (B, H, Tq) or x.dtype != torch.float32
                or x.device != q.device or not x.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 [B, H, Tq] = "
                             f"{(B, H, Tq)} tensor on {q.device}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
    km = kmask.to(torch.float32).contiguous() if kmask is not None else None
    return do, km


def _launch_bwd(fn, q, k, v, do, lse, delta, km, causal, q_offset, k_offset):
    """Launch one backward kernel on the operands padded to the kernels'
    head dim; returns its gradients at the real D: dq (q's shape) from
    ``flash_bwd_dq``, dk and dv (k's shape) from ``flash_bwd_dkv``."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    d, (q, k, v, do) = _padded(D, q.dtype, q, k, v, do)
    rows = [Tq] if fn == "flash_bwd_dq" else [Tk, Tk]
    outs = [torch.empty((B, t, H, d), dtype=q.dtype, device=q.device) for t in rows]
    if _wide(d):   # the wide-head route: flash_wide_bwd_dq / _dkv, the same arguments
        lib = _wide_kernel_lib()
        fn, error_string = fn.replace("flash_", "flash_wide_", 1), lib.flash_wide_error_string
    else:
        lib = _bwd_kernel_lib()
        error_string = lib.flash_bwd_error_string
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *do.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, fn)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            km.data_ptr() if km is not None else None,
            *(o.data_ptr() for o in outs),
            B, Tq, Tk, H, d, _DTYPE_CODES[q.dtype], int(bool(causal)),
            q_offset, k_offset, 1.0 / math.sqrt(D), strides, stream)
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed ({rc}): {error_string(rc).decode()}")
    counter = _profile.active_counter()
    if counter is not None:   # a counting pass (obs/profile.py) is running
        name = "flash_bwd_dq" if len(outs) == 1 else "flash_bwd_dkv"
        counter.kernel(name, *_profile.attention_bwd_cost(
            B, Tq, Tk, H, D, causal, q.element_size(), name[10:], km is not None,
            q_offset, k_offset))
    return [o if d == D else o[..., :D].contiguous() for o in outs]


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, kmask=None, causal=False,
                      q_offset=0, k_offset=0):
    """Launch kernel #2 (``csrc/flash_bwd.cu`` ``flash_bwd_dq``; past D =
    256 ``csrc/flash_wide.cu`` ``flash_wide_bwd_dq``): dq [B, Tq, H, D] in
    q's dtype from q/do [B, Tq, H, D] and k/v [B, Tk, H, D] (read through
    their strides), the forward's ``lse`` and ``delta = rowsum(do * out)``
    (less the lse cotangent, for the chunk entries; both contiguous f32
    [B, H, Tq]), the optional [B, Tk] key mask and the offsets of
    :func:`flash_fwd_cuda`. Raises on anything the kernel does not take and
    on a failed launch. Each launch adds one to
    ``flash_bwd_dq_cuda.launches``."""
    do, km = _bwd_operands(q, k, v, do, lse, delta, kmask, "flash_bwd_dq",
                           q_offset, k_offset)
    (dq,) = _launch_bwd("flash_bwd_dq", q, k, v, do, lse, delta, km, causal,
                        q_offset, k_offset)
    flash_bwd_dq_cuda.launches += 1
    return dq


flash_bwd_dq_cuda.launches = 0


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, kmask=None, causal=False,
                       q_offset=0, k_offset=0):
    """Launch kernel #3 (``csrc/flash_bwd.cu`` ``flash_bwd_dkv``; past D =
    256 ``flash_wide_bwd_dkv``): ``(dk, dv)`` [B, Tk, H, D] in q's dtype,
    from the same operands as :func:`flash_bwd_dq_cuda`. Each launch adds
    one to ``flash_bwd_dkv_cuda.launches``."""
    do, km = _bwd_operands(q, k, v, do, lse, delta, kmask, "flash_bwd_dkv",
                           q_offset, k_offset)
    dk, dv = _launch_bwd("flash_bwd_dkv", q, k, v, do, lse, delta, km, causal,
                         q_offset, k_offset)
    flash_bwd_dkv_cuda.launches += 1
    return dk, dv


flash_bwd_dkv_cuda.launches = 0


def _delta(out, do, dlse=None):
    """delta = rowsum(do * out) in f32, as [B, H, T] (the TPU package
    computes it with XLA outside its kernels too); less the lse cotangent
    ``dlse`` [B, H, T] where one is given (``delta_eff``, the TPU package's
    ``_flash_block_diff_bwd``)."""
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return delta if dlse is None else delta - dlse.float()


def flash_bwd_cuda(q, k, v, out, lse, do, kmask=None, causal=False, q_offset=0,
                   k_offset=0, dlse=None):
    """The attention backward on CUDA tensors: ``delta`` (less ``dlse``)
    with torch ops, then kernels #2 and #3. Returns ``(dq, dk, dv)`` in q's
    dtype, dq of q's shape and dk, dv of k's."""
    delta = _delta(out, do, dlse)
    dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, kmask, causal, q_offset, k_offset)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, kmask, causal, q_offset, k_offset)
    return dq, dk, dv


def _valid_pairs(q, k, causal, kmask, q_offset=0, k_offset=0):
    """[B or 1, 1, Tq, Tk] validity of (query, key) pairs: the causal rule
    on absolute positions (``k_offset + k <= q_offset + q``) and the key
    mask."""
    Tq, Tk = q.shape[1], k.shape[1]
    valid = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        qpos = q_offset + torch.arange(Tq, device=q.device)
        kpos = k_offset + torch.arange(Tk, device=q.device)
        valid = kpos[None, :] <= qpos[:, None]
    valid = valid[None, None]
    if kmask is not None:
        valid = valid & (kmask[:, None, None, :] > 0)
    return valid


def _masked_scores(q, k, causal, kmask, scale=None, q_offset=0, k_offset=0):
    """f32 scaled scores [B, H, Tq, Tk] with masked entries at -1e30."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal or kmask is not None:
        s = s.masked_fill(~_valid_pairs(q, k, causal, kmask, q_offset, k_offset), _NEG_BIG)
    return s


def flash_attention_reference(q, k, v, *, causal: bool = False, kmask=None,
                              with_lse: bool = False, scale: Optional[float] = None,
                              q_offset: int = 0, k_offset: int = 0):
    """The plain version of the kernel, on any device: f32 scores and
    softmax, masked scores clamped at -1e30, output in q's dtype (and, with
    ``with_lse``, the f32 logsumexp [B, H, Tq]). q [B, Tq, H, D], k and v
    [B, Tk, H, D], the causal mask on absolute positions from ``q_offset``
    and ``k_offset``. Materialises [B, H, Tq, Tk]. ``scale`` defaults to
    ``1/sqrt(D)`` (a zero-padded head passes its real D's)."""
    s = _masked_scores(q, k, causal, kmask, scale, q_offset, k_offset)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1),
                       v.float()).to(q.dtype)
    return (out, torch.logsumexp(s, dim=-1)) if with_lse else out


def flash_attention_bwd_reference(q, k, v, out, lse, do, kmask=None,
                                  causal: bool = False, scale: Optional[float] = None,
                                  q_offset: int = 0, k_offset: int = 0, dlse=None):
    """The plain version of the backward kernels, on any device, with the
    TPU kernels' formulas over a materialised [B, H, Tq, Tk] in f32:
    p = exp(s - lse) where the pair is valid and exactly 0 elsewhere,
    delta = rowsum(do * out) - dlse (``dlse``, the lse cotangent of the
    chunk entries, None for 0), ds = p * (do . v^T - delta);
    dv = p^T . do, dq = scale * ds . k, dk = scale * ds^T . q, with p and ds
    rounded to the operand dtype before their products as the kernels do.
    ``scale`` defaults to ``1/sqrt(D)``. Returns ``(dq, dk, dv)`` in q's
    dtype, dq of q's shape and dk, dv of k's."""
    dt = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    valid = _valid_pairs(q, k, causal, kmask, q_offset, k_offset)
    p = torch.where(valid, torch.exp(s - lse[..., None]), torch.zeros((), device=q.device))
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = (p * (dp - _delta(out, do, dlse)[..., None])).to(dt).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), dof)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    return dq.to(dt), dk.to(dt), dv.to(dt)


def flash_attention_with_lse(q, k, v, *, kmask=None, causal: bool = False):
    """``(out [B, T, H, D], lse [B, H, T] f32)``: the kernel on a CUDA
    tensor, the plain version on a CPU tensor. Forward only."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, kmask=kmask,
                                         with_lse=True)
    return flash_fwd_cuda(q, k, v, kmask=kmask, causal=causal)


class _FlashAttention(torch.autograd.Function):
    """Attention with the TPU package's custom-VJP contract: the forward
    saves q, k, v, out, lse and the key mask; the backward computes delta
    and runs kernels #2 and #3 on CUDA tensors (the plain backward on CPU
    tensors). The key mask gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kmask, causal):
        out, lse = flash_attention_with_lse(q, k, v, kmask=kmask, causal=causal)
        ctx.save_for_backward(q, k, v, out, lse, kmask)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, kmask = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_bwd_reference(
                q, k, v, out, lse, do, kmask, ctx.causal)
        else:
            dq, dk, dv = flash_bwd_cuda(q, k, v, out, lse, do, kmask, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, kmask=None, causal: bool = False):
    """Differentiable attention over [B, T, H, D]: kernels #1-#3 for CUDA
    tensors, the plain versions for CPU tensors. ``kmask`` [B, T]: key
    validity shared by the heads of a batch (1 = real key, 0 = padding)."""
    return _FlashAttention.apply(q, k, v, kmask, causal)


def flash_attention_block(q, k, v, *, kmask=None, q_offset: int = 0,
                          k_offset: int = 0, causal: bool = False):
    """FORWARD-ONLY building block of chunked and ring attention: attention
    of q [B, Tq, H, D] (absolute positions from ``q_offset``) over ONE k/v
    chunk [B, Tk, H, D] (positions from ``k_offset``), returning ``(out
    [B, Tq, H, D], lse [B, H, Tq] f32)`` — the per-row logsumexp that
    :func:`merge_attention_blocks` weights partial results by. ``kmask``
    [B, Tk]: this key chunk's validity.

    A row with no valid key (causal with ``q_offset + q < k_offset``, or a
    chunk whose kmask is all 0) gets an lse at or below -1e29, so its merge
    weight is exactly 0, and a finite ``out`` that means nothing on its
    own: always combine through the lse. Kernel #1 with the offsets on a
    CUDA tensor (each launch counted in :data:`CHUNK_LAUNCHES` too), the
    plain version on a CPU tensor."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, kmask=kmask, with_lse=True,
                                         q_offset=q_offset, k_offset=k_offset)
    out, lse = flash_fwd_cuda(q, k, v, kmask, causal, q_offset, k_offset)
    CHUNK_LAUNCHES["flash_fwd"] += 1
    return out, lse


class _FlashBlock(torch.autograd.Function):
    """The chunk entry with both outputs differentiable (the TPU package's
    ``_flash_block_diff``): the forward saves q, k, v, out, lse and the key
    mask; the backward takes the cotangents of out and lse (None read as
    0), folds the second into ``delta_eff = rowsum(do * out) - dlse``
    (``d lse_i / d s_ij = p_ij``), and runs kernels #2 and #3 with the
    offsets on CUDA tensors (the plain backward on CPU tensors). The key
    mask gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kmask, q_offset, k_offset, causal):
        out, lse = flash_attention_block(q, k, v, kmask=kmask, q_offset=q_offset,
                                         k_offset=k_offset, causal=causal)
        ctx.save_for_backward(q, k, v, out, lse, kmask)
        ctx.block = (q_offset, k_offset, causal)
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, out, lse, kmask = ctx.saved_tensors
        q_offset, k_offset, causal = ctx.block
        if do is None:
            do = torch.zeros_like(out)
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_bwd_reference(
                q, k, v, out, lse, do, kmask, causal, q_offset=q_offset,
                k_offset=k_offset, dlse=dlse)
        else:
            delta = _delta(out, do, dlse)
            dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, kmask, causal, q_offset, k_offset)
            CHUNK_LAUNCHES["flash_bwd_dq"] += 1
            dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, kmask, causal,
                                        q_offset, k_offset)
            CHUNK_LAUNCHES["flash_bwd_dkv"] += 1
        return dq, dk, dv, None, None, None, None


def flash_attention_block_grad(q, k, v, *, kmask=None, q_offset: int = 0,
                               k_offset: int = 0, causal: bool = False):
    """:func:`flash_attention_block` with ``(out, lse)`` both
    differentiable, so a merge of chunks (and everything downstream of it)
    backpropagates exactly through every chunk: the training building block
    of chunk-sequential and ring attention. ``kmask`` [B, Tk]: this key
    chunk's validity."""
    return _FlashBlock.apply(q, k, v, kmask, q_offset, k_offset, causal)


def merge_attention_blocks(parts):
    """Merge ``[(out_i [B, T, H, D], lse_i [B, H, T])]`` partial attentions
    over DISJOINT key chunks into the attention over their union: out =
    sum_i w_i * out_i with the f32 weights w_i = exp(lse_i - logsumexp_i
    lse_i), in the parts' dtype. The streaming-softmax identity, exact up to
    rounding; plain torch ops, differentiable in every out_i and lse_i."""
    outs = torch.stack([o for o, _ in parts])                  # [N, B, T, H, D]
    lses = torch.stack([l for _, l in parts]).float()          # [N, B, H, T]
    w = torch.exp(lses - torch.logsumexp(lses, dim=0)[None])   # [N, B, H, T]
    w = w.transpose(2, 3)[..., None]                           # [N, B, T, H, 1]
    return (outs.float() * w).sum(dim=0).to(outs.dtype)


def local_attention(q, k, v, *, causal: bool = False, kmask=None):
    """The non-flash attention path (``use_flash=False``), [B, T, H, D]:
    scores and softmax in the operand dtype, masked entries -inf clamped at
    -1e30 so a fully masked row stays finite."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        T = q.shape[1]
        keep = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    if kmask is not None:
        s = s.masked_fill(~(kmask[:, None, None, :] > 0), float("-inf"))
    s = torch.clamp_min(s, _NEG_BIG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def decode_attention(q, k, v, q_positions):
    """Attention of a new-token chunk against a gathered KV cache.

    ``q`` [B, Tc, H, D] is the chunk being decoded or prefilled; ``k`` and
    ``v`` [B, K, H, D] are the cache span gathered for each row, laid out
    so that index g along K IS absolute position g (the chunk's own k/v are
    written to the cache before the gather); ``q_positions`` [B, Tc] holds
    each query's absolute position. Key g is valid iff ``g <=
    q_positions[b, t]``: that is the causal mask and hides every cache slot
    past the row's written length at once.

    Numerics mirror :func:`local_attention`: scores in the operand dtype,
    masked entries -inf clamped at -1e30. A masked slot's softmax weight is
    exp(-1e30 - m) = 0 exactly, so padded rows and unwritten slots leave
    every real row's sums bit for bit unchanged, provided the slot holds a
    finite value (0 * NaN is NaN: the decode pools are zero-filled)."""
    K = k.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale          # [B, H, Tc, K]
    keys = torch.arange(K, device=q.device)
    valid = keys[None, None, None, :] <= q_positions[:, None, :, None]
    s = s.masked_fill(~valid, float("-inf"))
    s = torch.clamp_min(s, _NEG_BIG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)               # [B, Tc, H, D]
