"""Flash attention: the hand-written CUDA kernels and their plain versions.

Counterpart of ``deeplearning4j_tpu/ops/flash_attention.py``. The TPU
package runs three Pallas kernels that compute attention blockwise so the
[T, T] score matrix never reaches device memory: the forward ``_kernel``
and the backward pair ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel`` behind a
custom VJP. Here they are ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu``,
CUDA C++ for Hopper (``sm_90a``) built at first use and bound through
ctypes (``ops/_build.py``), for head dims up to 256; past 256 the same
wrappers launch the wide-head route of ``csrc/flash_wide.cu``: the 16-bit
forward, dq and dk/dv on wgmma and TMA (the head dim a run-time loop over
64-column boxes, the outputs' columns in groups of at most 256 that each
recompute the scores), the f32 forward on f32 register tiles, the f32 dq
and dk/dv on f32 FMAs, so every head dim runs on the card, bounded by
device memory alone, as in the JAX package. :func:`wide_plan` computes
each wide launch's plan (rows a block, column groups, ring slots, shared
memory) on the host; the kernel checks it. Their design notes and bounds
sit at the top of each source.

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
  :data:`CHUNK_LAUNCHES` as well as on the kernel's own wrapper (a launch
  of the wide-head route counts in :data:`WIDE_LAUNCHES` too).
- :func:`merge_attention_blocks` — the partial attentions over disjoint key
  chunks merged by their lse weights (plain torch ops, as in JAX).
- :func:`wide_plan` — the launch plan of a wide-head kernel at a head dim
  and dtype (:class:`WidePlan`), pure Python.
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
import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch.obs import profile as _profile
from deeplearning4j_tpu_torch.ops import _build

__all__ = [
    "SUPPORTED_HEAD_DIMS",
    "WIDE_HEAD_DIM_STEP",
    "WidePlan",
    "CHUNK_LAUNCHES",
    "WIDE_LAUNCHES",
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
    "wide_plan",
]

_NEG_BIG = -1e30
# head dims kernels #1-#3 are built for; a head dim between them runs
# zero-padded up to the next (kernel_head_dim)
SUPPORTED_HEAD_DIMS = (32, 64, 128, 256)
# past 256 the wide-head route (csrc/flash_wide.cu) takes any multiple of
# WIDE_HEAD_DIM_STEP, in column groups where one block cannot hold all of
# the outputs' columns (wide_plan)
WIDE_HEAD_DIM_STEP = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the kernels take positions and offsets as 32-bit ints
_MAX_OFFSET = 2 ** 30
# kernel launches made by the chunk entries (flash_attention_block and
# flash_attention_block_grad), by kernel; each also counts on the kernel's
# own wrapper (flash_fwd_cuda.launches, ...)
CHUNK_LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
# launches of the wide-head route (csrc/flash_wide.cu, head dims past 256),
# by kernel; each also counts on the wrapper (flash_fwd_cuda.launches, ...)
WIDE_LAUNCHES = {"flash_wide_fwd": 0, "flash_wide_bwd_dq": 0, "flash_wide_bwd_dkv": 0}
_lib = None
_bwd_lib = None
_wide_lib = None


def _kernel_lib() -> ctypes.CDLL:
    # graftlint: disable=jit-purity; the library handle, set once per process
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
    # graftlint: disable=jit-purity; the library handle, set once per process
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
    # graftlint: disable=jit-purity; the library handle, set once per process
    global _wide_lib
    if _wide_lib is None:
        lib = _build.load("flash_wide")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # flash_fwd's, flash_bwd_dq's and flash_bwd_dkv's arguments, then
        # the launch plan (3 ints: wide_plan's WidePlan.c_plan) before the stream
        plan = ctypes.POINTER(i32)
        lib.flash_wide_fwd.argtypes = (
            [ptr] * 6 + [i32] * 9 + [ctypes.c_float] + [i64] * 9 + [plan, ptr])
        lib.flash_wide_fwd.restype = i32
        head = [ptr] * 7
        dims = [i32] * 9 + [ctypes.c_float, ctypes.POINTER(i64), plan, ptr]
        lib.flash_wide_bwd_dq.argtypes = head + [ptr] + dims
        lib.flash_wide_bwd_dq.restype = i32
        lib.flash_wide_bwd_dkv.argtypes = head + [ptr, ptr] + dims
        lib.flash_wide_bwd_dkv.restype = i32
        lib.flash_wide_error_string.argtypes = [i32]
        lib.flash_wide_error_string.restype = ctypes.c_char_p
        # (which, dtype code, D, plan): what the launch takes under a plan
        lib.flash_wide_smem_bytes.argtypes = [i32, i32, i32, plan]
        lib.flash_wide_smem_bytes.restype = i64
        lib.flash_wide_groups.argtypes = [i32, i32, i32, plan]
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


# -- the wide-head route's launch plan (csrc/flash_wide.cu checks it) ----------

WIDE_KERNELS = ("fwd", "dq", "dkv")   # `which` 0, 1, 2 of the C interface
_SMEM_LIMIT = 232448                  # the opt-in shared memory of one block
_BOX = 64                             # rows and columns of a TMA box
_BOX_BYTES = _BOX * _BOX * 2
# wgmma kernels: rows a block owns (the forward and dq: 64 a consumer
# warpgroup; dk/dv: 64 shared by both), the widest column group (the
# forward's and dq's warpgroups each sum all of its columns for their own
# rows: 4 boxes of O or dQ, 4 x 32 f32 registers a thread; dk/dv's split
# its columns: 2 boxes of dK and dV each, 2 x 2 x 32), the f32 accumulator
# registers a thread may hold, the head dims up to which the forward's Q
# (dk/dv's K and V) stays resident in shared memory (dq streams Q: with it
# resident 8 ring slots were left, and dq ran slower), the 64-column chunks
# of D a score step sums, the most ring slots, and dk/dv's fragment
# exchange
_WGMMA_ROWS = {"fwd": 128, "dq": 128, "dkv": 64}
_MAX_GROUP = 256
WIDE_ACC_REGISTERS = 128
_RESIDENT_MAX_D = 512
_CHUNKS = {"fwd": 4, "dq": 2, "dkv": 2}
# dq parks a tile's p in shared memory: 32 f32 a consumer thread
_DQ_P_BYTES = 2 * 128 * 32 * 4
_MAX_SLOTS = 32
_XCH_BYTES = 2 * 128 * 16 * 4
# the f32 register tiles: blocks of 256 threads; the forward and dq own 64
# query rows, dk/dv 32 key rows; the output tile in registers (the
# forward's O, dq's dQ: 64 rows x at most 512 columns over the threads;
# dk/dv's dK and dV: 2 x 32 rows); a ring of slots of two 64 x 64 f32
# chunks (rows padded to 68 floats; dk/dv's slot holds two chunks of 32 K
# rows and two of 64 Q rows): 3 for the forward, 2 for dq (faster than 3
# or 4) and dk/dv (all that fit); the four thread groups'
# partial scores (64 x 64 f32, rows padded to 72 floats: dk/dv's eight
# groups of 32 x 64 take the same bytes), p (dq: then ds; dk/dv: p^T and
# ds^T, 32 x 64 each) and, but for dk/dv, two f32 a query row
_TILE_ROWS = {"fwd": 64, "dq": 64, "dkv": 32}
_TILE_THREADS = 256
_TILE_MAX_GROUP = 512
_TILE_SLOTS = {"fwd": 3, "dq": 2, "dkv": 2}
_TILE_SLOT_BYTES = {"fwd": 2 * 64 * 68 * 4, "dq": 2 * 64 * 68 * 4, "dkv": 2 * 96 * 68 * 4}
# p^T and ds^T (dk/dv reads lse and delta from device memory), or p and two
# f32 a query row
_TILE_P_BYTES = {"fwd": 64 * 72 * 4 + 2 * 64 * 4, "dq": 64 * 72 * 4 + 2 * 64 * 4,
                 "dkv": 2 * 32 * 72 * 4}


@dataclass(frozen=True)
class WidePlan:
    """How one wide-head kernel runs a head dim: ``route`` "wgmma" (the
    16-bit forward, dq and dk/dv) or "tiles" (the f32 forward, dq and dk/dv
    on register tiles); ``rows`` a block owns (queries, or keys for dk/dv);
    ``groups`` the widths of the column groups, which sum to D
    (``group_width`` the first); the ring's ``slots`` (8 KB boxes for
    wgmma, two 64 x 64 f32 chunks for tiles) and whether Q (dk/dv: K and V)
    is ``resident``; ``smem_bytes`` of dynamic shared memory a block takes;
    and ``acc_registers``, the f32 output accumulator registers a thread
    holds."""

    kernel: str
    route: str
    rows: int
    groups: Tuple[int, ...]
    slots: int
    resident: bool
    smem_bytes: int
    acc_registers: int

    @property
    def group_width(self) -> int:
        return self.groups[0]

    def c_plan(self):
        """The plan as the launch takes it: int[3] {G, slots, resident}."""
        return (ctypes.c_int * 3)(self.group_width, self.slots, int(self.resident))


def _even_groups(chunks: int, max_chunks: int) -> Tuple[int, ...]:
    """``chunks`` 64-column chunks in the fewest groups of at most
    ``max_chunks``, as even as whole chunks allow (the last may be
    narrower), as column widths."""
    n = -(-chunks // max_chunks)
    w = -(-chunks // n)
    return tuple(_BOX * min(w, chunks - i) for i in range(0, chunks, w))


def _min_slots(kernel: str, D: int, resident: bool) -> int:
    """The most ring items a consumer holds at once: a score step's and the
    previous step's (_CHUNKS chunks of (Q of both row halves and) K, or of
    (K, V and) Q, dO; dq's dP steps one chunk of dO of both row halves and
    V, 3 items), the forward's P.V and dq's dS.K its group's (at most 4) V
    or K boxes, an accumulation step of dk/dv and the previous one 8."""
    per_chunk = {"fwd": (1, 3), "dq": (3, 3), "dkv": (2, 4)}[kernel][0 if resident else 1]
    step = min(_CHUNKS[kernel], D // _BOX) * per_chunk
    score = 2 * step if D // _BOX > _CHUNKS[kernel] else step
    if kernel == "dq":   # a dP step's 3 items and the previous step's
        score = max(score, 6)
    return max(score, 8 if kernel == "dkv" else 4)


def _wgmma_bytes(kernel: str, D: int, slots: int, resident: bool) -> int:
    # resident: the forward's Q (128 rows: two boxes a chunk), dk/dv's K
    # and V
    res = 2 * (D // _BOX) * _BOX_BYTES if resident else 0
    xch = {"dkv": _XCH_BYTES, "dq": _DQ_P_BYTES}.get(kernel, 0)
    return res + xch + slots * _BOX_BYTES + (1 + 2 * slots) * 8 + 1024


@functools.lru_cache(maxsize=None)
def wide_plan(kernel: str, D: int, dtype: torch.dtype) -> WidePlan:
    """The launch plan of wide-head kernel ``kernel`` ("fwd", "dq" or
    "dkv") at head dim ``D`` (a multiple of 64 past 256: the kernels' head
    dim, :func:`kernel_head_dim`) in ``dtype``. The 16-bit kernels take
    the wgmma route: column groups of at most 256 columns (the forward and
    dq: 128 own query rows a block, each consumer warpgroup its own 64 over
    all of the group's columns; dk/dv: 64 own key rows, the group's columns
    split over the two warpgroups), the forward's Q (dk/dv's K and V)
    resident up to D = 512, dq's streamed, as many 8 KB ring slots as fit.
    The f32 kernels take the tiles route: the forward and dq 64 own query
    rows, dk/dv 32 own key rows, groups of at most 512 columns, every
    operand streamed through a ring of 3 (the forward) or 2 (dq; dk/dv, two
    chunks a slot) slots. Pure Python, so the CPU checks every plan;
    ``flash_wide_smem_bytes`` and ``flash_wide_groups`` of the library
    report the shared memory and groups a launch takes under a plan, from
    the kernels' own layouts."""
    if kernel not in WIDE_KERNELS:
        raise ValueError(f"wide-head kernels are {WIDE_KERNELS}, got {kernel!r}")
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"wide-head kernels take float32, bfloat16 or float16, got {dtype}")
    if D <= SUPPORTED_HEAD_DIMS[-1] or D % WIDE_HEAD_DIM_STEP:
        raise ValueError(f"the wide-head route takes multiples of {WIDE_HEAD_DIM_STEP} "
                         f"past {SUPPORTED_HEAD_DIMS[-1]}, got {D}")
    chunks = D // _BOX
    if dtype != torch.float32:
        groups = _even_groups(chunks, _MAX_GROUP // _BOX)
        resident = D <= _RESIDENT_MAX_D and kernel != "dq"
        slots = next(s for s in range(_MAX_SLOTS, _min_slots(kernel, D, resident) - 1, -1)
                     if _wgmma_bytes(kernel, D, s, resident) <= _SMEM_LIMIT)
        # a thread's accumulators: the forward's O and dq's dQ over the
        # group's boxes, dk/dv's dK and dV over the busier warpgroup's half
        boxes = groups[0] // _BOX
        regs = -(-boxes // 2) * 64 if kernel == "dkv" else boxes * 32
        return WidePlan(kernel, "wgmma", _WGMMA_ROWS[kernel], groups, slots, resident,
                        _wgmma_bytes(kernel, D, slots, resident), regs)
    groups = _even_groups(chunks, _TILE_MAX_GROUP // _BOX)
    rows, slots = _TILE_ROWS[kernel], _TILE_SLOTS[kernel]
    smem = slots * _TILE_SLOT_BYTES[kernel] + 4 * 64 * 72 * 4 + _TILE_P_BYTES[kernel]
    # the output tile over 256 threads: O or dQ (64 rows), dK and dV (2 x 32)
    outputs = 2 if kernel == "dkv" else 1
    return WidePlan(kernel, "tiles", rows, groups, slots, False, smem,
                    outputs * rows * groups[0] // _TILE_THREADS)


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
    forward (``csrc/flash_wide.cu``: wgmma for bf16 and f16, FMA for f32,
    under :func:`wide_plan`), on PyTorch's current stream.

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
    plan = ()
    if _wide(d):
        lib = _wide_kernel_lib()
        launch, error_string = lib.flash_wide_fwd, lib.flash_wide_error_string
        plan = (wide_plan("fwd", d, q.dtype).c_plan(),)
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
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *plan, stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed ({rc}, head dim {d}): "
                           f"{error_string(rc).decode()}")
    flash_fwd_cuda.launches += 1
    if plan:
        # graftlint: disable=jit-purity,retrace-hazard; a launch count: a rerun launches again
        WIDE_LAUNCHES["flash_wide_fwd"] += 1
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
    plan = ()
    if _wide(d):   # the wide-head route: flash_wide_bwd_dq / _dkv, the same arguments and a plan
        lib = _wide_kernel_lib()
        plan = (wide_plan(fn[10:], d, q.dtype).c_plan(),)
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
            q_offset, k_offset, 1.0 / math.sqrt(D), strides, *plan, stream)
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed ({rc}): {error_string(rc).decode()}")
    if plan:
        # graftlint: disable=jit-purity,retrace-hazard; a launch count: a rerun launches again
        WIDE_LAUNCHES[fn] += 1
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
    # graftlint: disable=jit-purity,retrace-hazard; a launch count: a rerun launches again
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
            # graftlint: disable=jit-purity,retrace-hazard; a launch count: a rerun launches again
            CHUNK_LAUNCHES["flash_bwd_dq"] += 1
            dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, kmask, causal,
                                        q_offset, k_offset)
            # graftlint: disable=jit-purity,retrace-hazard; a launch count: a rerun launches again
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
