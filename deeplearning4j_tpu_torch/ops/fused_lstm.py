"""Fused LSTM recurrence: the hand-written CUDA kernels and their plain versions.

Counterpart of ``deeplearning4j_tpu/ops/fused_lstm.py``. The TPU package
runs the whole LSTM / GravesLSTM recurrence over precomputed input rows
``zx = x @ Wx + b`` in one Pallas kernel with ``Wh`` resident in VMEM and
f32 h/c carries in scratch (``_fwd_kernel``), and the reverse-time sweep
in a second one (``_bwd_kernel``) behind a custom VJP. Here they are
``csrc/fused_lstm_fwd.cu`` (kernel #4) and ``csrc/fused_lstm_bwd.cu``
(kernel #5), CUDA C++ for Hopper (``sm_90a``) in float32, bfloat16 and
float16, built at first use and bound through ctypes (``ops/_build.py``).
Each walks the T steps by one of three routes that :func:`lstm_route`
picks from the hidden width, the dtype and the kernel: ``cluster``
(thread-block clusters that exchange h or dz through distributed shared
memory, one cluster barrier a step, no grid-wide synchronisation) where a
cluster's shared memory holds Wh; else ``wide`` (one cooperative launch
with a grid barrier a step) up to H = :data:`WIDE_MAX_HIDDEN`; else
``step`` (one launch a time step, the kernel boundary in place of the grid
barrier, Wh streamed from device memory every step), which takes any H.
Kernel #5 computes dWh after its sweep, as one product in the same
library. Their design
notes and bounds sit at the top of each source.

Dispatch follows one rule, with no fallback: a tensor on the CPU goes to
the plain version, a CUDA tensor goes to the kernel or raises.

- :func:`fused_lstm` — ``(out [B, T, H], (h_T, c_T))``, differentiable
  through :class:`_FusedLSTM`.
- :func:`fused_lstm_fwd_cuda`, :func:`fused_lstm_bwd_cuda` — the kernel
  wrappers, each counting its launches.
- :func:`fused_lstm_reference`, :func:`fused_lstm_bwd_reference` — the
  plain versions, step by step as the TPU kernels compute, with the same
  cast points (h and dz rounded to ``Wh``'s dtype before their products,
  residuals stored in ``zx``'s dtype, the backward's sums in f32).

Gate order is ``[i, f, g, o]``; ``peephole`` is ``[p_i | p_f | p_o]``
(GravesLSTM: ``c_prev`` feeds i and f, ``c_new`` feeds o). A masked step
outputs 0 and carries both h and c through unchanged. The TPU wrapper's
time chunking (``_pick_chunk``, ``_pad_time``) budgets a TPU core's VMEM;
the CUDA kernels walk every step in one launch and need neither.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch.obs import profile as _profile
from deeplearning4j_tpu_torch.ops import _build

__all__ = [
    "WIDE_MAX_HIDDEN",
    "bwd_operands",
    "cluster_smem_bytes",
    "fused_lstm",
    "fused_lstm_bwd_cuda",
    "fused_lstm_bwd_reference",
    "fused_lstm_fwd_cuda",
    "fused_lstm_reference",
    "lstm_route",
]

# the widest H of the cluster and wide routes: the wide route's grid of
# H / 8 blocks, each holding its Wh columns for all T steps, must be
# co-resident (H = 1024 f32: 128 blocks of 164 KB); wider takes ``step``
WIDE_MAX_HIDDEN = 1024
# the C interface's ``cluster`` argument for the two routes without clusters
_ROUTE_CODES = {"wide": 0, "step": -1}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_fwd_lib = None
_bwd_lib = None

# The cluster route's geometry, as csrc/lstm_common.cuh and the kernels'
# FwdCluster / BwdCluster layouts define it: a cluster owns at least _ROWS_C
# batch rows (9 only when the launch finds that ceil(B / 8) clusters would
# not all run at once and ceil(B / 9) would, and the layout still fits), its CTAs U = H / C hidden
# units each (C in _CLUSTER_SIZES, U <= 32 and a multiple of 8), the
# forward's product split in _KS k parts and the backward's in 2 _KS, and
# one CTA's shared memory may hold _SMEM_LIMIT bytes (227 KB, the opt-in
# maximum of a Hopper block).
_ROWS_C = 8
_KS = 8
_PADW = 4
_CLUSTER_SIZES = (4, 8, 16)
_SMEM_LIMIT = 232448


def _a16(n: int) -> int:
    return (n + 15) // 16 * 16


def cluster_smem_bytes(kernel: str, H: int, U: int, elem_bytes: int,
                       rows: int = _ROWS_C) -> int:
    """Shared memory of one cluster-route CTA with U units and ``rows``
    rows. Forward: the Wh slice [4U][H + 4] and the double-buffered h
    [2][rows][H] in the operand type, the product's partial sums
    [8][rows][4U] f32 and the CTA's h slice [rows][U]. Backward: the Wh rows
    [U][4H + 4] and the double-buffered dz [2][rows][4H] in the operand
    type, partial sums [16][rows][U] f32 and the dz slice [rows][4][U]."""
    e, R = elem_bytes, rows
    if kernel == "fwd":
        return (_a16(4 * U * (H + _PADW) * e) + _a16(2 * R * H * e)
                + _KS * R * 4 * U * 4 + _a16(R * U * e))
    return (_a16(U * (4 * H + _PADW) * e) + _a16(2 * R * 4 * H * e)
            + 2 * _KS * R * U * 4 + _a16(R * 4 * U * e))


@functools.lru_cache(maxsize=None)
def lstm_route(H: int, dtype: torch.dtype, kernel: str) -> Tuple[str, int]:
    """The route kernel #4 (``kernel="fwd"``) or #5 (``"bwd"``) takes for a
    hidden width and dtype: ``("cluster", C)`` with the smallest cluster
    size C in (4, 8, 16) whose CTAs hold U = H / C <= 32 units (a multiple
    of 8) within one block's shared memory, else ``("wide", 0)`` up to
    :data:`WIDE_MAX_HIDDEN`, else ``("step", 0)``. Raises a ValueError for a
    width or dtype the kernels do not take (H a multiple of 128; float32,
    bfloat16 or float16). At the char-RNN's H=256 both kernels take clusters
    of 8 in every dtype; f32 takes the wide route from H=512 (the backward
    from H=384), the 16-bit types from H=640; every dtype takes the step
    route from H=1152."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"fused LSTM kernels take float32, bfloat16 or float16, got {dtype}")
    if H % 128 or H < 128:
        raise ValueError(f"fused LSTM kernels take H a multiple of 128, got {H}")
    if kernel not in ("fwd", "bwd"):
        raise ValueError(f"kernel is 'fwd' or 'bwd', got {kernel!r}")
    es = torch.empty((), dtype=dtype).element_size()
    for C in _CLUSTER_SIZES:
        U = H // C
        if (H % C == 0 and U <= 32 and U % 8 == 0
                and cluster_smem_bytes(kernel, H, U, es) <= _SMEM_LIMIT):
            return "cluster", C
    return ("wide", 0) if H <= WIDE_MAX_HIDDEN else ("step", 0)


def _route_code(route: str, C: int) -> int:
    """The C interface's ``cluster`` argument: C, 0 (wide) or -1 (step)."""
    return C if route == "cluster" else _ROUTE_CODES[route]


def _fwd_kernel_lib() -> ctypes.CDLL:
    global _fwd_lib
    if _fwd_lib is None:
        lib = _build.load("fused_lstm_fwd")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # zx, wh, mask, peephole, hbuf, cbuf, hs, gates, cs, hT, cT,
        # B, T, H, dtype, cluster (C, 0 wide, -1 step), stream
        lib.fused_lstm_fwd.argtypes = [ptr] * 11 + [i32] * 5 + [ptr]
        lib.fused_lstm_fwd.restype = i32
        lib.fused_lstm_fwd_error_string.argtypes = [i32]
        lib.fused_lstm_fwd_error_string.restype = ctypes.c_char_p
        lib.fused_lstm_fwd_smem_bytes.argtypes = [i32, i32, i32]
        lib.fused_lstm_fwd_smem_bytes.restype = i64
        lib.fused_lstm_fwd_cluster_rows.argtypes = [i32] * 4
        lib.fused_lstm_fwd_cluster_rows.restype = i32
        _fwd_lib = lib
    return _fwd_lib


def _bwd_kernel_lib() -> ctypes.CDLL:
    global _bwd_lib
    if _bwd_lib is None:
        lib = _build.load("fused_lstm_bwd")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # gates, cs, cprev, hprev, wh, mask, dhs, peephole, dzx, dzr, dwh, dh,
        # dc, dpeep, work, B, T, H, dtype, cluster, stream
        lib.fused_lstm_bwd.argtypes = [ptr] * 15 + [i32] * 5 + [ptr]
        lib.fused_lstm_bwd.restype = i32
        lib.fused_lstm_bwd_workspace.argtypes = [i32] * 4
        lib.fused_lstm_bwd_workspace.restype = i64
        lib.fused_lstm_bwd_error_string.argtypes = [i32]
        lib.fused_lstm_bwd_error_string.restype = ctypes.c_char_p
        lib.fused_lstm_bwd_smem_bytes.argtypes = [i32, i32, i32]
        lib.fused_lstm_bwd_smem_bytes.restype = i64
        _bwd_lib = lib
    return _bwd_lib


def _check_shapes(zx, wh, who):
    """Raise on a recurrence the kernels do not take; returns (B, T, H)."""
    if zx.dim() != 3 or wh.dim() != 2:
        raise ValueError(f"{who}: zx must be [B, T, 4H] and wh [H, 4H], got "
                         f"{tuple(zx.shape)} and {tuple(wh.shape)}")
    B, T, Z = zx.shape
    H = wh.shape[0]
    if tuple(wh.shape) != (H, 4 * H) or Z != 4 * H:
        raise ValueError(f"{who}: zx {tuple(zx.shape)} and wh {tuple(wh.shape)} "
                         "do not form [B, T, 4H] and [H, 4H]")
    if H % 128 or H < 128:
        raise ValueError(f"{who} takes H a multiple of 128, got {H}")
    if B < 1 or T < 1:
        raise ValueError(f"{who} needs B >= 1 and T >= 1, got {tuple(zx.shape)}")
    return B, T, H


def _check_cuda(who, dtype, device, **named):
    """Every named tensor on ``device`` (CUDA); those given a dtype of None
    may be any float type, the others must have ``dtype``."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"{who} takes float32, bfloat16 or float16, got {dtype}")
    if device.type != "cuda":
        raise ValueError(f"{who} takes CUDA tensors, got {device}")
    for name, (x, want) in named.items():
        if x is None:
            continue
        if x.device != device:
            raise ValueError(f"{who}: {name} must lie on {device}, got {x.device}")
        if want is not None and x.dtype != want:
            raise ValueError(f"{who}: {name} is {x.dtype}, expected {want}")


def _f32(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if x is None else x.to(torch.float32).contiguous()


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def fused_lstm_fwd_cuda(zx: torch.Tensor, wh: torch.Tensor, h0: torch.Tensor,
                        c0: torch.Tensor, mask: Optional[torch.Tensor] = None,
                        peephole: Optional[torch.Tensor] = None):
    """Launch kernel #4 (``csrc/fused_lstm_fwd.cu``) on PyTorch's current
    stream: the recurrence over ``zx`` [B, T, 4H] with ``wh`` [H, 4H] (both
    of one dtype: f32, bf16 or f16; H a multiple of 128; the route is
    :func:`lstm_route`'s), carries
    ``h0``/``c0`` [B, H], optional ``mask`` [B, T] and ``peephole`` [3H].
    Returns ``(hs, gates, cs, h_T, c_T)`` in zx's dtype: the post-mask
    carries [B, T, H], the pre-mask gates [B, T, 4H], the post-mask cells
    [B, T, H] and the final carries [B, H]. Raises on anything the kernel
    does not take and on a failed launch. Each call adds one to
    ``fused_lstm_fwd_cuda.launches`` (the step route's T launches of one
    call count once, as the sweep of the other routes does)."""
    B, T, H = _check_shapes(zx, wh, "fused_lstm_fwd")
    _check_cuda("fused_lstm_fwd", zx.dtype, zx.device, wh=(wh, zx.dtype),
                h0=(h0, None), c0=(c0, None), mask=(mask, None),
                peephole=(peephole, None))
    if tuple(h0.shape) != (B, H) or tuple(c0.shape) != (B, H):
        raise ValueError(f"fused_lstm_fwd: h0/c0 must be [B, H] = {(B, H)}, got "
                         f"{tuple(h0.shape)} and {tuple(c0.shape)}")
    if mask is not None and tuple(mask.shape) != (B, T):
        raise ValueError(f"fused_lstm_fwd: mask must be [B, T] = {(B, T)}, "
                         f"got {tuple(mask.shape)}")
    if peephole is not None and tuple(peephole.shape) != (3 * H,):
        raise ValueError(f"fused_lstm_fwd: peephole must be [3H] = {(3 * H,)}, "
                         f"got {tuple(peephole.shape)}")
    route, C = lstm_route(H, zx.dtype, "fwd")
    lib = _fwd_kernel_lib()
    dev, dt = zx.device, zx.dtype
    zx, wh = zx.contiguous(), wh.contiguous()
    if route == "cluster":      # h0, c0 read once, carried in registers
        hbuf, cbuf = _f32(h0), _f32(c0)
    else:                       # wide, step: f32 carries exchanged between blocks, h double-buffered
        hbuf = torch.empty((2, B, H), dtype=torch.float32, device=dev)
        hbuf[0].copy_(h0)
        cbuf = _f32(c0).clone()
    m, peep = _f32(mask), _f32(peephole)
    hs = torch.empty((B, T, H), dtype=dt, device=dev)
    gates = torch.empty((B, T, 4 * H), dtype=dt, device=dev)
    cs = torch.empty((B, T, H), dtype=dt, device=dev)
    hT = torch.empty((B, H), dtype=dt, device=dev)
    cT = torch.empty((B, H), dtype=dt, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_lstm_fwd(
            zx.data_ptr(), wh.data_ptr(), _ptr(m), _ptr(peep), hbuf.data_ptr(),
            cbuf.data_ptr(), hs.data_ptr(), gates.data_ptr(), cs.data_ptr(),
            hT.data_ptr(), cT.data_ptr(), B, T, H, _DTYPE_CODES[dt], _route_code(route, C),
            stream)
    if rc != 0:
        msg = _rc_message(rc, lib.fused_lstm_fwd_error_string)
        raise RuntimeError(f"fused_lstm_fwd launch failed ({rc}, {route} route): {msg}")
    fused_lstm_fwd_cuda.launches += 1
    counter = _profile.active_counter()
    if counter is not None:   # a counting pass (obs/profile.py) is running
        counter.kernel("fused_lstm_fwd", *_profile.lstm_cost(
            B, T, H, zx.element_size(), "fwd", peep is not None))
    return hs, gates, cs, hT, cT


fused_lstm_fwd_cuda.launches = 0


def _rc_message(rc: int, error_string) -> str:
    if rc == -1:
        return "unsupported dtype or hidden width"
    if rc == -2:
        return "the wide route's grid cannot be co-resident on this device (cooperative launch)"
    return error_string(rc).decode()   # a cudaError_t


def fused_lstm_bwd_cuda(gates, cs, cprev, hprev, wh, m, dhs, dcT, peephole=None):
    """Launch kernel #5 (``csrc/fused_lstm_bwd.cu``): the reverse-time sweep.

    Operands as :func:`fused_lstm_bwd_reference` takes them: the forward's
    residuals ``gates`` [B, T, 4H] and ``cs`` [B, T, H] (zx's dtype), the
    shifted carries ``cprev`` [B, T, H] (f32) and ``hprev`` [B, T, H] (zx's
    dtype), ``wh`` [H, 4H], the f32 mask ``m`` [B, T], the f32 output
    cotangent ``dhs`` [B, T, H] (already times the mask, with dh_T folded
    into step T-1), the f32 ``dcT`` [B, H] and the optional ``peephole``.
    Returns f32 ``(dzx [B, T, 4H], dWh [H, 4H], dh0 [B, H], dc0 [B, H],
    dpeep [3H] or None)``. One call launches the sweep (:func:`lstm_route`'s
    route; T + 1 launches on the step route), then the dWh product and the
    fixed-order sum of its partials and of the peephole partials, all in the
    library; no atomics, so a run repeats bit for bit. Each call adds one to
    ``fused_lstm_bwd_cuda.launches``."""
    B, T, H = _check_shapes(gates, wh, "fused_lstm_bwd")
    dt = gates.dtype
    f32 = torch.float32
    _check_cuda("fused_lstm_bwd", dt, gates.device, wh=(wh, dt), cs=(cs, dt),
                hprev=(hprev, dt), cprev=(cprev, f32), m=(m, f32), dhs=(dhs, f32),
                dcT=(dcT, f32), peephole=(peephole, None))
    for name, x, shape in (("cs", cs, (B, T, H)), ("cprev", cprev, (B, T, H)),
                           ("hprev", hprev, (B, T, H)), ("m", m, (B, T)),
                           ("dhs", dhs, (B, T, H)), ("dcT", dcT, (B, H))):
        if tuple(x.shape) != shape:
            raise ValueError(f"fused_lstm_bwd: {name} must be {shape}, got {tuple(x.shape)}")
    if peephole is not None and tuple(peephole.shape) != (3 * H,):
        raise ValueError(f"fused_lstm_bwd: peephole must be [3H], got {tuple(peephole.shape)}")
    route, C = lstm_route(H, dt, "bwd")
    lib = _bwd_kernel_lib()
    dev = gates.device
    args = [x.contiguous() for x in (gates, cs, cprev, hprev, wh, m, dhs)]
    peep = _f32(peephole)
    dzx = torch.empty((B, T, 4 * H), dtype=f32, device=dev)
    # 16-bit types: dz rounded to the operand type, the tensor cores' dWh operand
    dzr = torch.empty((B, T, 4 * H), dtype=dt, device=dev) if dt != f32 else None
    dwh = torch.empty((H, 4 * H), dtype=f32, device=dev)
    # the carry cotangents: dh0 out (the wide and step routes read zeros in), dc_T in
    # and dc0 out, updated in place by their owning threads
    dh = torch.zeros((B, H), dtype=f32, device=dev)
    dc = dcT.to(f32).contiguous().clone()
    dpeep = torch.empty((3 * H,), dtype=f32, device=dev) if peep is not None else None
    # dWh split partials and peephole partials, summed in a fixed order
    work = torch.empty((lib.fused_lstm_bwd_workspace(B, T, H, _DTYPE_CODES[dt]),),
                       dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_lstm_bwd(
            *(x.data_ptr() for x in args[:6]), args[6].data_ptr(), _ptr(peep),
            dzx.data_ptr(), _ptr(dzr), dwh.data_ptr(), dh.data_ptr(), dc.data_ptr(),
            _ptr(dpeep), work.data_ptr(), B, T, H, _DTYPE_CODES[dt], _route_code(route, C),
            stream)
    if rc != 0:
        msg = _rc_message(rc, lib.fused_lstm_bwd_error_string)
        raise RuntimeError(f"fused_lstm_bwd launch failed ({rc}, {route} route): {msg}")
    fused_lstm_bwd_cuda.launches += 1
    counter = _profile.active_counter()
    if counter is not None:   # a counting pass (obs/profile.py) is running
        counter.kernel("fused_lstm_bwd", *_profile.lstm_cost(
            B, T, H, gates.element_size(), "bwd", peep is not None))
    return dzx, dwh, dh, dc, dpeep


fused_lstm_bwd_cuda.launches = 0


def _mask_f32(mask, B, T, zx):
    """The step mask as f32 [B, T], through zx's dtype as the TPU wrapper
    casts it (``mask.astype(zx.dtype)``); ones when there is none."""
    if mask is None:
        return torch.ones((B, T), dtype=torch.float32, device=zx.device)
    return mask.to(zx.dtype).to(torch.float32)


def fused_lstm_reference(zx, wh, h0, c0, mask=None, peephole=None, round_to=None):
    """The plain version of kernel #4, on any device, step by step as
    ``_fwd_kernel`` computes: f32 carries, ``h`` rounded to wh's dtype
    before the recurrent product (accumulated in f32), the masked blend
    ``m * new + (1 - m) * old``. Returns ``(hs, gates, cs, h_T, c_T)`` in
    zx's dtype, as the kernel does. ``round_to`` rounds ``h`` to another
    dtype instead (a control for the 16-bit tolerances)."""
    B, T, Z = zx.shape
    H = Z // 4
    dt = zx.dtype
    rdt = round_to or wh.dtype
    m = _mask_f32(mask, B, T, zx)
    whf = wh.float()
    peep = peephole.float() if peephole is not None else None
    h, c = h0.float(), c0.float()
    hs, gates, cs = [], [], []
    for t in range(T):
        z = zx[:, t].float() + h.to(rdt).float() @ whf
        if peep is not None:
            i = torch.sigmoid(z[:, :H] + c * peep[:H])
            f = torch.sigmoid(z[:, H:2 * H] + c * peep[H:2 * H])
            g = torch.tanh(z[:, 2 * H:3 * H])
            c_new = f * c + i * g
            o = torch.sigmoid(z[:, 3 * H:] + c_new * peep[2 * H:])
        else:
            i = torch.sigmoid(z[:, :H])
            f = torch.sigmoid(z[:, H:2 * H])
            g = torch.tanh(z[:, 2 * H:3 * H])
            o = torch.sigmoid(z[:, 3 * H:])
            c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        mt = m[:, t, None]
        h = mt * h_new + (1.0 - mt) * h
        c = mt * c_new + (1.0 - mt) * c
        hs.append(h.to(dt))
        cs.append(c.to(dt))
        gates.append(torch.cat([i, f, g, o], dim=-1).to(dt))
    return (torch.stack(hs, 1), torch.stack(gates, 1), torch.stack(cs, 1),
            h.to(dt), c.to(dt))


def fused_lstm_bwd_reference(gates, cs, cprev, hprev, wh, m, dhs, dcT, peephole=None,
                             round_to=None):
    """The plain version of kernel #5, on any device, step by step as
    ``_bwd_kernel`` computes, from the same operands as
    :func:`fused_lstm_bwd_cuda`: dz is rounded to wh's dtype before
    ``hprevᵀ·dz`` and ``dz·Whᵀ``; everything is summed in f32. Returns f32
    ``(dzx, dWh, dh0, dc0, dpeep or None)``. ``round_to`` rounds dz to
    another dtype instead (a control for the 16-bit tolerances)."""
    B, T, Z = gates.shape
    H = Z // 4
    wdt = wh.dtype
    rdt = round_to or wdt
    whf = wh.float()
    peep = peephole.float() if peephole is not None else None
    dh = torch.zeros((B, H), dtype=torch.float32, device=gates.device)
    dc = dcT.float()
    dwh = torch.zeros((H, Z), dtype=torch.float32, device=gates.device)
    dpeep = torch.zeros((3 * H,), dtype=torch.float32, device=gates.device)
    dzx = [None] * T
    for t in range(T - 1, -1, -1):
        gt = gates[:, t].float()
        i, f, g, o = gt[:, :H], gt[:, H:2 * H], gt[:, 2 * H:3 * H], gt[:, 3 * H:]
        c_t = cs[:, t].float()
        c_prev = cprev[:, t].float()
        mt = m[:, t, None].float()
        A = dh + dhs[:, t].float()
        C = dc
        tanh_c = torch.tanh(c_t)
        dh_g = A * mt
        do = dh_g * tanh_c * o * (1.0 - o)
        dcg = C * mt + dh_g * o * (1.0 - tanh_c * tanh_c)
        if peep is not None:
            dcg = dcg + do * peep[2 * H:]
        di = dcg * g * i * (1.0 - i)
        dg = dcg * i * (1.0 - g * g)
        df = dcg * c_prev * f * (1.0 - f)
        dz = torch.cat([di, df, dg, do], dim=-1)
        dzx[t] = dz
        dzw = dz.to(rdt).float()
        dwh = dwh + hprev[:, t].to(wdt).float().T @ dzw
        dh = dzw @ whf.T + A * (1.0 - mt)
        dc = dcg * f + C * (1.0 - mt)
        if peep is not None:
            dc = dc + di * peep[:H] + df * peep[H:2 * H]
            dpeep = dpeep + torch.cat([(di * c_prev).sum(0), (df * c_prev).sum(0),
                                       (do * c_t).sum(0)])
    return (torch.stack(dzx, 1), dwh, dh, dc,
            dpeep if peep is not None else None)


def bwd_operands(hs, cs, h0, c0, mask, dout, dhT):
    """The backward's operands built from the forward's residuals with torch
    ops, as the TPU wrapper builds them: the shifted carries ``cprev`` (f32)
    and ``hprev`` (hs's dtype) entering each step, the f32 mask ``m``, and
    the f32 output cotangent ``dhs`` times the mask, with ``dhT`` folded into
    the last step (h_T is hs[:, T-1]). Returns ``(cprev, hprev, m, dhs)``."""
    B, T, _ = hs.shape
    m = (torch.ones((B, T), dtype=torch.float32, device=hs.device)
         if mask is None else mask.float())
    dhs = dout.float() * m[..., None]
    dhs[:, T - 1] += dhT.float()
    hprev = torch.cat([h0.to(hs.dtype)[:, None], hs[:, :-1]], 1)
    cprev = torch.cat([c0.float()[:, None], cs[:, :-1].float()], 1)
    return cprev, hprev, m, dhs


class _FusedLSTM(torch.autograd.Function):
    """The TPU package's custom-VJP contract: the forward saves the gate and
    cell residuals, ``hs`` and the inputs it needs (not ``zx``); the
    backward builds the shifted carries with torch ops, folds ``dh_T`` into
    the last step's output cotangent and seeds the sweep with ``dc_T``, then
    runs kernel #5 on CUDA tensors (the plain backward on CPU tensors). The
    mask gets no gradient."""

    @staticmethod
    def forward(ctx, zx, wh, h0, c0, mask, peephole):
        fwd = fused_lstm_reference if zx.device.type == "cpu" else fused_lstm_fwd_cuda
        hs, gates, cs, hT, cT = fwd(zx, wh, h0, c0, mask, peephole)
        out = hs * mask.to(zx.dtype)[..., None] if mask is not None else hs
        ctx.save_for_backward(gates, wh, h0, c0, mask, peephole, hs, cs)
        return out, hT, cT

    @staticmethod
    def backward(ctx, dout, dhT, dcT):
        gates, wh, h0, c0, mask, peephole, hs, cs = ctx.saved_tensors
        cprev, hprev, m, dhs = bwd_operands(hs, cs, h0, c0, mask, dout, dhT)
        bwd = fused_lstm_bwd_reference if gates.device.type == "cpu" else fused_lstm_bwd_cuda
        dzx, dwh, dh0, dc0, dpeep = bwd(gates, cs, cprev, hprev, wh, m, dhs,
                                        dcT.float(), peephole)
        return (dzx.to(hs.dtype), dwh.to(wh.dtype), dh0.to(h0.dtype),
                dc0.to(c0.dtype), None,
                dpeep.to(peephole.dtype) if peephole is not None else None)


def fused_lstm(zx, wh, h0, c0, mask=None, peephole=None
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Weight-stationary LSTM recurrence over precomputed input rows.

    ``zx`` [B, T, 4H] (= x @ Wx + b, gate order [i, f, g, o]); ``wh``
    [H, 4H]; ``h0``/``c0`` [B, H]; ``mask`` optional [B, T] (a masked step
    carries state through and outputs 0); ``peephole`` optional [3H].
    Returns ``(out [B, T, H], (h_T, c_T))``, differentiable in zx, wh, h0,
    c0 and peephole, both final-carry cotangents included: kernels #4/#5 for
    CUDA tensors, the plain versions for CPU tensors."""
    if mask is not None:
        mask = torch.as_tensor(mask, device=zx.device).to(torch.float32)
    out, hT, cT = _FusedLSTM.apply(zx, wh, h0, c0, mask, peephole)
    return out, (hT, cT)
