"""Cost ledger and roofline utilization (MFU / memory bandwidth).

Counterpart of ``deeplearning4j_tpu/obs/profile.py``. The JAX package
prices the executables XLA compiles (``cost_analysis`` /
``memory_analysis``); PyTorch compiles nothing, so the port prices a
site by running it once under a **counting pass**, at warm time and never
per batch:

- ``torch.utils.flop_counter.FlopCounterMode`` counts the aten products
  (``mm`` / ``bmm`` / ``addmm`` / convolutions);
- a ``TorchDispatchMode`` sums every dispatched op's operand and result
  bytes (views and bare allocations excluded): XLA's "bytes accessed";
- every hand-written kernel launched in the pass adds its analytic flops
  and bytes. The kernels are ``ctypes`` calls that no dispatch mode sees,
  so each wrapper in ``ops/flash_attention.py`` and ``ops/fused_lstm.py``
  reports to :func:`active_counter` (one thread-local read when no pass is
  active). The formulas (:func:`attention_fwd_cost`, ...) are the ones the
  bound column of ``PERF.md`` §6 uses: ``chip_smoke.py`` computes its
  bounds through them.
- On the card ``peak_hbm_bytes`` is what the allocator held when the pass
  began plus the peak of the storages the pass allocated and still held
  (followed by the dispatch mode); on the CPU it is None. The pass leaves
  the allocator's process-wide peak statistic alone: that one belongs to
  the caller (``nn/memory.py`` resets it only when asked for a report).

Entries land in the in-process ledger under ``(site, key)`` and in the
same gauges as the JAX package's (``dl4j_xla_flops``,
``dl4j_xla_bytes_accessed``, ``dl4j_xla_peak_hbm_bytes``, ``dl4j_mfu``,
``dl4j_membw_util``), so a dashboard reads either package.

**Utilization's denominator.** A site's span (``mln.output``) ends when
its launches are queued, not when the card finishes them: nothing in it
synchronizes, so dividing by its p50 on the card would read an MFU above
100%. On the card :func:`utilization` divides by device time instead:
CUDA events that the ``nn/aot.py`` dispatcher records around one dispatch
in :data:`SAMPLE_EVERY` of a priced site, read here at report time and
never waited on in the dispatch path. On the CPU it divides by the host
span. A share above 1.0 is reported as an error in the report, never
clipped.

The roofline table holds the H100's published dense peaks only; CPU and
unknown devices give None unless ``DL4J_TPU_PEAK_FLOPS`` (FLOP/s) /
``DL4J_TPU_HBM_GBPS`` (GB/s) override them.
"""

from __future__ import annotations

import os
import threading
import weakref
from collections import deque
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.obs import metrics

__all__ = [
    "ROOFLINES",
    "active_counter",
    "attention_bwd_cost",
    "attention_fwd_cost",
    "attention_pairs",
    "bound",
    "chunk_cost",
    "cost_report",
    "count_pass",
    "harvest_compiled",
    "lstm_cost",
    "peak_flops",
    "record",
    "reset",
    "roofline",
    "snapshot",
    "utilization",
]

# Published dense peaks by device-name substring: (bf16 FLOP/s, f32 FLOP/s,
# HBM bytes/s). NVIDIA's H100 SXM data sheet: 989 TFLOP/s bf16 on the tensor
# cores, 67 TFLOP/s f32 FMA outside them, 3.35 TB/s HBM3, at 700 W.
ROOFLINES: Tuple[Tuple[str, float, float, float], ...] = (
    ("h100", 989e12, 67e12, 3.35e12),
)

# Which span's per-dispatch wall time prices a site on the CPU.
_SITE_SPANS = {
    "mln.step": "mln.fit_batch",
    "mln.step.tbptt": "mln.fit_batch",
    "cg.step": "cg.fit_batch",
    "cg.step.tbptt": "cg.fit_batch",
    "dp.step": "dp.step",
    "mln.output": "mln.output",
    "cg.output": "cg.output",
}

_lock = threading.Lock()
_costs: Dict[Tuple[str, str], dict] = {}
# (site, key) -> recent (start, end) CUDA event pairs, then their ms
_events: Dict[Tuple[str, str], deque] = {}
_times: Dict[Tuple[str, str], deque] = {}
_dispatches: Dict[str, int] = {}
_TLS = threading.local()
# one dispatch in this many of a priced site records CUDA events
SAMPLE_EVERY = 16


def _gauges():
    reg = metrics.registry()
    return (
        reg.gauge("dl4j_xla_flops",
                  "FLOPs of one dispatch of the site: the aten products a "
                  "counting pass saw plus the analytic count of every "
                  "hand-written kernel it launched", ("site", "key")),
        reg.gauge("dl4j_xla_bytes_accessed",
                  "bytes of one dispatch: every op's operands and results "
                  "plus the kernels' analytic bytes", ("site", "key")),
        reg.gauge("dl4j_xla_peak_hbm_bytes",
                  "the caching allocator's peak over the counting pass "
                  "(CUDA sites only)", ("site", "key")),
    )


# ---------------------------------------------------------------------------
# Roofline table
# ---------------------------------------------------------------------------

def _device_kind() -> str:
    try:
        import torch

        if torch.cuda.is_available():
            return torch.cuda.get_device_name(0)
    except Exception:
        pass
    return "cpu"


def roofline(device_kind: Optional[str] = None) -> dict:
    """Peak numbers for the device: ``{device_kind, peak_bf16_flops,
    peak_f32_flops, hbm_bytes_per_s, source}``. Peaks are None for the CPU
    and unknown devices unless ``DL4J_TPU_PEAK_FLOPS`` (FLOP/s) /
    ``DL4J_TPU_HBM_GBPS`` (GB/s) override them."""
    kind = device_kind if device_kind is not None else _device_kind()
    bf16 = f32 = hbm = None
    source = "unknown"
    low = kind.lower()
    for sub, peak_bf16, peak_f32, peak_hbm in ROOFLINES:
        if sub in low:
            bf16, f32, hbm = peak_bf16, peak_f32, peak_hbm
            source = "table"
            break
    env_flops = os.environ.get("DL4J_TPU_PEAK_FLOPS")
    if env_flops:
        try:
            bf16 = f32 = float(env_flops)
            source = "env"
        except ValueError:
            pass
    env_hbm = os.environ.get("DL4J_TPU_HBM_GBPS")
    if env_hbm:
        try:
            hbm = float(env_hbm) * 1e9
            source = "env"
        except ValueError:
            pass
    return {"device_kind": kind, "peak_bf16_flops": bf16, "peak_f32_flops": f32,
            "hbm_bytes_per_s": hbm, "source": source}


def peak_flops(dtype: str = "bfloat16",
               device_kind: Optional[str] = None) -> Optional[float]:
    """Peak FLOP/s for products in ``dtype`` (bf16 and f16 on the tensor
    cores, anything else on the f32 FMA units); None for the CPU and unknown
    devices."""
    r = roofline(device_kind)
    low = dtype in ("bfloat16", "float16", "torch.bfloat16", "torch.float16")
    return r["peak_bf16_flops"] if low else r["peak_f32_flops"]


# ---------------------------------------------------------------------------
# Analytic counts of the hand-written kernels (PERF.md §6's bound column)
# ---------------------------------------------------------------------------

def attention_pairs(Tq: int, Tk: int, causal: bool, q_offset: int = 0,
                    k_offset: int = 0) -> int:
    """The (query, key) pairs a causal mask keeps (all Tq * Tk without one):
    query q sees keys k <= q + q_offset - k_offset."""
    if not causal:
        return Tq * Tk
    if Tq == Tk and q_offset == k_offset:
        return Tq * (Tq + 1) // 2
    # graftlint: disable=numpy-on-tracer; Tq, Tk and the offsets are host ints
    seen = np.clip(np.arange(Tq) + q_offset - k_offset + 1, 0, Tk)
    return int(seen.sum())


def attention_fwd_cost(B, Tq, Tk, H, D, causal, elem_bytes, kmask=False,
                       q_offset=0, k_offset=0) -> Tuple[float, float]:
    """(flops, bytes) of kernel #1: its two products over the kept pairs,
    q/k/v read and out written once, the f32 lse written, the f32 key mask
    read."""
    pairs = attention_pairs(Tq, Tk, causal, q_offset, k_offset)
    flops = 4.0 * B * H * pairs * D
    nbytes = (2.0 * B * Tq + 2.0 * B * Tk) * H * D * elem_bytes + 4.0 * B * H * Tq
    if kmask:
        nbytes += 4.0 * B * Tk
    return flops, nbytes


def attention_bwd_cost(B, Tq, Tk, H, D, causal, elem_bytes, kernel, kmask=False,
                       q_offset=0, k_offset=0) -> Tuple[float, float]:
    """(flops, bytes) of one backward kernel: its products over the kept
    pairs (S, dP, dQ for ``"dq"``; S, dP, dV, dK for ``"dkv"``), q, k, v, do,
    lse and delta read once and its gradients written once."""
    pairs = attention_pairs(Tq, Tk, causal, q_offset, k_offset)
    if kernel == "dq":      # q, do, dq on the query side; k, v on the key side
        products, q_side, k_side = 3, 3, 2
    else:                   # q, do; k, v, dk, dv
        products, q_side, k_side = 4, 2, 4
    flops = 2.0 * products * B * H * pairs * D
    nbytes = ((q_side * B * Tq + k_side * B * Tk) * H * D * elem_bytes
              + 2 * 4.0 * B * H * Tq)
    if kmask:
        nbytes += 4.0 * B * Tk
    return flops, nbytes


def chunk_cost(B, Tq, Tk, H, D, pairs, elem_bytes, with_bwd) -> Tuple[float, float]:
    """(flops, bytes) of a chunk entry as a function (PERF.md row 6): its
    products over the kept pairs (the forward's two; with the backward five
    more: S and dP again, dQ, dK, dV), q, k, v read and out, lse written
    once; with the backward also do and dlse read, dq, dk and dv written."""
    flops = (2 + 2 + (10 if with_bwd else 0)) * B * H * pairs * D
    q_side, k_side = B * Tq * H * D * elem_bytes, B * Tk * H * D * elem_bytes
    nbytes = 2 * q_side + 2 * k_side + 4.0 * B * H * Tq
    if with_bwd:
        nbytes += 2 * q_side + 2 * k_side + 4.0 * B * H * Tq
    return float(flops), float(nbytes)


def lstm_cost(B, T, H, elem_bytes, kernel, peep=True) -> Tuple[float, float]:
    """(flops, bytes) of one fused-LSTM launch: the recurrent products (one
    forward, two backward) and every input read once and output written
    once."""
    e, f4 = float(elem_bytes), 4.0
    btH, bH = B * T * H, B * H
    if kernel == "fwd":
        flops = 2.0 * B * T * H * 4 * H
        # zx, Wh, h0, c0 (and peepholes) in; hs, gates, cs, h_T, c_T out
        nbytes = e * (4 * btH + 4 * H * H + 2 * bH) + e * (6 * btH + 2 * bH)
    else:
        flops = 2 * 2.0 * B * T * H * 4 * H
        # gates, cs, hprev (zx's dtype), cprev, dhs, mask (f32), Wh, dc_T in;
        # dzx, dWh, dh0, dc0 (f32) out
        nbytes = (e * (4 * btH + 2 * btH + 4 * H * H) + f4 * (2 * btH + B * T + bH)
                  + f4 * (4 * btH + 4 * H * H + 2 * bH))
    if peep:
        nbytes += e * 3 * H + (f4 * 3 * H if kernel == "bwd" else 0.0)
    return flops, nbytes


def bound(flops: float, nbytes: float, peak: float,
          peak_bytes: float) -> Tuple[float, str]:
    """(least ms, what bounds it): the larger of flops over the peak rate
    and bytes over the memory rate."""
    t_ops, t_bytes = flops / peak, nbytes / peak_bytes
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# The counting pass
# ---------------------------------------------------------------------------

class _Counter:
    """What the hand-written kernels of one counting pass report."""

    __slots__ = ("kernels",)

    def __init__(self):
        self.kernels: Dict[str, dict] = {}

    def kernel(self, name: str, flops: float, nbytes: float) -> None:
        k = self.kernels.setdefault(name, {"launches": 0, "flops": 0.0, "bytes": 0.0})
        k["launches"] += 1
        k["flops"] += float(flops)
        k["bytes"] += float(nbytes)


def active_counter() -> Optional[_Counter]:
    """The counting pass running on this thread, or None (the kernel
    wrappers' one read per launch)."""
    return getattr(_TLS, "counter", None)


def _nbytes(t) -> int:
    return int(t.numel()) * t.element_size()


def _bytes_mode(track_live: bool = False):
    """A TorchDispatchMode summing every op's operand and result bytes; with
    ``track_live`` it also follows the storages the pass allocates (by
    pointer, released when their last tensor dies; a result that writes
    into an operand's storage, as an in-place update does, is not new) and
    keeps the peak of their bytes."""
    import torch
    from torch.utils import _pytree as pytree
    from torch.utils._python_dispatch import TorchDispatchMode

    skip = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
            torch.ops.aten.empty_like.default}

    class _Bytes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.bytes = 0
            self.live = 0
            self.peak = 0
            self._refs: Dict[int, list] = {}

        def _release(self, ptr):
            rec = self._refs.get(ptr)
            if rec is None:
                return
            rec[1] -= 1
            if rec[1] <= 0:
                self.live -= rec[0]
                del self._refs[ptr]

        def _track(self, t, operands):
            storage = t.untyped_storage()
            ptr = storage.data_ptr()
            if ptr in operands:
                return
            rec = self._refs.get(ptr)
            if rec is None:
                rec = self._refs[ptr] = [storage.nbytes(), 0]
                self.live += rec[0]
                self.peak = max(self.peak, self.live)
            rec[1] += 1
            weakref.finalize(t, self._release, ptr)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if getattr(func, "is_view", False):
                return out
            ins = [x for x in pytree.tree_leaves((args, kwargs or {}))
                   if isinstance(x, torch.Tensor)]
            outs = [x for x in pytree.tree_leaves(out) if isinstance(x, torch.Tensor)]
            if track_live:
                operands = {x.untyped_storage().data_ptr() for x in ins}
                for x in outs:
                    self._track(x, operands)
            if func not in skip:
                self.bytes += sum(_nbytes(x) for x in ins) + sum(_nbytes(x) for x in outs)
            return out

    return _Bytes()


def count_pass(fn: Callable, device=None, dtype: str = "") -> Tuple[object, dict]:
    """Run ``fn()`` once under the counting pass; returns ``(result,
    entry)``. The entry holds ``flops``, ``bytes_accessed``, the kernels'
    own counts under ``kernels``, ``peak_hbm_bytes`` (CUDA only: allocated
    at the start plus the peak of what the pass allocated) and the
    device."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    cuda = device is not None and torch.device(device).type == "cuda"
    counter = _Counter()
    base = torch.cuda.memory_allocated(device) if cuda else 0
    prev = getattr(_TLS, "counter", None)
    _TLS.counter = counter
    try:
        fc = FlopCounterMode(display=False)
        with fc, _bytes_mode(track_live=cuda) as bm:
            out = fn()
    finally:
        _TLS.counter = prev
    kflops = sum(k["flops"] for k in counter.kernels.values())
    kbytes = sum(k["bytes"] for k in counter.kernels.values())
    entry = {
        "source": "count",
        "flops": float(fc.get_total_flops()) + kflops,
        "bytes_accessed": float(bm.bytes) + kbytes,
        "kernels": counter.kernels,
        "peak_hbm_bytes": float(base + bm.peak) if cuda else None,
        "device": "cuda" if cuda else "cpu",
    }
    if dtype:
        entry["dtype"] = str(dtype).replace("torch.", "")
    return out, entry


def harvest_compiled(site: str, fn: Callable, key: str, dtype: str = "",
                     device=None) -> Tuple[object, dict]:
    """Price one dispatch of ``site`` by a counting pass of ``fn()`` and
    record it under ``(site, key)``. Called by ``nn/aot.py`` at warm time,
    never on the dispatch path. Returns ``(result, entry)``."""
    out, entry = count_pass(fn, device=device, dtype=dtype)
    record(site, key, entry)
    return out, entry


def record(site: str, key: str, entry: dict) -> None:
    """Put an entry in the ledger (a counting pass's, or one a bundle
    carried) and set its gauges."""
    with _lock:
        _costs[(site, str(key))] = dict(entry)
    g_flops, g_bytes, g_hbm = _gauges()
    if entry.get("flops"):
        g_flops.set(entry["flops"], site=site, key=str(key))
    if entry.get("bytes_accessed"):
        g_bytes.set(entry["bytes_accessed"], site=site, key=str(key))
    if entry.get("peak_hbm_bytes"):
        g_hbm.set(entry["peak_hbm_bytes"], site=site, key=str(key))


def entry_for(site: str, key: str) -> Optional[dict]:
    with _lock:
        e = _costs.get((site, str(key)))
    return dict(e) if e is not None else None


# ---------------------------------------------------------------------------
# Device time of priced dispatches
# ---------------------------------------------------------------------------

def sample_start(site: str, key: str):
    """Called by the dispatcher before a CUDA dispatch of a priced site:
    one dispatch in :data:`SAMPLE_EVERY` gets a start event (returned)
    recorded on the current stream; None for the others."""
    with _lock:
        if (site, key) not in _costs:
            return None
        n = _dispatches.get(site, 0)
        _dispatches[site] = n + 1
    if n % SAMPLE_EVERY:
        return None
    import torch

    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def sample_stop(site: str, key: str, start) -> None:
    """Record the end event of a sampled dispatch; read at report time."""
    import torch

    end = torch.cuda.Event(enable_timing=True)
    end.record()
    with _lock:
        _events.setdefault((site, key), deque(maxlen=64)).append((start, end))


def device_seconds(site: str, key: str) -> Optional[float]:
    """p50 device time (s) of the sampled dispatches of ``(site, key)`` that
    have finished; None before any has. Reads events without waiting."""
    with _lock:
        pend = _events.get((site, key))
        pairs = list(pend) if pend else []
        if pend:
            pend.clear()
    done, later = [], []
    for a, b in pairs:
        (done if b.query() else later).append((a, b))
    with _lock:
        if later:
            _events.setdefault((site, key), deque(maxlen=64)).extendleft(reversed(later))
        times = _times.setdefault((site, key), deque(maxlen=256))
        times.extend(a.elapsed_time(b) / 1e3 for a, b in done)
        vals = list(times)
    return float(np.median(vals)) if vals else None


# ---------------------------------------------------------------------------
# Reports
# ---------------------------------------------------------------------------

def utilization(span_summary: Optional[Dict[str, dict]] = None) -> Dict[str, dict]:
    """MFU and memory-bandwidth share per priced site, from its
    largest-flops entry: flops (bytes) over the time of one dispatch over
    the peak for the entry's dtype (bandwidth). A CUDA site divides by the
    p50 device time of its sampled dispatches at that key (no sample yet:
    no row); a CPU site by the p50 of its host span. A share above 1.0 is
    kept as measured and named under ``error``. Refreshes the ``dl4j_mfu``
    / ``dl4j_membw_util`` gauges. Empty without a roofline."""
    r = roofline()
    if not r["peak_bf16_flops"] and not r["hbm_bytes_per_s"]:
        return {}
    if span_summary is None:
        from deeplearning4j_tpu_torch.obs import spans

        span_summary = spans.tracer().summary()
    with _lock:
        by_site: Dict[str, dict] = {}
        for (site, key), entry in _costs.items():
            if entry.get("flops", 0) > by_site.get(site, {}).get("flops", -1):
                by_site[site] = {**entry, "key": key}
    reg = metrics.registry()
    g_mfu = reg.gauge("dl4j_mfu", "model FLOPs utilization: flops of one "
                      "dispatch over its time (device time on a card) over "
                      "the peak for its dtype", ("site",))
    g_bw = reg.gauge("dl4j_membw_util", "bytes accessed by one dispatch over "
                     "its time over peak HBM bandwidth", ("site",))
    out: Dict[str, dict] = {}
    for site, entry in by_site.items():
        if entry.get("device") == "cuda":
            wall = device_seconds(site, entry["key"])
            timebase = "device"
        else:
            s = span_summary.get(_SITE_SPANS.get(site, site)) or {}
            wall = s.get("wall_p50_s") if s.get("count") else None
            timebase = "host_span"
        if not wall:
            continue
        peak = peak_flops(entry.get("dtype", "float32"))
        u = {"key": entry["key"], "seconds": wall, "timebase": timebase,
             "source": entry["source"]}
        errors = []
        if peak and entry.get("flops"):
            u["achieved_flops_per_s"] = entry["flops"] / wall
            u["peak_flops"] = peak
            u["mfu"] = entry["flops"] / wall / peak
            g_mfu.set(round(u["mfu"], 6), site=site)
            if u["mfu"] > 1.0:
                errors.append(f"mfu {u['mfu']:.4f} above 1.0")
        if r["hbm_bytes_per_s"] and entry.get("bytes_accessed"):
            u["achieved_bytes_per_s"] = entry["bytes_accessed"] / wall
            u["membw_util"] = entry["bytes_accessed"] / wall / r["hbm_bytes_per_s"]
            g_bw.set(round(u["membw_util"], 6), site=site)
            if u["membw_util"] > 1.0:
                errors.append(f"membw_util {u['membw_util']:.4f} above 1.0")
        if errors:
            u["error"] = "; ".join(errors) + f" ({timebase} time)"
        if "mfu" in u or "membw_util" in u:
            out[site] = u
    return out


def cost_report(resolve: bool = True) -> dict:
    """The ledger: roofline, per-(site, key) costs, and utilization.
    ``resolve`` is kept for the JAX package's signature: every entry here
    is priced when its site is warmed."""
    with _lock:
        sites: Dict[str, dict] = {}
        for (site, key), entry in sorted(_costs.items()):
            sites.setdefault(site, {})[key] = dict(entry)
    return {"roofline": roofline(), "sites": sites, "utilization": utilization()}


def snapshot(resolve: bool = True) -> dict:
    """JSON-friendly view for ``obs.snapshot()`` (same shape as
    :func:`cost_report`); never raises."""
    try:
        return cost_report(resolve=resolve)
    except Exception:
        return {"roofline": {"device_kind": "unknown", "source": "error"},
                "sites": {}, "utilization": {}}


def reset():
    """Drop the ledger and the device-time samples."""
    with _lock:
        _costs.clear()
        _events.clear()
        _times.clear()
        _dispatches.clear()
