"""Shape-bucketed execution: the batch-size ladder and its telemetry.

Counterpart of ``deeplearning4j_tpu/utils/bucketing.py``. A batch's leading
dimension is rounded up to the next rung of a geometric ladder, so mixed
request sizes collapse onto a small fixed set of shapes: under XLA that
bounds the compiled executables, here it bounds the set of GEMM and kernel
shapes the serving tier warms and measures (and the admission controller's
per-bucket latency estimates are keyed by the same rungs).

- ``BucketLadder`` / ``bucket_size`` / ``ladder_from_env`` — the ladder;
- ``pad_rows_zero`` / ``unpad`` — zero-pad the batch axis of a tensor (or
  array) up to a rung and slice results back; inference is
  row-independent, so padded rows are dead compute;
- ``reachable_buckets`` — every rung a batch of 1..n rows can land on (the
  JAX package keeps it in ``nn/aot.py``; the serving warm-up uses it);
- ``tile_pad`` / ``padded_label_mask`` / ``pad_fit_batch`` — the fit
  loop's padding of a partial tail batch up to the full row count, with a
  pre-scaled label mask so the loss stays the mean over the real rows;
- ``telemetry()`` — process-wide bucket-hit, padding and compile counters,
  kept in the obs metrics registry (``dl4j_bucketing_*``,
  ``dl4j_compiles_total``) so /metrics shows them. PyTorch compiles no
  executable; a "compile" here is the first dispatch of a new signature
  at a site (``record_trace``, called by ``nn/aot.py``'s sites): the
  cold-shape cost a new shape pays on the card (cuBLAS heuristics,
  allocator growth, template selection), and what a CUDA-graph capture
  would have to capture. The retrace guard (``analysis/retrace_guard.py``)
  bounds it by the buckets a site's traffic used.

Env knobs (read per call; the same names as the JAX package):

- ``DL4J_TPU_BUCKETING``       master switch (default 1)
- ``DL4J_TPU_BUCKETS``         explicit ascending ladder, e.g. "8,16,32,64";
                               sizes beyond the top rung keep growing
                               geometrically from it
- ``DL4J_TPU_BUCKET_MIN``      smallest rung of the geometric ladder (default 1)
- ``DL4J_TPU_BUCKET_GROWTH``   ladder growth factor (default 2.0, must be >1)
"""

from __future__ import annotations

import math
import os
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "BucketLadder",
    "BucketTelemetry",
    "bucket_size",
    "bucketing_enabled",
    "ladder_from_env",
    "pad_fit_batch",
    "pad_fit_multi",
    "pad_rows_zero",
    "padded_label_mask",
    "reachable_buckets",
    "telemetry",
    "tile_pad",
    "unpad",
]


@dataclass(frozen=True)
class BucketLadder:
    """Ascending bucket rungs. ``rungs`` may be an explicit list; beyond the
    top rung (or with no explicit rungs) sizes grow geometrically by
    ``growth`` starting at ``min_size``/the top rung."""

    rungs: Tuple[int, ...] = ()
    min_size: int = 1
    growth: float = 2.0

    def __post_init__(self):
        if self.min_size < 1:
            raise ValueError(f"bucket min_size must be >= 1, got {self.min_size}")
        if self.growth <= 1.0:
            raise ValueError(f"bucket growth must be > 1, got {self.growth}")
        if any(b <= a for a, b in zip(self.rungs, self.rungs[1:])):
            raise ValueError(f"bucket rungs must be strictly ascending, got {self.rungs}")

    def bucket(self, n: int) -> int:
        """Smallest rung >= n."""
        if n <= 0:
            return n
        for r in self.rungs:
            if n <= r:
                return r
        top = self.rungs[-1] if self.rungs else self.min_size
        while top < n:
            top = max(top + 1, int(math.ceil(top * self.growth)))
        return top


def ladder_from_env() -> BucketLadder:
    """Ladder from the DL4J_TPU_BUCKET* env knobs, with errors naming the
    variable."""
    raw = os.environ.get("DL4J_TPU_BUCKETS")
    rungs: Tuple[int, ...] = ()
    if raw:
        try:
            rungs = tuple(int(tok) for tok in raw.split(",") if tok.strip())
        except ValueError:
            raise ValueError(
                f"DL4J_TPU_BUCKETS must be comma-separated integers, got {raw!r}")
    try:
        min_size = int(os.environ.get("DL4J_TPU_BUCKET_MIN", "1"))
    except ValueError:
        raise ValueError(
            "DL4J_TPU_BUCKET_MIN must be an integer, got "
            f"{os.environ.get('DL4J_TPU_BUCKET_MIN')!r}")
    try:
        growth = float(os.environ.get("DL4J_TPU_BUCKET_GROWTH", "2.0"))
    except ValueError:
        raise ValueError(
            "DL4J_TPU_BUCKET_GROWTH must be a number, got "
            f"{os.environ.get('DL4J_TPU_BUCKET_GROWTH')!r}")
    return BucketLadder(rungs=rungs, min_size=min_size, growth=growth)


def bucketing_enabled() -> bool:
    return os.environ.get("DL4J_TPU_BUCKETING", "1") != "0"


def bucket_size(n: int, ladder: Optional[BucketLadder] = None) -> int:
    """Round ``n`` up to its bucket on ``ladder`` (env ladder by default)."""
    return (ladder or ladder_from_env()).bucket(n)


def reachable_buckets(max_n: int,
                      ladder: Optional[BucketLadder] = None) -> List[int]:
    """Every bucket a leading dim in [1, max_n] can land on, walked bucket
    boundary by bucket boundary."""
    ladder = ladder or ladder_from_env()
    out: List[int] = []
    n = 1
    while n <= max_n:
        b = ladder.bucket(n)
        out.append(b)
        n = b + 1
    return out


class BucketTelemetry:
    """Process-wide compile and bucket-hit counters (thread-safe: serving
    dispatchers record concurrently), stored in obs registry families so
    they are scrapeable at /metrics. ``record_trace`` counts one compile
    (a site's first dispatch of a new signature); ``record_hit`` counts one
    padded dispatch. The process singleton (``telemetry()``) shares the
    process registry; ad-hoc instances get a private registry so tests
    can't cross-talk."""

    def __init__(self, registry=None):
        from deeplearning4j_tpu_torch.obs import metrics as _obs_metrics

        reg = registry if registry is not None else _obs_metrics.MetricsRegistry()
        self._lock = threading.Lock()
        self._traces = reg.counter(
            "dl4j_bucketing_traces_total",
            "compiles by site: first dispatches of a new signature", ("site",))
        # the JAX package's public compile counter, same increment
        self._compiles = reg.counter(
            "dl4j_compiles_total",
            "compiles by site (a site's first dispatch of a new signature, "
            "warm or lazy; see dl4j_aot_warm_hits_total for warm hits)",
            ("site",))
        self.trace_shapes: Dict[str, set] = {}
        self._hits = reg.counter(
            "dl4j_bucketing_hits_total",
            "padded dispatches by site and bucket rung", ("site", "bucket"))
        self._padded = reg.counter(
            "dl4j_bucketing_padded_examples_total",
            "padding waste: rows added to reach bucket rungs")
        self._real = reg.counter(
            "dl4j_bucketing_real_examples_total",
            "real rows dispatched through bucketed paths")
        self._guard = reg.counter(
            "dl4j_guard_events_total",
            "divergence-guard events (invalid_score, warn/skip_batch/"
            "rollback trips, rollback_restore)", ("event",))
        self._comm = reg.gauge(
            "dl4j_comm_bytes",
            "per-step collective bytes by exchange site (dense = hypothetical "
            "dense all-reduce, wire = configured exchange, param = sharded-"
            "update all-gather); describes a configuration, latest wins",
            ("site", "kind"))

    def reset(self):
        with self._lock:
            for fam in (self._traces, self._compiles, self._hits, self._padded,
                        self._real, self._guard, self._comm):
                fam.clear()
            self.trace_shapes = {}

    def record_trace(self, site: str, shape: Sequence[int]):
        """Count one compile at ``site``: the first dispatch of a new
        signature there, whose leading shape is ``shape``."""
        with self._lock:
            self.trace_shapes.setdefault(site, set()).add(tuple(shape))
        self._compiles.inc(site=site)
        self._traces.inc(site=site)

    @property
    def traces(self) -> Dict[str, int]:
        return {k[0]: int(v) for k, v in self._traces.as_dict().items()}

    def compiles(self, site: Optional[str] = None) -> int:
        if site is not None:
            return int(self._traces.value(site=site))
        return sum(self.traces.values())

    def record_hit(self, site: str, n: int, bucket: int):
        self._hits.inc(site=site, bucket=bucket)
        self._real.inc(n)
        self._padded.inc(max(bucket - n, 0))

    def record_guard(self, event: str):
        """Count one divergence-guard event (``invalid_score``, a policy trip
        ``warn``/``skip_batch``/``rollback``, or ``rollback_restore``;
        train/resilience.py)."""
        self._guard.inc(event=event)

    def record_comm(self, site: str, dense_bytes: int, wire_bytes: int,
                    param_bytes: int = 0):
        """A site's per-step collective bytes (``parallel/grads.py``
        ``DataParallelStep.comm_stats``): what a dense all-reduce of the
        exchanged gradients would move, what the configured exchange moves,
        and the sharded update's all-gather of updated params. Latest wins:
        the numbers describe a configuration, not a running total."""
        self._comm.set(int(dense_bytes), site=site, kind="dense_bytes")
        self._comm.set(int(wire_bytes), site=site, kind="wire_bytes")
        self._comm.set(int(param_bytes), site=site, kind="param_bytes")

    @property
    def comm(self) -> Dict[str, Dict[str, int]]:
        """{site: {dense_bytes, wire_bytes, param_bytes}}."""
        out: Dict[str, Dict[str, int]] = {}
        for (site, kind), v in self._comm.as_dict().items():
            out.setdefault(site, {})[kind] = int(v)
        return out

    @property
    def guard_events(self) -> Dict[str, int]:
        return {k[0]: int(v) for k, v in self._guard.as_dict().items()}

    @property
    def bucket_hits(self) -> Dict[Tuple[str, int], int]:
        return {(k[0], int(k[1])): int(v)
                for k, v in self._hits.as_dict().items()}

    @property
    def padded_examples(self) -> int:
        return int(self._padded.value())

    @property
    def real_examples(self) -> int:
        return int(self._real.value())

    def buckets_used(self, site: Optional[str] = None) -> Tuple[int, ...]:
        return tuple(sorted({int(b) for (s, b) in self._hits.as_dict()
                             if site is None or s == site}))

    def snapshot(self) -> dict:
        """JSON-friendly view."""
        return {
            "traces": self.traces,
            "bucket_hits": {f"{s}:{b}": c
                            for (s, b), c in sorted(self.bucket_hits.items())},
            "padded_examples": self.padded_examples,
            "real_examples": self.real_examples,
            "guard": self.guard_events,
            "comm": self.comm,
        }


_TELEMETRY: Optional[BucketTelemetry] = None
_TELEMETRY_LOCK = threading.Lock()


def telemetry() -> BucketTelemetry:
    """The process singleton over the obs registry (built on first use)."""
    global _TELEMETRY
    with _TELEMETRY_LOCK:
        if _TELEMETRY is None:
            from deeplearning4j_tpu_torch.obs import metrics as _obs_metrics

            _TELEMETRY = BucketTelemetry(registry=_obs_metrics.registry())
        return _TELEMETRY


def pad_rows_zero(a, target: int):
    """Zero-pad the leading (batch) axis up to ``target`` rows. Tensors stay
    on their device; numpy arrays stay numpy."""
    if a is None:
        return None
    n = a.shape[0]
    if n >= target:
        return a
    if isinstance(a, torch.Tensor):
        pad = torch.zeros((target - n,) + tuple(a.shape[1:]), dtype=a.dtype,
                          device=a.device)
        return torch.cat([a, pad], dim=0)
    a = np.asarray(a)
    return np.pad(a, [(0, target - n)] + [(0, 0)] * (a.ndim - 1))


def unpad(out, n: int):
    """Slice a padded result (tensor, array, or tuple/list/dict of them)
    back to ``n`` rows."""
    if isinstance(out, dict):
        return {k: unpad(v, n) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return type(out)(unpad(v, n) for v in out)
    return out[:n]


def tile_pad(a, pad: int):
    """Append ``pad`` rows to ``a`` by tiling its real rows (zero rows when
    it is empty). Tiled rows keep batch-coupled numerics benign; the caller
    zero-weights them in the loss. Tensors stay tensors on their device,
    anything else becomes a numpy array."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        if len(a) == 0:
            return a.new_zeros((pad,) + tuple(a.shape[1:]))
        reps = a.repeat((pad // len(a) + 1,) + (1,) * (a.dim() - 1))[:pad]
        return torch.cat([a, reps])
    a = np.asarray(a)
    if len(a) == 0:
        return np.zeros((pad,) + a.shape[1:], a.dtype)
    reps = np.concatenate([a] * (pad // len(a) + 1))[:pad]
    return np.concatenate([a, reps])


def padded_label_mask(y, lm, n: int, scale: Optional[float] = None):
    """Label mask that zero-weights padded rows [n:] so the loss averages
    over the n REAL examples only (exactly the unpadded fit's loss).

    ``average_score`` divides a per-example-masked score by the full
    minibatch size B (the reference's computeScore), so a 0/1 validity
    mask alone would give sum_real/B_pad; the mask is therefore PRE-SCALED
    by B_pad/n. The rank-3 sum/sum(mask) branch is scale-invariant and
    stays exact. A user mask is multiplied by the scaled row validity;
    absent one, rank-2/3 labels get a per-example [B] weight (a [B, T] mask
    would switch ``average_score`` to its per-timestep branch) and rank-4
    labels a per-pixel [B, H, W] mask. An unpadded batch (``n == len(y)``)
    gets the all-ones mask, so full and padded batches share one calling
    convention. ``scale`` replaces the B_pad/n weight of a real row (the
    data-parallel wrapper's gB/n_tot across ranks with uneven rows,
    ``parallel/wrapper.py``). Returns a float32 numpy array."""
    total = len(y)
    valid = np.zeros(total, np.float32)
    valid[:n] = float(total) / float(n) if scale is None else float(scale)
    if lm is not None:
        lm = (lm.detach().cpu().float().numpy() if isinstance(lm, torch.Tensor)
              else np.asarray(lm, np.float32))
        return lm * valid.reshape([total] + [1] * (lm.ndim - 1))
    if len(y.shape) == 4:
        return np.broadcast_to(valid[:, None, None], tuple(y.shape[:3])).copy()
    return valid


def pad_fit_batch(x, y, fm, lm, target: int, site: str = "fit"):
    """Pad a training batch's leading axis up to ``target`` rows.

    Returns ``(x, y, fm, lm, ew)``: rows [n:] are tiled copies of real rows,
    ``ew`` is the per-example 0/1 weight and ``lm`` the pre-scaled validity
    label mask (see :func:`padded_label_mask`), so the loss equals the mean
    over the n real rows. Called with ``len(x) == target`` it only builds
    the all-ones channels, keeping one calling convention for full and
    partial batches alike."""
    n = len(x)
    if n > target:
        raise ValueError(f"batch of {n} rows exceeds pad target {target}")
    pad = target - n
    telemetry().record_hit(site, n, target)
    x, y, fm = (tile_pad(a, pad) if pad and a is not None else a
                for a in (x, y, fm))
    if pad and lm is not None:
        lm = tile_pad(lm, pad)
    lm = padded_label_mask(y, lm, n) if y is not None else lm
    ew = np.zeros(target, np.float32)
    ew[:n] = 1.0
    return x, y, fm, lm, ew


def pad_fit_multi(f, l, fm, lm, target: int, site: str = "fit"):
    """:func:`pad_fit_batch` for the tuples of a ComputationGraph batch:
    every features, labels and masks member is padded, and every output head
    gets its own pre-scaled validity label mask. Returns
    ``(f, l, fm, lm, ew)``."""
    n = len(f[0])
    if n > target:
        raise ValueError(f"batch of {n} rows exceeds pad target {target}")
    pad = target - n
    telemetry().record_hit(site, n, target)

    def pad_t(t):
        if t is None or not pad:
            return t
        return tuple(tile_pad(a, pad) if a is not None else None for a in t)

    f, l, fm, lm = pad_t(f), pad_t(l), pad_t(fm), pad_t(lm)
    if l is not None:
        lms = lm if lm is not None else (None,) * len(l)
        lm = tuple(padded_label_mask(yi, lmi, n) if yi is not None else lmi
                   for yi, lmi in zip(l, lms))
        if all(m is None for m in lm):
            lm = None
    ew = np.zeros(target, np.float32)
    ew[:n] = 1.0
    return f, l, fm, lm, ew
