"""Deadline-aware admission control: the serving tier's batching math.

μ-cuDNN (arXiv:1804.04806) picks per-layer micro-batch sizes by MEASUREMENT
against a time budget instead of by convention. Applied to request serving,
the same principle becomes: the batch a request coalesces into — and hence
the shape-ladder bucket it dispatches on — is chosen against the tightest
admitted DEADLINE using measured per-bucket execution latency, not by a
fixed drain tick or a fixed batch size.

Host-only copy of ``deeplearning4j_tpu/serve/admission.py``: the decode
knobs come from the environment, which ``tune.maybe_apply(model,
"serve")`` fills with the tuning DB's winner under ``DL4J_TPU_TUNE=auto``
before ``GenerateConfig.from_env`` reads it (``serve/registry.py``). The
pieces live here, all host-side float arithmetic (no device sync — the scheduler
calls these while holding its admission lock, so nothing here may stall
it):

- :class:`ServeConfig` — the ``DL4J_TPU_SERVE_*`` knob surface, read once
  per construction so launchers/tests control it per instance.
- :class:`LatencyModel` — measured per-(model, bucket) execution latency.
  Observations land in the ``dl4j_serve_exec_seconds{model,bucket}``
  histogram (P² streaming quantiles, obs/metrics.py) so the estimate is
  the same number operators see at /metrics; an estimate is only trusted
  for shedding once a bucket has ``min_samples`` observations (until then
  the system admits optimistically — never shed on a guess).
- :class:`AdmissionController` — the pure decisions:

  * ``infeasible(rows, deadline, now)``     → shed-on-arrival check
  * ``admit_more(rows, add, tightest, now)``→ coalesce one more request?
  * ``can_wait(rows, tightest, now)``       → keep the batch open one more
    wait quantum hoping for coalescing, or dispatch now?

  The admission loop built from these admits-until-deadline-margin: a
  forming batch keeps absorbing compatible requests while the NEXT bucket's
  measured latency still fits inside the tightest admitted deadline minus
  the safety margin — which is exactly "pick the bucket that maximizes
  goodput within the tightest admitted deadline", since every admitted
  request adds real rows and the loop stops at the last bucket whose
  estimate is feasible.
- :class:`GenerateConfig` — the generate route's knob surface
  (``DL4J_TPU_GEN_*``, ``DL4J_TPU_KV_PAGE_TOKENS``,
  ``DL4J_TPU_DECODE_BATCH_MAX``, ...).
- :class:`TokenAdmission` — the same deadline decisions repriced per
  remaining TOKEN budget for a token stream.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from deeplearning4j_tpu_torch.utils import bucketing

__all__ = ["AdmissionController", "GenerateConfig", "LatencyModel",
           "ServeConfig", "TokenAdmission"]


@dataclass(frozen=True)
class ServeConfig:
    """The ``DL4J_TPU_SERVE_*`` knob surface (docs/SERVING.md)."""

    max_batch: int = 32          # coalescing cap == AOT warm target (rows)
    queue_limit: int = 256       # per-model queue bound; beyond it -> 429
    margin_s: float = 0.005      # deadline safety margin
    max_wait_s: float = 0.002    # max time a batch stays open for coalescing
    wait_quantum_s: float = 0.0002   # admission loop poll interval
    default_deadline_s: float = 0.25  # deadline for requests that carry none
    min_samples: int = 3         # measurements before an estimate can shed
    workers: int = 1             # dispatcher threads per model pool

    @staticmethod
    def from_env() -> "ServeConfig":
        env = os.environ.get
        # default deadline follows the SLO latency objective: a request
        # with no explicit deadline is late exactly when the SLO says so
        default_ms = env("DL4J_TPU_SERVE_DEFAULT_DEADLINE_MS",
                         env("DL4J_TPU_SLO_LATENCY_MS", "250"))
        return ServeConfig(
            max_batch=int(env("DL4J_TPU_SERVE_MAX_BATCH", "32")),
            queue_limit=int(env("DL4J_TPU_SERVE_QUEUE", "256")),
            margin_s=float(env("DL4J_TPU_SERVE_MARGIN_MS", "5")) / 1e3,
            max_wait_s=float(env("DL4J_TPU_SERVE_WAIT_MS", "2")) / 1e3,
            wait_quantum_s=float(env("DL4J_TPU_SERVE_WAIT_QUANTUM_MS",
                                     "0.2")) / 1e3,
            default_deadline_s=float(default_ms) / 1e3,
            min_samples=int(env("DL4J_TPU_SERVE_MIN_SAMPLES", "3")),
            workers=int(env("DL4J_TPU_SERVE_WORKERS", "1")),
        )


class LatencyModel:
    """Measured per-(model, bucket) execution latency.

    ``observe`` records one dispatch's wall time into the shared
    ``dl4j_serve_exec_seconds`` histogram and a small internal ledger;
    ``estimate`` answers "how long will a batch on this bucket take" from
    the P² p95 of those observations — pessimistic enough that a feasible
    verdict usually holds, cheap enough (dict lookups under the family
    lock) for the admission loop.

    Estimates interpolate: an unmeasured bucket borrows the nearest
    measured bucket's latency scaled by the row ratio (compute scales at
    most linearly in padded rows for row-independent inference). A model
    with NO trusted measurement returns None — callers must admit
    optimistically, because shedding on a guess would reject traffic the
    hardware could have served.
    """

    def __init__(self, registry=None, min_samples: int = 3):
        from deeplearning4j_tpu_torch.obs import metrics as _metrics

        reg = registry if registry is not None else _metrics.registry()
        self._hist = reg.histogram(
            "dl4j_serve_exec_seconds",
            "serving dispatch execution latency by model and bucket "
            "(source of the admission loop's feasibility estimates)",
            ("model", "bucket"))
        self.min_samples = min_samples
        self._lock = threading.Lock()
        # (model, bucket) -> count; cheap trusted-set membership without
        # walking the histogram family on every estimate
        self._counts: Dict[Tuple[str, int], int] = {}

    def observe(self, model: str, bucket: int, seconds: float):
        self._hist.observe(seconds, model=model, bucket=bucket)
        with self._lock:
            self._counts[(model, int(bucket))] = \
                self._counts.get((model, int(bucket)), 0) + 1

    def samples(self, model: str, bucket: int) -> int:
        with self._lock:
            return self._counts.get((model, int(bucket)), 0)

    def estimate(self, model: str, bucket: int) -> Optional[float]:
        """p95 execution-latency estimate for ``bucket``, or None when the
        model has no bucket with ``min_samples`` measurements yet."""
        bucket = int(bucket)
        with self._lock:
            trusted = [b for (m, b), c in self._counts.items()
                       if m == model and c >= self.min_samples]
        if not trusted:
            return None
        nearest = min(trusted, key=lambda b: (abs(b - bucket), b))
        s = self._hist.summary(model=model, bucket=nearest)
        if s is None:  # registry reset between observe and estimate
            return None
        p95 = float(s["p95"])
        if nearest == bucket:
            return p95
        # linear row scaling, never below the measured floor: padded-row
        # inference work grows at most linearly, fixed overheads don't shrink
        return p95 * max(1.0, bucket / nearest)

    def clear(self):
        with self._lock:
            self._counts.clear()


class AdmissionController:
    """Pure deadline-admission decisions over a :class:`LatencyModel`.

    Every method takes ``now`` explicitly (``time.perf_counter()`` scale,
    same clock as the deadlines) so the math is deterministic under test.
    """

    def __init__(self, latency: LatencyModel, config: ServeConfig,
                 ladder: Optional[bucketing.BucketLadder] = None):
        self.latency = latency
        self.config = config
        self.ladder = ladder or bucketing.ladder_from_env()

    def _bucket(self, rows: int) -> int:
        return (self.ladder.bucket(rows)
                if bucketing.bucketing_enabled() else rows)

    def eta(self, model: str, rows: int, now: float) -> Optional[float]:
        """Estimated completion time for dispatching ``rows`` now, or None
        when unmeasured (optimistic)."""
        est = self.latency.estimate(model, self._bucket(rows))
        return None if est is None else now + est

    def infeasible(self, model: str, rows: int, deadline: float,
                   now: float) -> bool:
        """Shed-on-arrival: even dispatched IMMEDIATELY and ALONE, the
        request's measured bucket latency overruns its deadline (minus the
        safety margin). Unmeasured models are never infeasible."""
        eta = self.eta(model, rows, now)
        return eta is not None and eta + self.config.margin_s > deadline

    def admit_more(self, model: str, rows: int, add_rows: int,
                   tightest: float, now: float) -> bool:
        """Coalesce one more request (``add_rows`` rows, deadline already
        folded into ``tightest``) into a forming batch of ``rows``?

        Admit while the GROWN batch's bucket still meets the tightest
        admitted deadline with margin. Every admission adds real rows to
        one dispatch, so stopping at the last feasible bucket is the
        goodput-maximizing choice within that deadline."""
        total = rows + add_rows
        if total > self.config.max_batch:
            return False
        eta = self.eta(model, total, now)
        return eta is None or eta + self.config.margin_s <= tightest

    def can_wait(self, model: str, rows: int, tightest: float,
                 now: float) -> bool:
        """Keep the batch open one more wait quantum hoping more requests
        arrive (admit-until-deadline-margin, NOT a fixed drain tick)?
        Only while the current bucket dispatched AFTER the wait would still
        make the tightest deadline; an unmeasured model relies on the
        scheduler's ``max_wait_s`` cap alone."""
        if rows >= self.config.max_batch:
            return False
        after_wait = now + self.config.wait_quantum_s
        eta = self.eta(model, rows, after_wait)
        return eta is None or eta + self.config.margin_s <= tightest


@dataclass(frozen=True)
class GenerateConfig:
    """The generative-serving knob surface (``DL4J_TPU_GEN_*`` plus the two
    decode knobs ``DL4J_TPU_KV_PAGE_TOKENS`` and
    ``DL4J_TPU_DECODE_BATCH_MAX``), read from the environment per
    construction."""

    decode_batch_max: int = 8    # token-level continuous-batch width cap
    kv_page_tokens: int = 64     # KV-cache page size (tokens per page)
    prefill_chunk: int = 64      # max prompt tokens per prefill dispatch
    max_new_default: int = 64    # max_tokens for requests that carry none
    queue_limit: int = 64        # waiting-stream bound; beyond it -> 429
    margin_s: float = 0.005      # deadline safety margin (shared with serve)
    default_deadline_s: float = 30.0  # generous: streams run many tokens
    min_samples: int = 3         # measurements before an estimate can shed
    paged: bool = True           # paged pool vs contiguous strips

    @staticmethod
    def from_env() -> "GenerateConfig":
        env = os.environ.get
        return GenerateConfig(
            decode_batch_max=int(env("DL4J_TPU_DECODE_BATCH_MAX", "8")),
            kv_page_tokens=int(env("DL4J_TPU_KV_PAGE_TOKENS", "64")),
            prefill_chunk=int(env("DL4J_TPU_PREFILL_CHUNK", "64")),
            max_new_default=int(env("DL4J_TPU_GEN_MAX_NEW", "64")),
            queue_limit=int(env("DL4J_TPU_GEN_QUEUE", "64")),
            margin_s=float(env("DL4J_TPU_SERVE_MARGIN_MS", "5")) / 1e3,
            default_deadline_s=float(env("DL4J_TPU_GEN_DEADLINE_MS",
                                         "30000")) / 1e3,
            min_samples=int(env("DL4J_TPU_SERVE_MIN_SAMPLES", "3")),
            paged=env("DL4J_TPU_KV_PAGED", "1") != "0",
        )


class TokenAdmission:
    """Deadline decisions repriced per remaining TOKEN budget.

    A fixed-shape request has one dispatch between admission and response;
    a token stream has ``prefill + max_new`` of them, so its feasibility
    is repriced as the budget drains: a stream that was feasible at
    admission is shed mid-flight the moment ``now + remaining_tokens x
    measured_ITL`` overruns its deadline, since every further step it runs
    takes decode-batch slots from streams that can still finish.

    Latency ledger keys (one :class:`LatencyModel`, two logical sites):
    ``{model}:decode`` bucketed by batch rows (the per-token step) and
    ``{model}:prefill`` bucketed by chunk width. Both unmeasured: admit
    optimistically, never shed on a guess.
    """

    def __init__(self, latency: LatencyModel, config: GenerateConfig,
                 ladder: Optional[bucketing.BucketLadder] = None):
        self.latency = latency
        self.config = config
        self.ladder = ladder or bucketing.ladder_from_env()

    def _bucket(self, n: int) -> int:
        return self.ladder.bucket(n) if bucketing.bucketing_enabled() else n

    def itl(self, model: str, batch_rows: int) -> Optional[float]:
        """Measured per-token step latency at the given batch width."""
        return self.latency.estimate(f"{model}:decode",
                                     self._bucket(max(1, batch_rows)))

    def prefill_eta(self, model: str, prompt_len: int) -> Optional[float]:
        """Measured time to prefill a prompt, summed over chunk dispatches."""
        chunk = self.config.prefill_chunk
        total, n = 0.0, 0
        while n < prompt_len:
            c = min(chunk, prompt_len - n)
            est = self.latency.estimate(f"{model}:prefill", self._bucket(c))
            if est is None:
                return None
            total += est
            n += c
        return total

    def infeasible(self, model: str, prompt_len: int, max_new: int,
                   deadline: float, now: float) -> bool:
        """Shed-on-arrival: even admitted IMMEDIATELY, the stream's full
        token budget (prefill + max_new decode steps at measured ITL)
        overruns its deadline. Unmeasured components price as zero."""
        pre = self.prefill_eta(model, prompt_len) or 0.0
        itl = self.itl(model, 1) or 0.0
        if pre == 0.0 and itl == 0.0:
            return False
        eta = now + pre + max_new * itl
        return eta + self.config.margin_s > deadline

    def should_shed(self, model: str, remaining: int, deadline: float,
                    now: float, batch_rows: int = 1) -> bool:
        """Mid-stream repricing at a token boundary: shed when the
        REMAINING budget at the currently measured ITL can no longer make
        the deadline."""
        if remaining <= 0:
            return now > deadline
        itl = self.itl(model, batch_rows)
        if itl is None:
            return now + self.config.margin_s > deadline
        return now + remaining * itl + self.config.margin_s > deadline
