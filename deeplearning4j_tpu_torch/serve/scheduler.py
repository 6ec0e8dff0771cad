"""Continuous-batching scheduler: per-model queues, coalescing dispatchers.

Counterpart of ``deeplearning4j_tpu/serve/scheduler.py``: the predict
path, the token-level generate path and vector search. One
:class:`ModelWorker` per served model owns a bounded request queue and a
small pool of dispatcher threads. Each dispatcher runs the continuous-
batching loop:

1. **Pop** the oldest request (the batch seed).
2. **Admit** — coalesce compatible queued requests into the forming batch
   while the grown batch's bucket still meets the tightest admitted
   deadline with margin (:class:`~.admission.AdmissionController`), waiting
   in sub-millisecond quanta for more traffic only while that same check
   says the wait is affordable.
3. **Dispatch** OUTSIDE the admission lock: concatenate rows, let
   ``model.output`` pad up the shared bucket ladder, copy the result to the
   host (which waits for the device), slice it back per request, and
   measure the execution latency into the
   :class:`~.admission.LatencyModel`.

Overload protection is fail-fast, never queue-unboundedly:

- **Backpressure** — a full queue sheds at submit (→ HTTP 429).
- **Deadline shedding** — a request whose measured bucket latency cannot
  meet its deadline is shed at arrival, and one that expires while queued
  is shed at assembly instead of wasting a dispatch (→ HTTP 503).

Both paths record ``dl4j_requests_total{status="shed"}`` +
``dl4j_shed_total{reason}`` and burn SLO error budget (obs/slo.py).

Lock discipline: everything under ``self._cond`` is host-side queue/float
arithmetic — the device work, the copy to the host and the per-request
fan-out all happen with the lock released.

:class:`GenerateWorker` is token-level continuous batching for one
generative model over a :class:`~deeplearning4j_tpu_torch.nn.decode.DecodeProgram`:
its engine thread schedules single decode STEPS, not requests (see the
class docstring).

:class:`SearchWorker` is the same loop for one
:class:`~deeplearning4j_tpu_torch.search.index.VectorIndex`, coalescing
only requests that dispatch the same (tier, k bucket, nprobe) signature,
so a coalesced answer equals the same request served alone at the same
padded batch size.
"""

from __future__ import annotations

import contextlib
import math
import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.obs import fleet
from deeplearning4j_tpu_torch.serve.admission import (
    AdmissionController, GenerateConfig, LatencyModel, ServeConfig,
    TokenAdmission)
from deeplearning4j_tpu_torch.utils import bucketing

__all__ = ["GenerateStream", "GenerateWorker", "ModelWorker", "SearchWorker",
           "ServeConfig", "ShedError"]


class ShedError(RuntimeError):
    """A request the serving tier refused to run. ``reason`` is
    ``backpressure`` (queue full → HTTP 429), ``deadline`` (cannot meet the
    request's deadline → HTTP 503) or ``shutdown`` (→ HTTP 503)."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(detail or reason)
        self.reason = reason

    @property
    def http_status(self) -> int:
        return 429 if self.reason == "backpressure" else 503


def _trace_attrs(batch) -> Dict[str, str]:
    """Span attrs linking one coalesced dispatch back to the trace ids of
    every request in it (deduped, submit order)."""
    ids: List[str] = []
    for r in batch:
        t = getattr(r, "trace", None)
        if t is not None and t.trace_id not in ids:
            ids.append(t.trace_id)
    return {"traces": ",".join(ids)} if ids else {}


class _HostBuffer:
    """Host buffers for outputs' copies, one per thread: a dispatcher pool
    shares one ``_HostBuffer``, and each thread copies into and widens from
    its own (page-locked where a card is present), grown when a larger
    output arrives."""

    def __init__(self):
        self._local = threading.local()

    def int16(self, n: int) -> torch.Tensor:
        buf = getattr(self._local, "buf", None)
        if buf is None or buf.numel() < n:
            buf = torch.empty(n, dtype=torch.int16,
                              pin_memory=torch.cuda.is_available())
            self._local.buf = buf
        return buf[:n]


def _to_host(out, pinned: Optional[_HostBuffer] = None) -> np.ndarray:
    """A model output as a host numpy array. bf16 comes back as float32,
    since numpy has no bfloat16: its bits, viewed as int16, are copied as
    they are (into the calling thread's buffer of ``pinned`` when one is
    given: half the bytes of a float32 copy from the card) and widened on
    the host, where bf16 -> f32 is a 16-bit shift of the bits: exact, NaN
    payloads and infinities included."""
    if isinstance(out, torch.Tensor):
        out = out.detach()
        if out.dtype == torch.bfloat16:
            bits = out.contiguous().view(torch.int16)
            if pinned is not None:
                host = pinned.int16(bits.numel()).view(bits.shape)
                host.copy_(bits)
            else:
                host = bits.cpu()
            # torch's CPU bf16 -> f32 conversion is that shift, on every core
            return host.view(torch.bfloat16).float().numpy()
        return out.cpu().numpy()
    return np.asarray(out)


class _Req:
    __slots__ = ("x", "rows", "deadline", "arrival", "event", "result",
                 "error", "trace")

    def __init__(self, x, deadline: float, arrival: float):
        self.x = x
        self.rows = len(x)
        self.deadline = deadline
        self.arrival = arrival
        self.event = threading.Event()
        self.result = None
        self.error: Optional[Exception] = None
        # the submitter's trace context rides the request to the dispatch span
        self.trace: Optional[fleet.TraceContext] = None


class ModelWorker:
    """Deadline-aware continuous-batching front for ONE model.

    ``submit`` blocks the calling thread until its rows come back (or
    raises :class:`ShedError`); the dispatcher pool coalesces concurrent
    callers into bucket-ladder batches. ``latency`` may be shared across
    workers — estimates are keyed per model name.
    """

    def __init__(self, name: str, model, config: Optional[ServeConfig] = None,
                 latency: Optional[LatencyModel] = None,
                 ladder: Optional[bucketing.BucketLadder] = None):
        self.name = name
        self.model = model
        self.config = config or ServeConfig.from_env()
        self.route = f"serve.{name}"
        self.latency = latency or LatencyModel(
            min_samples=self.config.min_samples)
        self.admission = AdmissionController(self.latency, self.config,
                                             ladder=ladder)
        self._cond = threading.Condition()
        self._q: List[_Req] = []
        self._stop = False
        self._shed_seen: set = set()
        self._host = _HostBuffer()   # a copy buffer per dispatching thread
        self._batches = obs.counter(
            "dl4j_serve_batches_total",
            "coalesced dispatches by model", ("model",))
        self._batch_rows = obs.histogram(
            "dl4j_serve_batch_rows",
            "real rows per coalesced dispatch (fill, before bucket padding)",
            ("model",))
        self._depth = obs.gauge(
            "dl4j_serve_queue_depth",
            "requests waiting in the per-model serving queue", ("model",))
        self._threads = [
            threading.Thread(target=self._worker_loop, daemon=True,
                             name=f"serve-{name}-{i}")
            for i in range(max(1, self.config.workers))]
        for t in self._threads:
            t.start()

    # -- producer side -----------------------------------------------------

    def submit(self, x, deadline_s: Optional[float] = None) -> np.ndarray:
        """Serve one request of ``len(x)`` rows. ``deadline_s`` is relative
        to now (defaults to ``ServeConfig.default_deadline_s``); the call
        blocks until the rows are served, or raises :class:`ShedError` /
        the model's own failure."""
        x = np.asarray(x)
        if x.ndim < 1 or len(x) == 0:
            raise ValueError("request must carry at least one row")
        now = time.perf_counter()
        if deadline_s is None:
            deadline_s = self.config.default_deadline_s
        r = _Req(x, now + deadline_s, now)
        r.trace = fleet.current_trace()
        # arrival feasibility BEFORE touching the queue (503 semantics)
        if self.admission.infeasible(self.name, r.rows, r.deadline, now):
            self._shed(r, "deadline")
            raise ShedError("deadline",
                            f"{self.name}: measured bucket latency cannot "
                            f"meet deadline {deadline_s * 1e3:.1f}ms")
        with self._cond:
            if self._stop:
                raise ShedError("shutdown", f"{self.name}: worker shut down")
            if len(self._q) >= self.config.queue_limit:
                depth = len(self._q)
                shed = True
            else:
                shed = False
                self._q.append(r)
                depth = len(self._q)
                self._cond.notify()
        self._depth.set(depth, model=self.name)
        if shed:
            self._shed(r, "backpressure")
            raise ShedError("backpressure",
                            f"{self.name}: queue full ({depth} waiting)")
        r.event.wait()
        if r.error is not None:
            raise r.error
        return r.result

    # -- shed accounting ---------------------------------------------------

    def _shed(self, r: _Req, reason: str):
        obs.observe_shed(self.route, reason=reason)
        if reason not in self._shed_seen:  # first occurrence: one event
            self._shed_seen.add(reason)
            obs.event("serve_shed", model=self.name, reason=reason,
                      rows=int(r.rows))

    # -- dispatcher side ---------------------------------------------------

    def _worker_loop(self):
        while True:
            with self._cond:
                while not self._q and not self._stop:
                    self._cond.wait()
                if self._stop and not self._q:
                    return
                first = self._q.pop(0)
                depth = len(self._q)
            self._depth.set(depth, model=self.name)
            batch = self._assemble(first)
            if batch:
                self._dispatch(batch)

    def _assemble(self, first: _Req) -> List[_Req]:
        """The admission loop: grow [first] while the admission controller
        approves, shedding queued requests that expired. Returns the batch
        to dispatch (possibly empty if every candidate expired)."""
        cfg = self.config
        batch: List[_Req] = []
        rows = 0
        tightest = float("inf")
        opened = time.perf_counter()
        candidate: Optional[_Req] = first
        while True:
            now = time.perf_counter()
            if candidate is not None:
                merged = min(tightest, candidate.deadline)
                if now + cfg.margin_s > candidate.deadline:
                    # expired while queued: shed instead of a late response
                    self._shed(candidate, "deadline")
                    candidate.error = ShedError(
                        "deadline", f"{self.name}: deadline expired in queue")
                    candidate.event.set()
                elif not batch or self.admission.admit_more(
                        self.name, rows, candidate.rows, merged, now):
                    batch.append(candidate)
                    rows += candidate.rows
                    tightest = merged
                else:
                    # would overrun the tightest admitted deadline (or the
                    # batch cap): leave it at the queue head for the next batch
                    with self._cond:
                        self._q.insert(0, candidate)
                    break
                candidate = None
                continue
            if rows >= cfg.max_batch:
                break
            with self._cond:
                if self._q:
                    candidate = self._q.pop(0)
                    continue
            if self._stop or now - opened >= cfg.max_wait_s:
                break
            if batch and not self.admission.can_wait(
                    self.name, rows, tightest, now):
                break
            time.sleep(cfg.wait_quantum_s)
        return batch

    def _dispatch(self, batch: List[_Req]):
        total = sum(r.rows for r in batch)
        bucket = (bucketing.bucket_size(total)
                  if bucketing.bucketing_enabled() else total)
        bucketing.telemetry().record_hit(self.route, total, bucket)
        try:
            with obs.span("serve.dispatch", model=self.name,
                          # graftlint: disable=host-sync; total is the host's row count
                          rows=int(total), **_trace_attrs(batch)):
                xs = (batch[0].x if len(batch) == 1
                      else np.concatenate([r.x for r in batch], axis=0))
                t0 = time.perf_counter()
                # model.output pads up the shared ladder itself, so this
                # dispatch runs the same shapes a direct caller would; the
                # copy to the host waits for the device
                out = _to_host(self.model.output(xs), self._host)
                dt = time.perf_counter() - t0
            self.latency.observe(self.name, bucket, dt)
            self._batches.inc(model=self.name)
            self._batch_rows.observe(total, model=self.name)
            done = time.perf_counter()
            ofs = 0
            for r in batch:
                r.result = out[ofs:ofs + r.rows]
                ofs += r.rows
                r.event.set()
                obs.observe_request(self.route, done - r.arrival,
                                    status="ok")
        except Exception as e:  # propagate to every waiter, keep serving
            done = time.perf_counter()
            for r in batch:
                r.error = e
                r.event.set()
                obs.observe_request(self.route, done - r.arrival,
                                    status="error", error=True)

    # -- lifecycle ---------------------------------------------------------

    def stats(self) -> Dict[str, object]:
        with self._cond:
            depth = len(self._q)
        return {
            "model": self.name,
            "queue_depth": depth,
            "queue_limit": self.config.queue_limit,
            "max_batch": self.config.max_batch,
            "batches": int(self._batches.value(model=self.name)),
            "workers": len(self._threads),
        }

    def shutdown(self, timeout_s: float = 5.0):
        with self._cond:
            self._stop = True
            stranded = list(self._q)
            self._q.clear()
            self._cond.notify_all()
        for r in stranded:
            r.error = ShedError("shutdown", f"{self.name}: worker shut down")
            r.event.set()
        for t in self._threads:
            t.join(timeout=timeout_s)


# ---------------------------------------------------------------------------
# Vector search: signature-compatible query coalescing
# ---------------------------------------------------------------------------


class _SearchReq:
    __slots__ = ("q", "rows", "k", "kb", "nprobe", "tier", "deadline",
                 "arrival", "event", "result", "error", "trace")

    def __init__(self, q, k: int, kb: int, nprobe: int, tier: str,
                 deadline: float, arrival: float):
        self.q = q
        self.rows = len(q)
        self.k = k
        self.kb = kb
        self.nprobe = nprobe
        self.tier = tier
        self.deadline = deadline
        self.arrival = arrival
        self.event = threading.Event()
        self.result = None
        self.error: Optional[Exception] = None
        self.trace: Optional[fleet.TraceContext] = None

    @property
    def key(self):
        """Coalescing compatibility: only requests that would dispatch the
        SAME signature (tier, padded k, nprobe) may share a
        batch — so a coalesced response is bit-exact vs serving alone."""
        return (self.tier, self.kb, self.nprobe)


class SearchWorker:
    """Deadline-aware continuous batching for ONE
    :class:`~deeplearning4j_tpu_torch.search.index.VectorIndex`.

    Same shape as :class:`ModelWorker` with one twist: the admit loop only
    coalesces *signature-compatible* requests (same tier / k-bucket /
    nprobe — see :meth:`_SearchReq.key`); incompatible requests stay queued
    for the next batch rather than forcing a second signature into this
    dispatch. Latency estimates key per ``{index}:{tier}`` because the
    tiers sit at very different points on the latency/recall curve.
    """

    def __init__(self, name: str, index,
                 config: Optional[ServeConfig] = None,
                 latency: Optional[LatencyModel] = None,
                 ladder: Optional[bucketing.BucketLadder] = None):
        import dataclasses

        self.name = name
        self.index = index
        base = config or ServeConfig.from_env()
        # the index's own coalescing cap (search_batch_max knob) bounds the
        # batch — it is what the signature grid was warmed for
        self.config = dataclasses.replace(
            base, max_batch=int(index.config.batch_max))
        self.route = f"search.{name}"
        self.latency = latency or LatencyModel(
            min_samples=self.config.min_samples)
        self.admission = AdmissionController(self.latency, self.config,
                                             ladder=ladder)
        self._cond = threading.Condition()
        self._q: List[_SearchReq] = []
        self._stop = False
        self._shed_seen: set = set()
        self._batches = obs.counter(
            "dl4j_serve_batches_total",
            "coalesced dispatches by model", ("model",))
        self._batch_rows = obs.histogram(
            "dl4j_serve_batch_rows",
            "real rows per coalesced dispatch (fill, before bucket padding)",
            ("model",))
        self._depth = obs.gauge(
            "dl4j_serve_queue_depth",
            "requests waiting in the per-model serving queue", ("model",))
        self._threads = [
            threading.Thread(target=self._worker_loop, daemon=True,
                             name=f"search-{name}-{i}")
            for i in range(max(1, self.config.workers))]
        for t in self._threads:
            t.start()

    # -- producer side -----------------------------------------------------

    def submit(self, queries, k: int = 10, nprobe: Optional[int] = None,
               tier: Optional[str] = None,
               deadline_s: Optional[float] = None):
        """Top-k search for ``queries`` ([B, dim]); blocks until served.
        Returns ``(ids, distances, tier)``. Raises ``ValueError`` on a
        malformed request (HTTP 400) or :class:`ShedError` (429/503)."""
        ix = self.index
        q = np.atleast_2d(np.asarray(queries, np.float32))
        if q.ndim != 2 or q.shape[1] != ix.config.dim:
            raise ValueError(
                f"queries must be [B, {ix.config.dim}], got "
                f"{np.asarray(queries).shape}")
        if q.shape[0] == 0:
            raise ValueError("request must carry at least one query")
        if q.shape[0] > self.config.max_batch:
            raise ValueError(
                f"request of {q.shape[0]} queries exceeds search_batch_max "
                f"{self.config.max_batch}; split the batch client-side")
        if not 1 <= int(k) <= ix.config.max_k:
            raise ValueError(
                f"k must be in [1, {ix.config.max_k}], got {k}")
        tier = tier or ix.default_tier
        if tier not in ix.available_tiers():
            raise ValueError(f"tier {tier!r} not available; index has "
                             f"{ix.available_tiers()}")
        kb = min((c for c in ix.k_choices if c >= int(k)),
                 default=ix.k_choices[-1])
        p = ix._resolve_nprobe(nprobe) if tier != "exact" else 0
        now = time.perf_counter()
        if deadline_s is None:
            deadline_s = self.config.default_deadline_s
        r = _SearchReq(q, int(k), kb, p, tier, now + deadline_s, now)
        r.trace = fleet.current_trace()
        lkey = f"{self.name}:{tier}"
        if self.admission.infeasible(lkey, r.rows, r.deadline, now):
            self._shed(r, "deadline")
            raise ShedError("deadline",
                            f"{self.name}: measured {tier} latency cannot "
                            f"meet deadline {deadline_s * 1e3:.1f}ms")
        with self._cond:
            if self._stop:
                raise ShedError("shutdown", f"{self.name}: worker shut down")
            if len(self._q) >= self.config.queue_limit:
                depth = len(self._q)
                shed = True
            else:
                shed = False
                self._q.append(r)
                depth = len(self._q)
                self._cond.notify()
        self._depth.set(depth, model=self.name)
        if shed:
            self._shed(r, "backpressure")
            raise ShedError("backpressure",
                            f"{self.name}: queue full ({depth} waiting)")
        r.event.wait()
        if r.error is not None:
            raise r.error
        return r.result

    def _shed(self, r: _SearchReq, reason: str):
        obs.observe_shed(self.route, reason=reason)
        if reason not in self._shed_seen:
            self._shed_seen.add(reason)
            obs.event("search_shed", index=self.name, reason=reason,
                      rows=int(r.rows))

    # -- dispatcher side ---------------------------------------------------

    def _worker_loop(self):
        while True:
            with self._cond:
                while not self._q and not self._stop:
                    self._cond.wait()
                if self._stop and not self._q:
                    return
                first = self._q.pop(0)
                depth = len(self._q)
            self._depth.set(depth, model=self.name)
            batch = self._assemble(first)
            if batch:
                self._dispatch(batch)

    def _pop_compatible(self, key) -> Optional[_SearchReq]:
        """Pop the oldest queued request sharing ``key`` (tier/k/nprobe);
        incompatible requests keep their queue position for the next
        batch seed."""
        with self._cond:
            for i, r in enumerate(self._q):
                if r.key == key:
                    return self._q.pop(i)
        return None

    def _assemble(self, first: _SearchReq) -> List[_SearchReq]:
        cfg = self.config
        lkey = f"{self.name}:{first.tier}"
        batch: List[_SearchReq] = []
        rows = 0
        tightest = float("inf")
        opened = time.perf_counter()
        candidate: Optional[_SearchReq] = first
        while True:
            now = time.perf_counter()
            if candidate is not None:
                merged = min(tightest, candidate.deadline)
                if now + cfg.margin_s > candidate.deadline:
                    self._shed(candidate, "deadline")
                    candidate.error = ShedError(
                        "deadline", f"{self.name}: deadline expired in queue")
                    candidate.event.set()
                elif (not batch
                      or (rows + candidate.rows <= cfg.max_batch
                          and self.admission.admit_more(
                              lkey, rows, candidate.rows, merged, now))):
                    batch.append(candidate)
                    rows += candidate.rows
                    tightest = merged
                else:
                    with self._cond:
                        self._q.insert(0, candidate)
                    break
                candidate = None
                continue
            if rows >= cfg.max_batch:
                break
            candidate = self._pop_compatible(first.key)
            if candidate is not None:
                continue
            if self._stop or now - opened >= cfg.max_wait_s:
                break
            if batch and not self.admission.can_wait(
                    lkey, rows, tightest, now):
                break
            time.sleep(cfg.wait_quantum_s)
        return batch

    def _dispatch(self, batch: List[_SearchReq]):
        total = sum(r.rows for r in batch)
        bucket = (bucketing.bucket_size(total)
                  if bucketing.bucketing_enabled() else total)
        lkey = f"{self.name}:{batch[0].tier}"
        try:
            with obs.span("search.dispatch", index=self.name,
                          tier=batch[0].tier, rows=int(total),
                          **_trace_attrs(batch)):
                qs = (batch[0].q if len(batch) == 1
                      else np.concatenate([r.q for r in batch], axis=0))
                t0 = time.perf_counter()
                # dispatch at the shared kb so every member's slice equals
                # its solo response bit-for-bit (row-independent kernels,
                # stable column prefix of one top-kb result)
                ids, dists = self.index.search(
                    qs, k=batch[0].kb, nprobe=batch[0].nprobe or None,
                    tier=batch[0].tier)
                dt = time.perf_counter() - t0
            self.latency.observe(lkey, bucket, dt)
            self._batches.inc(model=self.name)
            self._batch_rows.observe(total, model=self.name)
            done = time.perf_counter()
            ofs = 0
            for r in batch:
                r.result = (ids[ofs:ofs + r.rows, :r.k],
                            dists[ofs:ofs + r.rows, :r.k], r.tier)
                ofs += r.rows
                r.event.set()
                obs.observe_request(self.route, done - r.arrival,
                                    status="ok")
        except Exception as e:
            done = time.perf_counter()
            for r in batch:
                r.error = e
                r.event.set()
                obs.observe_request(self.route, done - r.arrival,
                                    status="error", error=True)

    # -- lifecycle ---------------------------------------------------------

    def stats(self) -> Dict[str, object]:
        with self._cond:
            depth = len(self._q)
        out = {
            "model": self.name,
            "queue_depth": depth,
            "queue_limit": self.config.queue_limit,
            "max_batch": self.config.max_batch,
            "batches": int(self._batches.value(model=self.name)),
            "workers": len(self._threads),
        }
        out.update(self.index.stats)
        return out

    def shutdown(self, timeout_s: float = 5.0):
        with self._cond:
            self._stop = True
            stranded = list(self._q)
            self._q.clear()
            self._cond.notify_all()
        for r in stranded:
            r.error = ShedError("shutdown", f"{self.name}: worker shut down")
            r.event.set()
        for t in self._threads:
            t.join(timeout=timeout_s)


# ---------------------------------------------------------------------------
# Token-level continuous batching: the generative decode engine
# ---------------------------------------------------------------------------


class _Stream:
    """One in-flight generation request: host-side bookkeeping only."""

    __slots__ = ("prompt", "max_new", "eos", "deadline", "arrival", "out",
                 "state", "fed", "cached", "generated", "next_tok", "pages",
                 "slot", "last_emit", "sid")

    def __init__(self, prompt: List[int], max_new: int, eos: Optional[int],
                 deadline: float, arrival: float, sid: int):
        self.prompt = prompt
        self.max_new = max_new
        self.eos = eos
        self.deadline = deadline
        self.arrival = arrival
        self.sid = sid
        self.out: "queue.Queue" = queue.Queue()
        self.state = "queued"        # queued -> prefill -> decode -> done
        self.fed = 0                 # prompt tokens already dispatched
        self.cached = 0              # tokens whose k/v live in the cache
        self.generated = 0
        self.next_tok: Optional[int] = None   # emitted but not yet cached
        self.pages: List[int] = []   # owned page ids (paged mode)
        self.slot: Optional[int] = None       # owned strip (contiguous mode)
        self.last_emit: Optional[float] = None


class GenerateStream:
    """Consumer handle for one generation request: iterate to receive token
    ids as the engine emits them (each item was a separate decode step).
    After iteration ends, ``finish_reason`` is one of ``eos`` / ``length`` /
    ``shed:deadline`` / ``shutdown`` and ``ttft_s`` holds the measured time
    to first token. ``timeout_s`` bounds the wait for each item (None:
    unbounded); a wait past it raises ``queue.Empty``."""

    def __init__(self, stream: _Stream, timeout_s: Optional[float] = None):
        self._s = stream
        self.timeout_s = timeout_s
        self.finish_reason: Optional[str] = None
        self.ttft_s: Optional[float] = None
        self.tokens: List[int] = []

    def __iter__(self):
        while True:
            kind, payload = self._s.out.get(timeout=self.timeout_s)
            if kind == "token":
                if not self.tokens:
                    self.ttft_s = time.perf_counter() - self._s.arrival
                self.tokens.append(payload)
                yield payload
            elif kind == "done":
                self.finish_reason = payload
                return
            else:  # "error"
                self.finish_reason = "error"
                raise payload


class GenerateWorker:
    """Token-level continuous batching for ONE generative model.

    The unit of scheduling is a single decode STEP, not a request: every
    engine iteration (one thread, one device dispatch at a time)

    1. **admits** queued streams into free cache slots — join happens at a
       token boundary, mid-flight streams never restart;
    2. runs at most ONE prefill chunk for the oldest still-prefilling
       stream (``prefill_chunk`` tokens of ITS prompt): a long prompt costs
       in-flight streams one chunk of latency per iteration, never its
       whole length;
    3. runs ONE decode step over ALL streams in decode state — each one
       advances one token, finished streams leave at that boundary and
       their pages return to the free list at once.

    Prompts prefill at batch 1 and decode batches pad up the bucket
    ladder, so every dispatch lands on the warmed shape grid of the
    :class:`~deeplearning4j_tpu_torch.nn.decode.DecodeProgram`, and greedy
    output batched equals each stream served alone (batch padding gets an
    exact-zero attention weight and rows are independent).

    Deadlines are repriced per remaining token budget
    (:class:`~.admission.TokenAdmission`): shed-on-arrival prices prefill +
    ``max_new`` x measured ITL; every emitted token reprices the
    remainder, so a stream that can no longer finish in time stops taking
    batch slots mid-flight (``finish_reason == "shed:deadline"``).

    The engine thread selects the model's device and enters
    ``torch.inference_mode()`` itself (both are thread-local); reading the
    step's ids back (``ids.cpu()``) is its one host sync per step.
    """

    def __init__(self, name: str, model, program,
                 config: Optional[GenerateConfig] = None,
                 latency: Optional[LatencyModel] = None,
                 ladder: Optional[bucketing.BucketLadder] = None):
        self.name = name
        self.model = model
        self.program = program
        self.config = config or GenerateConfig.from_env()
        self.route = f"generate.{name}"
        self.latency = latency or LatencyModel(
            min_samples=self.config.min_samples)
        self.admission = TokenAdmission(self.latency, self.config,
                                        ladder=ladder)
        self.ladder = ladder or bucketing.ladder_from_env()
        self._pg = program.page_tokens
        self._cond = threading.Condition()
        self._q: List[_Stream] = []
        self._active: List[_Stream] = []
        self._stop = False
        self._sid = 0
        self._shed_seen: set = set()
        if program.paged:
            # page 0 is the program's scratch page: never hand it out
            self._free_pages = list(range(1, 1 + program.max_batch
                                          * program.max_pages))
            self._free_slots = None
        else:
            self._free_pages = None
            self._free_slots = list(range(program.max_batch))
        self.stats_counters = {"joins": 0, "leaves": 0, "generated": 0,
                               "shed_midstream": 0, "max_occupancy": 0}
        self._thread = threading.Thread(target=self._engine_loop, daemon=True,
                                        name=f"generate-{name}")
        self._thread.start()

    # -- producer side -----------------------------------------------------

    def submit(self, prompt, max_new: Optional[int] = None,
               eos: Optional[int] = None,
               deadline_s: Optional[float] = None,
               timeout_s: Optional[float] = None) -> GenerateStream:
        """Enqueue one generation request; returns a :class:`GenerateStream`
        at once (tokens arrive as the engine emits them; ``timeout_s``
        bounds each wait on it). Raises :class:`ShedError` on arrival-time
        shedding, ``ValueError`` on a request the cache can never hold or
        a token id outside the vocabulary (it would embed as NaN, and a
        NaN left in a page poisons the next stream that owns it)."""
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not prompt:
            raise ValueError("generate: prompt must carry at least one token")
        vocab = self.program.vocab
        if vocab is not None and not all(0 <= t < vocab for t in prompt):
            raise ValueError(f"generate: prompt token ids must lie in "
                             f"[0, {vocab})")
        if max_new is None:
            max_new = self.config.max_new_default
        max_new = int(max_new)
        if max_new < 1:
            raise ValueError("generate: max_tokens must be >= 1")
        if len(prompt) + max_new > self.program.capacity:
            raise ValueError(
                f"generate: prompt ({len(prompt)}) + max_tokens ({max_new}) "
                f"exceeds model capacity {self.program.capacity}")
        now = time.perf_counter()
        if deadline_s is None:
            deadline_s = self.config.default_deadline_s
        with self._cond:
            self._sid += 1
            sid = self._sid
        s = _Stream(prompt, max_new, eos, now + deadline_s, now, sid)
        # arrival repricing: prefill cost + max_new tokens at measured ITL
        if self.admission.infeasible(self.name, len(prompt), max_new,
                                     s.deadline, now):
            self._shed(s, "deadline")
            raise ShedError("deadline",
                            f"{self.name}: token budget ({max_new}) at "
                            f"measured ITL cannot meet deadline "
                            f"{deadline_s * 1e3:.1f}ms")
        with self._cond:
            if self._stop:
                raise ShedError("shutdown", f"{self.name}: worker shut down")
            if len(self._q) >= self.config.queue_limit:
                shed = True
            else:
                shed = False
                self._q.append(s)
                self._cond.notify()
        if shed:
            self._shed(s, "backpressure")
            raise ShedError("backpressure",
                            f"{self.name}: generate queue full")
        return GenerateStream(s, timeout_s)

    def _shed(self, s: _Stream, reason: str):
        obs.observe_shed(self.route, reason=reason)
        if reason not in self._shed_seen:
            self._shed_seen.add(reason)
            obs.event("generate_shed", model=self.name, reason=reason)

    # -- engine ------------------------------------------------------------

    def _pages_needed(self, s: _Stream) -> int:
        return max(1, math.ceil((len(s.prompt) + s.max_new) / self._pg))

    def _admit(self, now: float):
        """Move queued streams into free cache slots (token-boundary join).
        Expired queued streams shed here, before they cost a dispatch."""
        while True:
            with self._cond:
                if not self._q or len(self._active) \
                        >= self.config.decode_batch_max:
                    return
                need = self._pages_needed(self._q[0])
                if self.program.paged:
                    if len(self._free_pages) < need:
                        return
                elif not self._free_slots:
                    return
                s = self._q.pop(0)
            if now + self.config.margin_s > s.deadline:
                self._shed(s, "deadline")
                s.out.put(("done", "shed:deadline"))
                continue
            with self._cond:
                if self.program.paged:
                    n = self._pages_needed(s)
                    s.pages = [self._free_pages.pop() for _ in range(n)]
                else:
                    s.slot = self._free_slots.pop()
                s.state = "prefill"
                self._active.append(s)
            self.stats_counters["joins"] += 1
            occ = len(self._active)
            if occ > self.stats_counters["max_occupancy"]:
                self.stats_counters["max_occupancy"] = occ
            obs.set_decode_occupancy(self.name, occ)

    def _leave(self, s: _Stream, reason: str):
        """Stream leaves the batch at a token boundary; its cache capacity
        is reusable by the NEXT admit at once."""
        with self._cond:
            if s in self._active:
                self._active.remove(s)
            if self.program.paged:
                self._free_pages.extend(s.pages)
                s.pages = []
            elif s.slot is not None:
                self._free_slots.append(s.slot)
                s.slot = None
        s.state = "done"
        self.stats_counters["leaves"] += 1
        obs.set_decode_occupancy(self.name, len(self._active))
        s.out.put(("done", reason))
        status = "ok" if reason in ("eos", "length") else "shed"
        obs.observe_request(self.route, time.perf_counter() - s.arrival,
                            status=status)

    def _emit(self, s: _Stream, tok: int, step_bucket: int, now: float):
        """Deliver one token; record TTFT/ITL; decide finish/shed/continue."""
        s.generated += 1
        self.stats_counters["generated"] += 1
        if s.last_emit is None:
            obs.observe_ttft(self.route, now - s.arrival)
        else:
            obs.observe_itl(self.route, now - s.last_emit)
        s.last_emit = now
        s.out.put(("token", tok))
        if s.eos is not None and tok == s.eos:
            self._leave(s, "eos")
        elif s.generated >= s.max_new:
            self._leave(s, "length")
        elif self.admission.should_shed(self.name, s.max_new - s.generated,
                                        s.deadline, now,
                                        batch_rows=step_bucket):
            self.stats_counters["shed_midstream"] += 1
            self._shed(s, "deadline")
            self._leave(s, "shed:deadline")
        else:
            s.state = "decode"
            s.next_tok = tok

    def _table_for(self, streams: List[_Stream], np_bucket: int):
        if self.program.paged:
            table = np.zeros((len(streams), np_bucket), np.int64)
            for i, s in enumerate(streams):
                # only pages the step can touch fit the window; the rest of
                # the allocation enters the table as later positions need it
                n = min(len(s.pages), np_bucket)
                table[i, :n] = s.pages[:n]
            return table
        return np.asarray(
            [s.slot if s.slot is not None else self.program.max_batch
             for s in streams], np.int64)

    def _np_bucket(self, max_pos: int) -> int:
        if not self.program.paged:
            return 0
        used = max(1, math.ceil(max_pos / self._pg))
        return min(self.ladder.bucket(used), self.ladder.bucket(
            self.program.max_pages))

    def _prefill_one(self):
        """One chunk of the OLDEST prefilling stream (batch 1: the same
        dispatch shape an unbatched client would produce)."""
        s = next((t for t in self._active if t.state == "prefill"), None)
        if s is None:
            return False
        chunk = s.prompt[s.fed:s.fed + self.config.prefill_chunk]
        tc = self.ladder.bucket(len(chunk)) if len(chunk) > 1 else 1
        npb = self._np_bucket(s.fed + len(chunk))
        tokens = np.zeros((1, tc), np.int64)
        tokens[0, :len(chunk)] = chunk
        bucketing.telemetry().record_hit("serve.gen.prefill", len(chunk), tc)
        t0 = time.perf_counter()
        _, ids = self.program.dispatch(
            self._table_for([s], npb), [s.cached], tokens, [len(chunk)])
        tok = int(ids[0])  # host sync: the emitted token IS the product
        dt = time.perf_counter() - t0
        self.latency.observe(f"{self.name}:prefill", tc, dt)
        s.fed += len(chunk)
        s.cached += len(chunk)
        if s.fed >= len(s.prompt):
            # the final prefill chunk's logits ARE the first token
            self._emit(s, tok, 1, time.perf_counter())
        return True

    def _decode_step(self):
        """ONE token step over every decode-state stream, padded up the
        batch bucket ladder."""
        streams = [s for s in self._active if s.state == "decode"]
        if not streams:
            return False
        streams.sort(key=lambda s: s.sid)  # deterministic row order
        B = len(streams)
        bb = (self.ladder.bucket(B) if bucketing.bucketing_enabled() else B)
        bb = min(bb, self.ladder.bucket(self.config.decode_batch_max))
        npb = self._np_bucket(max(s.cached + 1 for s in streams))
        table = self._table_for(streams, npb)
        if self.program.paged and bb > B:
            table = np.concatenate(
                [table, np.zeros((bb - B, npb), np.int64)], axis=0)
        elif not self.program.paged and bb > B:
            table = np.concatenate(
                [table, np.full((bb - B,), self.program.max_batch,
                                np.int64)], axis=0)
        lengths = np.zeros((bb,), np.int64)
        tokens = np.zeros((bb, 1), np.int64)
        n_new = np.zeros((bb,), np.int64)
        for i, s in enumerate(streams):
            lengths[i] = s.cached
            tokens[i, 0] = s.next_tok
            n_new[i] = 1
        bucketing.telemetry().record_hit("serve.gen.decode", B, bb)
        t0 = time.perf_counter()
        _, ids = self.program.dispatch(table, lengths, tokens, n_new)
        ids = ids.cpu().numpy()  # host sync: tokens fan out to streams now
        dt = time.perf_counter() - t0
        self.latency.observe(f"{self.name}:decode", bb, dt)
        now = time.perf_counter()
        for i, s in enumerate(streams):
            s.cached += 1
            self._emit(s, int(ids[i]), bb, now)
        return True

    def _engine_loop(self):
        dev = self.program.device
        scope = (torch.cuda.device(dev) if dev.type == "cuda"
                 else contextlib.nullcontext())
        with scope, torch.inference_mode():
            self._engine_iterations()

    def _engine_iterations(self):
        while True:
            with self._cond:
                while not self._q and not self._active and not self._stop:
                    self._cond.wait()
                if self._stop:
                    return
            self._admit(time.perf_counter())
            try:
                did = self._prefill_one()
                did = self._decode_step() or did
            except Exception as e:  # fail every in-flight stream, keep serving
                with self._cond:
                    failing = list(self._active)
                for s in failing:
                    # error event first: the consumer stops at the first
                    # terminal event, _leave's "done" is just queue residue
                    s.out.put(("error", e))
                    self._leave(s, "shutdown")
                continue
            if not did:
                # active streams exist but none dispatchable: yield briefly
                time.sleep(0.0002)

    # -- lifecycle ---------------------------------------------------------

    def stats(self) -> Dict[str, object]:
        with self._cond:
            depth = len(self._q)
            occ = len(self._active)
        out = dict(self.stats_counters)
        out.update({"model": self.name, "queue_depth": depth,
                    "occupancy": occ,
                    "decode_batch_max": self.config.decode_batch_max,
                    "kv_page_tokens": self.config.kv_page_tokens,
                    "paged": self.program.paged,
                    "capacity": self.program.capacity,
                    "off_grid_dispatches": self.program.off_grid_dispatches})
        return out

    def shutdown(self, timeout_s: float = 5.0):
        with self._cond:
            self._stop = True
            stranded = list(self._q) + list(self._active)
            self._q.clear()
            self._active.clear()
            self._cond.notify_all()
        for s in stranded:
            s.out.put(("done", "shutdown"))
        self._thread.join(timeout=timeout_s)
