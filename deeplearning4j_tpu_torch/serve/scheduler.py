"""Continuous-batching scheduler: per-model queues, coalescing dispatchers.

Counterpart of ``deeplearning4j_tpu/serve/scheduler.py`` (the predict
path; the generate and search workers wait for their slices). One
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
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.obs import fleet
from deeplearning4j_tpu_torch.serve.admission import (
    AdmissionController, LatencyModel, ServeConfig)
from deeplearning4j_tpu_torch.utils import bucketing

__all__ = ["ModelWorker", "ServeConfig", "ShedError"]


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
