"""Parallel inference with request batching (the PyTorch port of
``parallel/inference.py``, DL4J's ParallelInference).

One model on its device serves every caller thread: ``inplace`` calls
straight through, ``batched`` queues requests and a worker thread
coalesces them into one ``model.output`` call of at most
``max_batch_size`` rows (one oversized request still goes whole), padded
up the bucket ladder with zero rows that are cut off before the answers
fan back out. A request still queued when its deadline passes is shed with
``serve.scheduler.ShedError`` instead of answered late. ``warmup`` runs
the model's ``mln.output`` / ``cg.output`` site once at every bucket a
coalesced batch can reach before the first request, each priced by a
counting pass (``nn/aot.py``; ``DL4J_TPU_AOT=1`` turns it on by default).
With ``DL4J_TPU_TUNE=auto`` the tuning DB's winner for the model is
applied first (``tune.maybe_apply(model, "serve")``).
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.nn import aot
from deeplearning4j_tpu_torch.utils import bucketing

__all__ = ["ParallelInference"]


class _Pending:
    __slots__ = ("x", "event", "result", "deadline")

    def __init__(self, x, deadline: Optional[float] = None):
        self.x = x
        self.event = threading.Event()
        self.result = None
        self.deadline = deadline  # perf_counter scale, None = no deadline


def _host(out) -> np.ndarray:
    t = out.detach()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.cpu().numpy()


class ParallelInference:
    """Batched inference front end over ``model`` (see the module
    docstring). ``bucket`` defaults to ``DL4J_TPU_BUCKETING``, ``warmup`` to
    ``DL4J_TPU_AOT``."""

    def __init__(self, model, mode: str = "batched", max_batch_size: int = 32,
                 queue_limit: int = 64, worker: bool = True,
                 bucket: Optional[bool] = None, warmup: Optional[bool] = None):
        if os.environ.get("DL4J_TPU_TUNE"):
            # the DB's serve-scope winner, before the warm reads its knobs
            from deeplearning4j_tpu_torch import tune

            tune.maybe_apply(model, "serve")
        if mode not in ("batched", "inplace", "sequential"):
            raise ValueError(f"mode={mode!r}: want 'batched', 'inplace' or 'sequential'")
        self.model = model
        self.mode = mode
        self.max_batch_size = max_batch_size
        self.bucket = bucketing.bucketing_enabled() if bucket is None else bucket
        if warmup is None:
            warmup = aot.enabled()
        self.warmed: List[int] = []
        if warmup:
            self._warm()
        self._queue: "queue.Queue[_Pending]" = queue.Queue(maxsize=queue_limit)
        self._carry: Optional[_Pending] = None  # a request _drain deferred
        self._stop = threading.Event()
        self._lifecycle_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        if mode == "batched" and worker:
            self._thread = threading.Thread(target=self._worker_loop, daemon=True)
            self._thread.start()

    def _warm(self):
        """The output site at every bucket a coalesced batch can hit
        (``nn/aot.py``, as ``aot.warm_serving``)."""
        m = self.model
        if m.params is None:
            m.init()
        sizes = (bucketing.reachable_buckets(self.max_batch_size) if self.bucket
                 else [self.max_batch_size])
        fn = m._get_output_fn()
        for b in sizes:
            if fn.warm(aot._dummy_features(m, b), None, cost_key=f"b{b}"):
                bucketing.telemetry().record_hit(fn.site, b, b)
        if m.device.type == "cuda":
            torch.cuda.synchronize(m.device)
        self.warmed = list(sizes)

    # -- public ------------------------------------------------------------
    def output(self, x, deadline_ms: Optional[float] = None) -> np.ndarray:
        """The model's output on ``x`` as a host array. ``deadline_ms``
        (from now): a batched request still queued when it passes is shed
        with :class:`~deeplearning4j_tpu_torch.serve.scheduler.ShedError`
        and counted into ``dl4j_shed_total``."""
        from deeplearning4j_tpu_torch.serve.scheduler import ShedError

        t0 = time.perf_counter()
        try:
            out = self._output(x, deadline_ms=deadline_ms)
        except ShedError:
            raise  # counted by observe_shed, not a latency sample
        except Exception:
            obs.observe_request("pi.output", time.perf_counter() - t0,
                                status="error", error=True)
            raise
        obs.observe_request("pi.output", time.perf_counter() - t0)
        return out

    def _output(self, x, deadline_ms: Optional[float] = None) -> np.ndarray:
        x = np.asarray(x)
        if self.mode != "batched" or self._thread is None:
            if self._stop.is_set():
                raise RuntimeError("ParallelInference is shut down")
            return _host(self.model.output(x))
        deadline = (None if deadline_ms is None
                    else time.perf_counter() + float(deadline_ms) / 1e3)
        p = _Pending(x, deadline=deadline)
        # enqueue under the shutdown lock, so that no request slips into
        # the queue after shutdown() drained it
        with self._lifecycle_lock:
            if self._stop.is_set():
                raise RuntimeError("ParallelInference is shut down")
            self._queue.put(p)
            if obs.enabled():
                obs.gauge("dl4j_inference_queue_depth",
                          "Requests waiting in the batching queue").set(self._queue.qsize())
        p.event.wait()
        if isinstance(p.result, Exception):
            raise p.result
        return p.result

    def shutdown(self):
        with self._lifecycle_lock:
            self._stop.set()
        if self._thread is not None:
            self._queue.put(_Pending(None))  # wake the worker
            self._thread.join(timeout=5)
            with self._lifecycle_lock:
                # fail the requests left in the queue (or carried by the
                # coalescer), so that no waiter hangs
                stranded = [self._carry] if self._carry is not None else []
                self._carry = None
                while True:
                    try:
                        stranded.append(self._queue.get_nowait())
                    except queue.Empty:
                        break
                for p in stranded:
                    if p.x is not None:
                        p.result = RuntimeError("ParallelInference shut down")
                        p.event.set()

    # -- worker ------------------------------------------------------------
    def _drain(self) -> List[_Pending]:
        """One device batch: queued requests coalesced until their rows
        reach ``max_batch_size``; a request that would overflow it is
        carried to the next batch."""
        if self._carry is not None:
            batch, self._carry = [self._carry], None
        else:
            batch = [self._queue.get()]
        n = len(batch[0].x) if batch[0].x is not None else 0
        while n < self.max_batch_size:
            try:
                p = self._queue.get_nowait()
            except queue.Empty:
                break
            if p.x is not None and n + len(p.x) > self.max_batch_size:
                self._carry = p
                break
            batch.append(p)
            if p.x is not None:
                n += len(p.x)
        return self._shed_expired([p for p in batch if p.x is not None])

    def _shed_expired(self, batch: List[_Pending]) -> List[_Pending]:
        from deeplearning4j_tpu_torch.serve.scheduler import ShedError

        now = time.perf_counter()
        live = [p for p in batch if p.deadline is None or p.deadline >= now]
        for p in batch:
            if p not in live:
                obs.observe_shed("pi.output", reason="deadline")
                p.result = ShedError("deadline", "deadline expired in the batching queue")
                p.event.set()
        return live

    def _worker_loop(self):
        if self.model.device.type == "cuda":
            torch.cuda.set_device(self.model.device)
        while not self._stop.is_set():
            batch = self._drain()
            if not batch:
                continue
            if obs.enabled():
                obs.gauge("dl4j_inference_in_flight",
                          "Coalesced requests currently on device").set(len(batch))
            try:
                sizes = [len(p.x) for p in batch]
                xs = np.concatenate([p.x for p in batch], axis=0)
                total = len(xs)
                if self.bucket and total > 0:
                    target = bucketing.bucket_size(total)
                    bucketing.telemetry().record_hit("pi.batched", total, target)
                    if target > total:
                        xs = np.concatenate(
                            [xs, np.zeros((target - total,) + xs.shape[1:], xs.dtype)])
                out = _host(self.model.output(xs))[:total]
                ofs = 0
                for p, n in zip(batch, sizes):
                    p.result = out[ofs:ofs + n]
                    ofs += n
                    p.event.set()
            except Exception as e:  # every waiter of the batch gets the error
                for p in batch:
                    p.result = e
                    p.event.set()
            finally:
                if obs.enabled():
                    obs.gauge("dl4j_inference_in_flight",
                              "Coalesced requests currently on device").set(0)
