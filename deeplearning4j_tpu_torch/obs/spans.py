"""Span tracer: host wall-time + dispatch-time windows around step-level work.

``span("mln.fit_batch")`` wraps one unit of work. On exit it records

- ``wall_s``  — host wall-clock window (``time.perf_counter`` delta). With
  async dispatch this includes any time the host BLOCKED on the device
  (donated-buffer back-pressure, explicit syncs in callers) but never forces
  a sync itself — ``block_until_ready`` is deliberately absent here.
- ``cpu_s``   — the dispatch-time window: CPU time this thread spent inside
  the span (``time.thread_time`` delta). For a healthy async pipeline
  ``cpu_s`` ≈ tracing/dispatch cost and ``wall_s`` ≫ ``cpu_s`` means the
  host was waiting (device-bound or back-pressured) — the two windows
  together locate the bottleneck without device instrumentation.

Nesting is tracked per thread: a span opened while another is active records
the outer span's name as ``parent`` and its own ``depth``. Finished spans go
to a bounded ring buffer (most recent last) and into the
``dl4j_span_seconds`` histogram family in the metrics registry.

Ring records carry everything ``obs/trace_export.py`` needs to render a
Chrome/Perfetto timeline: ``t0_s`` (span start on the process-local
``perf_counter`` timeline), ``tid``/``thread`` (OS thread identity for
per-thread lanes), and the tracer's ``anchor()`` maps that timeline onto
wall-clock so event-log instants (whose ``ts`` is wall-clock by design)
land on the same axis.

Ring capacity defaults to 512 finished spans and is tunable via
``DL4J_TPU_SPAN_RING`` (read at tracer construction, i.e. first import of
the obs layer). Overflow is NOT silent: every record evicted to make room
increments ``dl4j_spans_dropped_total`` — mirroring the
``dl4j_events_dropped_total`` discipline — so a long fit that outruns the
ring is visible in /metrics instead of producing quietly truncated traces.
``DL4J_TPU_SPAN_DUMP=<path>`` dumps the ring (plus the anchor) as JSON at
interpreter exit for offline trace export.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.obs import fleet, metrics

__all__ = ["SpanTracer", "compile_span", "tracer"]

_RING_DEFAULT = 512  # finished spans retained unless DL4J_TPU_SPAN_RING


def _ring_capacity() -> int:
    raw = os.environ.get("DL4J_TPU_SPAN_RING", "")
    try:
        n = int(raw)
    except ValueError:
        return _RING_DEFAULT
    return n if n > 0 else _RING_DEFAULT


class _ActiveSpan:
    __slots__ = ("name", "attrs", "t0", "c0")

    def __init__(self, name: str, attrs: Dict[str, object]):
        self.name = name
        self.attrs = attrs
        self.t0 = time.perf_counter()
        self.c0 = time.thread_time()


class _SpanContext:
    """Context manager handed out by ``SpanTracer.span``. Re-entrant-safe in
    the sense that each ``with`` creates a fresh context."""

    __slots__ = ("_tracer", "_name", "_attrs", "_active")

    def __init__(self, tracer: "SpanTracer", name: str, attrs: Dict[str, object]):
        self._tracer = tracer
        self._name = name
        self._attrs = attrs
        self._active: Optional[_ActiveSpan] = None

    def __enter__(self):
        self._active = self._tracer._push(self._name, self._attrs)
        return self

    def __exit__(self, exc_type, exc, tb):
        self._tracer._pop(self._active, error=exc_type is not None)
        return False


class _NullContext:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL = _NullContext()


class SpanTracer:
    def __init__(self, reg: Optional[metrics.MetricsRegistry] = None,
                 ring_size: Optional[int] = None):
        self._reg = reg or metrics.registry()
        self._hist = self._reg.histogram(
            "dl4j_span_seconds",
            "host wall-time of instrumented spans (see dl4j_span_cpu_seconds "
            "for the dispatch-time window)", ("span",))
        self._cpu = self._reg.histogram(
            "dl4j_span_cpu_seconds",
            "thread CPU time inside instrumented spans (dispatch cost; "
            "wall >> cpu means the host was waiting)", ("span",))
        self._dropped = self._reg.counter(
            "dl4j_spans_dropped_total",
            "finished spans evicted from the bounded span ring "
            "(raise DL4J_TPU_SPAN_RING if this grows during a window "
            "you want to trace)")
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=ring_size or _ring_capacity())
        self._tls = threading.local()
        # One (wall-clock, perf_counter) pair sampled back to back: maps the
        # perf_counter timeline every span uses onto wall-clock so trace
        # export can align event-log instants (wall-clock ts) with spans.
        self._anchor = {"wall_s": time.time(), "perf_s": time.perf_counter()}

    # -- recording ---------------------------------------------------------

    def span(self, name: str, **attrs) -> object:
        """Context manager timing one unit of work. With observability
        disabled (DL4J_TPU_OBS=0) returns a shared no-op context."""
        from deeplearning4j_tpu_torch import obs

        if not obs.enabled():
            return _NULL
        return _SpanContext(self, name, attrs)

    def _stack(self) -> List[_ActiveSpan]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _push(self, name: str, attrs: Dict[str, object]) -> _ActiveSpan:
        sp = _ActiveSpan(name, attrs)
        self._stack().append(sp)
        return sp

    def _pop(self, sp: Optional[_ActiveSpan], error: bool = False):
        if sp is None:
            return
        wall = time.perf_counter() - sp.t0
        cpu = time.thread_time() - sp.c0
        stack = self._stack()
        # tolerate exotic unwinds: pop through to OUR frame
        while stack and stack[-1] is not sp:
            stack.pop()
        if stack:
            stack.pop()
        parent = stack[-1].name if stack else None
        th = threading.current_thread()
        rec = {
            "span": sp.name,
            "t0_s": sp.t0,
            "wall_s": wall,
            "cpu_s": cpu,
            "parent": parent,
            "depth": len(stack),
            "tid": th.ident,
            "thread": th.name,
        }
        if error:
            rec["error"] = True
        if sp.attrs:
            rec["attrs"] = sp.attrs
        # rank/incarnation + active trace ids (obs/fleet.py) — cheap dict
        # writes; records keep the rank current when they were recorded,
        # which matters across elastic reforms
        fleet.stamp_span(rec)
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self._dropped.inc()
            self._ring.append(rec)
        self._hist.observe(wall, span=sp.name)
        self._cpu.observe(cpu, span=sp.name)

    # -- views -------------------------------------------------------------

    def recent(self, n: Optional[int] = None) -> List[dict]:
        """Most recent finished spans, oldest first."""
        with self._lock:
            out = list(self._ring)
        return out if n is None else out[-n:]

    def anchor(self) -> Dict[str, float]:
        """The (wall_s, perf_s) pair mapping the span timeline to wall-clock:
        ``wall = anchor.wall_s + (t0_s - anchor.perf_s)``."""
        return dict(self._anchor)

    def capacity(self) -> int:
        return self._ring.maxlen or 0

    def summary(self) -> Dict[str, dict]:
        """Per-span-name {count, wall_sum_s, wall_p50_s, wall_max_s, cpu_sum_s}
        from the registry histograms (JSON-friendly, for ``obs.snapshot()``)."""
        out: Dict[str, dict] = {}
        for key, _ in self._hist.series():
            name = key[0]
            s = self._hist.summary(span=name)
            c = self._cpu.summary(span=name)
            out[name] = {
                "count": s["count"],
                "wall_sum_s": s["sum"],
                "wall_p50_s": s["p50"],
                "wall_max_s": s["max"],
                "cpu_sum_s": c["sum"] if c else 0.0,
            }
        return out

    def dump(self, path: str) -> int:
        """Write the ring + anchor as JSON for offline trace export
        (``python -m deeplearning4j_tpu_torch.obs.trace_export --spans <path>``).
        Returns the number of spans written."""
        spans = self.recent()
        doc = {"anchor": self.anchor(), "spans": spans,
               "process": fleet.process_context()}
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return len(spans)

    def clear(self):
        with self._lock:
            self._ring.clear()


_TRACER = SpanTracer()


def tracer() -> SpanTracer:
    return _TRACER


def _dump_at_exit():
    path = os.environ.get("DL4J_TPU_SPAN_DUMP")
    if not path:
        return
    try:
        _TRACER.dump(path)
    except OSError:
        pass  # exit-time best effort; never mask the real exit status


atexit.register(_dump_at_exit)


def compile_span(site: str, **attrs):
    """The ``compile`` span kind: one span family for the warm passes of
    ``nn/aot.py`` (a site's first dispatch per signature, its counting pass,
    a bundle's replay). The site rides as an attribute, so every warm
    aggregates under the single ``compile`` series: its ``wall_sum_s`` in
    ``obs.snapshot()`` is the process's whole cold-start cost."""
    return tracer().span("compile", site=site, **attrs)
