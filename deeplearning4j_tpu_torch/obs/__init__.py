"""Unified observability layer: metrics registry, span tracer, event log.

Host-only copy of ``deeplearning4j_tpu/obs`` (metrics, spans, events, slo,
fleet) with imports re-pointed at this package: the serving tier's
counters, histograms, SLO burn rate and trace context are the same families
under the same names, so a dashboard reads either package alike. The XLA
cost model (``obs/profile.py``) and trace export are not carried over.

Public surface::

    obs.counter/gauge/histogram(name, help, label_names)  # get-or-create
    with obs.span("mln.output"): ...                      # wall+cpu windows
    obs.event("serve_started", port=...)                  # JSONL + counter
    obs.configure_event_log(path)                         # or DL4J_TPU_EVENT_LOG
    obs.snapshot(); obs.prometheus_text(); obs.reset()

Recording is host-side dict updates under locks; nothing here synchronises
with the device. ``DL4J_TPU_OBS=0`` disables span recording and event
emission.
"""

from __future__ import annotations

import os
from typing import Optional

from deeplearning4j_tpu_torch.obs import events as _events
from deeplearning4j_tpu_torch.obs import metrics as _metrics
from deeplearning4j_tpu_torch.obs import spans as _spans

__all__ = [
    "configure_event_log",
    "counter",
    "current_trace",
    "enabled",
    "event",
    "event_log",
    "gauge",
    "histogram",
    "observe_itl",
    "observe_request",
    "observe_shed",
    "observe_ttft",
    "phase_spans_enabled",
    "prometheus_text",
    "recent_spans",
    "registry",
    "reset",
    "set_decode_occupancy",
    "set_process_context",
    "snapshot",
    "span",
    "trace_scope",
    "tracer",
]


def enabled() -> bool:
    """Master switch (default on). Read per call so tests can flip it."""
    return os.environ.get("DL4J_TPU_OBS", "1") != "0"


def phase_spans_enabled() -> bool:
    """Opt-in phase profiling (DL4J_TPU_PHASE_SPANS=1): the fit loops run a
    step as forward, backward and update, each synchronised with the device
    under its own span (``phase.fwd``, ``phase.bwd``, ``phase.update``), so
    the spans carry real per-phase wall time. Costs overlap: a profiling
    mode, never the default. Implies enabled()."""
    return enabled() and os.environ.get("DL4J_TPU_PHASE_SPANS", "0") == "1"


# -- metrics ----------------------------------------------------------------

def registry() -> _metrics.MetricsRegistry:
    return _metrics.registry()


def counter(name: str, help: str = "", label_names=()) -> _metrics.Counter:
    return _metrics.registry().counter(name, help, label_names)


def gauge(name: str, help: str = "", label_names=()) -> _metrics.Gauge:
    return _metrics.registry().gauge(name, help, label_names)


def histogram(name: str, help: str = "", label_names=()) -> _metrics.Histogram:
    return _metrics.registry().histogram(name, help, label_names)


def prometheus_text() -> str:
    return _metrics.registry().prometheus_text()


# -- spans ------------------------------------------------------------------

def tracer() -> _spans.SpanTracer:
    return _spans.tracer()


def span(name: str, **attrs):
    """``with obs.span("mln.output"): ...`` — see obs/spans.py."""
    return _spans.tracer().span(name, **attrs)


def recent_spans(n: Optional[int] = None):
    return _spans.tracer().recent(n)


# -- SLOs -------------------------------------------------------------------

def observe_request(route: str, latency_s: float, status: str = "ok",
                    error: bool = False):
    """Record one serving/HTTP request against the SLO tracker
    (see obs/slo.py). No-op when DL4J_TPU_OBS=0; never raises."""
    from deeplearning4j_tpu_torch.obs import slo as _slo

    _slo.observe_request(route, latency_s, status=status, error=error)


def observe_shed(route: str, reason: str = "backpressure"):
    """Record one load-shedding decision against the SLO tracker
    (see obs/slo.py). No-op when DL4J_TPU_OBS=0; never raises."""
    from deeplearning4j_tpu_torch.obs import slo as _slo

    _slo.observe_shed(route, reason=reason)


def observe_ttft(route: str, latency_s: float):
    """Record one stream's time-to-first-token (see obs/slo.py).
    No-op when DL4J_TPU_OBS=0; never raises."""
    from deeplearning4j_tpu_torch.obs import slo as _slo

    _slo.observe_ttft(route, latency_s)


def observe_itl(route: str, latency_s: float):
    """Record one inter-token latency gap (see obs/slo.py).
    No-op when DL4J_TPU_OBS=0; never raises."""
    from deeplearning4j_tpu_torch.obs import slo as _slo

    _slo.observe_itl(route, latency_s)


def set_decode_occupancy(model: str, streams: int):
    """Set the decode-batch occupancy gauge (see obs/slo.py).
    No-op when DL4J_TPU_OBS=0; never raises."""
    from deeplearning4j_tpu_torch.obs import slo as _slo

    _slo.set_decode_occupancy(model, streams)


# -- fleet (trace and process context) ---------------------------------------

def current_trace():
    """The thread's active W3C trace context, or None (see obs/fleet.py)."""
    from deeplearning4j_tpu_torch.obs import fleet as _fleet

    return _fleet.current_trace()


def trace_scope(ctx):
    """``with obs.trace_scope(ctx): ...`` — spans/events recorded inside
    carry ``ctx``'s trace/span ids (see obs/fleet.py)."""
    from deeplearning4j_tpu_torch.obs import fleet as _fleet

    return _fleet.trace_scope(ctx)


def set_process_context(**fields):
    """Tag this process's spans/events with rank/wid/incarnation/slice
    (see obs/fleet.py)."""
    from deeplearning4j_tpu_torch.obs import fleet as _fleet

    _fleet.set_process_context(**fields)


# -- events -----------------------------------------------------------------

def event_log() -> _events.EventLog:
    return _events.event_log()


def event(kind: str, **fields):
    """Emit one structured event (no-op when DL4J_TPU_OBS=0; never raises)."""
    if enabled():
        _events.event_log().emit(kind, **fields)


def configure_event_log(path: Optional[str], max_bytes: int = 4 * 1024 * 1024):
    _events.event_log().configure(path, max_bytes)


# -- aggregate views --------------------------------------------------------

def snapshot() -> dict:
    """JSON-friendly aggregate of everything the registry knows: metric
    families (counters/gauges plain, histograms summarized), per-span
    aggregates, event counts and the bucketing telemetry."""
    from deeplearning4j_tpu_torch.utils import bucketing

    return {
        "metrics": _metrics.registry().snapshot(),
        "spans": _spans.tracer().summary(),
        "events": _events.event_log().counts(),
        "bucketing": bucketing.telemetry().snapshot(),
    }


def reset():
    """Zero every metric series and drop recent spans, keeping
    configuration (event-log path, family registrations)."""
    from deeplearning4j_tpu_torch.obs import slo as _slo

    _metrics.registry().reset()
    _spans.tracer().clear()
    _slo._reset_tracker()
