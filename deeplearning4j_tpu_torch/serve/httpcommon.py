"""Shared HTTP plumbing for the stdlib servers.

Host-only copy of ``deeplearning4j_tpu/serve/httpcommon.py``. Every route
of ``serve/server.py`` (and of the fleet collector in ``obs/fleet.py``)
carries the same non-negotiables: the serving-SLO envelope (per-route
latency histogram + ``dl4j_requests_total{route,status}`` + burn rate via
obs/slo.py), the ``dl4j_http_in_flight`` gauge, quiet request logging, and
the operational endpoints ``/metrics`` (Prometheus text exposition) and
``/healthz``. This module owns those once:

- :class:`InFlight` — the shared in-flight counter → gauge;
- :class:`ObservedHandler` — a BaseHTTPRequestHandler that wraps
  ``handle_get``/``handle_post`` (return the status they sent) in the SLO
  envelope and answers ``/metrics`` + ``/healthz`` before delegating;
- :func:`start_server` — ThreadingHTTPServer on 127.0.0.1 + daemon thread.

Subclasses override ``handle_get``/``handle_post`` and reply through
``send_body``/``send_json``/``send_error_body`` so Content-Length is always
right.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import urlparse

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.obs import fleet

__all__ = ["InFlight", "ObservedHandler", "start_server"]

PROM_CTYPE = "text/plain; version=0.0.4; charset=utf-8"


class InFlight:
    """Requests currently inside a handler, mirrored to the
    ``dl4j_http_in_flight`` gauge (shared by every server in the process —
    the gauge is process-wide saturation, not per-listener)."""

    def __init__(self):
        self._n = 0
        self._lock = threading.Lock()

    def note(self, delta: int) -> None:
        with self._lock:
            self._n += delta
            v = self._n
        if obs.enabled():
            obs.gauge("dl4j_http_in_flight",
                      "HTTP requests currently being served").set(v)


class ObservedHandler(BaseHTTPRequestHandler):
    """SLO-observed request handler with the common operational routes.

    Class attribute ``inflight`` (an :class:`InFlight`) is injected by the
    server that mounts the handler. ``slo_route(path)`` may be overridden
    to collapse high-cardinality paths (e.g. per-model predict URLs) into a
    bounded route label set.
    """

    inflight: Optional[InFlight] = None
    # the request's trace context (obs/fleet.py): adopted from an inbound
    # W3C ``traceparent`` header (same trace, fresh span id) or minted at
    # this front door; echoed on every reply and stamped onto every
    # span/event recorded while the handler runs
    trace: Optional[fleet.TraceContext] = None

    def log_message(self, *a):  # quiet: obs carries the signal
        pass

    # -- envelope ----------------------------------------------------------

    def slo_route(self, path: str) -> str:
        return path

    def _observed(self, handler):
        route = self.slo_route(urlparse(self.path).path)
        inbound = fleet.TraceContext.parse(self.headers.get("traceparent"))
        self.trace = inbound.child() if inbound else fleet.TraceContext.mint()
        if self.inflight is not None:
            self.inflight.note(1)
        self._pending = (route, time.perf_counter())
        status = 500
        try:
            with fleet.trace_scope(self.trace), \
                    obs.span("http.request", route=route,
                             method=self.command):
                status = handler()
        finally:
            if self.inflight is not None:
                self.inflight.note(-1)
            self._record(status)   # a streamed reply, or a handler that raised

    def _record(self, status: int) -> None:
        """Record this request in the SLO envelope, once. ``send_body``
        records before it writes the body, so a client that has read its
        reply finds the request in ``/metrics``."""
        pending, self._pending = getattr(self, "_pending", None), None
        if pending is not None:
            route, t0 = pending
            obs.observe_request(route, time.perf_counter() - t0,
                                status=str(status), error=status >= 500)

    def do_GET(self):
        self._observed(self._get_with_common)

    def do_POST(self):
        self._observed(self.handle_post)

    def _get_with_common(self) -> int:
        route = urlparse(self.path).path
        if route == "/metrics":
            return self.send_body(200, obs.prometheus_text().encode(),
                                  PROM_CTYPE)
        if route == "/healthz":
            return self.send_json(200, {"status": "ok"})
        return self.handle_get()

    # -- overridables ------------------------------------------------------

    def handle_get(self) -> int:
        self.send_response(404)
        self.end_headers()
        return 404

    def handle_post(self) -> int:
        self.send_response(404)
        self.end_headers()
        return 404

    # -- reply helpers -----------------------------------------------------

    def send_body(self, status: int, body: bytes, ctype: str,
                  headers: Tuple[Tuple[str, str], ...] = ()) -> int:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        if self.trace is not None:
            self.send_header("traceparent", self.trace.header())
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self._record(status)
        self.wfile.write(body)
        return status

    def send_json(self, status: int, payload,
                  headers: Tuple[Tuple[str, str], ...] = ()) -> int:
        return self.send_body(status, json.dumps(payload).encode(),
                              "application/json", headers)

    def read_json(self):
        n = int(self.headers.get("Content-Length", "0"))
        return json.loads(self.rfile.read(n).decode("utf-8"))


def start_server(handler_cls, port: int = 0,
                 host: str = "127.0.0.1") -> Tuple[ThreadingHTTPServer,
                                                   threading.Thread, int]:
    """Bind ``handler_cls`` and serve it from a daemon thread. Returns
    ``(httpd, thread, bound_port)`` (``port=0`` lets the OS pick)."""
    httpd = ThreadingHTTPServer((host, port), handler_cls)
    bound = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, thread, bound
