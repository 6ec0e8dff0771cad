"""HTTP/JSON inference server over the continuous-batching scheduler.

Counterpart of ``deeplearning4j_tpu/serve/server.py`` (stdlib
ThreadingHTTPServer — one OS thread per connection, so concurrent blocked
``submit`` calls ARE the batch). Routes ported so far:

- ``POST /v1/models/<name>:predict`` with ``{"inputs": [[...], ...],
  "deadline_ms": 50}`` → ``{"outputs": [...], "rows": n, "request_id":
  ...}``. 200 served, 400 malformed payload, 404 unknown model, **429**
  shed by queue backpressure (with ``Retry-After``), **503** shed because
  the deadline is infeasible or already expired (or the worker shut down);
- ``POST /v1/models/<name>:generate`` with ``{"prompt": [token ids],
  "max_tokens": 32, "deadline_ms": 30000, "eos": 2}`` → a chunked
  (HTTP/1.1 ``Transfer-Encoding: chunked``) ``application/x-ndjson``
  stream: one ``{"token": id, "i": n}`` line per generated token, flushed
  as the decode engine emits it, then a terminal ``{"done": true,
  "reason": ..., "tokens": n, "ttft_ms": ..., "request_id": ...}`` line.
  Arrival sheds keep the predict route's 429/503, since no byte has been
  sent; a mid-stream shed (the deadline repriced per remaining token)
  shows as the terminal line's ``reason == "shed:deadline"``;
- ``GET /v1/models`` → per-model pool stats;
- ``GET /healthz``, ``GET /metrics`` — from serve/httpcommon.py.

``inputs`` that are all JSON integers stay int64 on their way to a model
whose first layer takes ids (``MultiLayerNetwork.takes_ids``), so token
ids reach the embedding exactly. (The JAX package's route decodes every
payload as float32 and the model then casts it to bf16, which moves ids
above 256 — 1027 becomes 1024.) For any other model, and for any other
numeric payload, they are float32, as there: an image of integer pixels
0-255 reaches a convolution in the model dtype.

SLO route labels are collapsed to ``serve.<name>:http`` / ``/v1/models`` /
``/metrics`` so label cardinality stays bounded by the model count.
"""

from __future__ import annotations

import json
import re
from typing import Optional
from urllib.parse import urlparse

import numpy as np

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.nn.model import resolve_device
from deeplearning4j_tpu_torch.serve import httpcommon
from deeplearning4j_tpu_torch.serve.admission import ServeConfig
from deeplearning4j_tpu_torch.serve.registry import ModelRegistry
from deeplearning4j_tpu_torch.serve.scheduler import ShedError

__all__ = ["InferenceServer", "decode_inputs"]

_PREDICT_RE = re.compile(r"^/v1/models/([\w.\-]+):predict$")
_GENERATE_RE = re.compile(r"^/v1/models/([\w.\-]+):generate$")

# a generate stream's wait for its next token: a bound on a stalled engine,
# far above any step time
_STREAM_WAIT_S = 600.0


def decode_inputs(raw, ids: bool = True) -> np.ndarray:
    """A JSON ``inputs`` value as an array: int64 when every entry is an
    integer and ``ids`` (the model takes token ids), float32 otherwise.
    Raises ValueError for ragged or non-numeric payloads."""
    x = np.asarray(raw)
    if x.dtype.kind in "iu" and ids:
        return x.astype(np.int64)
    if x.dtype.kind in "iu":
        return x.astype(np.float32)
    if x.dtype.kind in "fb":
        return x.astype(np.float32)
    raise ValueError(f"inputs must be a rectangular array of numbers, "
                     f"got dtype {x.dtype}")


class InferenceServer:
    """``InferenceServer(registry).start(port)`` — see module docstring.
    Without a registry it builds one on ``device`` (the GPU by default)."""

    def __init__(self, registry: Optional[ModelRegistry] = None,
                 config: Optional[ServeConfig] = None, device=None):
        if registry is None:
            registry = ModelRegistry(config=config, device=device)
        elif (device is not None
              and resolve_device(device).type != registry.device.type):
            raise ValueError(f"registry serves {registry.device}, "
                             f"server asked for {device}")
        self.registry = registry
        self._httpd = None
        self._thread = None
        self.port: Optional[int] = None
        self._inflight = httpcommon.InFlight()

    # -- lifecycle ---------------------------------------------------------

    def start(self, port: int = 0) -> "InferenceServer":
        outer = self

        class Handler(httpcommon.ObservedHandler):
            inflight = outer._inflight
            protocol_version = "HTTP/1.1"

            def slo_route(self, path: str) -> str:
                m = _PREDICT_RE.match(path)
                if m:
                    return f"serve.{m.group(1)}:http"
                m = _GENERATE_RE.match(path)
                if m:
                    return f"generate.{m.group(1)}:http"
                return path

            def handle_get(self) -> int:
                path = urlparse(self.path).path
                if path == "/v1/models":
                    return self.send_json(200,
                                          {"models": outer.registry.describe()})
                return self.send_json(404, {"error": "no such route"})

            def _send_shed(self, e: ShedError) -> int:
                body = {"error": str(e), "shed": e.reason}
                if e.http_status == 429:
                    # closed-loop clients back off for one deadline's
                    # worth of queue drain rather than hammering
                    return self.send_json(429, body,
                                          headers=(("Retry-After", "1"),))
                return self.send_json(503, body)

            # -- streaming generate ----------------------------------------

            def _chunk(self, data: bytes) -> None:
                self.wfile.write(f"{len(data):x}\r\n".encode())
                self.wfile.write(data)
                self.wfile.write(b"\r\n")

            def handle_generate(self, name: str) -> int:
                gen = outer.registry.generator(name)
                if gen is None:
                    return self.send_json(
                        404, {"error": f"model {name!r} not served for "
                              f"generation", "served": outer.registry.names()})
                try:
                    payload = self.read_json()
                    prompt = [int(t) for t in payload["prompt"]]
                    max_new = payload.get("max_tokens")
                    eos = payload.get("eos")
                    eos = None if eos is None else int(eos)
                    deadline_ms = payload.get("deadline_ms")
                    deadline_s = (None if deadline_ms is None
                                  else float(deadline_ms) / 1e3)
                    if deadline_s is not None and deadline_s <= 0:
                        raise ValueError("deadline_ms must be > 0")
                except Exception as e:
                    return self.send_json(400, {"error": str(e)})
                try:
                    stream = gen.submit(prompt, max_new=max_new, eos=eos,
                                        deadline_s=deadline_s,
                                        timeout_s=_STREAM_WAIT_S)
                except ShedError as e:
                    return self._send_shed(e)
                except ValueError as e:
                    return self.send_json(400, {"error": str(e)})
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                if self.trace is not None:
                    self.send_header("traceparent", self.trace.header())
                self.end_headers()
                try:
                    for i, tok in enumerate(stream):
                        self._chunk(json.dumps(
                            {"token": int(tok), "i": i}).encode() + b"\n")
                        self.wfile.flush()
                    tail = {"done": True, "reason": stream.finish_reason,
                            "tokens": len(stream.tokens)}
                    if stream.ttft_s is not None:
                        tail["ttft_ms"] = round(stream.ttft_s * 1e3, 3)
                except (BrokenPipeError, ConnectionResetError):
                    return 200  # the client went away mid-stream
                except Exception as e:
                    tail = {"done": True, "reason": "error", "error": str(e)}
                if self.trace is not None:
                    # the terminal line names the trace, so a client can
                    # find its request in the merged timeline
                    tail["request_id"] = self.trace.trace_id
                try:
                    self._chunk(json.dumps(tail).encode() + b"\n")
                    # counted before the stream's end reaches the client
                    self._record(200)
                    self.wfile.write(b"0\r\n\r\n")
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    pass  # client went away at the end; engine already done
                return 200

            def handle_post(self) -> int:
                g = _GENERATE_RE.match(urlparse(self.path).path)
                if g:
                    return self.handle_generate(g.group(1))
                m = _PREDICT_RE.match(urlparse(self.path).path)
                if not m:
                    return self.send_json(404, {"error": "no such route"})
                worker = outer.registry.worker(m.group(1))
                if worker is None:
                    return self.send_json(
                        404, {"error": f"model {m.group(1)!r} not served",
                              "served": outer.registry.names()})
                try:
                    payload = self.read_json()
                    x = decode_inputs(payload["inputs"],
                                      getattr(worker.model, "takes_ids", True))
                    deadline_ms = payload.get("deadline_ms")
                    deadline_s = (None if deadline_ms is None
                                  else float(deadline_ms) / 1e3)
                    if deadline_s is not None and deadline_s <= 0:
                        raise ValueError("deadline_ms must be > 0")
                except Exception as e:
                    return self.send_json(400, {"error": str(e)})
                try:
                    out = worker.submit(x, deadline_s=deadline_s)
                except ShedError as e:
                    return self._send_shed(e)
                except ValueError as e:
                    return self.send_json(400, {"error": str(e)})
                except Exception as e:
                    return self.send_json(500, {"error": str(e)})
                body = {"outputs": out.tolist(), "rows": int(len(out))}
                if self.trace is not None:
                    body["request_id"] = self.trace.trace_id
                return self.send_json(200, body)

        self._httpd, self._thread, self.port = httpcommon.start_server(
            Handler, port)
        obs.event("serve_started", port=self.port,
                  models=",".join(self.registry.names()))
        return self

    def stop(self, shutdown_registry: bool = True) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            if self._thread:
                self._thread.join(timeout=10)
                self._thread = None
        if shutdown_registry:
            self.registry.shutdown()
