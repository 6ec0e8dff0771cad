"""Nearest-neighbors HTTP server — DEPRECATED shim over the unified stack
(PyTorch port of the JAX package's ``clustering/server.py``).

The ``/knn`` / ``/knnnew`` / ``/status`` wire contract lives on the
unified inference server (``serve/server.py``), so there is ONE HTTP
stack, one SLO tracker and one ``/metrics`` endpoint for predict,
generate and search alike. :class:`NearestNeighborsServer` is a thin
compatibility shim: same constructor, same ``start(port)`` / ``stop()`` /
``.port`` surface, same JSON responses — ``start`` builds an exact-tier
:class:`~deeplearning4j_tpu_torch.search.index.VectorIndex` and serves it
through :class:`~deeplearning4j_tpu_torch.serve.InferenceServer`, on
``device`` (None: the GPU, raising without one). Prefer
``serve.ModelRegistry().register_index(...)`` + ``POST /v1/search`` for
new code.

Metrics the device index does not speak (sqeuclidean / manhattan / dot /
inverted similarity) fall back to the legacy in-module server so the old
CLI keeps answering; that path warns and will be removed with the shim.

POST /knn     {"ndarray": <row index>, "k": 5}
POST /knnnew  {"ndarray": [..vector..], "k": 5}
Response      {"results": [{"index": i, "distance": d}, ...]}
GET  /status  {"ok": true, "points": N, "dim": D}
"""

from __future__ import annotations

import json
import threading
import warnings
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.clustering.knn import knn_search

# legacy similarity name -> VectorIndex metric; anything absent here (or
# invert=True) cannot be expressed by the device index and stays legacy
_UNIFIED_METRICS = {
    "euclidean": "euclidean",
    "cosine": "cosine",
    "cosinedistance": "cosine",
}


class NearestNeighborsServer:
    """``NearestNeighborsServer(points, similarity_function).start(port)``;
    ``stop()`` to shut down. Port 0 picks a free port (see ``.port``).

    Deprecated: a compatibility front for the unified serving stack — see
    the module docstring."""

    def __init__(self, points, similarity_function: str = "euclidean",
                 invert: bool = False, device=None):
        from deeplearning4j_tpu_torch.nn.model import resolve_device

        warnings.warn(
            "clustering.server.NearestNeighborsServer is deprecated: the "
            "/knn routes now live on the unified inference server — use "
            "serve.ModelRegistry().register_index(...) and POST /v1/search",
            DeprecationWarning, stacklevel=2)
        self.points = np.asarray(points, np.float32)
        self.similarity_function = similarity_function
        self.invert = invert
        self.device = resolve_device(device)
        self._srv = None          # unified InferenceServer
        self._legacy: Optional[_LegacyNearestNeighborsServer] = None
        self.port: Optional[int] = None

    def start(self, port: int = 9000) -> "NearestNeighborsServer":
        metric = _UNIFIED_METRICS.get(self.similarity_function.lower())
        if metric is None or self.invert:
            warnings.warn(
                f"similarity {self.similarity_function!r} (invert="
                f"{self.invert}) is not served by the device index; "
                "falling back to the legacy brute-force server",
                DeprecationWarning, stacklevel=2)
            self._legacy = _LegacyNearestNeighborsServer(
                self.points, self.similarity_function, self.invert,
                device=self.device).start(port)
            self.port = self._legacy.port
            return self
        from deeplearning4j_tpu_torch.search import IndexConfig, VectorIndex
        from deeplearning4j_tpu_torch.serve import InferenceServer, ModelRegistry

        index = VectorIndex.build(self.points, IndexConfig(
            dim=int(self.points.shape[1]), name="default", metric=metric,
            ivf=False, pending_cap=0, max_k=64), device=self.device)
        registry = ModelRegistry(device=self.device)
        # compat shim favors startup latency over first-request latency
        registry.register_index("default", index, warm=False)
        self._srv = InferenceServer(registry).start(port=port)
        self.port = self._srv.port
        return self

    def stop(self) -> None:
        if self._srv is not None:
            self._srv.stop()
            self._srv = None
        if self._legacy is not None:
            self._legacy.stop()
            self._legacy = None


class _LegacyNearestNeighborsServer:
    """The pre-unification stdlib server, kept verbatim for the metric
    combinations the device index does not express. Scheduled for removal
    with the shim."""

    def __init__(self, points, similarity_function: str = "euclidean",
                 invert: bool = False, device=None):
        self.points = np.asarray(points, np.float32)
        self.similarity_function = similarity_function
        self.invert = invert
        self.device = device
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.port: Optional[int] = None

    def _search(self, vec: np.ndarray, k: int):
        idx, dist = knn_search(self.points, vec[None, :], k,
                               metric=self.similarity_function,
                               device=self.device)
        return [
            {"index": int(i), "distance": float(d)}
            for i, d in zip(idx[0], dist[0])
        ]

    def start(self, port: int = 9000) -> "_LegacyNearestNeighborsServer":
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silent: tests spin servers up/down
                pass

            def _reply(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/status":
                    self._reply(200, {"ok": True,
                                      "points": int(outer.points.shape[0]),
                                      "dim": int(outer.points.shape[1])})
                else:
                    self._reply(404, {"error": "unknown path"})

            def do_POST(self):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    k = int(req.get("k", 1))
                    if self.path == "/knn":
                        row = int(req["ndarray"])
                        vec = outer.points[row]
                        results = outer._search(vec, k + 1)
                        # drop the query row itself (reference /knn semantics).
                        # The [:k] slice only trims when the self row wasn't
                        # among the k+1 hits (duplicate points); when the
                        # corpus caps the search (k >= num points) the
                        # filtered list is already <= k, so no available
                        # neighbor is ever dropped.
                        results = [r for r in results if r["index"] != row][:k]
                    elif self.path == "/knnnew":
                        vec = np.asarray(req["ndarray"], np.float32).reshape(-1)
                        results = outer._search(vec, k)
                    else:
                        self._reply(404, {"error": "unknown path"})
                        return
                    self._reply(200, {"results": results})
                except Exception as e:  # bad request payloads
                    self._reply(400, {"error": str(e)})

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            if self._thread:
                self._thread.join(timeout=10)
                self._thread = None
