"""UIServer: dashboard rendering + attach API.

Reference surface: UIServer.getInstance().attach(statsStorage)
(deeplearning4j-play/.../api/UIServer.java:24,49) with train modules
(/train/overview score+throughput, /train/model per-param charts,
/train/system). Re-designed: render() emits ONE static self-contained HTML
file (inline SVG, no JS dependencies, air-gap friendly); serve() optionally
exposes it plus a JSON stats endpoint over stdlib HTTP.
"""

from __future__ import annotations

import html
import json
from typing import List, Optional, Sequence, Tuple

from deeplearning4j_tpu_torch.ui.i18n import I18N
from deeplearning4j_tpu_torch.ui.storage import StatsStorage


def _msg(key: str, lang=None) -> str:
    """Localized UI chrome string (ui/i18n.py, DefaultI18N parity)."""
    return I18N.get_instance().get_message(key, lang)


def _kv_table(d: dict, keys=None) -> str:
    """Escaped key/value <table> (the stats/system table renderer)."""
    rows = "".join(
        f"<tr><th>{html.escape(str(k))}</th><td>{html.escape(str(v))}</td></tr>"
        for k, v in d.items() if keys is None or k in keys)
    return f"<table>{rows}</table>"

_W, _H, _PAD = 640, 220, 42


def _polyline(xs: Sequence[float], ys: Sequence[float], color: str) -> str:
    if not xs:
        return ""
    x0, x1 = min(xs), max(xs)
    y0, y1 = min(ys), max(ys)
    sx = lambda x: _PAD + (x - x0) / (x1 - x0 or 1) * (_W - 2 * _PAD)
    sy = lambda y: _H - _PAD - (y - y0) / (y1 - y0 or 1) * (_H - 2 * _PAD)
    pts = " ".join(f"{sx(x):.1f},{sy(y):.1f}" for x, y in zip(xs, ys))
    axis_labels = (
        f'<text x="{_PAD}" y="{_H - 8}" class="ax">{x0:.4g}</text>'
        f'<text x="{_W - _PAD}" y="{_H - 8}" class="ax" text-anchor="end">{x1:.4g}</text>'
        f'<text x="4" y="{_H - _PAD}" class="ax">{y0:.4g}</text>'
        f'<text x="4" y="{_PAD}" class="ax">{y1:.4g}</text>'
    )
    return (
        f'<polyline fill="none" stroke="{color}" stroke-width="1.6" points="{pts}"/>'
        + axis_labels
    )


def _chart(title: str, series: List[Tuple[str, Sequence[float], Sequence[float]]]) -> str:
    colors = ["#1976d2", "#e53935", "#43a047", "#fb8c00", "#8e24aa",
              "#00897b", "#6d4c41", "#3949ab"]
    body, legend = [], []
    for i, (label, xs, ys) in enumerate(series):
        c = colors[i % len(colors)]
        body.append(_polyline(list(xs), list(ys), c))
        legend.append(f'<tspan fill="{c}">&#9632; {html.escape(label)}</tspan> ')
    return (
        f'<div class="card"><h3>{html.escape(title)}</h3>'
        f'<svg viewBox="0 0 {_W} {_H}" width="{_W}" height="{_H}">'
        f'<rect width="{_W}" height="{_H}" fill="#fafafa" stroke="#ddd"/>'
        + "".join(body)
        + f'<text x="{_PAD}" y="16" class="ax">{"".join(legend)}</text>'
        "</svg></div>"
    )


def _histogram_svg(title: str, counts: Sequence[int], lo: float, hi: float) -> str:
    if not counts:
        return ""
    w, h, pad = 300, 120, 24
    n = len(counts)
    mx = max(counts) or 1
    bars = []
    bw = (w - 2 * pad) / n
    for i, c in enumerate(counts):
        bh = (h - 2 * pad) * c / mx
        bars.append(
            f'<rect x="{pad + i * bw:.1f}" y="{h - pad - bh:.1f}" '
            f'width="{max(bw - 1, 1):.1f}" height="{bh:.1f}" fill="#1976d2"/>'
        )
    return (
        f'<div class="hist"><h4>{html.escape(title)}</h4>'
        f'<svg viewBox="0 0 {w} {h}" width="{w}" height="{h}">'
        f'<rect width="{w}" height="{h}" fill="#fafafa" stroke="#ddd"/>'
        + "".join(bars)
        + f'<text x="{pad}" y="{h - 6}" class="ax">{lo:.3g}</text>'
        f'<text x="{w - pad}" y="{h - 6}" class="ax" text-anchor="end">{hi:.3g}</text>'
        "</svg></div>"
    )


_CSS = """
body { font-family: system-ui, sans-serif; margin: 20px; color: #222; }
h1 { font-size: 20px; } h2 { font-size: 16px; margin-top: 28px; }
h3 { font-size: 13px; margin: 6px 0; } h4 { font-size: 11px; margin: 4px 0; }
.card { display: inline-block; margin: 8px; vertical-align: top; }
.hist { display: inline-block; margin: 6px; }
.ax { font-size: 9px; fill: #666; }
table { border-collapse: collapse; font-size: 12px; }
td, th { border: 1px solid #ccc; padding: 3px 8px; }
"""


def _scatter_svg(coords, labels=None, w: int = 640, h: int = 480) -> str:
    """Inline-SVG scatter of a 2-D embedding (+ optional point labels)."""
    xs, ys = coords[:, 0], coords[:, 1]
    x0, x1 = float(xs.min()), float(xs.max())
    y0, y1 = float(ys.min()), float(ys.max())
    sx = (w - 40) / ((x1 - x0) or 1.0)
    sy = (h - 40) / ((y1 - y0) or 1.0)
    pts = []
    for i in range(len(coords)):
        px = 20 + (float(xs[i]) - x0) * sx
        py = h - 20 - (float(ys[i]) - y0) * sy
        pts.append(f"<circle cx='{px:.1f}' cy='{py:.1f}' r='3' fill='#1f77b4'/>")
        if labels is not None:
            pts.append(f"<text x='{px + 4:.1f}' y='{py - 4:.1f}' "
                       f"font-size='9'>{html.escape(labels[i])}</text>")
    return (f"<svg width='{w}' height='{h}' style='border:1px solid #ccc'>"
            + "".join(pts) + "</svg>")


def _power_limit() -> str:
    """The cards' power limits as ``nvidia-smi`` reports them, or n/a."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=10)
        return ", ".join(l.strip() for l in out.stdout.splitlines() if l.strip()) or "n/a"
    except (OSError, subprocess.SubprocessError):
        return "n/a"


class UIServer:
    """``UIServer.get_instance().attach(storage)`` then ``render(path)`` or
    ``serve(port)``."""

    _instance: Optional["UIServer"] = None

    def __init__(self):
        self.storages: List[StatsStorage] = []
        self._httpd = None
        self._thread = None
        self.port: Optional[int] = None
        self._remote_storage: Optional[StatsStorage] = None
        # /tsne embedding page (reference deeplearning4j-play
        # module/tsne/TsneModule.java): named 2-D point sets + labels
        self._tsne_sets: dict = {}

    @classmethod
    def get_instance(cls) -> "UIServer":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def attach(self, storage: StatsStorage) -> "UIServer":
        if storage not in self.storages:
            self.storages.append(storage)
        return self

    def detach(self, storage: StatsStorage) -> None:
        if storage in self.storages:
            self.storages.remove(storage)

    def enable_remote_listener(self, storage: Optional[StatsStorage] = None
                               ) -> StatsStorage:
        """Accept POSTed stats records on ``/remote`` into ``storage``
        (reference play/.../RemoteReceiverModule.java behind
        UIServer.enableRemoteListener). Records come from
        `RemoteStatsStorageRouter` in the training process."""
        if storage is None:
            from deeplearning4j_tpu_torch.ui.storage import InMemoryStatsStorage

            storage = InMemoryStatsStorage()
        self._remote_storage = storage
        self.attach(storage)
        return storage

    # -- rendering ---------------------------------------------------------
    def render_html(self, refresh_seconds: int = 0,
                    lang: Optional[str] = None) -> str:
        """``refresh_seconds > 0`` makes the page LIVE: served pages carry a
        meta-refresh so the dashboard re-renders from storage while training
        runs (reference module/train/TrainModule.java live updates).
        ``lang`` localizes the chrome via ui/i18n.py (DefaultI18N parity;
        served pages take ``?lang=ja`` etc.)."""
        msg = lambda k: _msg(k, lang)
        refresh = (f"<meta http-equiv='refresh' content='{refresh_seconds}'>"
                   if refresh_seconds > 0 else "")
        parts = [f"<html><head><meta charset='utf-8'>{refresh}"
                 f"<style>{_CSS}</style>"
                 f"<title>{html.escape(msg('train.pagetitle'))}</title></head><body>"
                 f"<h1>{html.escape(msg('train.overview.title'))}</h1>"]
        for storage in self.storages:
            for sid in storage.list_session_ids():
                parts.append(self._render_session(storage, sid, lang))
        parts.append("</body></html>")
        return "".join(parts)

    def _render_session(self, storage: StatsStorage, sid: str,
                        lang: Optional[str] = None) -> str:
        msg = lambda k: _msg(k, lang)
        ups = [u for u in storage.get_all_updates(sid)
               if u.get("type_id") == "StatsReport"]
        statics = storage.get_static_info(sid)
        parts = [f"<h2>{html.escape(msg('train.session'))} {html.escape(sid)}</h2>"]
        if statics:
            parts.append(_kv_table(
                statics[0],
                keys=("model_class", "n_layers", "n_params", "backend",
                      "devices")))
        if not ups:
            return "".join(parts)
        its = [u["iteration"] for u in ups]
        parts.append(_chart(msg("train.overview.chart.score"),
                            [("score", its, [u["score"] for u in ups])]))
        tput = [(u["iteration"], u["samples_per_sec"]) for u in ups
                if u.get("samples_per_sec")]
        if tput:
            parts.append(_chart(msg("train.overview.chart.throughput"),
                                [("samples/sec", [t[0] for t in tput], [t[1] for t in tput])]))
        pnames = sorted(ups[-1].get("parameters", {}).keys())
        if pnames:
            parts.append(_chart(
                msg("train.model.chart.l2norm"),
                [(n, its, [u["parameters"].get(n, {}).get("norm2", 0.0) for u in ups])
                 for n in pnames],
            ))
            ratio_ups = [u for u in ups if u.get("update_ratios")]
            if ratio_ups:
                parts.append(_chart(
                    msg("train.model.chart.updateratio"),
                    [(n, [u["iteration"] for u in ratio_ups],
                      [u["update_ratios"].get(n, 0.0) for u in ratio_ups])
                     for n in pnames],
                ))
            parts.append(f"<h2>{html.escape(msg('train.model.histograms'))}</h2>")
            for n in pnames:
                hg = ups[-1]["parameters"][n].get("histogram")
                if hg:
                    parts.append(_histogram_svg(n, hg["counts"], hg["lo"], hg["hi"]))
        return "".join(parts)

    def render(self, path: str) -> str:
        """Write the dashboard to ``path``; returns the path."""
        with open(path, "w") as f:
            f.write(self.render_html())
        return path

    # -- t-SNE embedding page (TsneModule parity) --------------------------
    def upload_tsne(self, coords, labels=None, session_id: str = "tsne"):
        """Register a 2-D embedding for the ``/tsne`` page (the reference
        TsneModule's file-upload flow, as a programmatic surface — e.g.
        ``upload_tsne(BarnesHutTsne(...).fit_transform(X), words)``)."""
        import numpy as np

        coords = np.asarray(coords, float)
        if coords.ndim != 2 or coords.shape[1] < 2:
            raise ValueError(f"coords must be [n, 2+], got {coords.shape}")
        if labels is not None and len(labels) != len(coords):
            raise ValueError("labels length must match coords")
        self._tsne_sets[session_id] = (
            coords[:, :2],
            [str(l) for l in labels] if labels is not None else None,
        )
        return self

    def render_system_html(self, lang: Optional[str] = None) -> str:
        """/train/system (reference TrainModule's system tab): runtime and
        per-session hardware/memory facts — the CUDA cards (name, memory
        in use and total, power limit from ``nvidia-smi``) in place of the
        reference's JVM/GC telemetry, peak host RSS from the OS (ru_maxrss:
        a lifetime high-water mark, kilobytes on Linux and bytes on
        BSD/macOS)."""
        import sys as _sys

        import torch as _torch

        msg = lambda k: _msg(k, lang)
        cuda = _torch.cuda.is_available()
        devs = ([_torch.cuda.get_device_name(i) for i in range(_torch.cuda.device_count())]
                if cuda else ["cpu"])
        try:
            # POSIX-only; on other hosts the page renders with RSS as n/a
            # instead of the whole endpoint 500ing
            import resource

            maxrss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            if _sys.platform == "darwin":
                maxrss //= 1024                # bytes -> KB
            peak_rss = f"{maxrss / 1024:.1f} MB"
        except (ImportError, OSError):
            peak_rss = "n/a"
        rows = {
            "backend": "cuda" if cuda else "cpu",
            "devices": ", ".join(devs),
            "device count": len(devs),
            "process count": (_torch.distributed.get_world_size()
                              if _torch.distributed.is_available()
                              and _torch.distributed.is_initialized() else 1),
            "peak host RSS": peak_rss,
        }
        if cuda:
            for i in range(_torch.cuda.device_count()):
                free, total = _torch.cuda.mem_get_info(i)
                rows[f"cuda:{i} memory"] = (
                    f"{(total - free) / 2**30:.2f} GiB in use of {total / 2**30:.2f} GiB")
            rows["power limit"] = _power_limit()
        parts = [f"<html><head><meta charset='utf-8'><style>{_CSS}</style>"
                 f"<title>{html.escape(msg('train.pagetitle'))}</title>"
                 f"</head><body><h1>{html.escape(msg('train.system'))}</h1>"
                 + _kv_table(rows)]
        for storage in self.storages:
            for sid in storage.list_session_ids():
                statics = storage.get_static_info(sid)
                if not statics:
                    continue
                parts.append(
                    f"<h2>{html.escape(msg('train.session'))} "
                    f"{html.escape(sid)}</h2>" + _kv_table(statics[0]))
        parts.append("</body></html>")
        return "".join(parts)

    def render_tsne_html(self, lang: Optional[str] = None) -> str:
        msg = lambda k: _msg(k, lang)
        title = html.escape(msg("tsne.title"))
        parts = [f"<html><head><meta charset='utf-8'><style>{_CSS}</style>"
                 f"<title>{title}</title></head><body>"
                 f"<h1>{title}</h1>"]
        if not self._tsne_sets:
            parts.append(f"<p>{html.escape(msg('tsne.empty'))}</p>")
        for sid, (coords, labels) in sorted(self._tsne_sets.items()):
            parts.append(f"<h2>{html.escape(sid)} ({len(coords)} "
                         f"{html.escape(msg('tsne.points'))})</h2>")
            parts.append(_scatter_svg(coords, labels))
        parts.append("</body></html>")
        return "".join(parts)

    # -- serving -----------------------------------------------------------
    def serve(self, port: int = 9001, warm_models=(),
              warm_batch: int = 32) -> "UIServer":
        # the warm pass BEFORE the socket binds: a server that answers its
        # port is warm — time-to-first-request pays no first dispatch
        # (``warm_models``: models whose inference path this server fronts;
        # ``warm_batch``: largest request batch to ladder-walk up to)
        if warm_models:
            from deeplearning4j_tpu_torch.nn import aot

            for m in warm_models:
                aot.warm_serving(m, warm_batch)
        # SLO envelope, in-flight gauge, /metrics and /healthz all come
        # from the shared plumbing (serve/httpcommon.py) — the UI handler
        # only contributes its dashboard routes
        from deeplearning4j_tpu_torch.serve import httpcommon

        outer = self

        class Handler(httpcommon.ObservedHandler):
            inflight = httpcommon.InFlight()

            def handle_get(self) -> int:
                from urllib.parse import parse_qs, urlparse

                parsed = urlparse(self.path)
                route = parsed.path
                # ?lang=ja etc. (DefaultI18N setDefaultLanguage per request)
                lang = (parse_qs(parsed.query).get("lang") or [None])[0]
                if route in ("/", "/train", "/train/overview"):
                    # served pages are live: re-rendered per request + a
                    # 5s meta-refresh so the browser polls while training
                    body = outer.render_html(refresh_seconds=5,
                                             lang=lang).encode()
                    ctype = "text/html"
                elif route == "/train/system":
                    body = outer.render_system_html(lang=lang).encode()
                    ctype = "text/html"
                elif route == "/tsne":
                    body = outer.render_tsne_html(lang=lang).encode()
                    ctype = "text/html"
                elif route == "/stats":
                    body = json.dumps([
                        {"sessions": st.list_session_ids()} for st in outer.storages
                    ]).encode()
                    ctype = "application/json"
                elif route == "/debug/trace":
                    # live Chrome/Perfetto trace of the span ring + event
                    # log (load in ui.perfetto.dev / chrome://tracing)
                    from deeplearning4j_tpu_torch.obs import trace_export

                    body = trace_export.live_trace(
                        include_events=True).encode()
                    ctype = "application/json"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return 404
                return self.send_body(200, body, ctype)

            def handle_post(self) -> int:
                from urllib.parse import urlparse

                if urlparse(self.path).path == "/tsne":
                    # TsneModule upload parity: JSON {coords, labels?, name?}
                    try:
                        payload = self.read_json()
                        outer.upload_tsne(payload["coords"],
                                          payload.get("labels"),
                                          session_id=str(payload.get("name",
                                                                     "tsne")))
                    except Exception as e:
                        return self.send_body(400, str(e).encode(),
                                              "text/plain")
                    return self.send_body(200, b"ok", "text/plain")
                if urlparse(self.path).path != "/remote" \
                        or outer._remote_storage is None:
                    self.send_response(404)
                    self.end_headers()
                    return 404
                try:
                    payload = self.read_json()
                    records = payload if isinstance(payload, list) else [payload]
                    # validate the WHOLE batch before applying any record:
                    # a mid-batch failure must not store a partial batch the
                    # client will then retry in full (duplicates), and a
                    # record without session_id would poison every later
                    # dashboard read (list_session_ids keys on it)
                    if not all(isinstance(r, dict) and "session_id" in r
                               for r in records):
                        raise ValueError(
                            "records must be JSON objects with a session_id")
                    # fully parse/stage the batch BEFORE the first put_*:
                    # any VALIDATION failure leaves storage untouched (a
                    # storage fault mid-apply can still persist a prefix —
                    # put_* on validated dicts doesn't raise in the
                    # in-memory/file storages shipped here)
                    staged = [(rec.pop("_kind", "update"), rec)
                              for rec in records]
                except Exception as e:  # any bad payload -> 400, keep serving
                    return self.send_body(400, str(e).encode(), "text/plain")
                try:
                    for kind, rec in staged:
                        if kind == "static":
                            outer._remote_storage.put_static_info(rec)
                        else:
                            outer._remote_storage.put_update(rec)
                except Exception as e:  # storage fault: 500, keep serving
                    return self.send_body(500, str(e).encode(), "text/plain")
                return self.send_body(200, b"ok", "text/plain")

        self._httpd, self._thread, self.port = httpcommon.start_server(
            Handler, port)
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            if self._thread:
                self._thread.join(timeout=10)
                self._thread = None
