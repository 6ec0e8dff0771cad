"""Fleet observability plane: trace propagation, federation, stragglers.

The obs layer (metrics/spans/events) is process-local by design; elastic
workers across processes and a multi-worker serving front door make the
system a fleet. This module is the cross-process half:

- **Trace context** — a W3C-style ``traceparent`` (``00-<32 hex
  trace_id>-<16 hex span_id>-<2 hex flags>``) minted (or adopted) at the
  HTTP front door (serve/httpcommon.py), held in a thread-local scope for
  the request's lifetime, and stamped onto every span/event recorded while
  the scope is open. The scheduler carries it across the coalescing
  boundary so a batched dispatch span lists the trace ids it served.
- **Process context** — ``set_process_context(rank=..., wid=...,
  incarnation=..., slice=...)``; elastic workers call it at every view
  adoption so spans and JSONL event lines are rank/incarnation-tagged
  (``DL4J_TPU_RANK``/``DL4J_TPU_WID``/``DL4J_TPU_SLICE`` seed it for
  processes launched with the knobs already decided).
- **Metrics federation** — :func:`publish_snapshot` writes this process's
  registry export (mergeable bucket histograms, obs/metrics.py) into the
  elastic store under ``obs/snap/<wid>`` (CRC-framed like every other key);
  :class:`FleetCollector` reads every snapshot back and renders ONE
  Prometheus exposition with ``rank``/``slice``/``incarnation`` labels plus
  fleet roll-ups (counters summed, histogram buckets merged, federated
  quantiles via :func:`metrics.quantile_from_buckets`).
- **Straggler detection** — :class:`StragglerDetector` consumes per-rank
  step walls (published by ``train/elastic.py`` at iteration boundaries
  under ``obs/stepwall/<gen>/<it>/<rank>``), maintains the
  ``dl4j_step_skew_seconds{rank}`` gauge and emits one
  ``straggler_detected`` event when a rank exceeds median ×
  ``DL4J_TPU_STRAGGLER_FACTOR`` (default 2.0) for
  ``DL4J_TPU_STRAGGLER_PATIENCE`` (default 3) consecutive boundaries.

Report-time discipline: :func:`publish_snapshot`,
:meth:`FleetCollector.collect_snapshots`, and the collector exposition do
store round-trips and whole-registry serialization — none may be reachable
from traced or per-batch dispatch code (enforced by the
``cost-analysis-off-hot-path`` lint rule). The stamping helpers
(:func:`stamp_span`/:func:`stamp_event`) are the only pieces that ride the
hot path and they are dict updates that never raise.

Host-only copy of ``deeplearning4j_tpu/obs/fleet.py`` with imports
re-pointed at this package. CLI::

    python -m deeplearning4j_tpu_torch.obs.fleet serve  --store DIR|tcp://… --port 0
    python -m deeplearning4j_tpu_torch.obs.fleet render --store DIR|tcp://…
"""

from __future__ import annotations

import argparse
import json
import os
import re
import socket
import sys
import threading
import time
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.obs import metrics

__all__ = [
    "FleetCollector",
    "OBS_PREFIX",
    "SNAP_PREFIX",
    "STEPWALL_PREFIX",
    "StragglerDetector",
    "TraceContext",
    "current_trace",
    "main",
    "process_context",
    "publish_snapshot",
    "serve_collector",
    "set_current_trace",
    "set_process_context",
    "stamp_event",
    "stamp_span",
    "stepwall_key",
    "trace_scope",
]

OBS_PREFIX = "obs/"
SNAP_PREFIX = OBS_PREFIX + "snap/"
STEPWALL_PREFIX = OBS_PREFIX + "stepwall/"

_HOST = socket.gethostname()

# ---------------------------------------------------------------------------
# Trace context (W3C traceparent)
# ---------------------------------------------------------------------------

_TRACEPARENT_RE = re.compile(
    r"^[0-9a-f]{2}-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$")


class TraceContext:
    """One hop of a distributed trace: ``trace_id`` names the request end
    to end, ``span_id`` names this process's segment of it."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    @staticmethod
    def mint() -> "TraceContext":
        return TraceContext(os.urandom(16).hex(), os.urandom(8).hex())

    @staticmethod
    def parse(header: Optional[str]) -> Optional["TraceContext"]:
        """``traceparent`` header -> context, or None when absent/invalid
        (the caller mints a fresh root instead of failing the request)."""
        if not header:
            return None
        m = _TRACEPARENT_RE.match(header.strip().lower())
        if not m:
            return None
        trace_id, span_id = m.group(1), m.group(2)
        if trace_id == "0" * 32 or span_id == "0" * 16:
            return None  # all-zero ids are invalid per the W3C spec
        return TraceContext(trace_id, span_id)

    def child(self) -> "TraceContext":
        """Same trace, fresh span id — what a server does with an inbound
        context before doing its own work."""
        return TraceContext(self.trace_id, os.urandom(8).hex())

    def header(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"TraceContext({self.header()!r})"


_TLS = threading.local()


def current_trace() -> Optional[TraceContext]:
    return getattr(_TLS, "trace", None)


def set_current_trace(ctx: Optional[TraceContext]) -> Optional[TraceContext]:
    """Install ``ctx`` as this thread's active trace; returns the previous
    one so callers can restore it (see :func:`trace_scope`)."""
    prev = getattr(_TLS, "trace", None)
    _TLS.trace = ctx
    return prev


class trace_scope:
    """``with trace_scope(ctx): ...`` — thread-local trace window; every
    span/event recorded inside carries ``ctx``'s ids."""

    def __init__(self, ctx: Optional[TraceContext]):
        self._ctx = ctx
        self._prev: Optional[TraceContext] = None

    def __enter__(self) -> Optional[TraceContext]:
        self._prev = set_current_trace(self._ctx)
        return self._ctx

    def __exit__(self, exc_type, exc, tb):
        set_current_trace(self._prev)
        return False


# ---------------------------------------------------------------------------
# Process context (rank/incarnation tagging)
# ---------------------------------------------------------------------------

_CTX_LOCK = threading.Lock()
_PROC_CTX: Dict[str, object] = {}
_CTX_ENV_CHECKED = False


def _maybe_adopt_env():
    # lazy: a worker launched with the identity already decided
    # (tools/obs_smoke.sh bench arm, ad-hoc scripts) inherits it without an
    # explicit set_process_context call. Every caller holds _CTX_LOCK (the
    # lock is not reentrant, so it cannot be re-acquired here).
    global _CTX_ENV_CHECKED
    if _CTX_ENV_CHECKED:
        return
    _CTX_ENV_CHECKED = True
    env = os.environ.get
    rank = env("DL4J_TPU_RANK")
    if rank is not None and rank.lstrip("-").isdigit():
        _PROC_CTX.setdefault("rank", int(rank))  # graftlint: disable=lock-discipline
    for key, var in (("wid", "DL4J_TPU_WID"), ("slice", "DL4J_TPU_SLICE")):
        val = env(var)
        if val:
            _PROC_CTX.setdefault(key, val)  # graftlint: disable=lock-discipline


def set_process_context(**fields):
    """Merge identity fields (``rank``, ``wid``, ``incarnation``, ``slice``)
    into the process context; a None value removes the field. Elastic
    workers call this at every view adoption — rank changes across reforms
    and span/event records carry the rank current when recorded."""
    with _CTX_LOCK:
        _maybe_adopt_env()
        for k, v in fields.items():
            if v is None:
                _PROC_CTX.pop(k, None)
            else:
                _PROC_CTX[k] = v


def process_context() -> Dict[str, object]:
    """host/pid plus whatever identity has been set — the block stamped
    into span dumps and federation snapshots."""
    with _CTX_LOCK:
        _maybe_adopt_env()
        out: Dict[str, object] = {"host": _HOST, "pid": os.getpid()}
        out.update(_PROC_CTX)
        return out


def _reset_for_tests():
    global _CTX_ENV_CHECKED
    with _CTX_LOCK:
        _PROC_CTX.clear()
        _CTX_ENV_CHECKED = False
    set_current_trace(None)


def stamp_span(rec: Dict[str, object]) -> None:
    """Tag one finished-span record in place (obs/spans.py calls this per
    pop). Hot-path: a few dict reads/writes, never raises."""
    try:
        rank = _PROC_CTX.get("rank")
        if rank is not None:
            rec["rank"] = rank
            inc = _PROC_CTX.get("incarnation")
            if inc is not None:
                rec["inc"] = inc
        ctx = getattr(_TLS, "trace", None)
        if ctx is not None:
            rec["trace_id"] = ctx.trace_id
            rec["span_id"] = ctx.span_id
    except Exception:
        pass


def stamp_event(rec: Dict[str, object]) -> None:
    """Tag one event-log record in place (obs/events.py calls this per
    emit): host/pid always, plus ``perf_s`` — the (ts, perf_s) pair on
    every line IS a wall↔perf anchor, so merged timelines never rely on
    hosts agreeing about wall-clock. Rank/incarnation/trace ride along when
    set. Hot-path: never raises."""
    try:
        rec.setdefault("host", _HOST)
        rec.setdefault("pid", os.getpid())
        rec.setdefault("perf_s", time.perf_counter())
        rank = _PROC_CTX.get("rank")
        if rank is not None:
            rec.setdefault("rank", rank)
            inc = _PROC_CTX.get("incarnation")
            if inc is not None:
                rec.setdefault("inc", inc)
        ctx = getattr(_TLS, "trace", None)
        if ctx is not None:
            rec.setdefault("trace_id", ctx.trace_id)
    except Exception:
        pass


# ---------------------------------------------------------------------------
# Metrics federation: publish + collect/merge
# ---------------------------------------------------------------------------

def publish_snapshot(store, wid: str, extra: Optional[dict] = None) -> str:
    """Serialize this process's registry into the elastic store under
    ``obs/snap/<wid>`` (last write wins — the store frames it with a CRC
    like every other key). Report-time only: serializes every family and
    does a store round-trip; never call from traced/per-batch code
    (cost-analysis-off-hot-path). Returns the key written."""
    from deeplearning4j_tpu_torch import obs
    from deeplearning4j_tpu_torch.obs import spans as spans_mod

    doc = {
        "wid": str(wid),
        "ts": time.time(),  # graftlint: disable=monotonic-clock
        "process": process_context(),
        "anchor": spans_mod.tracer().anchor(),
        "bucket_bounds": list(metrics.BUCKET_BOUNDS),
        "families": metrics.registry().export(),
        "spans": spans_mod.tracer().summary(),
        "events": obs.event_log().counts(),
    }
    if extra:
        doc.update(extra)
    key = SNAP_PREFIX + str(wid)
    store.set(key, json.dumps(doc, default=str).encode("utf-8"))
    return key


def stepwall_key(gen: int, iteration: int, rank: int) -> str:
    return f"{STEPWALL_PREFIX}{int(gen)}/{int(iteration)}/{int(rank)}"


class FleetCollector:
    """Merge every worker's published snapshot into one exposition.

    Per-worker series keep their original labels plus ``rank``/``slice``/
    ``incarnation``; roll-ups get a ``_fleet`` suffix: counters sum across
    workers, histogram bucket counts add and federated quantiles are
    re-derived from the merged ladder (quantiles-of-quantiles would be
    wrong — obs/metrics.py)."""

    def __init__(self, store):
        self.store = store

    # -- reading ------------------------------------------------------------

    def collect_snapshots(self) -> List[dict]:
        """Read every ``obs/snap/*`` key; torn/unparseable payloads are
        skipped (a publisher may die mid-run; the CRC framing already
        rejects torn writes). Sorted by wid for stable output."""
        out: List[dict] = []
        for name in self.store.list(SNAP_PREFIX):
            # list() yields names relative to the prefix directory
            raw = self.store.get(SNAP_PREFIX + name)
            if raw is None:
                continue
            try:
                doc = json.loads(raw.decode("utf-8"))
            except (ValueError, UnicodeDecodeError):
                continue
            if isinstance(doc, dict):
                out.append(doc)
        out.sort(key=lambda d: str(d.get("wid", "")))
        return out

    # -- rendering ----------------------------------------------------------

    @staticmethod
    def _worker_labels(doc: dict) -> Dict[str, str]:
        proc = doc.get("process") or {}
        out = {"rank": str(proc.get("rank", "")),
               "slice": str(proc.get("slice", "")),
               "incarnation": str(proc.get("incarnation", ""))}
        return out

    @staticmethod
    def _parse_skey(skey: str) -> Dict[str, str]:
        if not skey:
            return {}
        out: Dict[str, str] = {}
        for pair in skey.split("|"):
            k, _, v = pair.partition("=")
            out[k] = v
        return out

    def prometheus_text(self) -> str:
        """One Prometheus text exposition (0.0.4) over every snapshot.
        Report-time only — never call from traced/per-batch code."""
        snaps = self.collect_snapshots()
        lines: List[str] = [
            "# TYPE dl4j_fleet_workers gauge",
            metrics._sample("dl4j_fleet_workers", {}, len(snaps)),
        ]
        # name -> {"kind", "help", per-worker sample lines}
        fam_lines: Dict[str, List[str]] = {}
        fam_kind: Dict[str, str] = {}
        fam_help: Dict[str, str] = {}
        # roll-ups keyed (name, orig-label skey)
        counter_sums: Dict[str, Dict[str, float]] = {}
        hist_merge: Dict[str, Dict[str, dict]] = {}
        for doc in snaps:
            wlabels = self._worker_labels(doc)
            fams = doc.get("families") or {}
            for name in sorted(fams):
                fam = fams[name]
                kind = fam.get("kind", "untyped")
                fam_kind.setdefault(name, kind)
                fam_help.setdefault(name, fam.get("help", ""))
                bucket = fam_lines.setdefault(name, [])
                for skey, val in sorted((fam.get("series") or {}).items()):
                    # identity labels fill in around the series' own labels
                    # — a family that already carries e.g. a ``rank`` label
                    # (dl4j_step_skew_seconds) keeps it, publisher identity
                    # never clobbers it
                    labels = dict(wlabels)
                    labels.update(self._parse_skey(skey))
                    if kind == "histogram" and isinstance(val, dict):
                        bucket.append(metrics._sample(
                            name + "_sum", labels, val.get("sum", 0.0)))
                        bucket.append(metrics._sample(
                            name + "_count", labels, val.get("count", 0)))
                        merged = hist_merge.setdefault(name, {}).setdefault(
                            skey, {"sum": 0.0, "count": 0, "buckets": None})
                        merged["sum"] += float(val.get("sum", 0.0))
                        merged["count"] += int(val.get("count", 0))
                        counts = val.get("buckets")
                        if isinstance(counts, list):
                            if merged["buckets"] is None:
                                merged["buckets"] = [0] * len(counts)
                            if len(merged["buckets"]) == len(counts):
                                for i, c in enumerate(counts):
                                    merged["buckets"][i] += c
                    else:
                        bucket.append(metrics._sample(name, labels, val))
                        if kind == "counter":
                            sums = counter_sums.setdefault(name, {})
                            sums[skey] = sums.get(skey, 0.0) + float(val or 0)
        for name in sorted(fam_lines):
            kind = fam_kind[name]
            if fam_help.get(name):
                lines.append(
                    f"# HELP {name} {metrics._esc_help(fam_help[name])}")
            # per-worker histogram series render as untyped sum/count pairs;
            # the merged _fleet family below is the real summary
            lines.append(f"# TYPE {name} "
                         f"{'untyped' if kind == 'histogram' else kind}")
            lines.extend(fam_lines[name])
        for name in sorted(counter_sums):
            lines.append(f"# TYPE {name}_fleet counter")
            for skey, total in sorted(counter_sums[name].items()):
                lines.append(metrics._sample(
                    name + "_fleet", self._parse_skey(skey), total))
        for name in sorted(hist_merge):
            lines.append(f"# TYPE {name}_fleet summary")
            for skey, m in sorted(hist_merge[name].items()):
                labels = self._parse_skey(skey)
                counts = m["buckets"] or []
                for q in (0.5, 0.95, 0.99):
                    lines.append(metrics._sample(
                        name + "_fleet", {**labels, "quantile": str(q)},
                        metrics.quantile_from_buckets(counts, q)))
                lines.append(metrics._sample(
                    name + "_fleet_sum", labels, m["sum"]))
                lines.append(metrics._sample(
                    name + "_fleet_count", labels, m["count"]))
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Straggler detection
# ---------------------------------------------------------------------------

class StragglerDetector:
    """Flag ranks whose per-step work wall exceeds the group median ×
    ``factor`` for ``patience`` consecutive boundaries. Feed it the
    complete per-rank wall map for one iteration (train/elastic.py reads
    the previous boundary's ``obs/stepwall`` keys — all published before
    any rank can finish the next step, so no waiting is ever needed).

    Maintains ``dl4j_step_skew_seconds{rank}`` (wall minus group median)
    and emits one ``straggler_detected`` event per rank per flagging."""

    def __init__(self, factor: Optional[float] = None,
                 patience: Optional[int] = None):
        env = os.environ.get
        if factor is None:
            try:
                factor = float(env("DL4J_TPU_STRAGGLER_FACTOR", "2.0"))
            except ValueError:
                factor = 2.0
        if patience is None:
            try:
                patience = int(env("DL4J_TPU_STRAGGLER_PATIENCE", "3"))
            except ValueError:
                patience = 3
        self.factor = max(1.0, float(factor))
        self.patience = max(1, int(patience))
        self._over: Dict[int, int] = {}
        self.flagged: set = set()

    def observe(self, iteration: int, walls: Dict[int, float]) -> List[int]:
        """One boundary's per-rank walls -> ranks newly flagged. Never
        raises (telemetry must not take the step loop down)."""
        try:
            from deeplearning4j_tpu_torch import obs

            if len(walls) < 2:
                return []
            ordered = sorted(walls.values())
            # LOWER median: with 2 ranks an averaged median sits between
            # the fast and slow rank, making wall > median * factor
            # unsatisfiable for any factor >= 2 (w1 > w0 + w1); anchoring
            # on the lower middle keeps the threshold meaningful at every
            # world size
            median = ordered[(len(ordered) - 1) // 2]
            skew = obs.gauge(
                "dl4j_step_skew_seconds",
                "per-rank step work-wall minus the group median at the last "
                "observed boundary (straggler detection input)", ("rank",))
            newly: List[int] = []
            for rank, wall in sorted(walls.items()):
                skew.set(round(wall - median, 6), rank=rank)
                if median > 0 and wall > median * self.factor:
                    self._over[rank] = self._over.get(rank, 0) + 1
                else:
                    self._over[rank] = 0
                    continue
                if self._over[rank] >= self.patience \
                        and rank not in self.flagged:
                    self.flagged.add(rank)
                    newly.append(rank)
                    obs.event("straggler_detected", rank=int(rank),
                              iteration=int(iteration),
                              wall_s=round(float(wall), 6),
                              median_s=round(float(median), 6),
                              factor=self.factor, patience=self.patience)
            return newly
        except Exception:
            return []


# ---------------------------------------------------------------------------
# Collector server + CLI
# ---------------------------------------------------------------------------

def serve_collector(store, port: int = 0):
    """Mount ``/fleet/metrics`` (merged exposition) + ``/fleet/snapshots``
    (raw worker docs) over ``store`` on a daemon ThreadingHTTPServer.
    Returns ``(httpd, thread, bound_port)``. The process's own ``/metrics``
    and ``/healthz`` come along from the shared handler."""
    from urllib.parse import urlparse

    from deeplearning4j_tpu_torch.serve import httpcommon

    collector = FleetCollector(store)

    class FleetHandler(httpcommon.ObservedHandler):
        inflight = httpcommon.InFlight()

        def handle_get(self) -> int:
            path = urlparse(self.path).path
            if path == "/fleet/metrics":
                return self.send_body(
                    200, collector.prometheus_text().encode("utf-8"),
                    httpcommon.PROM_CTYPE)
            if path == "/fleet/snapshots":
                return self.send_json(
                    200, {"snapshots": collector.collect_snapshots()})
            self.send_response(404)
            self.end_headers()
            return 404

    return httpcommon.start_server(FleetHandler, port)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.obs.fleet",
        description="Fleet metrics collector over an elastic store "
                    "(FileStore dir or tcp://host:port netstore)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    srv = sub.add_parser("serve", help="HTTP collector: /fleet/metrics + "
                                       "/fleet/snapshots")
    srv.add_argument("--store", required=True)
    srv.add_argument("--port", type=int, default=0)
    rnd = sub.add_parser("render", help="print the merged exposition once")
    rnd.add_argument("--store", required=True)
    args = ap.parse_args(argv)

    from deeplearning4j_tpu_torch.parallel.netstore import open_store

    store = open_store(args.store)
    if args.cmd == "render":
        sys.stdout.write(FleetCollector(store).prometheus_text())
        return 0
    httpd, thread, bound = serve_collector(store, port=args.port)
    print(json.dumps({"port": bound}), flush=True)
    try:
        thread.join()
    except KeyboardInterrupt:  # pragma: no cover - interactive stop
        httpd.shutdown()
    return 0


if __name__ == "__main__":  # pragma: no cover - CLI shim
    raise SystemExit(main())
