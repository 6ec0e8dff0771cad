"""Render the span ring as Chrome/Perfetto ``trace_event`` JSON.

The span tracer already records everything a timeline needs — start time on
the process ``perf_counter`` clock (``t0_s``), wall duration, thread id and
name, nesting attrs — and the event log carries wall-clock-stamped instants
(checkpoints, chaos faults, guard trips). This module joins the two onto
one microsecond axis and emits the `trace_event format`_ that both
``chrome://tracing`` and https://ui.perfetto.dev load directly:

- every finished span becomes a complete event (``ph: "X"``) on its
  thread's lane, so nested phase spans (``phase.fwd`` under
  ``mln.fit_batch``) render as stacked slices;
- ``compile`` spans keep their ``site``/``mode`` attrs as args (the warm
  passes of ``nn/aot.py``: a cold start's warm wall is visible);
- event-log records become instant events (``ph: "i"``) — their wall-clock
  ``ts`` is mapped onto the span timeline through the tracer's anchor, a
  (wall, perf_counter) pair sampled back to back at tracer construction;
- thread-name metadata events (``ph: "M"``) label each lane.

Debug/report-time only: nothing here may be called from per-batch code.
The documents are the JAX package's (same event names, lanes and args), so
one viewer reads either package's timeline.

Two front doors:

- ``python -m deeplearning4j_tpu_torch.obs.trace_export --out trace.json``
  renders a ``DL4J_TPU_SPAN_DUMP`` file (``--spans``) and optionally a
  ``DL4J_TPU_EVENT_LOG`` JSONL (``--events``) offline;
- ``GET /debug/trace`` on ``ui/server.py`` renders the live ring of the
  serving process.

.. _trace_event format: https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Iterable, List, Optional

__all__ = ["trace_events", "render", "live_trace", "merge", "validate",
           "main"]

_PID = 1  # single-process timeline; lanes are threads (merge() re-pids)


def trace_events(spans: Iterable[dict],
                 events: Iterable[dict] = (),
                 anchor: Optional[Dict[str, float]] = None) -> dict:
    """Build the ``{"traceEvents": [...]}`` document from span-ring records
    (``SpanTracer.recent()`` / a ``DL4J_TPU_SPAN_DUMP`` file) plus optional
    event-log records. Spans without ``t0_s`` (records from a pre-profiling
    ring) are skipped rather than guessed at."""
    out: List[dict] = []
    threads: Dict[int, str] = {}
    for rec in spans:
        t0 = rec.get("t0_s")
        if t0 is None:
            continue
        tid = int(rec.get("tid") or 0)
        threads.setdefault(tid, str(rec.get("thread") or f"thread-{tid}"))
        name = rec["span"]
        attrs = rec.get("attrs") or {}
        if name == "compile" and "site" in attrs:
            name = f"compile:{attrs['site']}"
        args = dict(attrs)
        args["cpu_ms"] = round(rec.get("cpu_s", 0.0) * 1e3, 3)
        if rec.get("parent"):
            args["parent"] = rec["parent"]
        if rec.get("error"):
            args["error"] = True
        out.append({
            "name": name,
            "cat": "span",
            "ph": "X",
            "ts": t0 * 1e6,
            "dur": max(rec.get("wall_s", 0.0), 0.0) * 1e6,
            "pid": _PID,
            "tid": tid,
            "args": args,
        })
    if events and anchor:
        # wall = anchor.wall_s + (perf - anchor.perf_s)  =>  invert for ts
        wall0, perf0 = anchor.get("wall_s"), anchor.get("perf_s")
        if wall0 is not None and perf0 is not None:
            for ev in events:
                ts = ev.get("ts")
                kind = ev.get("kind")
                if ts is None or kind is None:
                    continue
                args = {k: v for k, v in ev.items() if k not in ("ts", "kind")}
                out.append({
                    "name": str(kind),
                    "cat": "event",
                    "ph": "i",
                    "s": "p",
                    "ts": (perf0 + (float(ts) - wall0)) * 1e6,
                    "pid": _PID,
                    "tid": 0,
                    "args": args,
                })
    for tid, tname in sorted(threads.items()):
        out.append({
            "name": "thread_name",
            "ph": "M",
            "pid": _PID,
            "tid": tid,
            "args": {"name": tname},
        })
    out.sort(key=lambda e: (e["ph"] == "M", e.get("ts", 0.0)))
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def render(spans: Iterable[dict], events: Iterable[dict] = (),
           anchor: Optional[Dict[str, float]] = None) -> str:
    return json.dumps(trace_events(spans, events, anchor))


def live_trace(include_events: bool = False) -> str:
    """Render the current process's span ring (the ``/debug/trace`` body).
    Event-log instants are only available when a file sink is configured
    and ``include_events`` is set (the log is the only durable store)."""
    from deeplearning4j_tpu_torch.obs import events as events_mod
    from deeplearning4j_tpu_torch.obs import spans as spans_mod

    tr = spans_mod.tracer()
    evs: List[dict] = []
    if include_events:
        path = events_mod.event_log().path
        if path:
            evs = _read_events(path)
    return render(tr.recent(), evs, tr.anchor())


def merge(dumps: Iterable[dict],
          events_seq: Optional[List[List[dict]]] = None) -> dict:
    """Join per-process span dumps (``SpanTracer.dump`` docs) into ONE
    timeline: every process becomes its own Perfetto track (distinct
    ``pid`` + ``process_name`` metadata naming its rank/wid/host), with
    all tracks aligned on a common wall-clock axis through each dump's own
    wall↔perf anchor — cross-host alignment never assumes the hosts agree
    about *when*, only that each process sampled its anchor pair back to
    back. ``events_seq`` optionally carries each dump's event-log records
    (same order). Report-time only."""
    merged: List[dict] = []
    offsets: List[float] = []
    for i, dump in enumerate(dumps):
        anchor = dump.get("anchor") if isinstance(dump, dict) else None
        spans = dump.get("spans", []) if isinstance(dump, dict) else dump
        evs = (events_seq[i] if events_seq and i < len(events_seq) else ())
        doc = trace_events(spans, evs, anchor)
        proc = (dump.get("process") or {}) if isinstance(dump, dict) else {}
        pid = i + 1
        rank = proc.get("rank")
        label = (f"rank {rank}" if rank is not None else f"proc {pid}")
        if proc.get("wid"):
            label += f" ({proc['wid']})"
        if proc.get("host"):
            label += f" @{proc['host']}"
        # perf-axis µs -> wall-axis µs: shift by this dump's own anchor
        off = 0.0
        if isinstance(anchor, dict) and \
                anchor.get("wall_s") is not None and \
                anchor.get("perf_s") is not None:
            off = (float(anchor["wall_s"]) - float(anchor["perf_s"])) * 1e6
        for e in doc["traceEvents"]:
            e["pid"] = pid
            if "ts" in e:
                e["ts"] += off
                offsets.append(e["ts"])
        merged.extend(doc["traceEvents"])
        merged.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": label}})
    if offsets:
        # normalize so the merged timeline starts near zero (epoch-scale µs
        # values render, but pan/zoom UX is much better from the origin)
        t0 = min(offsets)
        for e in merged:
            if "ts" in e:
                e["ts"] -= t0
    merged.sort(key=lambda e: (e["ph"] == "M", e.get("ts", 0.0)))
    return {"traceEvents": merged, "displayTimeUnit": "ms"}


def validate(doc: dict) -> List[str]:
    """Schema + nesting sanity of a trace document. Returns problems (empty
    = loadable). Checks: top-level shape, required per-event fields, and
    that complete events on each (process, thread) lane are properly nested
    (a child slice must lie inside its enclosing slice — exactly what
    Perfetto requires to stack them)."""
    problems: List[str] = []
    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents is not a list"]
    lanes: Dict[tuple, List[dict]] = {}
    for i, e in enumerate(evs):
        if not isinstance(e, dict) or "ph" not in e or "name" not in e:
            problems.append(f"event {i}: missing ph/name")
            continue
        if e["ph"] == "X":
            if not isinstance(e.get("ts"), (int, float)) or \
                    not isinstance(e.get("dur"), (int, float)):
                problems.append(f"event {i} ({e['name']}): bad ts/dur")
                continue
            lanes.setdefault(
                (int(e.get("pid", 0)), int(e.get("tid", 0))), []).append(e)
        elif e["ph"] == "i" and not isinstance(e.get("ts"), (int, float)):
            problems.append(f"event {i} ({e['name']}): instant without ts")
    eps = 1e-3  # µs slack for float rounding at the boundaries
    for tid, lane in lanes.items():
        lane.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: List[dict] = []
        for e in lane:
            while stack and e["ts"] >= stack[-1]["ts"] + stack[-1]["dur"] - eps:
                stack.pop()
            if stack:
                parent = stack[-1]
                if e["ts"] + e["dur"] > parent["ts"] + parent["dur"] + eps:
                    problems.append(
                        f"lane {tid}: {e['name']} overlaps {parent['name']} "
                        "without nesting")
            stack.append(e)
    return problems


def _read_events(path: str) -> List[dict]:
    out: List[dict] = []
    try:
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue  # torn rotation line
    except OSError:
        pass
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.obs.trace_export",
        description="Render a DL4J_TPU_SPAN_DUMP file (+ optional event log) "
                    "as Chrome/Perfetto trace_event JSON.")
    ap.add_argument("--spans", required=True, nargs="+",
                    help="span dump JSON written by DL4J_TPU_SPAN_DUMP or "
                         "SpanTracer.dump(); several files merge into one "
                         "multi-process timeline (one track per dump)")
    ap.add_argument("--events", default=None, nargs="*",
                    help="optional DL4J_TPU_EVENT_LOG JSONL to overlay as "
                         "instant events (with several --spans, matched by "
                         "position)")
    ap.add_argument("--out", default="-",
                    help="output path (default stdout)")
    ap.add_argument("--validate", action="store_true",
                    help="also run schema/nesting validation; non-zero exit "
                         "on problems")
    args = ap.parse_args(argv)

    dumps = []
    for path in args.spans:
        with open(path, "r", encoding="utf-8") as f:
            dumps.append(json.load(f))
    ev_paths = args.events or []
    if len(dumps) == 1:
        dump = dumps[0]
        spans = dump.get("spans", dump if isinstance(dump, list) else [])
        anchor = dump.get("anchor") if isinstance(dump, dict) else None
        events = _read_events(ev_paths[0]) if ev_paths else []
        doc = trace_events(spans, events, anchor)
    else:
        events_seq = [_read_events(p) for p in ev_paths] or None
        doc = merge(dumps, events_seq)
    text = json.dumps(doc)
    if args.out == "-":
        sys.stdout.write(text + "\n")
    else:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(text)
    n_spans = sum(1 for e in doc["traceEvents"] if e["ph"] == "X")
    sys.stderr.write(f"trace_export: {n_spans} spans, "
                     f"{sum(1 for e in doc['traceEvents'] if e['ph'] == 'i')} "
                     f"instants -> {args.out}\n")
    if args.validate:
        problems = validate(doc)
        for p in problems:
            sys.stderr.write(f"trace_export: INVALID: {p}\n")
        return 1 if problems else 0
    return 0


if __name__ == "__main__":  # pragma: no cover - CLI shim
    raise SystemExit(main())
