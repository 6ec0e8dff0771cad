"""The port's trace export (``deeplearning4j_tpu_torch/obs/trace_export.py``)
against the JAX package's: the same span and event records render to equal
Chrome/Perfetto documents, per-process dumps merge alike, validation finds
the same problems, and the CLI renders a span dump the tracer wrote."""

import json
import os
import subprocess
import sys
import threading

import pytest

from deeplearning4j_tpu.obs import trace_export as jte
from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.obs import trace_export as te

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith("DL4J_TPU_"):
            monkeypatch.delenv(k)


def _spans(t0=10.0, tid=7):
    return [
        {"span": "mln.fit_batch", "t0_s": t0, "wall_s": 0.5, "cpu_s": 0.1,
         "tid": tid, "thread": "MainThread", "parent": None, "depth": 0},
        {"span": "phase.fwd", "t0_s": t0 + 0.1, "wall_s": 0.2, "cpu_s": 0.05,
         "tid": tid, "thread": "MainThread", "parent": "mln.fit_batch", "depth": 1},
        {"span": "compile", "t0_s": t0 + 0.6, "wall_s": 0.3, "cpu_s": 0.3, "tid": tid,
         "thread": "MainThread", "attrs": {"site": "mln.output", "mode": "warm"}},
        {"span": "serve.dispatch", "t0_s": t0 + 0.05, "wall_s": 0.1, "cpu_s": 0.01,
         "tid": 9, "thread": "worker", "error": True, "attrs": {"rows": 4}},
        {"span": "old", "wall_s": 1.0},   # no t0_s: skipped
    ]


_EVENTS = [{"ts": 1000.25, "kind": "checkpoint_saved", "path": "/x"},
           {"ts": 1000.5, "kind": "aot_bundle_saved", "entries": 5},
           {"kind": "no_ts"}]
_ANCHOR = {"wall_s": 1000.0, "perf_s": 10.0}


def test_trace_events_equal_the_jax_package():
    for ev, anchor in (((), None), (_EVENTS, _ANCHOR), (_EVENTS, None)):
        assert te.trace_events(_spans(), ev, anchor) == jte.trace_events(_spans(), ev, anchor)
        assert te.render(_spans(), ev, anchor) == jte.render(_spans(), ev, anchor)
    doc = te.trace_events(_spans(), _EVENTS, _ANCHOR)
    names = [e["name"] for e in doc["traceEvents"]]
    assert "compile:mln.output" in names and "old" not in names
    assert sum(e["ph"] == "i" for e in doc["traceEvents"]) == 2


def test_merge_equals_the_jax_package():
    dumps = [{"anchor": _ANCHOR, "spans": _spans(), "process": {"rank": 0, "host": "a"}},
             {"anchor": {"wall_s": 2000.0, "perf_s": 5.0}, "spans": _spans(t0=6.0),
              "process": {"rank": 1, "wid": "w1"}}]
    for events_seq in (None, [_EVENTS, []]):
        got = te.merge(json.loads(json.dumps(dumps)), events_seq)
        want = jte.merge(json.loads(json.dumps(dumps)), events_seq)
        assert got == want
    labels = [e["args"]["name"] for e in got["traceEvents"] if e["name"] == "process_name"]
    assert labels == ["rank 0 @a", "rank 1 (w1)"]


@pytest.mark.parametrize("doc", [
    {"traceEvents": "x"},
    {"traceEvents": [{"ph": "X"}]},
    {"traceEvents": [{"ph": "X", "name": "a", "ts": "0", "dur": 1}]},
    {"traceEvents": [{"ph": "i", "name": "a"}]},
    {"traceEvents": [{"ph": "X", "name": "a", "ts": 0.0, "dur": 10.0, "pid": 1, "tid": 1},
                     {"ph": "X", "name": "b", "ts": 5.0, "dur": 10.0, "pid": 1, "tid": 1}]},
    {"traceEvents": [{"ph": "X", "name": "a", "ts": 0.0, "dur": 10.0, "pid": 1, "tid": 1},
                     {"ph": "X", "name": "b", "ts": 2.0, "dur": 3.0, "pid": 1, "tid": 1}]},
])
def test_validate_finds_what_the_jax_package_finds(doc):
    assert te.validate(doc) == jte.validate(doc)


def test_the_span_ring_renders_a_valid_nested_timeline():
    obs.reset()
    with obs.span("outer"):
        with obs.compile_span("mln.output", mode="warm"):
            pass
        with obs.span("inner"):
            pass

    def worker():
        with obs.span("worker.span"):
            pass

    t = threading.Thread(target=worker, name="w")
    t.start()
    t.join()
    doc = json.loads(te.live_trace())
    assert te.validate(doc) == []
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert {"outer", "inner", "compile:mln.output", "worker.span"} <= names
    lanes = {e["args"]["name"] for e in doc["traceEvents"] if e["ph"] == "M"}
    assert {"w", threading.current_thread().name} <= lanes


def test_the_cli_renders_and_merges_span_dumps(tmp_path):
    obs.reset()
    with obs.span("cli.outer"):
        with obs.span("cli.inner"):
            pass
    dump = tmp_path / "spans.json"
    n = obs.save_spans(str(dump))
    assert n >= 2
    events = tmp_path / "events.jsonl"
    events.write_text("\n".join(json.dumps(e) for e in _EVENTS[:2]) + "\n\n{torn\n")
    out = tmp_path / "trace.json"
    env = dict(os.environ, PYTHONPATH=REPO)
    cmd = [sys.executable, "-m", "deeplearning4j_tpu_torch.obs.trace_export",
           "--spans", str(dump), "--events", str(events), "--out", str(out), "--validate"]
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    doc = json.loads(out.read_text())
    d = json.loads(dump.read_text())
    want = jte.trace_events(d["spans"], jte._read_events(str(events)), d["anchor"])
    assert doc == want and te.validate(doc) == []
    # two dumps: one merged multi-process timeline, as the JAX CLI makes it
    merged = tmp_path / "merged.json"
    proc = subprocess.run([sys.executable, "-m", "deeplearning4j_tpu_torch.obs.trace_export",
                           "--spans", str(dump), str(dump), "--out", str(merged)],
                          capture_output=True, text=True, cwd=REPO, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(merged.read_text()) == jte.merge([d, d])
