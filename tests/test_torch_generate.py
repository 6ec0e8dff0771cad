"""Token-level generation parity: the port's GenerateWorker, TokenAdmission,
GenerateConfig, ModelRegistry.register_generate and the streaming
``:generate`` route, on a tiny f32 TransformerLM whose weights come from
the JAX package (vocab 29, max_len 64, d_model 32, 4 heads, 2 blocks, as
tests/test_generate.py). The greedy oracle is the JAX model's full forward
over the growing sequence (argmax of its softmax), so every stream is held
against the JAX package token for token.

Timing never decides a result here: the mid-stream shed and the
backpressure case hold the engine inside a dispatch on an event and prime
the LatencyModel with ``observe(...)``. Every wait on a stream, a thread
or an HTTP reply is bounded (``WAIT_S``)."""

import http.client
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JNetwork
from deeplearning4j_tpu.serve.admission import GenerateConfig as JGenerateConfig
from deeplearning4j_tpu.serve.admission import LatencyModel as JLatencyModel
from deeplearning4j_tpu.serve.admission import TokenAdmission as JTokenAdmission
from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.interop import params_from_numpy
from deeplearning4j_tpu_torch.obs import slo
from deeplearning4j_tpu_torch.serve import (
    GenerateConfig, InferenceServer, ModelRegistry, ShedError, TokenAdmission)
from deeplearning4j_tpu_torch.serve.admission import LatencyModel
from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration, MultiLayerNetwork
from deeplearning4j_tpu_torch.utils import bucketing

VOCAB = 29
MAX_LEN = 64
TINY = dict(vocab_size=VOCAB, max_len=MAX_LEN, d_model=32, n_heads=4, n_blocks=2)
WAIT_S = 60.0


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in list(os.environ):
        if k.startswith("DL4J_TPU_"):
            monkeypatch.delenv(k)
    obs.reset()
    bucketing.telemetry().reset()
    yield
    obs.reset()


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


_PAIR = {}


def _pair():
    """(JAX network, port network) with the same f32 weights."""
    if not _PAIR:
        jconf = jzoo.TransformerLM(dtype="float32", **TINY)
        jm = JNetwork(jconf).init(seed=7)
        m = MultiLayerNetwork(MultiLayerConfiguration.from_json(jconf.to_json()),
                              device="cpu")
        params_from_numpy(m, jax.tree_util.tree_map(np.asarray, jm.params))
        _PAIR["p"] = (jm, m)
    return _PAIR["p"]


def _clone(m):
    c = MultiLayerNetwork(m.conf, device="cpu")
    c.params, c.state = m.params, m.state
    return c


def _prompt(n, seed=0):
    return np.random.RandomState(seed).randint(0, VOCAB, size=n).tolist()


def _ref_greedy(jm, prompt, n_gen):
    """Oracle: the JAX model's full forward over the growing sequence."""
    toks = list(prompt)
    out = []
    for _ in range(n_gen):
        probs = np.asarray(jm.output(np.asarray(toks, np.int32)[None, :, None]))
        nxt = int(np.argmax(probs[0, len(toks) - 1]))
        out.append(nxt)
        toks.append(nxt)
    return out


def _cfg(**kw):
    base = dict(decode_batch_max=4, kv_page_tokens=8, prefill_chunk=16,
                max_new_default=8, queue_limit=8, default_deadline_s=30.0)
    base.update(kw)
    return GenerateConfig(**base)


def _take(stream):
    return list(stream)   # each wait bounded by the stream's timeout_s


class _Gate:
    """Holds the engine inside ``program.dispatch`` from its ``at``-th call
    until ``release()``; ``entered`` is set when it is held there."""

    def __init__(self, program, at: int):
        self._inner = program.dispatch
        self._at = at
        self.calls = 0
        self.entered = threading.Event()
        self._go = threading.Event()
        program.dispatch = self

    def __call__(self, *a, **kw):
        self.calls += 1
        if self.calls == self._at:
            self.entered.set()
            assert self._go.wait(WAIT_S), "the test never released the engine"
        return self._inner(*a, **kw)

    def release(self):
        self._go.set()


def test_batched_greedy_equals_solo_and_jax():
    jm, m = _pair()
    reg = ModelRegistry(device="cpu")
    try:
        gw = reg.register_generate("lm", m, config=_cfg())
        prompts = [_prompt(n, seed=s) for s, n in enumerate((4, 11, 19, 26))]
        streams = [gw.submit(p, max_new=6, timeout_s=WAIT_S) for p in prompts]
        batched = [_take(s) for s in streams]
        assert all(s.finish_reason == "length" for s in streams)
        assert gw.stats_counters["max_occupancy"] > 1, \
            "streams never shared the decode batch"
        solo = reg.register_generate("solo", _clone(m), config=_cfg())
        for p, want in zip(prompts, batched):
            assert _take(solo.submit(p, max_new=6, timeout_s=WAIT_S)) == want
        for p, want in zip(prompts[:2], batched[:2]):
            assert want == _ref_greedy(jm, p, 6)
        assert gw.program.off_grid_dispatches == 0
        assert gw.program.shapes_seen <= gw.program.warmed
    finally:
        reg.shutdown()


def test_contiguous_worker_gives_the_paged_tokens():
    _, m = _pair()
    reg = ModelRegistry(device="cpu")
    try:
        paged = reg.register_generate("paged", m, config=_cfg())
        contig = reg.register_generate("contig", _clone(m), config=_cfg(paged=False))
        p = _prompt(13, seed=8)
        assert (_take(paged.submit(p, max_new=5, timeout_s=WAIT_S))
                == _take(contig.submit(p, max_new=5, timeout_s=WAIT_S)))
    finally:
        reg.shutdown()


def test_join_and_leave_at_token_boundaries():
    jm, m = _pair()
    reg = ModelRegistry(device="cpu")
    try:
        gw = reg.register_generate("lm", m, config=_cfg(decode_batch_max=2))
        p1, p2, p3 = _prompt(6, seed=1), _prompt(9, seed=2), _prompt(5, seed=3)
        gate = _Gate(gw.program, at=3)   # prefill s1, decode 1, then hold
        s1 = gw.submit(p1, max_new=12, timeout_s=WAIT_S)
        assert gate.entered.wait(WAIT_S)
        s2 = gw.submit(p2, max_new=3, timeout_s=WAIT_S)   # joins mid-flight
        gate.release()
        got2 = _take(s2)
        rest1 = _take(s1)
        assert len(got2) == 3 and s2.finish_reason == "length"
        assert len(rest1) == 12 and s1.finish_reason == "length"
        assert rest1 == _ref_greedy(jm, p1, 12)
        assert got2 == _ref_greedy(jm, p2, 3)
        assert gw.stats_counters["max_occupancy"] == 2
        s3 = gw.submit(p3, max_new=2, timeout_s=WAIT_S)
        assert len(_take(s3)) == 2
        assert gw.stats_counters["joins"] == 3
        assert gw.stats_counters["leaves"] == 3
    finally:
        reg.shutdown()


def test_eos_leaves_early():
    jm, m = _pair()
    reg = ModelRegistry(device="cpu")
    try:
        gw = reg.register_generate("lm", m, config=_cfg())
        p = _prompt(7, seed=4)
        ref = _ref_greedy(jm, p, 8)
        eos = ref[-1]              # occurs in the stream
        s = gw.submit(p, max_new=8, eos=eos, timeout_s=WAIT_S)
        assert _take(s) == ref[:ref.index(eos) + 1]
        assert s.finish_reason == "eos"
    finally:
        reg.shutdown()


def test_midstream_deadline_shed_repriced_per_token():
    _, m = _pair()
    reg = ModelRegistry(device="cpu")
    try:
        gw = reg.register_generate("lm", m, config=_cfg(margin_s=0.0))
        gate = _Gate(gw.program, at=2)   # hold the first decode step
        # unmeasured at arrival: admitted optimistically
        s = gw.submit(_prompt(5, seed=1), max_new=55, deadline_s=30.0,
                      timeout_s=WAIT_S)
        it = iter(s)
        first = next(it)                 # from the prefill
        assert gate.entered.wait(WAIT_S)
        for _ in range(5):               # 10 s a token: 53 more cannot make it
            gw.latency.observe("lm:decode", 1, 10.0)
        gate.release()
        got = [first] + list(it)
        assert s.finish_reason == "shed:deadline"
        assert len(got) == 2
        assert gw.stats_counters["shed_midstream"] == 1
        assert slo.slo_tracker()._shed.value(route="generate.lm", reason="deadline") == 1
    finally:
        reg.shutdown()


def test_arrival_shed_and_backpressure():
    _, m = _pair()
    reg = ModelRegistry(device="cpu")
    try:
        gw = reg.register_generate("lm", m, config=_cfg(decode_batch_max=1,
                                                        queue_limit=1))
        for _ in range(3):
            gw.latency.observe("lm:decode", 1, 0.01)
        with pytest.raises(ShedError) as ei:
            gw.submit(_prompt(4, seed=1), max_new=40, deadline_s=0.1)
        assert ei.value.reason == "deadline" and ei.value.http_status == 503
        gate = _Gate(gw.program, at=1)
        s1 = gw.submit(_prompt(4, seed=2), max_new=2, timeout_s=WAIT_S)
        assert gate.entered.wait(WAIT_S)   # s1 holds the one decode slot
        s2 = gw.submit(_prompt(4, seed=3), max_new=2, timeout_s=WAIT_S)  # queued
        with pytest.raises(ShedError) as ei:
            gw.submit(_prompt(4, seed=4), max_new=2)
        assert ei.value.reason == "backpressure" and ei.value.http_status == 429
        gate.release()
        assert len(_take(s1)) == 2 and len(_take(s2)) == 2
        with pytest.raises(ValueError, match="capacity"):
            gw.submit(_prompt(4), max_new=MAX_LEN + 1)
        with pytest.raises(ValueError, match="at least one token"):
            gw.submit([])
        with pytest.raises(ValueError, match="token ids"):
            gw.submit([1, VOCAB])
    finally:
        reg.shutdown()


def _admissions():
    jlat, lat = JLatencyModel(min_samples=2), LatencyModel(min_samples=2)
    kw = dict(min_samples=2, margin_s=0.003, prefill_chunk=16)
    return (JTokenAdmission(jlat, JGenerateConfig(**kw)),
            TokenAdmission(lat, GenerateConfig(**kw)))


def test_token_admission_decisions_equal_jax():
    jadm, adm = _admissions()
    rs = np.random.RandomState(0)

    def decisions():
        out = []
        for _ in range(60):
            pl, mx = int(rs.randint(1, 90)), int(rs.randint(0, 120))
            dl, now = float(rs.uniform(0, 2)), float(rs.uniform(0, 1))
            rows = int(rs.randint(1, 9))
            out.append((pl, mx, dl, now, rows))
        return out

    for phase in range(3):
        for pl, mx, dl, now, rows in decisions():
            assert (adm.infeasible("m", pl, max(mx, 1), dl, now)
                    == jadm.infeasible("m", pl, max(mx, 1), dl, now))
            assert (adm.should_shed("m", mx, dl, now, rows)
                    == jadm.should_shed("m", mx, dl, now, rows))
            assert adm.itl("m", rows) == jadm.itl("m", rows)
            assert adm.prefill_eta("m", pl) == jadm.prefill_eta("m", pl)
        # the same observations on both sides
        for _ in range(3):
            for site, bucket in (("m:decode", 1), ("m:decode", 4), ("m:prefill", 16),
                                 ("m:prefill", 4)):
                v = float(rs.uniform(0.001, 0.05)) * (phase + 1)
                jadm.latency.observe(site, bucket, v)
                adm.latency.observe(site, bucket, v)


def test_generate_config_from_env_equals_jax(monkeypatch):
    assert GenerateConfig.from_env() == GenerateConfig()
    for var, val in (("DL4J_TPU_KV_PAGE_TOKENS", "32"), ("DL4J_TPU_DECODE_BATCH_MAX", "16"),
                     ("DL4J_TPU_PREFILL_CHUNK", "128"), ("DL4J_TPU_GEN_MAX_NEW", "9"),
                     ("DL4J_TPU_GEN_QUEUE", "3"), ("DL4J_TPU_SERVE_MARGIN_MS", "7"),
                     ("DL4J_TPU_GEN_DEADLINE_MS", "1500"),
                     ("DL4J_TPU_SERVE_MIN_SAMPLES", "5"), ("DL4J_TPU_KV_PAGED", "0")):
        monkeypatch.setenv(var, val)
    cfg = GenerateConfig.from_env()
    assert cfg.kv_page_tokens == 32 and cfg.decode_batch_max == 16 and not cfg.paged
    assert vars(cfg) == vars(JGenerateConfig.from_env())


def test_register_generate_refuses_a_bundle_and_another_device():
    _, m = _pair()
    reg = ModelRegistry(device="cpu")
    try:
        with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
            reg.register_generate("lm", m, bundle="lm.aotbundle")
        gw = reg.register_generate("lm", m, warm=False, config=_cfg())
        row = [r for r in reg.describe() if r.get("generate")][0]
        assert row["warmed"] == 0 and row["kv_pool_bytes"] == gw.program.pool_bytes()
        assert reg.generator("lm") is gw and reg.names() == ["lm"]
    finally:
        reg.shutdown()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ModelRegistry()


# ---------------------------------------------------------------------------
# HTTP streaming + metrics
# ---------------------------------------------------------------------------


@pytest.fixture()
def served():
    jm, m = _pair()
    reg = ModelRegistry(device="cpu")
    reg.register_generate("lm", m, config=_cfg())
    srv = InferenceServer(reg).start(port=0)
    yield srv, jm
    srv.stop()


def _generate(port, payload, name="lm"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT_S)
    try:
        conn.request("POST", f"/v1/models/{name}:generate", json.dumps(payload).encode(),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.getheader("Transfer-Encoding"), resp.read().decode()
    finally:
        conn.close()


def test_streaming_round_trip(served):
    srv, jm = served
    p = _prompt(6, seed=9)
    status, chunked, body = _generate(srv.port, {"prompt": p, "max_tokens": 5})
    assert status == 200 and chunked == "chunked"
    lines = [json.loads(l) for l in body.strip().splitlines()]
    assert [l["token"] for l in lines[:-1]] == _ref_greedy(jm, p, 5)
    assert [l["i"] for l in lines[:-1]] == list(range(5))
    tail = lines[-1]
    assert tail["done"] and tail["reason"] == "length"
    assert tail["tokens"] == 5 and tail["ttft_ms"] > 0
    assert len(tail["request_id"]) == 32


def test_bad_payload_and_unknown_model(served):
    srv, _ = served
    for payload in ({"prompt": []}, {"max_tokens": 3}, {"prompt": [1, 2], "deadline_ms": -1},
                    {"prompt": [1, VOCAB + 3]}, {"prompt": [1], "max_tokens": MAX_LEN}):
        assert _generate(srv.port, payload)[0] == 400, payload
    status, _, body = _generate(srv.port, {"prompt": [1]}, name="nope")
    assert status == 404 and json.loads(body)["served"] == ["lm"]


def test_arrival_shed_over_http(served):
    srv, _ = served
    gw = srv.registry.generator("lm")
    for _ in range(3):
        gw.latency.observe("lm:decode", 1, 1.0)
    status, _, body = _generate(srv.port, {"prompt": [1, 2], "max_tokens": 20,
                                           "deadline_ms": 50})
    assert status == 503 and json.loads(body)["shed"] == "deadline"


def test_slo_metrics_populated(served, monkeypatch):
    from deeplearning4j_tpu_torch.serve import httpcommon

    # the handler's exit held back 0.3 s: a client that has read the whole
    # stream must still find its request counted
    note = httpcommon.InFlight.note

    def slow_exit(self, delta):
        if delta < 0:
            time.sleep(0.3)
        note(self, delta)

    monkeypatch.setattr(httpcommon.InFlight, "note", slow_exit)
    srv, _ = served
    _generate(srv.port, {"prompt": _prompt(5), "max_tokens": 4})
    tracker = slo.slo_tracker()
    route = "generate.lm"
    assert int(tracker._tokens.value(route=route) or 0) == 4
    assert tracker._ttft.summary(route=route)["count"] == 1
    assert tracker._itl.summary(route=route)["count"] == 3
    assert tracker._occupancy.value(model="lm") == 0   # drained
    assert tracker.burn_rate(route) is not None
    text = obs.prometheus_text()
    for fam in ("dl4j_ttft_seconds", "dl4j_itl_seconds", "dl4j_tokens_generated_total",
                "dl4j_decode_batch_occupancy",
                'dl4j_requests_total{route="generate.lm:http",status="200"}'):
        assert fam in text
    listing = json.loads(http_get(srv.port, "/v1/models"))
    assert listing["models"][0]["generate"] and listing["models"][0]["model"] == "lm"


def http_get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT_S)
    try:
        conn.request("GET", path)
        return conn.getresponse().read().decode()
    finally:
        conn.close()

