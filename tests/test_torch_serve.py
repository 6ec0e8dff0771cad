"""The port's serving tier on the CPU: registry + continuous-batching
``ModelWorker`` + HTTP ``:predict``, with the JAX package's status codes
(400/404/429/503) and exact token ids end to end."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import obs, serve
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.nn.model import MultiLayerNetwork
from deeplearning4j_tpu_torch.obs import slo
from deeplearning4j_tpu_torch.serve import ModelWorker, ServeConfig, ShedError
from deeplearning4j_tpu_torch.serve.server import decode_inputs
from deeplearning4j_tpu_torch.utils import bucketing

VOCAB, T = 300, 8


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("DL4J_TPU_SERVE_MAX_BATCH", "DL4J_TPU_SERVE_QUEUE",
                "DL4J_TPU_SERVE_MARGIN_MS", "DL4J_TPU_SERVE_WAIT_MS",
                "DL4J_TPU_SERVE_WAIT_QUANTUM_MS",
                "DL4J_TPU_SERVE_DEFAULT_DEADLINE_MS",
                "DL4J_TPU_SERVE_MIN_SAMPLES", "DL4J_TPU_SERVE_WORKERS",
                "DL4J_TPU_SLO_LATENCY_MS", "DL4J_TPU_BUCKETING",
                "DL4J_TPU_BUCKETS"):
        monkeypatch.delenv(var, raising=False)
    obs.reset()
    bucketing.telemetry().reset()
    yield
    obs.reset()
    bucketing.telemetry().reset()


def _lm(dtype="float32", seed=1):
    conf = zoo.TransformerLM(vocab_size=VOCAB, max_len=T, d_model=32, n_heads=2,
                             n_blocks=1, dtype=dtype, seed=seed)
    return MultiLayerNetwork(conf, device="cpu").init()


def _ids(n, seed=0, lo=0):
    return np.random.RandomState(seed).randint(lo, VOCAB, (n, T))


class _SlowModel:
    """A real model behind a fixed host-side delay, so the dispatcher's
    occupancy (and so queueing) is deterministic."""

    def __init__(self, model, delay_s):
        self._model = model
        self.delay_s = delay_s
        self.params = model.params
        self.device = model.device

    def output(self, x):
        time.sleep(self.delay_s)
        return self._model.output(x)

    def dummy_input(self, batch):
        return self._model.dummy_input(batch)


def _post(port, name, payload, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/{name}:predict",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    resp = urllib.request.urlopen(req, timeout=timeout)
    return resp.status, json.loads(resp.read()), dict(resp.headers)


def _reg(**cfg):
    return serve.ModelRegistry(config=ServeConfig(**cfg), device="cpu")


@pytest.fixture()
def server():
    reg = _reg(max_batch=8, workers=1, max_wait_s=0.05)
    reg.register("lm", _lm())
    srv = serve.InferenceServer(reg).start(port=0)
    yield srv
    srv.stop()


def test_decode_inputs_keeps_integral_payloads_integral():
    assert decode_inputs([[1027, 2047]]).dtype == np.int64
    assert decode_inputs([[1.5, 2]]).dtype == np.float32
    assert decode_inputs([[1.0, 2.0]]).dtype == np.float32
    # a model that takes no ids (an image model) gets integer pixels as floats
    assert decode_inputs([[0, 255]], ids=False).dtype == np.float32
    for bad in ([[1, 2], [3]], [["a"]]):
        with pytest.raises(ValueError):
            decode_inputs(bad)


def test_register_warms_every_reachable_bucket():
    reg = _reg(max_batch=8)
    try:
        reg.register("lm", _lm())
        (row,) = reg.describe()
        assert row["warm_buckets"] == [1, 2, 4, 8] and row["warmed"] == 4
        assert bucketing.telemetry().buckets_used("mln.output") == (1, 2, 4, 8)
    finally:
        reg.shutdown()


def test_registry_refuses_a_model_on_another_device():
    reg = _reg()

    class OnGpu:
        device = torch.device("cuda")
        params = ()

    try:
        with pytest.raises(ValueError, match="lives on"):
            reg.register("x", OnGpu())
    finally:
        reg.shutdown()


def test_concurrent_requests_coalesce_and_match_output():
    model = _lm()
    w = ModelWorker("lm", model, config=ServeConfig(
        max_batch=8, workers=1, max_wait_s=0.2))
    try:
        xs = [_ids(1, seed=i) for i in range(6)]
        got = {}
        barrier = threading.Barrier(len(xs))

        def call(i):
            barrier.wait(timeout=30)
            got[i] = w.submit(xs[i], deadline_s=60.0)

        threads = [threading.Thread(target=call, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert w.stats()["batches"] < 6          # requests shared dispatches
        for i, x in enumerate(xs):
            np.testing.assert_allclose(got[i], model.output(x).numpy(),
                                       rtol=1e-5, atol=1e-7)
    finally:
        w.shutdown()


def test_predict_round_trip(server):
    model = server.registry.worker("lm").model
    x = _ids(3, seed=4)
    status, body, headers = _post(server.port, "lm",
                                  {"inputs": x.tolist(), "deadline_ms": 60000})
    assert status == 200 and body["rows"] == 3
    assert "traceparent" in headers and body["request_id"]
    np.testing.assert_allclose(body["outputs"], model.output(x).numpy(),
                               rtol=1e-5, atol=1e-7)


def test_token_ids_above_256_reach_a_bf16_model_exactly():
    reg = _reg(max_batch=4, workers=1)
    model = _lm("bfloat16", seed=2)
    reg.register("lm", model, warm=False)
    srv = serve.InferenceServer(reg).start(port=0)
    try:
        x = _ids(2, seed=5, lo=257)
        x[0, :3] = [299, 257, 281]      # bf16 holds even integers here: 299 -> 300
        status, body, _ = _post(srv.port, "lm",
                                {"inputs": x.tolist(), "deadline_ms": 60000})
        assert status == 200
        want = model.output(x).float().numpy()
        np.testing.assert_array_equal(np.asarray(body["outputs"], np.float32), want)
        # what a float32 -> bf16 route would have served instead
        with pytest.raises(ValueError, match="embedding ids"):
            model.output(torch.from_numpy(x).to(torch.bfloat16))
    finally:
        srv.stop()


def test_unknown_model_404(server):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(server.port, "nope", {"inputs": _ids(1).tolist()})
    assert ei.value.code == 404
    assert "lm" in json.loads(ei.value.read())["served"]


def test_bad_payload_400(server):
    for payload in ({}, {"inputs": _ids(1).tolist(), "deadline_ms": -5},
                    {"inputs": [[1, 2], [3]]}):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(server.port, "lm", payload)
        assert ei.value.code == 400


def test_models_health_metrics_endpoints(server):
    base = f"http://127.0.0.1:{server.port}"
    listing = json.loads(urllib.request.urlopen(f"{base}/v1/models").read())
    assert [m["model"] for m in listing["models"]] == ["lm"]
    health = json.loads(urllib.request.urlopen(f"{base}/healthz").read())
    assert health == {"status": "ok"}
    _post(server.port, "lm", {"inputs": _ids(2).tolist(), "deadline_ms": 60000})
    text = urllib.request.urlopen(f"{base}/metrics").read().decode()
    assert "dl4j_serve_batches_total" in text
    assert 'dl4j_requests_total{route="serve.lm:http",status="200"}' in text


def test_request_is_in_metrics_before_its_reply_is_read(server, monkeypatch):
    # the handler's exit (in-flight gauge, span close) held back 0.3 s: a
    # client that has read its reply must still find the request counted
    from deeplearning4j_tpu_torch.serve import httpcommon

    note = httpcommon.InFlight.note

    def slow_exit(self, delta):
        if delta < 0:
            time.sleep(0.3)
        note(self, delta)

    monkeypatch.setattr(httpcommon.InFlight, "note", slow_exit)
    _post(server.port, "lm", {"inputs": _ids(1).tolist(), "deadline_ms": 60000})
    text = urllib.request.urlopen(
        f"http://127.0.0.1:{server.port}/metrics", timeout=60).read().decode()
    assert 'dl4j_requests_total{route="serve.lm:http",status="200"} 1' in text


def test_infeasible_deadline_503(server):
    w = server.registry.worker("lm")
    for _ in range(3):
        w.latency.observe("lm", w.admission._bucket(2), 10.0)
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(server.port, "lm", {"inputs": _ids(2).tolist(), "deadline_ms": 5})
    assert ei.value.code == 503
    assert json.loads(ei.value.read())["shed"] == "deadline"


def test_backpressure_429_with_retry_after():
    reg = _reg(max_batch=4, queue_limit=1, workers=1)
    reg.register("lm", _SlowModel(_lm(), 0.05), warm=False)
    srv = serve.InferenceServer(reg).start(port=0)
    try:
        codes, retry_after = [], []

        def blast():
            try:
                status, _, _ = _post(srv.port, "lm", {"inputs": _ids(4).tolist(),
                                                      "deadline_ms": 60000})
                codes.append(status)
            except urllib.error.HTTPError as e:
                codes.append(e.code)
                if e.code == 429:
                    retry_after.append(e.headers.get("Retry-After"))

        threads = [threading.Thread(target=blast) for _ in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert 429 in codes and 200 in codes
        assert retry_after and retry_after[0] is not None
        tracker = slo.slo_tracker()
        assert tracker._shed.value(route="serve.lm", reason="backpressure") > 0
    finally:
        srv.stop()


def test_shutdown_sheds_queued_requests():
    w = ModelWorker("lm", _SlowModel(_lm(), 0.2),
                    config=ServeConfig(max_batch=1, workers=1))
    errs = []

    def call():
        try:
            w.submit(_ids(1), deadline_s=60.0)
        except ShedError as e:
            errs.append(e)

    threads = [threading.Thread(target=call) for _ in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.1)
    w.shutdown()
    for t in threads:
        t.join(timeout=30)
    assert errs and all(e.http_status == 503 for e in errs)
