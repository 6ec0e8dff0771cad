"""The port's vector search (``deeplearning4j_tpu_torch/search/``, the
``SearchWorker`` and the search routes of ``serve/``) against the JAX
package's on the CPU.

Both packages build an index from the same seeded numpy corpus and
config. Tolerances: centroids, codebooks and distances are f32 within
rtol 1e-5 (``F32``); ids, postings, assignments and PQ codes are equal;
ties break lowest index first in both. Corpora are unit-scale blobs: a
distance from the ``||q||² - 2q·x + ||x||²`` expansion carries rounding of
order ``||x||² · 1e-7``, far below rtol 1e-5 of the distances compared
unless a query sits on a corpus row (then only ids are compared).
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request
import zipfile

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import obs as jobs
from deeplearning4j_tpu import serve as jserve
from deeplearning4j_tpu.search import IndexConfig as JConfig
from deeplearning4j_tpu.search import VectorIndex as JIndex

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch import serve
from deeplearning4j_tpu_torch.obs import slo
from deeplearning4j_tpu_torch.search import IndexConfig, VectorIndex
from deeplearning4j_tpu_torch.serve.admission import ServeConfig
from deeplearning4j_tpu_torch.serve.scheduler import SearchWorker
from deeplearning4j_tpu_torch.utils import bucketing

F32 = dict(rtol=1e-5, atol=1e-6)
CPU = "cpu"
# 600 rows, rows 500..599 copies of rows 0..99 (ties in every tier)
CONF = dict(dim=16, nlist=8, nprobe=2, pq_m=4, pq_ksub=16, rerank=32,
            max_k=8, batch_max=8, train_sample=600, pending_cap=8)


def _drop_knobs(mp):
    # another test module may leave tuning knobs (DL4J_TPU_BUCKETS,
    # DL4J_TPU_IVF_NPROBE, ...) in os.environ; both packages read them
    for k in list(os.environ):
        if k.startswith("DL4J_TPU_"):
            mp.delenv(k)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    _drop_knobs(monkeypatch)
    obs.reset()
    bucketing.telemetry().reset()
    yield
    obs.reset()
    bucketing.telemetry().reset()


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _blobs(n, dim, n_clusters=8, seed=0, spread=0.3):
    rs = np.random.RandomState(seed)
    centers = rs.randn(n_clusters, dim).astype(np.float32)
    pts = centers[rs.randint(0, n_clusters, n)]
    return (pts + spread * rs.randn(n, dim)).astype(np.float32)


def _corpus():
    c = _blobs(600, 16, seed=1)
    c[500:] = c[:100]
    return c


@pytest.fixture(scope="module")
def pair():
    """The JAX index and the port's, built from the same corpus."""
    with pytest.MonkeyPatch.context() as mp:
        _drop_knobs(mp)
        corpus = _corpus()
        j = JIndex.build(corpus, JConfig(**CONF))
        t = VectorIndex.build(corpus, IndexConfig(**CONF), device=CPU)
    return corpus, j, t


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# build: the same layout
# ---------------------------------------------------------------------------


def test_build_layout_matches_jax(pair):
    _, j, t = pair
    np.testing.assert_allclose(_np(t._centroids), np.asarray(j._centroids), **F32)
    np.testing.assert_array_equal(t._assign, j._assign)
    np.testing.assert_array_equal(_np(t._postings), np.asarray(j._postings))
    np.testing.assert_array_equal(_np(t._sizes), np.asarray(j._sizes))
    np.testing.assert_allclose(_np(t._codebooks), np.asarray(j._codebooks), **F32)
    np.testing.assert_array_equal(_np(t._codes), np.asarray(j._codes))
    np.testing.assert_array_equal(_np(t._cnorms), np.asarray(j._cnorms))
    assert t.config == IndexConfig(**{k: getattr(j.config, k)
                                      for k in j.config.__dataclass_fields__})
    assert t.stats == j.stats
    assert t.available_tiers() == j.available_tiers() == ("exact", "ivf", "ivf_pq")
    assert (t.k_choices, t.nprobe_choices) == (j.k_choices, j.nprobe_choices)
    assert t.program.signature_grid() == j.program.signature_grid()


# ---------------------------------------------------------------------------
# search: every tier, ties, full probe, cosine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tier", ["exact", "ivf", "ivf_pq"])
def test_search_matches_jax(pair, tier):
    _, j, t = pair
    q = _blobs(8, 16, seed=2)
    wi, wd = j.search(q, k=5, tier=tier)
    gi, gd = t.search(q, k=5, tier=tier)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gd, wd, **F32)
    assert gi.dtype == wi.dtype and gd.dtype == wd.dtype


@pytest.mark.parametrize("tier", ["exact", "ivf", "ivf_pq"])
def test_ties_break_lowest_index_first(pair, tier):
    """Queries on rows 0..7, each stored twice (i and i + 500): both
    copies come first, i before i + 500, as in JAX."""
    corpus, j, t = pair
    q = corpus[:8]
    gi, _ = t.search(q, k=5, tier=tier)
    wi, _ = j.search(q, k=5, tier=tier)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gi[:, :2], np.stack([np.arange(8), np.arange(8) + 500], 1))


def test_full_probe_ivf_equals_exact():
    """nprobe = nlist scans every list: IVF's ids equal the exact tier's
    (the posting lists partition the corpus), ties included."""
    t = VectorIndex.build(_corpus(), IndexConfig(**dict(CONF, nprobe=8)), device=CPU)
    q = np.concatenate([_blobs(6, 16, seed=3), _corpus()[:2]])
    e_ids, e_d = t.search(q, k=8, tier="exact")
    i_ids, i_d = t.search(q, k=8, tier="ivf")
    np.testing.assert_array_equal(i_ids, e_ids)
    np.testing.assert_allclose(i_d[:6], e_d[:6], **F32)


def test_cosine_exact_matches_jax():
    rs = np.random.RandomState(4)
    corpus = rs.randn(200, 10).astype(np.float32)
    cfg = dict(dim=10, metric="cosine", ivf=False, pending_cap=0, max_k=4, batch_max=4)
    j = JIndex.build(corpus, JConfig(**cfg))
    t = VectorIndex.build(corpus, IndexConfig(**cfg), device=CPU)
    q = rs.randn(4, 10).astype(np.float32)
    wi, wd = j.search(q, k=4)
    gi, gd = t.search(q, k=4)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gd, wd, **F32)


def test_validation_errors(pair):
    _, _, t = pair
    for bad in (dict(queries=np.zeros((1, 5), np.float32), k=2),
                dict(queries=np.zeros((1, 16), np.float32), k=99),
                dict(queries=np.zeros((1, 16), np.float32), k=2, tier="bogus")):
        with pytest.raises(ValueError):
            t.search(**bad)
    exact_only = VectorIndex.build(np.eye(6, dtype=np.float32), IndexConfig(
        dim=6, ivf=False, pending_cap=0, max_k=4, batch_max=4), device=CPU)
    with pytest.raises(ValueError):
        exact_only.search(np.zeros((1, 6), np.float32), k=2, tier="ivf")
    with pytest.raises(ValueError):
        exact_only.add(np.ones((1, 6), np.float32))


def test_metrics_match_jax(pair):
    """dl4j_search_candidates_scanned and dl4j_search_requests_total read
    the same in both packages for the same searches."""
    corpus, j, t = pair
    jobs.reset()
    obs.reset()
    for ix in (j, t):
        ix.search(corpus[:2] + 0.5, k=4, tier="ivf")
        ix.search(corpus[:2] + 0.5, k=4, tier="exact")
    want = jobs.snapshot()["metrics"]
    got = obs.snapshot()["metrics"]
    for name in ("dl4j_search_candidates_scanned", "dl4j_search_requests_total"):
        assert got[name] == want[name], name
    assert got["dl4j_search_candidates_scanned"]["index=default|tier=exact"]["max"] == 600.0


def test_entry_points_need_a_device_or_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VectorIndex.build(np.eye(4, dtype=np.float32), IndexConfig(dim=4, ivf=False))
    VectorIndex.build(np.eye(4, dtype=np.float32), IndexConfig(
        dim=4, ivf=False, pending_cap=0), device=CPU).save(tmp_path / "e.zip")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VectorIndex.load(tmp_path / "e.zip")


# ---------------------------------------------------------------------------
# incremental adds
# ---------------------------------------------------------------------------


def test_add_and_merge_match_jax():
    """A far row is visible to every tier before and after merge_pending,
    with the same ids and distances as JAX; the merged layout (postings,
    codes) equals JAX's."""
    corpus = _corpus()
    j = JIndex.build(corpus, JConfig(**CONF))
    t = VectorIndex.build(corpus, IndexConfig(**CONF), device=CPU)
    far = np.full((2, 16), 3.0, np.float32)
    far[1] += 0.5
    assert list(t.add(far)) == list(j.add(far)) == [600, 601]
    q = far + 0.25
    for stage in ("pending", "merged"):
        for tier in t.available_tiers():
            wi, wd = j.search(q, k=3, tier=tier)
            gi, gd = t.search(q, k=3, tier=tier)
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_allclose(gd, wd, **F32)
            assert gi[0, 0] == 600 and gi[1, 0] == 601, (stage, tier)
        if stage == "pending":
            assert t.merge_pending() == j.merge_pending() == 2
            assert t.n == 602 and t._pending_n == 0
    np.testing.assert_array_equal(_np(t._postings), np.asarray(j._postings))
    np.testing.assert_array_equal(_np(t._codes), np.asarray(j._codes))


def test_add_overflow_forces_merge():
    corpus = _blobs(200, 8, seed=5)
    cfg = dict(dim=8, ivf=False, max_k=4, batch_max=4, pending_cap=4)
    j = JIndex.build(corpus, JConfig(**cfg))
    t = VectorIndex.build(corpus, IndexConfig(**cfg), device=CPU)
    new = (np.random.RandomState(6).randn(11, 8) * 0.1 + 30.0).astype(np.float32)
    assert list(t.add(new)) == list(j.add(new)) == list(range(200, 211))
    assert (t.n, t._pending_n) == (j.n, j._pending_n)
    assert t._pending_n < 11
    got, _ = t.search(new[5:6], k=1)
    assert got[0, 0] == 205


# ---------------------------------------------------------------------------
# the index zip, read across the packages
# ---------------------------------------------------------------------------


def _members(path):
    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


def test_zip_read_across_packages(pair, tmp_path):
    """JAX's zip loads into the port with the same answers, and the port
    writes it back equal: the manifest as JSON, every array byte for byte.
    The port's own zip loads into JAX with the port's answers."""
    _, j, t = pair
    q = _blobs(8, 16, seed=7)
    jz = str(tmp_path / "jax.zip")
    j.save(jz)
    t2 = VectorIndex.load(jz, device=CPU)
    tz = str(tmp_path / "port.zip")
    t2.save(tz)
    a, b = _members(jz), _members(tz)
    assert sorted(a) == sorted(b)
    assert json.loads(a["manifest.json"]) == json.loads(b["manifest.json"])
    for name in a:
        if name != "manifest.json":
            assert a[name] == b[name], name
    for tier in t2.available_tiers():
        np.testing.assert_array_equal(t2.search(q, k=5, tier=tier)[0],
                                      j.search(q, k=5, tier=tier)[0])
    own = str(tmp_path / "own.zip")
    t.save(own)
    j2 = JIndex.load(own)
    np.testing.assert_allclose(np.asarray(j2._centroids), _np(t._centroids), rtol=0, atol=0)
    for tier in t.available_tiers():
        gi, gd = t.search(q, k=5, tier=tier)
        wi, wd = j2.search(q, k=5, tier=tier)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gd, wd, **F32)


def test_corrupt_zip_rejected(tmp_path):
    ix = VectorIndex.build(np.eye(8, dtype=np.float32), IndexConfig(
        dim=8, ivf=False, max_k=2, batch_max=2, pending_cap=0), device=CPU)
    p = str(tmp_path / "ix.zip")
    ix.save(p)
    with zipfile.ZipFile(p) as zf:
        members = {n: zf.read(n) for n in zf.namelist()}
    v = bytearray(members["vectors.npy"])
    v[-1] ^= 0xFF
    members["vectors.npy"] = bytes(v)
    with zipfile.ZipFile(p, "w") as zf:
        for n, b in members.items():
            zf.writestr(n, b)
    with pytest.raises(ValueError, match="CRC"):
        VectorIndex.load(p, device=CPU)


# ---------------------------------------------------------------------------
# SearchWorker: coalesced equals solo
# ---------------------------------------------------------------------------


def test_coalesced_matches_individual_bit_exact(monkeypatch):
    """One-row submits and a coalesced 4-row batch pad to the SAME bucket
    (ladder 4, 8): bitwise-identical results (the JAX test's recipe)."""
    monkeypatch.setenv("DL4J_TPU_BUCKETS", "4,8")
    corpus = _blobs(500, 12, seed=11)
    ix = VectorIndex.build(corpus, IndexConfig(
        dim=12, nlist=8, max_k=4, batch_max=4, train_sample=500), device=CPU)
    q = _blobs(4, 12, seed=12)
    solo = [ix.search(q[i:i + 1], k=4) for i in range(4)]
    batch_ids, batch_d = ix.search(q, k=4)
    for i, (ids, dist) in enumerate(solo):
        assert np.array_equal(ids[0], batch_ids[i])
        assert np.array_equal(dist[0], batch_d[i])
    w = SearchWorker("coal", ix, config=ServeConfig(max_batch=4, queue_limit=32,
                                                    max_wait_s=0.5))
    try:
        results = [None] * 4
        barrier = threading.Barrier(4)

        def one(i):
            barrier.wait()
            results[i] = w.submit(q[i:i + 1], k=4, deadline_s=30.0)

        threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive()
        for i, (ids, dist, tier) in enumerate(results):
            assert tier == "ivf"
            assert np.array_equal(ids[0], batch_ids[i])
            assert np.array_equal(dist[0], batch_d[i])
    finally:
        w.shutdown()


# ---------------------------------------------------------------------------
# HTTP: /v1/search, /knn, /knnnew, /status
# ---------------------------------------------------------------------------


def _post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def _status_of(port, path, payload):
    try:
        return _post(port, path, payload)[0]
    except urllib.error.HTTPError as e:
        return e.code


@pytest.fixture(scope="module")
def servers(pair, tmp_path_factory):
    """The JAX server over the JAX index and the port's over that index's
    zip (the same layout), both as "vecs"."""
    _, j, _ = pair
    z = str(tmp_path_factory.mktemp("ix") / "ix.zip")
    j.save(z)
    t = VectorIndex.load(z, device=CPU)
    jreg = jserve.ModelRegistry()
    jreg.register_index("vecs", j, warm=False)
    treg = serve.ModelRegistry(device=CPU)
    treg.register_index("vecs", t)
    js = jserve.InferenceServer(jreg).start(port=0)
    ts = serve.InferenceServer(treg).start(port=0)
    yield js, ts
    ts.stop()
    js.stop()


def _same_hits(got, want):
    """Equal indices; distances within ``F32`` but for a stored copy of the
    query (0 in one package, the square root of the expansion's rounding,
    ~1e-3, in the other)."""
    assert [r["index"] for r in got] == [r["index"] for r in want]
    far = [i for i, r in enumerate(want) if r["distance"] > 0.1]
    np.testing.assert_allclose([got[i]["distance"] for i in far],
                               [want[i]["distance"] for i in far], **F32)


def test_http_routes_answer_like_jax(pair, servers):
    corpus = pair[0]
    js, ts = servers
    q = (_blobs(3, 16, seed=8)).tolist()
    for payload in ({"index": "vecs", "queries": q, "k": 3},
                    {"index": "vecs", "queries": q, "k": 5, "tier": "exact"},
                    {"queries": q, "k": 2, "tier": "ivf", "nprobe": 3}):
        _, got = _post(ts.port, "/v1/search", payload)
        _, want = _post(js.port, "/v1/search", payload)
        assert got.pop("request_id") and want.pop("request_id")
        assert got["ids"] == want["ids"]
        np.testing.assert_allclose(got.pop("distances"), want.pop("distances"), **F32)
        assert got == want
    for path, payload in (("/knn", {"ndarray": 7, "k": 4}),
                          ("/knnnew", {"ndarray": (corpus[9] + 0.5).tolist(), "k": 2})):
        _, got = _post(ts.port, path, payload)
        _, want = _post(js.port, path, payload)
        _same_hits(got["results"], want["results"])
    _, got = _post(ts.port, "/knn", {"ndarray": 3, "k": 4})
    assert 3 not in [r["index"] for r in got["results"]]
    assert got["results"][0]["index"] == 503             # its stored copy
    status = {}
    for name, port in (("port", ts.port), ("jax", js.port)):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/status") as r:
            status[name] = json.loads(r.read())
    assert status["port"] == status["jax"] == {"ok": True, "points": 600, "dim": 16}


def test_http_errors_like_jax(servers):
    js, ts = servers
    cases = [("/v1/search", {"index": "vecs", "queries": [[1.0] * 5], "k": 2}),
             ("/v1/search", {"index": "vecs", "queries": [[1.0] * 16], "k": 99}),
             ("/v1/search", {"index": "vecs", "queries": [[1.0] * 16], "k": 2,
                             "tier": "bogus"}),
             ("/v1/search", {"index": "vecs", "queries": "nope", "k": 2}),
             ("/v1/search", {"index": "vecs", "queries": [[1.0] * 16] * 9, "k": 2}),
             ("/v1/search", {"index": "vecs", "queries": [[1.0] * 16], "k": 2,
                             "deadline_ms": 0}),
             ("/v1/search", {"index": "nope", "queries": [[0.0] * 16], "k": 1}),
             ("/knn", {"ndarray": 10_000, "k": 2}),
             ("/knn", {"ndarray": 1, "k": 0})]
    for path, payload in cases:
        got = _status_of(ts.port, path, payload)
        assert got == _status_of(js.port, path, payload), payload
        assert got in (400, 404), payload


def test_infeasible_deadline_503(pair, servers):
    """(Last of the tests on ``servers``: it leaves a 10 s estimate.)"""
    _, ts = servers
    w = ts.registry.searcher("vecs")
    lkey = "vecs:" + w.index.default_tier
    b = w.admission._bucket(1)
    for _ in range(3):
        w.latency.observe(lkey, b, 10.0)
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(ts.port, "/v1/search", {"index": "vecs",
                                      "queries": [pair[0][0].tolist()],
                                      "k": 2, "deadline_ms": 5})
    assert ei.value.code == 503
    assert json.loads(ei.value.read())["shed"] == "deadline"


def test_backpressure_429_and_search_slo_route():
    corpus = _blobs(200, 8, seed=20)
    ix = VectorIndex.build(corpus, IndexConfig(
        dim=8, ivf=False, max_k=4, batch_max=4, pending_cap=0), device=CPU)
    real = ix.search

    def slow(*a, **kw):
        time.sleep(0.05)
        return real(*a, **kw)

    ix.search = slow
    reg = serve.ModelRegistry(
        config=ServeConfig(max_batch=4, queue_limit=1, workers=1), device=CPU)
    reg.register_index("vecs", ix, warm=False)
    srv = serve.InferenceServer(reg).start(port=0)
    try:
        codes, retry_after = [], []

        def blast():
            try:
                codes.append(_post(srv.port, "/v1/search", {
                    "index": "vecs", "queries": corpus[:4].tolist(), "k": 2,
                    "deadline_ms": 30000})[0])
            except urllib.error.HTTPError as e:
                codes.append(e.code)
                if e.code == 429:
                    retry_after.append(e.headers.get("Retry-After"))

        threads = [threading.Thread(target=blast) for _ in range(12)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert 429 in codes and 200 in codes
        assert retry_after and retry_after[0] is not None
        tracker = slo.slo_tracker()
        assert tracker._count.value(route="search:http", status="429") > 0
        assert tracker._shed.value(route="search.vecs", reason="backpressure") > 0
    finally:
        srv.stop()


def test_per_route_slo_threshold(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_SLO_ROUTE_LATENCY_MS", "search:http=50,generate=2000")
    t = slo.SloTracker()
    assert t.threshold_for("search:http") == pytest.approx(0.05)
    t.observe("search:http", 0.06)
    assert t.burn_rate("search:http") > 0
    t.observe("serve.toy:http", 0.06)
    assert t.burn_rate("serve.toy:http") == 0


def test_registry_refuses_bundle_and_other_device(pair, tmp_path):
    _, _, t = pair
    # bundle= is taken (nn/aot.py): gated off on the CPU, nothing written
    other = serve.ModelRegistry(device=CPU)
    try:
        other.register_index("vecs", t, warm=False, bundle=str(tmp_path / "ix.aotbundle"))
        assert other.searcher("vecs") is not None
        assert not (tmp_path / "ix.aotbundle").exists()
    finally:
        other.shutdown()
    reg = serve.ModelRegistry(device=CPU)

    class _OnCard:
        device = torch.device("cuda")

    with pytest.raises(ValueError, match="lives on"):
        reg.register_index("vecs", _OnCard())
    assert reg.searcher(None) is None
    w = reg.register_index("vecs", t, warm=False)
    try:
        assert reg.searcher(None) is w and reg.searcher("vecs") is w
        assert reg.names() == ["vecs"]
        row = reg.describe()[0]
        assert row["search"] is True and row["model"] == "vecs"
        assert row["points"] == 600
    finally:
        reg.shutdown()
