"""The port's clustering library (``deeplearning4j_tpu_torch/clustering/``)
against the JAX package's on the CPU.

The same numpy inputs (seeded) go through both packages. Tolerances: ids,
assignments, hashes and masks are equal; distances, centres and
embeddings are f32 within rtol 1e-5 (``F32``) unless a test says
otherwise. Ties are broken lowest index first in both (``lax.top_k``'s
rule, ``knn.topk_stable`` in the port).
"""

import json
import os
import urllib.request
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.clustering import kmeans as JK
from deeplearning4j_tpu.clustering import knn as JN
from deeplearning4j_tpu.clustering import lsh as JL
from deeplearning4j_tpu.clustering import sptree as JS
from deeplearning4j_tpu.clustering import trees as JT
from deeplearning4j_tpu.clustering import tsne as JTS
from deeplearning4j_tpu.clustering.server import NearestNeighborsServer as JServer

from deeplearning4j_tpu_torch.clustering import kmeans as TK
from deeplearning4j_tpu_torch.clustering import knn as TN
from deeplearning4j_tpu_torch.clustering import lsh as TL
from deeplearning4j_tpu_torch.clustering import sptree as TS
from deeplearning4j_tpu_torch.clustering import trees as TT
from deeplearning4j_tpu_torch.clustering import tsne as TTS
from deeplearning4j_tpu_torch.clustering.__main__ import build_parser
from deeplearning4j_tpu_torch.clustering.server import NearestNeighborsServer as TServer

F32 = dict(rtol=1e-5, atol=1e-6)
CPU = "cpu"


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    # another test module may leave tuning knobs (DL4J_TPU_BUCKETS, ...)
    # in os.environ; both packages' bucketed paths read them
    for k in list(os.environ):
        if k.startswith("DL4J_TPU_"):
            monkeypatch.delenv(k)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _blobs(n, dim, n_clusters=6, seed=0, spread=0.3):
    # unit-scale centres: a distance from the ||x||² - 2x·y + ||y||²
    # expansion carries rounding of order ||x||² · 1e-7, which must stay
    # far below rtol 1e-5 of the distances compared
    rs = np.random.RandomState(seed)
    centers = rs.randn(n_clusters, dim).astype(np.float32)
    pts = centers[rs.randint(0, n_clusters, n)]
    return (pts + spread * rs.randn(n, dim)).astype(np.float32)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# knn: distances, the tie rule, chunked search
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", TN._METRICS)
def test_pairwise_distance_matches_jax(metric):
    rs = np.random.RandomState(1)
    x = rs.randn(7, 12).astype(np.float32)
    y = rs.randn(40, 12).astype(np.float32)
    want = np.asarray(JN.pairwise_distance(x, y, metric))
    got = _np(TN.pairwise_distance(x, y, metric, device=CPU))
    np.testing.assert_allclose(got, want, **F32)


def test_pairwise_distance_rejects_unknown_metric():
    with pytest.raises(ValueError, match="unknown metric"):
        TN.pairwise_distance(np.zeros((1, 2)), np.zeros((1, 2)), "cosine", device=CPU)


def test_topk_stable_breaks_ties_like_lax_top_k():
    """Integer-valued scores with many ties, -0.0 / +0.0 and -inf: the
    port's order equals lax.top_k's exactly (value desc, index asc)."""
    rs = np.random.RandomState(2)
    s = rs.randint(-3, 4, size=(6, 50)).astype(np.float32)
    s[0, :10] = -0.0
    s[1, 5:20] = -np.inf
    for k in (1, 7, 50):
        wv, wi = jax.lax.top_k(jnp.asarray(s), k)
        gv, gi = TN.topk_stable(torch.as_tensor(s), k)
        np.testing.assert_array_equal(_np(gi), np.asarray(wi))
        np.testing.assert_array_equal(_np(gv), np.asarray(wv))


@pytest.mark.parametrize("chunk", [None, 40])
@pytest.mark.parametrize("metric", ["sqeuclidean", "cosinesimilarity", "manhattan"])
def test_knn_search_matches_jax_with_duplicate_rows(metric, chunk):
    """A corpus with every row three times and queries equal to corpus
    rows: ids equal JAX's (the tied copies in index order), chunked or
    not. Chunks of 40 hold one copy each, so the copies' distances come
    from products of one shape and tie exactly; a chunk's hits merge after
    the earlier chunks', as in JAX. A self match's squared distance is the
    expansion's rounding (~1e-7 of ||x||², 0 in one package, 4e-6 in the
    other), so squared distances are held within 1e-5 of the largest
    squared norm, the rest within ``F32``."""
    rs = np.random.RandomState(3)
    base = rs.randn(40, 8).astype(np.float32)
    corpus = np.concatenate([base, base, base])       # rows i, i+40, i+80 tie
    q = np.concatenate([base[:5], rs.randn(3, 8).astype(np.float32)])
    wi, wd = JN.knn_search(corpus, q, 7, metric=metric, chunk_size=chunk)
    gi, gd = TN.knn_search(corpus, q, 7, metric=metric, chunk_size=chunk, device=CPU)
    np.testing.assert_array_equal(gi, wi)
    if metric == "sqeuclidean":
        np.testing.assert_allclose(gd, wd, rtol=0,
                                   atol=1e-5 * (corpus * corpus).sum(1).max())
    else:
        np.testing.assert_allclose(gd, wd, **F32)
    # the first query's three copies come first, lowest index first
    assert list(gi[0, :3]) == [0, 40, 80]


def test_knn_search_chunked_equals_unchunked():
    corpus = _blobs(300, 16, seed=4)
    q = _blobs(9, 16, seed=5)
    a = TN.knn_search(corpus, q, 10, device=CPU)
    b = TN.knn_search(corpus, q, 10, chunk_size=64, device=CPU)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_entry_points_need_a_device_or_cpu(monkeypatch):
    """device=None means the GPU: with none present every entry point
    raises, never falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = _blobs(20, 4)
    for make in (lambda: TN.knn_search(pts, pts[:1], 2),
                 lambda: TK.KMeansClustering(2),
                 lambda: TL.RandomProjectionLSH(4, 2, 4),
                 lambda: TT.VPTree(pts),
                 lambda: TT.KDTree(4),
                 lambda: TTS.Tsne(),
                 lambda: TTS.BarnesHutTsne(method="barnes_hut"),
                 lambda: TServer(pts)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()


# ---------------------------------------------------------------------------
# k-means
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("init", ["kmeanspp", "random"])
def test_kmeans_matches_jax(init):
    pts = _blobs(250, 8, n_clusters=5, seed=6)       # 250 pads to 256
    want = JK.KMeansClustering(5, 20, seed=7, init=init).apply_to(pts)
    got = TK.KMeansClustering(5, 20, seed=7, init=init, device=CPU).apply_to(pts)
    np.testing.assert_array_equal(got.assignments, want.assignments)
    np.testing.assert_allclose(got.centers, want.centers, **F32)
    np.testing.assert_allclose(got.distances, want.distances, **F32)
    assert [c.count for c in got.clusters] == [c.count for c in want.clusters]
    assert got.nearest_cluster(pts[3]) == want.nearest_cluster(pts[3])


def test_assign_points_bucket_padded_matches_jax():
    """Chunks of 100 rows pad to 128 (the last, 50, to 64): assignments and
    distances equal JAX's and the unpadded product's."""
    pts = _blobs(250, 8, n_clusters=5, seed=8)
    centers = _blobs(5, 8, n_clusters=5, seed=9)
    wa, wd = JK.assign_points(pts, centers, chunk_rows=100)
    ga, gd = TK.assign_points(pts, centers, chunk_rows=100, device=CPU)
    np.testing.assert_array_equal(ga, wa)
    assert ga.dtype == np.int32
    np.testing.assert_allclose(gd, wd, **F32)
    d = _np(TN.pairwise_distance(pts, centers, device=CPU))
    np.testing.assert_array_equal(ga, d.argmin(1))


def test_lloyd_step_masks_bucket_padding():
    pts = torch.as_tensor(_blobs(50, 4, n_clusters=3, seed=10))
    centers = pts[:3].clone()
    padded = torch.cat([pts, torch.zeros(14, 4)])
    a = TK._lloyd_step(pts, centers, 50, "euclidean")
    b = TK._lloyd_step(padded, centers, 50, "euclidean")
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
    torch.testing.assert_close(a[1], b[1][:50], rtol=0, atol=0)


def test_kmeans_rejects_similarity_metric():
    with pytest.raises(ValueError):
        TK.KMeansClustering(3, distance_function="dot", device=CPU)


# ---------------------------------------------------------------------------
# LSH
# ---------------------------------------------------------------------------


def test_lsh_hash_bucket_and_search_match_jax():
    pts = _blobs(200, 16, n_clusters=8, seed=11)
    j = JL.RandomProjectionLSH(6, 4, 16, radius=0.1, seed=3)
    t = TL.RandomProjectionLSH(6, 4, 16, radius=0.1, seed=3, device=CPU)
    np.testing.assert_array_equal(_np(t.projection), np.asarray(j.projection))
    np.testing.assert_array_equal(t.hash(pts), j.hash(pts))
    j.make_index(pts)
    t.make_index(pts)
    for i in (0, 17, 101):
        np.testing.assert_array_equal(t.bucket(pts[i]), j.bucket(pts[i]))
        np.testing.assert_array_equal(t.search(pts[i], k=5), j.search(pts[i], k=5))
        np.testing.assert_array_equal(t.search(pts[i], max_range=0.05),
                                      j.search(pts[i], max_range=0.05))
    # the perturbation draws stayed in step
    assert t._rs.randint(1 << 30) == j._rs.randint(1 << 30)


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------


def test_vptree_and_kdtree_match_jax():
    pts = np.random.RandomState(12).randn(120, 6).astype(np.float32)
    for invert in (False, True):
        j = JT.VPTree(pts, invert=invert, chunk_size=50)
        t = TT.VPTree(pts, invert=invert, chunk_size=50, device=CPU)
        target = pts[4] + 0.5     # far from every row: no sqrt of rounding
        wi, wd = j.search(target, 5)
        gi, gd = t.search(target, 5)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gd, wd, **F32)
    assert TT.VPTree(pts, device=CPU).distance(pts[0], pts[1]) == pytest.approx(
        JT.VPTree(pts).distance(pts[0], pts[1]), rel=1e-5)
    jk, tk = JT.KDTree(6), TT.KDTree(6, device=CPU)
    for p in pts[:40]:
        jk.insert(p)
        tk.insert(p)
    assert tk.delete(pts[3]) and jk.delete(pts[3]) and tk.size() == jk.size() == 39
    wd, wp = jk.nn(pts[7] + 0.5)
    gd, gp = tk.nn(pts[7] + 0.5)
    np.testing.assert_array_equal(gp, wp)
    assert gd == pytest.approx(wd, rel=1e-5)
    want = jk.knn(pts[7] + 0.5, 2.5)
    got = tk.knn(pts[7] + 0.5, 2.5)
    assert len(got) == len(want)
    for (gdi, gpi), (wdi, wpi) in zip(got, want):
        np.testing.assert_array_equal(gpi, wpi)
        assert gdi == pytest.approx(wdi, rel=1e-5, abs=1e-6)


# ---------------------------------------------------------------------------
# Barnes-Hut trees and t-SNE
# ---------------------------------------------------------------------------


def test_barnes_hut_gradient_equals_jax():
    """The port's sptree is a copy of the JAX package's host code: equal
    bits for the same float64 inputs, at theta 0 (exact) and 0.5."""
    rs = np.random.RandomState(13)
    y = rs.randn(60, 2)
    n = y.shape[0]
    row_p = np.arange(0, 3 * n + 1, 3, dtype=np.int64)
    col_p = rs.randint(0, n, 3 * n).astype(np.int64)
    val_p = rs.rand(3 * n)
    val_p /= val_p.sum()
    for theta in (0.0, 0.5):
        np.testing.assert_array_equal(
            TS.barnes_hut_gradient(y, row_p, col_p, val_p, theta),
            JS.barnes_hut_gradient(y, row_p, col_p, val_p, theta))


def test_tsne_perplexity_and_first_iterations_match_jax():
    """P from the bisection (f32 within 1e-5 of its largest entry), then 20
    optimizer steps from the same y0 at learning rate 10 (f32 within 1e-5
    of the embedding's largest entry). t-SNE amplifies rounding: at the
    default rate 200 on this few points the two packages part by 1e-3 of
    the scale in 10 steps, so over a full run only what t-SNE is for
    (separated clusters, below) is comparable."""
    x = _blobs(100, 10, n_clusters=3, seed=14)
    sqd = np.asarray(JN.pairwise_distance(x, x, "sqeuclidean"))
    want_p = np.asarray(JTS._binary_search_perplexity(jnp.asarray(sqd), jnp.float32(15.0)))
    got_p = _np(TTS._binary_search_perplexity(torch.as_tensor(sqd.copy()), 15.0))
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=1e-5 * want_p.max())
    kw = dict(perplexity=15.0, n_iter=20, learning_rate=10.0,
              stop_lying_iteration=5, switch_momentum_iteration=3)
    want = JTS.Tsne(**kw).fit_transform(x)
    got = TTS.Tsne(**kw, device=CPU).fit_transform(x)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_tsne_separates_two_clusters():
    """The JAX package's own recipe (tests/test_clustering.py) over the full
    1000 steps at the default rate."""
    rng = np.random.RandomState(0)
    x = np.concatenate([rng.randn(25, 10).astype(np.float32),
                        rng.randn(25, 10).astype(np.float32) + 8.0])
    emb = TTS.BarnesHutTsne(perplexity=10.0, n_iter=1000, seed=1,
                            device=CPU).fit_transform(x)
    assert emb.shape == (50, 2) and np.all(np.isfinite(emb))
    a, b = emb[:25], emb[25:]
    intra = max(np.linalg.norm(a - a.mean(0), axis=1).mean(),
                np.linalg.norm(b - b.mean(0), axis=1).mean())
    assert np.linalg.norm(a.mean(0) - b.mean(0)) > 2.0 * intra


def test_barnes_hut_tsne_matches_jax():
    """The host Barnes-Hut loop (float64) on the port's kNN: the same
    neighbourhoods, their f32 squared distances within rounding, so 5 steps
    at learning rate 10 agree within 1e-5 of the embedding's largest entry
    (the loop amplifies that rounding as the exact method does)."""
    x = _blobs(40, 6, n_clusters=2, seed=16)
    kw = dict(method="barnes_hut", perplexity=5.0, n_iter=5, theta=0.5,
              learning_rate=10.0)
    want = JTS.BarnesHutTsne(**kw).fit_transform(x)
    got = TTS.BarnesHutTsne(**kw, device=CPU).fit_transform(x)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    with pytest.raises(ValueError):
        TTS.BarnesHutTsne(method="bogus", device=CPU)


# ---------------------------------------------------------------------------
# NearestNeighborsServer and its CLI
# ---------------------------------------------------------------------------


def _ask(port, path, payload=None):
    url = f"http://127.0.0.1:{port}{path}"
    data = None if payload is None else json.dumps(payload).encode()
    with urllib.request.urlopen(urllib.request.Request(url, data=data), timeout=30) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("similarity", ["euclidean", "manhattan"])
def test_nn_server_answers_like_jax(similarity):
    """The index route (euclidean) and the legacy fallback (manhattan):
    /status equal, /knn and /knnnew the same indices and distances."""
    pts = _blobs(30, 4, seed=17)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        j = JServer(pts, similarity_function=similarity).start(0)
        t = TServer(pts, similarity_function=similarity, device=CPU).start(0)
    try:
        assert (t._legacy is None) == (similarity == "euclidean")
        assert _ask(t.port, "/status") == _ask(j.port, "/status") == {
            "ok": True, "points": 30, "dim": 4}
        for path, payload in (("/knn", {"ndarray": 3, "k": 4}),
                              ("/knnnew", {"ndarray": pts[5].tolist(), "k": 3})):
            got = _ask(t.port, path, payload)["results"]
            want = _ask(j.port, path, payload)["results"]
            assert [r["index"] for r in got] == [r["index"] for r in want]
            np.testing.assert_allclose([r["distance"] for r in got],
                                       [r["distance"] for r in want], **F32)
        assert 3 not in [r["index"] for r in _ask(t.port, "/knn", {"ndarray": 3, "k": 4})["results"]]
    finally:
        t.stop()
        j.stop()


def test_cli_parser():
    a = build_parser().parse_args(["--points", "p.npy", "--port", "0",
                                   "--similarity", "cosine", "--invert",
                                   "--device", "cpu"])
    assert (a.points, a.port, a.similarity, a.invert, a.device) == (
        "p.npy", 0, "cosine", True, "cpu")
    d = build_parser().parse_args(["--points", "p.npz"])
    assert (d.port, d.similarity, d.invert, d.device) == (9000, "euclidean", False, None)
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--points", "p.npy", "--similarity", "bogus"])
