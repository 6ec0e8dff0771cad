"""The port's graph embeddings (``graph/``) against the JAX package's on
the CPU: the graph API and edge-list loader, the random walks (uniform,
weighted, node2vec) from the same seeds, GraphHuffman's tables, and
DeepWalk and Node2Vec trained from the same seeds. The walks and tables are
host numpy in both packages and must be equal; the trained tables are f32
sums in other orders (XLA against PyTorch) and are held to ``FIT_TOL``.
"""

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.graph as JG
import deeplearning4j_tpu_torch.graph as TG
from deeplearning4j_tpu.graph import walks as jwalks
from deeplearning4j_tpu_torch.graph import walks as twalks
from deeplearning4j_tpu_torch.interop import embeddings_from_numpy, embeddings_to_numpy

FIT_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _cliques(mod, k=5, m=3, weighted=False):
    """m k-cliques in a chain, each joined to the next by one edge."""
    g = mod.Graph(k * m)
    for b in range(m):
        for i in range(k):
            for j in range(i + 1, k):
                g.add_edge(b * k + i, b * k + j, 1.0 + (i + j) % 3 if weighted else 1.0)
    for b in range(m - 1):
        g.add_edge(b * k + k - 1, (b + 1) * k)
    return g


def _walks(it):
    return [w.tolist() for w in it]


@pytest.mark.parametrize("seed", [0, 5])
def test_walks_equal_from_the_same_seed(seed):
    tg, jg = _cliques(TG, weighted=True), _cliques(JG, weighted=True)
    assert _walks(TG.RandomWalkIterator(tg, 7, seed=seed)) == _walks(
        JG.RandomWalkIterator(jg, 7, seed=seed))
    assert _walks(TG.WeightedRandomWalkIterator(tg, 7, seed=seed)) == _walks(
        JG.WeightedRandomWalkIterator(jg, 7, seed=seed))
    for p, q in ((1.0, 1.0), (0.5, 2.0), (4.0, 0.25)):
        assert _walks(TG.Node2VecWalkIterator(tg, 7, p=p, q=q, seed=seed)) == _walks(
            JG.Node2VecWalkIterator(jg, 7, p=p, q=q, seed=seed))
    a, b = TG.RandomWalkIterator(tg, 4, seed=seed), JG.RandomWalkIterator(jg, 4, seed=seed)
    _walks(a), _walks(b)
    a.reset(), b.reset()
    assert _walks(a) == _walks(b)


def test_disconnected_vertices_and_graph_api_match(tmp_path):
    tg, jg = TG.Graph(4), JG.Graph(4)
    for g in (tg, jg):
        g.add_edge(0, 1, 2.0)
        g.add_edge(1, 2)
    assert _walks(TG.RandomWalkIterator(tg, 3, seed=1)) == _walks(
        JG.RandomWalkIterator(jg, 3, seed=1))
    with pytest.raises(twalks.NoEdgesException):
        list(TG.RandomWalkIterator(tg, 3, seed=1,
                                   no_edge_handling=twalks.EXCEPTION_ON_DISCONNECTED))
    assert twalks.EXCEPTION_ON_DISCONNECTED == jwalks.EXCEPTION_ON_DISCONNECTED
    assert tg.degrees().tolist() == jg.degrees().tolist()
    assert tg.get_edge_weights(1) == jg.get_edge_weights(1)
    assert tg.get_vertex(2) == TG.Vertex(2, None)
    with pytest.raises(ValueError):
        TG.Graph(0)
    path = tmp_path / "edges.txt"
    path.write_text("# comment\n0 1\n1 2 3.5\n\n2 3\n")
    for load in ("load_undirected_graph_edge_list_file", "load_directed_graph_edge_list_file"):
        a = getattr(TG.GraphLoader, load)(str(path), 4)
        b = getattr(JG.GraphLoader, load)(str(path), 4)
        assert [a.get_connected_vertex_indices(i) for i in range(4)] == [
            b.get_connected_vertex_indices(i) for i in range(4)]
        assert [a.get_edge_weights(i) for i in range(4)] == [b.get_edge_weights(i) for i in range(4)]


def test_graph_huffman_equal():
    counts = np.random.RandomState(3).randint(1, 30, 40)
    a, b = TG.GraphHuffman(counts), JG.GraphHuffman(counts)
    for x, y in ((a.codes, b.codes), (a.points, b.points), (a.mask, b.mask),
                 (a.code_lengths, b.code_lengths)):
        np.testing.assert_array_equal(x, y)
    assert a.num_inner == b.num_inner and a.get_code_length(5) == b.get_code_length(5)


def _np(params):
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("epochs", [1, 2])
def test_deepwalk_matches_jax(epochs):
    kw = dict(vector_size=8, window_size=2, batch_size=32, seed=3)
    j = JG.DeepWalk(**kw).fit(_cliques(JG), walk_length=6, epochs=epochs)
    t = TG.DeepWalk(device="cpu", **kw).fit(_cliques(TG), walk_length=6, epochs=epochs)
    for k, v in _np(j.params).items():
        np.testing.assert_allclose(embeddings_to_numpy(t)[k], v, **FIT_TOL)
    assert t.vertices_nearest(0, 4) == j.vertices_nearest(0, 4)
    np.testing.assert_allclose(t.similarity(0, 7), j.similarity(0, 7), **FIT_TOL)
    np.testing.assert_allclose(t.get_vertex_vector(3), j.get_vertex_vector(3), **FIT_TOL)
    assert t.num_vertices() == j.num_vertices() == 15


def test_deepwalk_initial_params_bit_equal_and_lookups_from_them():
    j = JG.DeepWalk(vector_size=8, seed=9).initialize(_cliques(JG))
    t = TG.DeepWalk(vector_size=8, seed=9, device="cpu").initialize(_cliques(TG))
    for k, v in _np(j.params).items():
        np.testing.assert_array_equal(embeddings_to_numpy(t)[k], v)
    j.fit(_cliques(JG), walk_length=5)
    embeddings_from_numpy(t, _np(j.params))
    for v in range(15):
        assert t.vertices_nearest(v, 5) == j.vertices_nearest(v, 5)
        assert t.similarity(v, 14 - v) == j.similarity(v, 14 - v)


def test_deepwalk_from_walks_and_its_checks():
    tg, jg = _cliques(TG), _cliques(JG)
    walks = list(JG.RandomWalkIterator(jg, 5, seed=2))
    j = JG.DeepWalk(vector_size=8, batch_size=16, seed=1).initialize(jg)
    j.fit(walks, walk_length=5, epochs=2)
    t = TG.DeepWalk(vector_size=8, batch_size=16, seed=1, device="cpu").initialize(tg)
    t.fit(walks, walk_length=5, epochs=2)
    np.testing.assert_allclose(t.syn0, j.syn0, **FIT_TOL)
    with pytest.raises(ValueError, match="single-use"):
        t.fit(iter(walks), walk_length=5, epochs=2)
    with pytest.raises(RuntimeError, match="initialize"):
        TG.DeepWalk(device="cpu").fit(walks)
    with pytest.raises(ValueError, match="walk vertices"):   # checked before upload
        t.fit([np.array([0, 1, 15, 2])], walk_length=3)


def test_node2vec_matches_jax():
    kw = dict(vector_size=8, window=2, walk_length=6, walks_per_vertex=3, p=0.5, q=2.0,
              epochs=2, batch_size=32, seed=2)
    j = JG.Node2Vec(**kw).fit(_cliques(JG))
    t = TG.Node2Vec(device="cpu", **kw).fit(_cliques(TG))
    np.testing.assert_allclose(t._sv.syn0, j._sv.syn0, **FIT_TOL)
    assert [w.word for w in t._sv.vocab.words] == [w.word for w in j._sv.vocab.words]
    assert t.vertices_nearest(0, 4) == j.vertices_nearest(0, 4)
    np.testing.assert_allclose(t.get_vertex_vector(4), j.get_vertex_vector(4), **FIT_TOL)
    np.testing.assert_allclose(t.similarity(0, 9), j.similarity(0, 9), **FIT_TOL)
    with pytest.raises(RuntimeError, match="fit"):
        TG.Node2Vec(device="cpu").get_vertex_vector(0)
