"""Word2Vec, ParagraphVectors and GloVe of the port against the JAX package's
on the CPU.

The five step functions and ``_glove_step`` take the same numpy inputs
(ids repeated within a batch) in both packages; the initial tables are
drawn from the same ``RandomState`` and must be equal bit for bit; the
host pair generators must give the same pairs; whole fits on a tiny corpus
(2 epochs) must end with the JAX package's tables and with its host RNG
stream in the same state; the epoch-scan path must equal a loop of
``_sg_ns_step`` fed the negatives its generator draws; lookups, the
serializer's files and ``infer_vector`` must agree.

Tolerances: f32 arithmetic in both packages, summed in other orders by
XLA and PyTorch (einsum, row sums, scatter-adds of repeated ids):
``STEP_TOL`` for one step on entries of order 1, ``FIT_TOL`` for a whole
fit (the largest difference measured is 1.5e-7, on GloVe entries of order
1). Where both sides run the same PyTorch operations in the same order,
equality is exact.
"""

import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import deeplearning4j_tpu.nlp.embeddings as J
import deeplearning4j_tpu.nlp.glove as JG
from deeplearning4j_tpu.nlp.serializer import WordVectorSerializer as JSer
import deeplearning4j_tpu_torch.nlp.embeddings as T
import deeplearning4j_tpu_torch.nlp.glove as TG
from deeplearning4j_tpu_torch.interop import embeddings_from_numpy, embeddings_to_numpy
from deeplearning4j_tpu_torch.nlp.serializer import WordVectorSerializer as TSer
from deeplearning4j_tpu_torch.nlp.vocab import (
    VocabCache,
    VocabWord,
    subsample_probs,
    unigram_table,
)

STEP_TOL = dict(rtol=1e-5, atol=1e-6)
FIT_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _corpus(seed=0, n=40, L=12, V=25):
    rs = np.random.RandomState(seed)
    z = rs.zipf(1.5, n * L * 3)
    z = z[z <= V][:n * L]
    return [" ".join(f"w{t}" for t in z[i:i + L]) for i in range(0, len(z), L)]


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "iu" else a.copy())


def _j(a):
    return jnp.asarray(a)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


# -- the step functions ---------------------------------------------------------

V, D, B, K, W, L = 12, 8, 64, 4, 6, 5   # B >> V: every id repeats in a batch


def _tables(rs, names, rows):
    return {n: ((rs.rand(rows[n], D) - 0.5)).astype(np.float32) for n in names}


def _step_case(kind, seed):
    rs = np.random.RandomState(seed)
    lr = np.float32(0.05)
    if kind in ("sg_ns", "cbow_ns", "dm_ns"):
        params = _tables(rs, ("syn0", "syn1neg"), {"syn0": V, "syn1neg": V})
    else:
        params = _tables(rs, ("syn0", "syn1"), {"syn0": V, "syn1": V - 1})
    win = rs.randint(0, V, (B, W)).astype(np.int32)
    wmask = (np.arange(W)[None, :] < rs.randint(0, W + 1, B)[:, None]).astype(np.float32)
    negs = rs.randint(0, V, (B, K)).astype(np.int32)
    ids = rs.randint(0, V, B).astype(np.int32)
    ids2 = rs.randint(0, V, B).astype(np.int32)
    lens = rs.randint(1, L + 1, B)
    hmask = (np.arange(L)[None, :] < lens[:, None]).astype(np.float32)
    codes = (rs.rand(B, L) < 0.5).astype(np.float32) * hmask
    points = rs.randint(0, V - 1, (B, L)).astype(np.int32) * hmask.astype(np.int32)
    args = {"sg_ns": (ids, ids2, negs), "cbow_ns": (win, wmask, ids, negs),
            "dm_ns": (ids2, win, wmask, ids, negs),
            "cbow_hs": (win, wmask, codes, points, hmask),
            "sg_hs": (ids, codes, points, hmask)}[kind]
    return params, args, lr


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", ["sg_ns", "cbow_ns", "dm_ns", "cbow_hs", "sg_hs"])
def test_step_matches_jax(kind, seed):
    params, args, lr = _step_case(kind, seed)
    tp, tloss = getattr(T, f"_{kind}_step")({k: _t(v) for k, v in params.items()},
                                            *(_t(a) for a in args), float(lr))
    jp, jloss = getattr(J, f"_{kind}_step")({k: _j(v) for k, v in params.items()},
                                            *(_j(a) for a in args), _j(lr))
    assert list(tp) == list(jp)
    np.testing.assert_allclose(float(tloss), float(jloss), **STEP_TOL)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), **STEP_TOL)
        assert not np.array_equal(tp[k].numpy(), params[k]), f"{k} did not move"


def test_step_takes_an_f32_tensor_rate():
    params, args, lr = _step_case("sg_ns", 3)
    a, la = T._sg_ns_step({k: _t(v) for k, v in params.items()}, *(_t(x) for x in args), float(lr))
    b, lb = T._sg_ns_step({k: _t(v) for k, v in params.items()}, *(_t(x) for x in args),
                          torch.tensor(lr))
    assert float(la) == float(lb)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_repeated_ids_sum_their_updates():
    """One center repeated B times moves by the sum of the B pairs' updates,
    each taken alone from the same tables (a torch ``t[idx] += v`` would
    keep one of them)."""
    params, (ids, ids2, negs), lr = _step_case("sg_ns", 4)
    ids = np.full(B, 3, np.int32)
    before = params["syn0"][3].copy()
    tp, _ = T._sg_ns_step({k: _t(v) for k, v in params.items()}, _t(ids), _t(ids2),
                          _t(negs), float(lr))
    jp, _ = J._sg_ns_step({k: _j(v) for k, v in params.items()}, ids, ids2, negs, _j(lr))
    moved = tp["syn0"][3].numpy() - before
    np.testing.assert_allclose(moved, np.asarray(jp["syn0"])[3] - before, **STEP_TOL)
    alone = sum(T._sg_ns_step({k: _t(v) for k, v in params.items()}, _t(ids[i:i + 1]),
                              _t(ids2[i:i + 1]), _t(negs[i:i + 1]), float(lr))[0]["syn0"][3]
                .numpy() - before for i in range(B))
    np.testing.assert_allclose(moved, alone, **STEP_TOL)


def test_padded_huffman_positions_add_exactly_zero():
    params, (ids, codes, points, hmask), lr = _step_case("sg_hs", 5)
    points = np.where(hmask > 0, np.maximum(points, 1), 0).astype(np.int32)  # 0 only as padding
    assert (hmask == 0).any()
    row0 = params["syn1"][0].copy()
    tp, _ = T._sg_hs_step({k: _t(v) for k, v in params.items()}, _t(ids), _t(codes),
                          _t(points), _t(hmask), float(lr))
    np.testing.assert_array_equal(tp["syn1"][0].numpy(), row0)


@pytest.mark.parametrize("seed", [0, 1])
def test_glove_step_matches_jax_with_repeated_ids(seed):
    rs = np.random.RandomState(seed)
    Vg, Bg = 10, 48
    params = {"W": (rs.rand(Vg, D) - 0.5).astype(np.float32),
              "Wc": (rs.rand(Vg, D) - 0.5).astype(np.float32),
              "b": (rs.rand(Vg) - 0.5).astype(np.float32),
              "bc": (rs.rand(Vg) - 0.5).astype(np.float32),
              "hW": rs.rand(Vg, D).astype(np.float32),
              "hWc": rs.rand(Vg, D).astype(np.float32),
              "hb": rs.rand(Vg).astype(np.float32),
              "hbc": rs.rand(Vg).astype(np.float32)}
    wi = rs.randint(0, Vg, Bg).astype(np.int32)
    wj = rs.randint(0, Vg, Bg).astype(np.int32)
    assert len(set(wi.tolist())) < Bg
    xij = (rs.rand(Bg) * 150 + 0.1).astype(np.float32)
    tp, tloss = TG._glove_step({k: _t(v) for k, v in params.items()}, _t(wi), _t(wj),
                               _t(xij), 0.05, x_max=100.0, alpha=0.75)
    jp, jloss = JG._glove_step({k: _j(v) for k, v in params.items()}, _j(wi), _j(wj),
                               _j(xij), _j(np.float32(0.05)), x_max=100.0, alpha=0.75)
    np.testing.assert_allclose(float(tloss), float(jloss), **STEP_TOL)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), **STEP_TOL)


# -- initial params and interop --------------------------------------------------

def _w2v_pair(**kw):
    common = dict(layer_size=8, window=3, negative=3, min_word_frequency=1, epochs=2,
                  seed=7, batch_size=16, learning_rate=0.05)
    common.update(kw)
    return J.Word2Vec(**common), T.Word2Vec(device="cpu", **common)


@pytest.mark.parametrize("hs", [False, True])
def test_initial_params_bit_equal(hs):
    j, t = _w2v_pair(use_hierarchic_softmax=hs)
    j.build_vocab(_corpus())
    t.build_vocab(_corpus())
    j._init_params()
    t._init_params()
    got, want = embeddings_to_numpy(t), _np(j.params)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == np.float32


def test_glove_and_paragraph_initial_params_bit_equal():
    jg = JG.Glove(layer_size=8, epochs=0, seed=3).fit(_corpus())
    tg = TG.Glove(layer_size=8, epochs=0, seed=3, device="cpu").fit(_corpus())
    got, want = embeddings_to_numpy(tg), _np(jg.params)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    docs = [(s, f"d{i % 3}") for i, s in enumerate(_corpus()[:9])]
    jp = J.ParagraphVectors(layer_size=8, epochs=0, seed=5)
    jp.fit_documents(docs)
    tp = T.ParagraphVectors(layer_size=8, epochs=0, seed=5, device="cpu")
    tp.fit_documents(docs)
    np.testing.assert_array_equal(tp.syn0, jp.syn0)


def test_interop_round_trip_and_checks():
    j, t = _w2v_pair()
    j.fit(_corpus())
    t.build_vocab(_corpus())
    t._init_params()
    embeddings_from_numpy(t, _np(j.params))
    for k, v in _np(j.params).items():
        np.testing.assert_array_equal(embeddings_to_numpy(t)[k], v)
        assert t.params[k].dtype == torch.float32
    with pytest.raises(ValueError, match="keys"):
        embeddings_from_numpy(t, {"syn0": np.asarray(j.params["syn0"])})
    with pytest.raises(ValueError, match="shape"):
        embeddings_from_numpy(t, {"syn0": np.zeros((2, 8), np.float32),
                                  "syn1neg": np.asarray(j.params["syn1neg"])})
    with pytest.raises(ValueError, match="no params"):
        embeddings_from_numpy(T.Word2Vec(device="cpu"), _np(j.params))


# -- host pair generation ----------------------------------------------------------

def _idx_seqs(n=30, seed=1):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 20, rs.randint(0, 15)).astype(np.int64) for _ in range(n)]


def test_pair_generators_equal():
    keep = np.random.RandomState(0).rand(20) * 0.5 + 0.5
    seqs = _idx_seqs()
    for window in (1, 3):
        got = list(T._PairGenerator(window, keep, np.random.RandomState(4)).generate(seqs))
        want = list(J._PairGenerator(window, keep, np.random.RandomState(4)).generate(seqs))
        assert [(int(c), int(t)) for c, t in got] == [(int(c), int(t)) for c, t in want]
        got = list(T._PairGenerator(window, keep, np.random.RandomState(4)).generate_windows(seqs))
        assert got == list(J._PairGenerator(window, keep,
                                            np.random.RandomState(4)).generate_windows(seqs))
        for a, b in zip(T._fast_pairs(seqs, window, keep, np.random.RandomState(5)),
                        J._fast_pairs(seqs, window, keep, np.random.RandomState(5))):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    pairs = list(J._fast_pairs(seqs, 3, keep, np.random.RandomState(5)))
    for got, want in zip(T._batched_arrays(iter(pairs), 7), J._batched_arrays(iter(pairs), 7)):
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)
    items = list(J._PairGenerator(3, keep, np.random.RandomState(4)).generate_windows(seqs))
    tagged = [(i % 3,) + it for i, it in enumerate(items)]
    for src in (items, tagged):
        for got, want in zip(T._batched_windows(iter(src), 5, 6),
                             J._batched_windows(iter(src), 5, 6)):
            assert len(got) == len(want)
            for x, y in zip(got, want):
                np.testing.assert_array_equal(x, y)


def test_unknown_words_dropped_as_jax_does():
    j, t = _w2v_pair(min_word_frequency=3)
    j.build_vocab(_corpus())
    t.build_vocab(_corpus())
    seqs = [s.split() + ["never-seen"] for s in _corpus()[:6]]
    for a, b in zip(t._index_sequences(seqs), j._index_sequences(seqs)):
        np.testing.assert_array_equal(a, b)
        assert (a >= 0).all()


# -- whole fits --------------------------------------------------------------------

def _rs_equal(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a.get_state(), b.get_state()))


FITS = {
    "sg_ns_python": dict(),
    "sg_hs": dict(use_hierarchic_softmax=True),
    "cbow_ns": dict(elements_learning="cbow"),
    "cbow_hs": dict(elements_learning="cbow", use_hierarchic_softmax=True),
    "sg_hs_numpy": dict(use_hierarchic_softmax=True, pair_backend="numpy"),
}


@pytest.mark.parametrize("mode", sorted(FITS))
def test_whole_fit_matches_jax(mode):
    j, t = _w2v_pair(**FITS[mode])
    j.fit(_corpus())
    t.fit(_corpus())
    assert [w.word for w in t.vocab.words] == [w.word for w in j.vocab.words]
    np.testing.assert_allclose(t.syn0, j.syn0, **FIT_TOL)
    for k, v in _np(j.params).items():
        np.testing.assert_allclose(embeddings_to_numpy(t)[k], v, **FIT_TOL)
    assert _rs_equal(t._rs, j._rs)


def test_scan_path_consumes_the_host_stream_as_jax_does():
    """SG-NS with the numpy backend takes the epoch-scan path (negatives on
    the device, so the tables differ from JAX's); its host draws — the
    per-epoch key seed, the pairs — leave the stream where JAX's leave it."""
    j, t = _w2v_pair(pair_backend="numpy", scan_batches=2)
    j.fit(_corpus())
    t.fit(_corpus())
    assert _rs_equal(t._rs, j._rs)
    assert np.isfinite(t.syn0).all()


@pytest.mark.parametrize("mode", ["dbow", "dm"])
def test_paragraph_vectors_fit_matches_jax(mode):
    docs = [(s, f"d{i % 4}") for i, s in enumerate(_corpus()[:16])]
    kw = dict(layer_size=8, window=2, negative=3, epochs=2, seed=5, batch_size=16,
              learning_rate=0.05, sequence_learning=mode)
    jp = J.ParagraphVectors(**kw)
    jp.fit_documents(docs)
    tp = T.ParagraphVectors(device="cpu", **kw)
    tp.fit_documents(docs)
    np.testing.assert_allclose(tp.syn0, jp.syn0, **FIT_TOL)
    np.testing.assert_allclose(tp.get_label_vector("d1"), jp.get_label_vector("d1"), **FIT_TOL)
    assert _rs_equal(tp._rs, jp._rs)
    # infer_vector from the same tables: the same host arithmetic, exactly
    embeddings_from_numpy(tp, _np(jp.params))
    text = _corpus()[20] + " never-seen"
    np.testing.assert_array_equal(tp.infer_vector(text), jp.infer_vector(text))
    assert tp.similarity_to_label(text, "d2") == jp.similarity_to_label(text, "d2")
    np.testing.assert_array_equal(tp.infer_vector("never-seen"), np.zeros(8, np.float32))


def test_glove_fit_matches_jax():
    kw = dict(layer_size=8, window=3, epochs=3, batch_size=32, seed=3)
    jg = JG.Glove(**kw).fit(_corpus())
    tg = TG.Glove(device="cpu", **kw).fit(_corpus())
    for k, v in _np(jg.params).items():
        np.testing.assert_allclose(embeddings_to_numpy(tg)[k], v, **FIT_TOL)
    np.testing.assert_allclose(tg.syn0, jg.syn0, **FIT_TOL)
    np.testing.assert_allclose(tg.get_word_vector("w2"), jg.get_word_vector("w2"), **FIT_TOL)
    assert tg.get_word_vector("never-seen") is None
    np.testing.assert_allclose(tg.similarity("w1", "w3"), jg.similarity("w1", "w3"), **FIT_TOL)


# -- the epoch scan ----------------------------------------------------------------

def _scan_inputs(N=4, Bs=32, Vs=30, seed=0):
    rs = np.random.RandomState(seed)
    counts = rs.zipf(1.3, Vs).astype(np.float64)
    cache = VocabCache()
    for i, c in enumerate(sorted(counts, reverse=True)):
        cache.add(VocabWord(f"w{i}", int(c)))
    table = unigram_table(cache)
    params = {"syn0": ((rs.rand(Vs, D) - 0.5) / D).astype(np.float32),
              "syn1neg": ((rs.rand(Vs, D) - 0.5) / D).astype(np.float32)}
    c2 = rs.randint(0, Vs, (N, Bs)).astype(np.int64)
    t2 = rs.randint(0, Vs, (N, Bs)).astype(np.int64)
    return params, c2, t2, np.cumsum(table).astype(np.float32), table


def test_scan_equals_the_loop_of_steps():
    params, c2, t2, cum, _ = _scan_inputs()
    N, Bs = c2.shape
    lr0, min_lr, seen0, total = np.float32(0.025), np.float32(1e-4), 96.0, 400.0
    cum_t = torch.from_numpy(cum)
    gen = torch.Generator().manual_seed(1234)
    sp, slosses = T._sg_ns_epoch_scan({k: _t(v) for k, v in params.items()}, _t(c2), _t(t2),
                                      cum_t, gen, float(lr0), float(min_lr), seen0, total,
                                      negative=K, unroll=4)
    # the same generator seed gives the same negatives, one draw per batch
    gen = torch.Generator().manual_seed(1234)
    lp = {k: _t(v) for k, v in params.items()}
    jp = {k: _j(v) for k, v in params.items()}
    seen = torch.tensor(seen0, dtype=torch.float32)
    llosses, jlosses = [], []
    for i in range(N):
        negs = T._device_negatives(cum_t, gen, Bs, K)
        lr = torch.maximum(torch.tensor(lr0) * (1.0 - torch.clamp(seen / total, max=1.0)),
                           torch.tensor(min_lr))
        lp, loss = T._sg_ns_step(lp, _t(c2[i]), _t(t2[i]), negs, lr)
        llosses.append(float(loss))
        jp, jloss = J._sg_ns_step(jp, _j(c2[i]), _j(t2[i]), _j(negs.numpy().astype(np.int32)),
                                  _j(lr.numpy()))
        jlosses.append(float(jloss))
        seen = seen + Bs
    assert slosses.tolist() == llosses
    for k in params:
        np.testing.assert_array_equal(sp[k].numpy(), lp[k].numpy())
        np.testing.assert_allclose(sp[k].numpy(), np.asarray(jp[k]), **STEP_TOL)
    np.testing.assert_allclose(llosses, jlosses, **STEP_TOL)


def test_scan_rate_is_the_f32_schedule():
    """seen is an f32 carry: past total the rate holds at min_lr."""
    params, c2, t2, cum, _ = _scan_inputs(N=3)
    gen = torch.Generator().manual_seed(0)
    a, _ = T._sg_ns_epoch_scan({k: _t(v) for k, v in params.items()}, _t(c2), _t(t2),
                               torch.from_numpy(cum), gen, 0.025, 0.0, 1e9, 10.0, negative=K)
    np.testing.assert_array_equal(a["syn0"].numpy(), params["syn0"])


def test_device_negatives_follow_the_unigram_table():
    _, _, _, cum, table = _scan_inputs(Vs=50)
    n = 400_000
    gen = torch.Generator().manual_seed(7)
    draws = T._device_negatives(torch.from_numpy(cum), gen, n // 5, 5)
    assert draws.dtype == torch.int64 and int(draws.min()) >= 0 and int(draws.max()) < 50
    freq = np.bincount(draws.numpy().ravel(), minlength=50) / n
    z = np.abs(freq - table) / np.sqrt(table * (1 - table) / n)
    assert z.max() < 5.0, z.max()


def test_fit_runs_every_pair_through_scan_and_tail(monkeypatch):
    """The numpy backend's pairs all reach a step: scan chunks plus the tail."""
    t = T.Word2Vec(device="cpu", layer_size=8, window=3, negative=3, min_word_frequency=1,
                   epochs=1, seed=7, batch_size=16, scan_batches=3, pair_backend="numpy")
    counted = {"pairs": 0, "scans": 0}
    step, scan = T._sg_ns_step, T._sg_ns_epoch_scan

    def counting_step(params, centers, *a):
        counted["pairs"] += len(centers)
        return step(params, centers, *a)

    def counting_scan(*a, **kw):
        counted["scans"] += 1
        return scan(*a, **kw)

    monkeypatch.setattr(T, "_sg_ns_step", counting_step)
    monkeypatch.setattr(T, "_sg_ns_epoch_scan", counting_scan)
    t.fit(_corpus())
    rs = np.random.RandomState(7)
    rs.randint(2 ** 31)   # the epoch's key seed is drawn first
    idx = t._index_sequences([s.split() for s in _corpus()])
    want = sum(len(c) for c, _ in T._fast_pairs(idx, 3, subsample_probs(t.vocab, t.sample), rs))
    assert counted["pairs"] == want and counted["scans"] >= 1


# -- lookups, errors ------------------------------------------------------------------

def test_words_nearest_and_similarity_match():
    j, t = _w2v_pair()
    j.fit(_corpus())
    t.build_vocab(_corpus())
    t._init_params()
    embeddings_from_numpy(t, _np(j.params))
    for w in ("w1", "w2", "w5", "w9"):
        assert t.words_nearest(w, 5) == j.words_nearest(w, 5)
        assert t.similarity(w, "w3") == j.similarity(w, "w3")
        np.testing.assert_array_equal(t.get_word_vector(w), j.get_word_vector(w))
    v = j.syn0[2] + j.syn0[4]
    assert t.words_nearest(v, 4) == j.words_nearest(v, 4)
    assert t.words_nearest("never-seen") == [] and t.get_word_vector("never-seen") is None
    assert np.isnan(t.similarity("w1", "never-seen"))
    ts, js = T.StaticWord2Vec.from_model(t), J.StaticWord2Vec.from_model(j)
    assert ts.words_nearest("w1", 6) == js.words_nearest("w1", 6)
    assert ts.similarity("w1", "w2") == js.similarity("w1", "w2")


def test_out_of_range_ids_raise_before_upload():
    with pytest.raises(ValueError, match=r"\[0, 5\)"):
        T._ids(np.array([0, 5]), 5, torch.device("cpu"), "centers")
    with pytest.raises(ValueError):
        T._ids(np.array([-1, 2]), 5, torch.device("cpu"), "centers")
    assert T._ids(np.array([], np.int32), 5, torch.device("cpu"), "x").numel() == 0


def test_entry_points_raise_without_a_gpu(monkeypatch):
    from deeplearning4j_tpu_torch.graph import DeepWalk, Node2Vec
    from deeplearning4j_tpu_torch.nlp.distributed import DistributedWord2Vec

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (T.SequenceVectors, T.Word2Vec, T.ParagraphVectors, TG.Glove, DeepWalk,
                 Node2Vec, DistributedWord2Vec):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make(device="cuda")


def test_scan_unroll_validated_as_jax_does():
    with pytest.raises(ValueError, match="scan_unroll"):
        T.Word2Vec(device="cpu", scan_unroll=0)
    with pytest.raises(ValueError, match="scan_batches"):
        T.Word2Vec(device="cpu", scan_batches=0)
    with pytest.raises(ValueError, match="pair_backend"):
        T.Word2Vec(device="cpu", pair_backend="c")


# -- the serializer ---------------------------------------------------------------------

@pytest.fixture()
def trained_pair():
    j, t = _w2v_pair()
    j.fit(_corpus())
    t.build_vocab(_corpus())
    t._init_params()
    embeddings_from_numpy(t, _np(j.params))
    return j, t


@pytest.mark.parametrize("fmt", [("write_word_vectors", "load_txt_vectors", "txt"),
                                 ("write_binary", "read_binary", "bin"),
                                 ("write_word2vec_model", "read_word2vec_model", "zip")])
def test_serializer_files_byte_equal_and_cross_read(trained_pair, tmp_path, monkeypatch, fmt):
    write, read, ext = fmt
    j, t = trained_pair
    # a zip entry carries the time it was written: both files are written
    # at one fixed time
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    getattr(TSer, write)(t, str(tmp_path / f"port.{ext}"))
    getattr(JSer, write)(j, str(tmp_path / f"jax.{ext}"))
    assert (tmp_path / f"port.{ext}").read_bytes() == (tmp_path / f"jax.{ext}").read_bytes()
    for reader, path in ((getattr(TSer, read), "jax"), (getattr(JSer, read), "port")):
        m = reader(str(tmp_path / f"{path}.{ext}"))
        assert [w.word for w in m.vocab.words] == [w.word for w in j.vocab.words]
        if ext == "txt":   # the text format keeps 6 significant digits
            np.testing.assert_allclose(m.syn0, j.syn0, rtol=1e-5, atol=1e-8)
        else:
            np.testing.assert_array_equal(m.syn0, j.syn0)
    back = TSer.read_word2vec_model(str(tmp_path / f"jax.{ext}")) if ext == "zip" else None
    if back is not None:
        assert [w.count for w in back.vocab.words] == [w.count for w in j.vocab.words]


def test_large_batch_overshoot_is_the_reference_behaviour():
    """bench_word2vec's rate (0.025) at a batch far above the vocabulary's
    frequent words: a word's summed updates a batch grow its rows far past
    the init scale. A cut of the bench corpus (100,000 zipf(1.3) tokens
    below 50,000, sentences of 1,000, B = 16,384, the python backend): the
    port's tables equal the JAX package's there too, within FIT_TOL's
    relative part of entries that reached ~1e11."""
    rs = np.random.RandomState(0)
    z = rs.zipf(1.3, 200_000)
    toks = z[z <= 50_000][:100_000]
    corpus = [[f"w{t}" for t in toks[i:i + 1000]] for i in range(0, len(toks), 1000)]
    kw = dict(layer_size=100, window=5, negative=5, min_word_frequency=1, epochs=1, seed=1,
              batch_size=16384)
    j = J.Word2Vec(**kw).fit(corpus)
    t = T.Word2Vec(device="cpu", **kw).fit(corpus)
    assert np.abs(j.syn0).max() > 1e6        # overshot: the init scale is 5e-3
    np.testing.assert_allclose(t.syn0, j.syn0, rtol=FIT_TOL["rtol"],
                               atol=FIT_TOL["rtol"] * np.abs(j.syn0).max())
