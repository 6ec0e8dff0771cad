"""The port's host-side text modules against the JAX package's: tokenizers
and sentence iterators, CJK segmentation, vocabulary construction, Huffman
tables, the unigram and subsampling tables, the vectorizers, and
``utils/misc.py``'s Viterbi and MovingWindowMatrix. These are copies, so
every comparison is exact (lists equal, arrays equal bit for bit); the one
exception is stated where it is made.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nlp import cjk as jcjk
from deeplearning4j_tpu.nlp import tokenization as jtok
from deeplearning4j_tpu.nlp import vectorizers as jvec
from deeplearning4j_tpu.nlp import vocab as jvocab
from deeplearning4j_tpu.utils import misc as jmisc
from deeplearning4j_tpu_torch.nlp import cjk, tokenization, vectorizers, vocab
from deeplearning4j_tpu_torch.utils import misc


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


TEXTS = [
    "The quick brown fox, (jumps) over the lazy dog!",
    "  Hello   WORLD: 42 times?  ",
    "a b c a b c d e f g a a a",
    "",
]
CJK_TEXTS = [
    "我爱北京天安门", "東京に行きました", "한국어를 공부합니다",
    "mixed 中文 text 和 English", "𠀀𠀁 supplementary", "我们的朋友在学校学习中文",
]


def _corpus(seed=0, n=60, L=15, V=40):
    rs = np.random.RandomState(seed)
    z = rs.zipf(1.4, n * L * 3)
    z = z[z <= V][:n * L]
    return [" ".join(f"w{t}" for t in z[i:i + L]) for i in range(0, len(z), L)]


@pytest.mark.parametrize("pre", [None, "common", "lowcase"])
@pytest.mark.parametrize("text", TEXTS)
def test_default_tokenizer_matches(text, pre):
    def factory(mod):
        f = mod.DefaultTokenizerFactory()
        if pre == "common":
            f.set_token_pre_processor(mod.CommonPreprocessor())
        elif pre == "lowcase":
            f.set_token_pre_processor(mod.LowCasePreprocessor())
        return f

    assert factory(tokenization).tokenize(text) == factory(jtok).tokenize(text)
    assert (list(factory(tokenization).create(text))
            == factory(jtok).create(text).get_tokens())


@pytest.mark.parametrize("n", [(1, 1), (1, 2), (2, 3)])
def test_ngram_tokenizer_matches(n):
    for text in TEXTS:
        assert (tokenization.NGramTokenizerFactory(*n).tokenize(text)
                == jtok.NGramTokenizerFactory(*n).tokenize(text))


def test_sentence_and_document_iterators_match(tmp_path):
    (tmp_path / "sub").mkdir()
    (tmp_path / "a.txt").write_text("one line\n\n  two line \n", encoding="utf-8")
    (tmp_path / "sub" / "b.txt").write_text("three\nfour four\n", encoding="utf-8")
    assert (list(tokenization.BasicLineIterator(str(tmp_path / "a.txt")))
            == list(jtok.BasicLineIterator(str(tmp_path / "a.txt"))))
    assert (list(tokenization.FileSentenceIterator(str(tmp_path)))
            == list(jtok.FileSentenceIterator(str(tmp_path))))
    assert (list(tokenization.CollectionSentenceIterator(TEXTS))
            == list(jtok.CollectionSentenceIterator(TEXTS)))
    docs = [("text one", "a"), ("text two", "b")]
    got = [(d.content, d.labels) for d in tokenization.LabelAwareIterator(docs)]
    assert got == [(d.content, d.labels) for d in jtok.LabelAwareIterator(docs)]


@pytest.mark.parametrize("text", CJK_TEXTS)
def test_cjk_tokenizers_match(text):
    assert (tokenization.CJKTokenizerFactory().tokenize(text)
            == jtok.CJKTokenizerFactory().tokenize(text))
    for name in ("ChineseTokenizerFactory", "JapaneseTokenizerFactory",
                 "KoreanTokenizerFactory"):
        got = getattr(cjk, name)(user_dict=["天安门", "学校"]).tokenize(text)
        assert got == getattr(jcjk, name)(user_dict=["天安门", "学校"]).tokenize(text)


def test_cjk_lattice_tokenizer_protocol_matches():
    a = cjk.ChineseTokenizerFactory().create(CJK_TEXTS[-1])
    b = jcjk.ChineseTokenizerFactory().create(CJK_TEXTS[-1])
    assert a.count_tokens() == b.count_tokens()
    got, want = [], []
    while a.has_more_tokens():
        got.append(a.next_token())
    while b.has_more_tokens():
        want.append(b.next_token())
    assert got == want


def _vocab_state(cache):
    return ([(w.word, w.count, w.index, list(w.code), list(w.points)) for w in cache.words],
            cache.total_word_count)


@pytest.mark.parametrize("min_freq", [1, 3])
def test_vocab_and_huffman_equal(min_freq):
    sents = _corpus()
    a = vocab.VocabConstructor(min_freq).build(sents, special=("__label__x",))
    b = jvocab.VocabConstructor(min_freq).build(sents, special=("__label__x",))
    vocab.build_huffman(a)
    jvocab.build_huffman(b)
    assert _vocab_state(a) == _vocab_state(b)
    assert a.index_of("w1") == b.index_of("w1") and a.index_of("nope") == -1
    for got, want in zip(vocab.huffman_tables(a), jvocab.huffman_tables(b)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    for got, want in zip(vocab.huffman_tables(a, max_len=3), jvocab.huffman_tables(b, max_len=3)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(vocab.unigram_table(a), jvocab.unigram_table(b))
    np.testing.assert_array_equal(vocab.unigram_table(a, 0.5), jvocab.unigram_table(b, 0.5))
    for sample in (0.0, 1e-3, 1e-1):
        np.testing.assert_array_equal(vocab.subsample_probs(a, sample),
                                      jvocab.subsample_probs(b, sample))


def test_huffman_of_one_word_and_none():
    for n in (0, 1):
        a, b = vocab.VocabCache(), jvocab.VocabCache()
        for i in range(n):
            a.add(vocab.VocabWord(f"x{i}", 3))
            b.add(jvocab.VocabWord(f"x{i}", 3))
        vocab.build_huffman(a)
        jvocab.build_huffman(b)
        assert _vocab_state(a) == _vocab_state(b)


@pytest.mark.parametrize("cls", ["BagOfWordsVectorizer", "TfidfVectorizer"])
def test_vectorizers_match(cls):
    docs = _corpus(seed=3, n=12)
    kw = {} if cls == "BagOfWordsVectorizer" else {"smooth": False}
    for extra in ({}, kw):
        a = getattr(vectorizers, cls)(**extra)
        b = getattr(jvec, cls)(**extra)
        np.testing.assert_array_equal(a.fit_transform(docs), b.fit_transform(docs))
        np.testing.assert_array_equal(a.transform("w1 w2 w2 unknown"),
                                      b.transform("w1 w2 w2 unknown"))
        for got, want in zip(a.vectorize(docs[0], "b", ["a", "b"]),
                             b.vectorize(docs[0], "b", ["a", "b"])):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_viterbi_matches(seed):
    rs = np.random.RandomState(seed)
    labels = np.repeat(rs.randint(0, 4, 6), 5)
    noisy = labels.copy()
    flip = rs.rand(len(noisy)) < 0.15
    noisy[flip] = rs.randint(0, 4, flip.sum())
    for lab in (noisy, np.eye(4)[noisy]):
        lp, path = misc.Viterbi(4, 0.9, 0.95).decode(lab)
        jlp, jpath = jmisc.Viterbi(4, 0.9, 0.95).decode(lab)
        assert lp == jlp
        np.testing.assert_array_equal(path, jpath)
    with pytest.raises(ValueError):
        misc.Viterbi(1)


@pytest.mark.parametrize("rotate", [False, True])
def test_moving_window_matrix_matches(rotate):
    m = np.arange(30, dtype=np.float32).reshape(5, 6)
    got = misc.MovingWindowMatrix(m, 3, 2, add_rotate=rotate).window_list()
    want = jmisc.MovingWindowMatrix(m, 3, 2, add_rotate=rotate).window_list()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        misc.MovingWindowMatrix(m, 6, 2)
