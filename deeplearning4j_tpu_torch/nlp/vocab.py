"""Vocabulary construction + Huffman coding.

Capability parity with the reference's vocab machinery
(models/word2vec/wordstore/VocabConstructor.java:31 buildJointVocabulary:167,
wordstore/inmemory/AbstractCache, models/word2vec/VocabWord,
models/word2vec/Huffman.java — SURVEY.md §2.7). Counting is host-side (it is
IO-bound string work); the output is index arrays + Huffman code tables the
trainers upload to the device.
"""

from __future__ import annotations

import heapq
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np


class VocabWord:
    """models/word2vec/VocabWord.java: word + frequency + Huffman code."""

    __slots__ = ("word", "count", "index", "code", "points")

    def __init__(self, word: str, count: int = 1, index: int = -1):
        self.word = word
        self.count = count
        self.index = index
        self.code: List[int] = []     # Huffman bits (0/1)
        self.points: List[int] = []   # inner-node indices on the root path

    def __repr__(self):
        return f"VocabWord({self.word!r}, count={self.count}, idx={self.index})"


class VocabCache:
    """In-memory vocab store (wordstore/inmemory/AbstractCache.java)."""

    def __init__(self):
        self.words: List[VocabWord] = []
        self._by_word: Dict[str, VocabWord] = {}
        self.total_word_count = 0

    def add(self, vw: VocabWord):
        vw.index = len(self.words)
        self.words.append(vw)
        self._by_word[vw.word] = vw

    def __contains__(self, word: str) -> bool:
        return word in self._by_word

    def __len__(self) -> int:
        return len(self.words)

    def word_for(self, word: str) -> Optional[VocabWord]:
        return self._by_word.get(word)

    def index_of(self, word: str) -> int:
        vw = self._by_word.get(word)
        return vw.index if vw is not None else -1

    def word_at(self, index: int) -> str:
        return self.words[index].word

    def counts(self) -> np.ndarray:
        return np.asarray([w.count for w in self.words], np.float64)


class VocabConstructor:
    """Count tokens over sentence iterables, apply min_word_frequency, sort
    by frequency (VocabConstructor.buildJointVocabulary:167)."""

    def __init__(self, min_word_frequency: int = 5, tokenizer=None):
        self.min_word_frequency = min_word_frequency
        self.tokenizer = tokenizer

    def build(self, sentences: Iterable, special: Sequence[str] = ()) -> VocabCache:
        from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizerFactory

        tok = self.tokenizer or DefaultTokenizerFactory()
        counts: Counter = Counter()
        total = 0
        for s in sentences:
            toks = tok.tokenize(s) if isinstance(s, str) else list(s)
            counts.update(toks)
            total += len(toks)
        cache = VocabCache()
        for w in special:  # labels/special tokens survive min-frequency
            cache.add(VocabWord(w, counts.pop(w, 1)))
        for w, c in sorted(counts.items(), key=lambda kv: (-kv[1], kv[0])):
            if c >= self.min_word_frequency:
                cache.add(VocabWord(w, c))
        cache.total_word_count = total
        return cache


def build_huffman(cache: VocabCache, max_code_length: int = 40):
    """Assign Huffman codes/points to every vocab word
    (models/word2vec/Huffman.java). Inner nodes are numbered 0..V-2; the
    root path is stored leaf→root REVERSED to root→leaf, as word2vec does."""
    V = len(cache)
    if V == 0:
        return
    if V == 1:
        cache.words[0].code = [0]
        cache.words[0].points = [0]
        return
    heap: List = []
    for i, w in enumerate(cache.words):
        heapq.heappush(heap, (w.count, i, None))
    next_inner = 0
    parent: Dict[int, tuple] = {}  # node id -> (parent_inner_idx, bit)
    # node ids: leaves 0..V-1, inner nodes V..2V-2 (inner index = id - V)
    nid = V
    while len(heap) > 1:
        c1, id1, _ = heapq.heappop(heap)
        c2, id2, _ = heapq.heappop(heap)
        inner_idx = nid - V
        parent[id1] = (nid, 0)
        parent[id2] = (nid, 1)
        heapq.heappush(heap, (c1 + c2, nid, None))
        nid += 1
    root_id = heap[0][1]
    for i, w in enumerate(cache.words):
        code: List[int] = []
        points: List[int] = []
        node = i
        while node != root_id:
            pid, bit = parent[node]
            code.append(bit)
            points.append(pid - V)
            node = pid
        w.code = list(reversed(code))[:max_code_length]
        w.points = list(reversed(points))[:max_code_length]


def huffman_tables(cache: VocabCache, max_len: Optional[int] = None):
    """Pack codes/points into padded arrays for the HS trainers:
    (codes [V,L], points [V,L], mask [V,L])."""
    if not cache.words or not cache.words[0].code:
        build_huffman(cache)
    L = max_len or max(len(w.code) for w in cache.words)
    V = len(cache)
    codes = np.zeros((V, L), np.float32)
    points = np.zeros((V, L), np.int32)
    mask = np.zeros((V, L), np.float32)
    for i, w in enumerate(cache.words):
        n = min(len(w.code), L)
        codes[i, :n] = w.code[:n]
        points[i, :n] = w.points[:n]
        mask[i, :n] = 1.0
    return codes, points, mask


def unigram_table(cache: VocabCache, power: float = 0.75) -> np.ndarray:
    """Negative-sampling distribution: counts^0.75 normalized (the word2vec
    unigram table, used by SkipGram.java negative sampling)."""
    p = cache.counts() ** power
    return (p / p.sum()).astype(np.float64)


def subsample_probs(cache: VocabCache, sample: float = 1e-3) -> np.ndarray:
    """Per-word KEEP probability under frequent-word subsampling
    (word2vec's subsampling formula)."""
    if sample <= 0:
        return np.ones(len(cache), np.float64)
    freq = cache.counts() / max(cache.total_word_count, 1)
    keep = np.sqrt(sample / np.maximum(freq, 1e-12)) + sample / np.maximum(freq, 1e-12)
    return np.clip(keep, 0.0, 1.0)
