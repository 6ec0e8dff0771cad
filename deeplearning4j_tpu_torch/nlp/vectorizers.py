"""Bag-of-words / TF-IDF vectorizers.

Parity: bagofwords/vectorizer/ (BagOfWordsVectorizer, TfidfVectorizer:
fit over a corpus builds the vocab + document frequencies;
transform(document) -> vector; vectorize(text, label) -> DataSet). The
reference runs per-document Java loops; here transform of a batch is a
single [n_docs, V] count matrix built host-side then any model math on
device.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, VocabConstructor


class BagOfWordsVectorizer:
    """Count vectors over a fitted vocab."""

    def __init__(self, min_word_frequency: int = 1, tokenizer=None):
        self.min_word_frequency = min_word_frequency
        self.tokenizer = tokenizer
        self.vocab: Optional[VocabCache] = None

    def _tokenize(self, doc) -> List[str]:
        if isinstance(doc, str):
            if self.tokenizer is not None:
                return self.tokenizer.tokenize(doc)
            return doc.split()
        return list(doc)

    def fit(self, docs: Iterable) -> "BagOfWordsVectorizer":
        token_docs = [self._tokenize(d) for d in docs]
        vc = VocabConstructor(self.min_word_frequency, tokenizer=_Identity())
        self.vocab = vc.build(token_docs)
        self._post_fit(token_docs)
        return self

    def _post_fit(self, token_docs: List[List[str]]) -> None:
        pass

    @property
    def vocab_size(self) -> int:
        return len(self.vocab) if self.vocab else 0

    def transform(self, docs) -> np.ndarray:
        """docs: one document or a sequence -> [n_docs, V] float32."""
        if isinstance(docs, str):
            docs = [docs]
        out = np.zeros((len(docs), self.vocab_size), np.float32)
        for i, d in enumerate(docs):
            for t in self._tokenize(d):
                j = self.vocab.index_of(t)
                if j >= 0:
                    out[i, j] += 1.0
        return self._weight(out)

    def _weight(self, counts: np.ndarray) -> np.ndarray:
        return counts

    def fit_transform(self, docs: Sequence) -> np.ndarray:
        self.fit(docs)
        return self.transform(list(docs))

    def vectorize(self, text: str, label: str, labels: Sequence[str]):
        """(features, one-hot label) pair — the reference's
        vectorize(text, label) -> DataSet surface."""
        x = self.transform([text])[0]
        y = np.zeros(len(labels), np.float32)
        y[list(labels).index(label)] = 1.0
        return x, y


class TfidfVectorizer(BagOfWordsVectorizer):
    """tf-idf weighting: tf * log(N / df) (TfidfVectorizer.java's
    formulation; smooth=True uses log((1+N)/(1+df)) + 1)."""

    def __init__(self, min_word_frequency: int = 1, tokenizer=None,
                 smooth: bool = True):
        super().__init__(min_word_frequency, tokenizer)
        self.smooth = smooth
        self.idf: Optional[np.ndarray] = None

    def _post_fit(self, token_docs: List[List[str]]) -> None:
        n_docs = len(token_docs)
        df = np.zeros(self.vocab_size, np.float64)
        for toks in token_docs:
            for j in {self.vocab.index_of(t) for t in toks}:
                if j >= 0:
                    df[j] += 1.0
        if self.smooth:
            self.idf = (np.log((1.0 + n_docs) / (1.0 + df)) + 1.0).astype(np.float32)
        else:
            self.idf = np.log(np.maximum(n_docs / np.maximum(df, 1.0), 1.0)).astype(np.float32)

    def _weight(self, counts: np.ndarray) -> np.ndarray:
        return counts * self.idf[None, :]


class _Identity:
    def tokenize(self, s):
        return list(s) if not isinstance(s, str) else s.split()
