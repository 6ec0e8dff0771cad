"""Tokenizers, token preprocessors, sentence/document iterators.

Capability parity with the reference's text pipeline
(deeplearning4j-nlp-parent/deeplearning4j-nlp/.../text/: tokenization/
tokenizerfactory/DefaultTokenizerFactory, NGramTokenizerFactory,
tokenization/tokenizer/preprocessor/CommonPreprocessor,
sentenceiterator/{BasicLineIterator,CollectionSentenceIterator,
FileSentenceIterator}, documentiterator/LabelAwareIterator — SURVEY.md §2.7
'Text pipeline' row). Host-side text handling; the device sees only index
arrays.
"""

from __future__ import annotations

import os
import re
import string
from typing import Callable, Iterable, Iterator, List, Optional, Sequence, Tuple


class CommonPreprocessor:
    """Lowercase + strip punctuation (preprocessor/CommonPreprocessor.java)."""

    _PUNCT = re.compile(r"[\d\.:,\"'\(\)\[\]|/?!;]+")

    def pre_process(self, token: str) -> str:
        return self._PUNCT.sub("", token).lower()

    __call__ = pre_process


class LowCasePreprocessor:
    def pre_process(self, token: str) -> str:
        return token.lower()

    __call__ = pre_process


class DefaultTokenizer:
    """Whitespace tokenizer with optional per-token preprocessor
    (tokenizer/DefaultTokenizer.java)."""

    def __init__(self, text: str, pre: Optional[Callable] = None):
        self._tokens = [t for t in text.split() if t]
        if pre is not None:
            self._tokens = [p for p in (pre(t) for t in self._tokens) if p]

    def get_tokens(self) -> List[str]:
        return list(self._tokens)

    def __iter__(self):
        return iter(self._tokens)


class DefaultTokenizerFactory:
    """tokenizerfactory/DefaultTokenizerFactory.java."""

    def __init__(self):
        self._pre: Optional[Callable] = None

    def set_token_pre_processor(self, pre: Callable):
        self._pre = pre
        return self

    def create(self, text: str) -> DefaultTokenizer:
        return DefaultTokenizer(text, self._pre)

    def tokenize(self, text: str) -> List[str]:
        return self.create(text).get_tokens()


class NGramTokenizerFactory(DefaultTokenizerFactory):
    """n-gram over the base tokens (NGramTokenizerFactory.java)."""

    def __init__(self, min_n: int = 1, max_n: int = 2):
        super().__init__()
        self.min_n, self.max_n = min_n, max_n

    def tokenize(self, text: str) -> List[str]:
        base = super().tokenize(text)
        out: List[str] = []
        for n in range(self.min_n, self.max_n + 1):
            for i in range(len(base) - n + 1):
                out.append(" ".join(base[i:i + n]))
        return out


# -- sentence / document iterators ------------------------------------------

class CollectionSentenceIterator:
    """In-memory list of sentences (CollectionSentenceIterator.java)."""

    def __init__(self, sentences: Sequence[str]):
        self.sentences = list(sentences)

    def __iter__(self) -> Iterator[str]:
        return iter(self.sentences)

    def reset(self):
        pass


class BasicLineIterator:
    """One sentence per line from a file (BasicLineIterator.java)."""

    def __init__(self, path: str):
        self.path = path

    def __iter__(self) -> Iterator[str]:
        with open(self.path, encoding="utf-8", errors="replace") as f:
            for line in f:
                line = line.strip()
                if line:
                    yield line

    def reset(self):
        pass


class FileSentenceIterator:
    """Every file under a directory, one sentence per line
    (FileSentenceIterator.java)."""

    def __init__(self, root: str):
        self.root = root

    def __iter__(self) -> Iterator[str]:
        for dirpath, _, files in sorted(os.walk(self.root)):
            for fn in sorted(files):
                yield from BasicLineIterator(os.path.join(dirpath, fn))

    def reset(self):
        pass


class LabelledDocument:
    """documentiterator/LabelledDocument.java."""

    def __init__(self, content: str, labels: Sequence[str]):
        self.content = content
        self.labels = list(labels)


class LabelAwareIterator:
    """Documents with labels, for ParagraphVectors
    (documentiterator/LabelAwareIterator.java). Wraps (text, label) pairs."""

    def __init__(self, docs: Sequence[Tuple[str, str]]):
        self.docs = [LabelledDocument(t, [l]) for t, l in docs]

    def __iter__(self) -> Iterator[LabelledDocument]:
        return iter(self.docs)

    def reset(self):
        pass


# ---------------------------------------------------------------------------
# CJK tokenization (deeplearning4j-nlp-chinese / -japanese / -korean)
# ---------------------------------------------------------------------------

_CJK_RANGES = (
    (0x4E00, 0x9FFF),    # CJK Unified Ideographs
    (0x3400, 0x4DBF),    # CJK Extension A
    (0xF900, 0xFAFF),    # CJK Compatibility Ideographs
    (0x3040, 0x309F),    # Hiragana
    (0x30A0, 0x30FF),    # Katakana
    (0xAC00, 0xD7AF),    # Hangul Syllables
    (0x1100, 0x11FF),    # Hangul Jamo
    (0x20000, 0x3FFFF),  # supplementary-plane ideographs (Ext B-G + compat)
)


def _is_cjk(ch: str) -> bool:
    cp = ord(ch)
    return any(lo <= cp <= hi for lo, hi in _CJK_RANGES)


class CJKTokenizer:
    """Dictionary-free CJK segmentation by character bigrams.

    Scope stand-in for the reference's bundled third-party analyzers
    (deeplearning4j-nlp-chinese: ansj ~9.5K LoC, -japanese: kuromoji ~6.8K
    LoC, -korean glue): those embed dictionary-driven morphological
    analysis this framework deliberately does not vendor (README
    "Deliberate descopes"). The overlapping-bigram scheme here is the
    classic dictionary-free IR fallback (Lucene CJKAnalyzer): embedding
    quality on CJK corpora is serviceable, morphology is not attempted.
    Latin/digit runs inside CJK text are kept as whole tokens; a true
    morphological analyzer can be plugged in as a ``tokenizer_factory``.
    """

    def __init__(self, text: str, preprocessor: Optional[Callable[[str], str]] = None):
        self._tokens: List[str] = []
        run: List[str] = []      # pending CJK character run
        word: List[str] = []     # pending non-CJK word run

        def flush_run():
            if len(run) == 1:
                self._tokens.append(run[0])
            else:
                self._tokens.extend(run[i] + run[i + 1]
                                    for i in range(len(run) - 1))
            run.clear()

        def flush_word():
            if word:
                self._tokens.append("".join(word))
                word.clear()

        for ch in text:
            if _is_cjk(ch):
                flush_word()
                run.append(ch)
            elif ch.isalnum():
                if run:
                    flush_run()
                word.append(ch)
            else:
                flush_word()
                if run:
                    flush_run()
        flush_word()
        if run:
            flush_run()
        if preprocessor is not None:
            self._tokens = [t for t in (preprocessor(t) for t in self._tokens) if t]
        self._i = 0

    def has_more_tokens(self) -> bool:
        return self._i < len(self._tokens)

    def next_token(self) -> str:
        t = self._tokens[self._i]
        self._i += 1
        return t

    def get_tokens(self) -> List[str]:
        return list(self._tokens)

    def count_tokens(self) -> int:
        return len(self._tokens)


class CJKTokenizerFactory:
    """TokenizerFactory over :class:`CJKTokenizer` (the reference's
    ChineseTokenizerFactory / JapaneseTokenizerFactory surface)."""

    def __init__(self, preprocessor: Optional[Callable[[str], str]] = None):
        self.preprocessor = preprocessor

    def set_token_pre_processor(self, pre: Callable):
        """Same factory surface as DefaultTokenizerFactory — the two are
        drop-in interchangeable."""
        self.preprocessor = pre
        return self

    def create(self, text: str) -> CJKTokenizer:
        return CJKTokenizer(text, self.preprocessor)

    def tokenize(self, text: str) -> List[str]:
        return self.create(text).get_tokens()
