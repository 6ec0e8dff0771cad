"""CJK morphological tokenization: lattice Viterbi segmentation.

Capability parity target (SURVEY.md §2.7 CJK row): the reference vendors
full third-party morphological analyzers — ansj for Chinese
(deeplearning4j-nlp-chinese, ~9.5K LoC + dictionaries), kuromoji for
Japanese (deeplearning4j-nlp-japanese, ~6.8K LoC + IPADIC), and
open-korean-text glue (deeplearning4j-nlp-korean) — each a Viterbi lattice
over a lexicon with word/connection costs plus an unknown-word model.

This module implements that same ALGORITHMIC core natively:

- :class:`LatticeSegmenter` — a Viterbi shortest-path over a word lattice:
  dictionary edges from a cost-weighted lexicon (longest-match prefix scan),
  unknown-word edges from a script-class model (same-script runs group,
  singletons carry a penalty), additive costs (no connection matrix — the
  documented simplification vs ansj/kuromoji).
- Per-language factories with COMPACT embedded lexicons (high-frequency
  function words, particles and everyday vocabulary) and ``user_dict``
  extension — the kuromoji UserDictionary / ansj UserDefineLibrary surface.

Scope, stated plainly: the embedded lexicons are a few hundred entries, not
the reference's megabyte dictionaries; part-of-speech tags, readings and
named-entity recognizers are out of scope. What IS equivalent: genuine
dictionary-driven segmentation (not the char-bigram fallback in
tokenization.py), user dictionaries, per-script unknown-word handling, and
the reference factory surface (ChineseTokenizerFactory /
JapaneseTokenizerFactory / KoreanTokenizerFactory names).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple

# ---------------------------------------------------------------------------
# script classes
# ---------------------------------------------------------------------------


def _script(ch: str) -> str:
    cp = ord(ch)
    if (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0xF900 <= cp <= 0xFAFF
            or 0x20000 <= cp <= 0x3FFFF):   # supplementary-plane ideographs
        return "han"
    if 0x3040 <= cp <= 0x309F:
        return "hiragana"
    if 0x30A0 <= cp <= 0x30FF or 0xFF66 <= cp <= 0xFF9F:  # + half-width
        return "katakana"
    if 0xAC00 <= cp <= 0xD7A3 or 0x1100 <= cp <= 0x11FF:
        return "hangul"
    if ch.isdigit():
        return "digit"
    if ch.isalpha():
        return "latin"
    if ch.isspace():
        return "space"
    return "other"


# ---------------------------------------------------------------------------
# lattice segmenter
# ---------------------------------------------------------------------------


class LatticeSegmenter:
    """Viterbi shortest path over the segmentation lattice of a string.

    ``lexicon``: {word: cost} — LOWER is preferred; typical range 1-10.
    Unknown-word edges: a run of same-script characters costs
    ``unk_base + unk_per_char * len`` (runs group); a single character
    always has a fallback edge so segmentation never fails.
    """

    def __init__(self, lexicon: Dict[str, float], *, unk_base: float = 12.0,
                 unk_per_char: float = 1.0):
        self.lexicon = dict(lexicon)
        self.unk_base = unk_base
        self.unk_per_char = unk_per_char
        self.max_len = max((len(w) for w in self.lexicon), default=1)
        # prefix set for the longest-match scan (trie-lite: Python dict
        # lookups on slices beat a pointer trie at these lexicon sizes)
        self._prefixes = {w[:i] for w in self.lexicon for i in range(1, len(w))}

    def add(self, word: str, cost: float = 2.0):
        self.lexicon[word] = cost
        self.max_len = max(self.max_len, len(word))
        for i in range(1, len(word)):
            self._prefixes.add(word[:i])

    def segment(self, text: str) -> List[str]:
        n = len(text)
        if n == 0:
            return []
        INF = float("inf")
        best = [INF] * (n + 1)
        back: List[Tuple[int, str]] = [(-1, "")] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] == INF:
                continue
            # dictionary edges (longest-match scan, pruned by prefixes)
            j = i + 1
            limit = min(n, i + self.max_len)
            while j <= limit:
                w = text[i:j]
                cost = self.lexicon.get(w)
                if cost is not None and best[i] + cost < best[j]:
                    best[j] = best[i] + cost
                    back[j] = (i, w)
                if j < limit and w not in self._prefixes and w not in self.lexicon:
                    break
                j += 1
            # unknown edges. Whole-run grouping only for scripts whose
            # unknown words ARE runs (katakana loan words, latin, digits,
            # hangul eojeol); han/hiragana unknowns fall back to single
            # characters so dictionary hits next to them still win.
            sc = _script(text[i])
            if sc in ("katakana", "latin", "digit", "hangul"):
                k = i + 1
                while k < n and _script(text[k]) == sc:
                    k += 1
                c = best[i] + self.unk_base + self.unk_per_char * (k - i)
                if c < best[k]:
                    best[k] = c
                    back[k] = (i, text[i:k])
            c = best[i] + self.unk_base + self.unk_per_char + 2.0
            if c < best[i + 1]:
                best[i + 1] = c
                back[i + 1] = (i, text[i])
        # backtrace
        out: List[str] = []
        pos = n
        while pos > 0:
            i, w = back[pos]
            out.append(w)
            pos = i
        out.reverse()
        return out


# ---------------------------------------------------------------------------
# embedded lexicons (compact high-frequency sets; costs: common=1-2,
# ordinary=3-4). Extend per instance via user_dict.
# ---------------------------------------------------------------------------

_ZH_LEXICON = {w: c for c, ws in {
    1.0: ["的", "了", "是", "在", "我", "有", "和", "就", "不", "人", "都",
          "一个", "我们", "你们", "他们", "这个", "那个", "什么", "没有",
          "可以", "自己", "这", "那", "他", "她", "它", "你", "与", "也"],
    2.0: ["中国", "北京", "上海", "今天", "明天", "现在", "时候", "时间",
          "知道", "觉得", "喜欢", "学习", "工作", "朋友", "老师", "学生",
          "问题", "世界", "国家", "地方", "东西", "事情", "孩子", "因为",
          "所以", "但是", "如果", "已经", "还是", "或者", "非常", "很",
          "大", "小", "多", "少", "好", "新", "来", "去", "说", "看",
          "想", "要", "会", "能", "到", "从", "对", "给", "被", "把"],
    3.0: ["深度", "机器", "模型", "数据", "训练", "神经", "网络",
          "语言", "文字", "科学", "技术", "公司", "大学", "电脑", "手机",
          "经济", "历史", "文化", "音乐", "电影", "汉语", "英语", "高兴",
          "漂亮", "便宜", "开始", "结束", "帮助", "希望", "认为", "发现"],
}.items() for w in ws}

_JA_LEXICON = {w: c for c, ws in {
    1.0: ["の", "は", "が", "を", "に", "で", "と", "も", "へ", "や",
          "から", "まで", "より", "です", "ます", "でした", "ました",
          "ない", "する", "した", "いる", "ある", "なる", "これ", "それ",
          "あれ", "この", "その", "あの", "私", "あなた", "何", "だ"],
    2.0: ["日本", "東京", "今日", "明日", "時間", "学生", "先生", "学校",
          "会社", "仕事", "友達", "言葉", "世界", "問題", "勉強", "研究",
          "大学", "電車", "天気", "映画", "音楽", "料理", "好き", "大きい",
          "小さい", "新しい", "行く", "来る", "見る", "食べる", "飲む",
          "読む", "書く", "話す", "聞く", "思う", "言う", "知る", "とても"],
    3.0: ["機械", "学習", "深層", "モデル", "データ", "訓練", "計算",
          "言語", "科学", "技術", "自然", "処理", "人工", "知能"],
}.items() for w in ws}

# Korean postpositions (josa) and common endings — suffix-stripped from
# space-delimited words (the open-korean-text stemming surface)
_KO_JOSA = ["은", "는", "이", "가", "을", "를", "의", "에", "에서", "에게",
            "께", "와", "과", "랑", "이랑", "로", "으로", "부터", "까지",
            "만", "도", "보다", "처럼", "같이", "하고", "이나", "나", "요"]
_KO_JOSA_BY_LEN = sorted(_KO_JOSA, key=len, reverse=True)

# josa as first-class lattice entries: the segmenter itself splits
# "학교에서" -> 학교 + 에서 (the word_filter below covers unknown stems)
# one entry per surface form: words listed in a tier must NOT repeat in
# _KO_JOSA (the josa cost is authoritative for shared surfaces like 이/나/보다)
_KO_LEXICON = {j: 1.2 for j in _KO_JOSA}
_KO_LEXICON.update({w: c for c, ws in {
    1.0: ["그", "저", "것", "수", "안", "못", "더", "잘", "또",
          "하다", "있다", "없다", "되다", "이다", "아니다", "우리", "나",
          "너", "그리고", "그러나", "하지만", "그래서"],
    2.0: ["한국", "서울", "오늘", "내일", "시간", "학생", "선생님", "학교",
          "회사", "일", "친구", "말", "세계", "문제", "공부", "연구",
          "대학", "날씨", "영화", "음악", "음식", "사람", "사랑", "좋다",
          "크다", "작다", "새롭다", "가다", "오다", "먹다",
          "마시다", "읽다", "쓰다", "말하다", "듣다", "생각하다", "알다"],
    3.0: ["기계", "학습", "심층", "모델", "데이터", "훈련", "계산", "언어",
          "과학", "기술", "자연", "처리", "인공", "지능"],
}.items() for w in ws})


# ---------------------------------------------------------------------------
# tokenizers / factories (the reference factory surface)
# ---------------------------------------------------------------------------


class _LatticeTokenizer:
    """Tokenizer over a LatticeSegmenter; non-CJK runs (latin words,
    numbers) pass through whole; whitespace/punctuation separate."""

    def __init__(self, text: str, seg: LatticeSegmenter,
                 pre: Optional[Callable[[str], str]] = None,
                 word_filter: Optional[Callable[[str], List[str]]] = None):
        toks: List[str] = []
        buf: List[str] = []
        buf_kind = None  # "cjk" | "word"

        def flush():
            nonlocal buf_kind
            if not buf:
                return
            chunk = "".join(buf)
            if buf_kind == "cjk":
                toks.extend(seg.segment(chunk))
            else:
                toks.append(chunk)
            buf.clear()
            buf_kind = None

        for ch in text:
            sc = _script(ch)
            if sc in ("han", "hiragana", "katakana", "hangul"):
                if buf_kind != "cjk":
                    flush()
                buf_kind = "cjk"
                buf.append(ch)
            elif sc in ("latin", "digit"):
                if buf_kind != "word":
                    flush()
                buf_kind = "word"
                buf.append(ch)
            else:
                flush()
        flush()
        if word_filter is not None:
            toks = [t for w in toks for t in word_filter(w)]
        if pre is not None:
            toks = [t for t in (pre(t) for t in toks) if t]
        self._tokens = toks
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


class _BaseCJKFactory:
    """Shared factory plumbing (user_dict, preprocessor, tokenize)."""

    _lexicon: Dict[str, float] = {}

    def __init__(self, user_dict: Optional[Iterable[str]] = None,
                 preprocessor: Optional[Callable[[str], str]] = None):
        self.preprocessor = preprocessor
        self._seg = LatticeSegmenter(dict(self._lexicon))
        for w in user_dict or ():
            self._seg.add(w, 1.5)     # user entries outrank built-ins

    def add_word(self, word: str, cost: float = 1.5):
        """ansj UserDefineLibrary.insertWord / kuromoji UserDictionary."""
        self._seg.add(word, cost)
        return self

    def set_token_pre_processor(self, pre: Callable):
        self.preprocessor = pre
        return self

    def _word_filter(self, w: str) -> List[str]:
        return [w]

    def create(self, text: str) -> _LatticeTokenizer:
        return _LatticeTokenizer(text, self._seg, self.preprocessor,
                                 self._word_filter)

    def tokenize(self, text: str) -> List[str]:
        return self.create(text).get_tokens()


class ChineseTokenizerFactory(_BaseCJKFactory):
    """Dictionary-lattice Chinese segmentation
    (tokenizerfactory/ChineseTokenizerFactory.java over ansj's
    ToAnalysis — NlpAnalysis' extra NER layers are out of scope)."""

    _lexicon = _ZH_LEXICON


class JapaneseTokenizerFactory(_BaseCJKFactory):
    """Dictionary-lattice Japanese segmentation
    (tokenizerfactory/JapaneseTokenizerFactory.java over kuromoji).
    Katakana loan-word runs group via the unknown-word script model;
    ``baseForm`` conjugation lookup is out of scope."""

    _lexicon = _JA_LEXICON


class KoreanTokenizerFactory(_BaseCJKFactory):
    """Korean tokenization (tokenizerfactory/KoreanTokenizerFactory.java
    over open-korean-text): lattice over hangul runs, then josa
    (postposition) stripping — the morphological normalization that makes
    '학교에서' and '학교' share an embedding row."""

    _lexicon = _KO_LEXICON

    def _word_filter(self, w: str) -> List[str]:
        # suffix-strip the longest matching particle, keep both morphemes
        if len(w) >= 2 and _script(w[0]) == "hangul" and w not in self._seg.lexicon:
            for josa in _KO_JOSA_BY_LEN:
                if w.endswith(josa) and len(w) > len(josa):
                    return [w[:-len(josa)], josa]
        return [w]
