"""GloVe embeddings on PyTorch (the port of the JAX package's
``nlp/glove.py``).

Capability parity with the reference's GloVe learning impl
(models/embeddings/learning/impl/elements/GloVe.java + models/glove/ —
SURVEY.md §2.7). The co-occurrence matrix builds on the host (a
string-processing pass, like the reference's co-occurrence pipeline);
training runs AdaGrad steps over batches of nonzero (i, j, X_ij) triples on
the model's device — gathers, the weighted-least-squares loss, and
scatter updates (``index_add_``).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nlp.embeddings import _cosine, _f32, _ids, _to_device
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, VocabConstructor


def _glove_step(params, wi, wj, xij, lr, x_max, alpha):
    """One AdaGrad batch: J = Σ f(X) (w_i·w̃_j + b_i + b̃_j - log X)².

    Updates the tables in place. The accumulators take their scatter
    first and the rates read them after it (``hW[wi]`` after the add), so
    a row repeated in the batch sees every repeat's squares, as in the JAX
    package."""
    W, Wc, b, bc = params["W"], params["Wc"], params["b"], params["bc"]
    hW, hWc, hb, hbc = params["hW"], params["hWc"], params["hb"], params["hbc"]

    vi = W[wi]
    vj = Wc[wj]
    diff = (vi * vj).sum(-1) + b[wi] + bc[wj] - torch.log(xij)
    f = torch.clamp((xij / x_max) ** alpha, max=1.0)
    loss = 0.5 * torch.mean(f * diff * diff)

    g = f * diff                                  # [B]
    gW = g[:, None] * vj
    gWc = g[:, None] * vi

    # AdaGrad accumulate + update (scatter)
    hW.index_add_(0, wi, gW * gW)
    hWc.index_add_(0, wj, gWc * gWc)
    hb.index_add_(0, wi, g * g)
    hbc.index_add_(0, wj, g * g)
    W.index_add_(0, wi, -lr * gW / torch.sqrt(hW[wi] + 1e-8))
    Wc.index_add_(0, wj, -lr * gWc / torch.sqrt(hWc[wj] + 1e-8))
    b.index_add_(0, wi, -lr * g / torch.sqrt(hb[wi] + 1e-8))
    bc.index_add_(0, wj, -lr * g / torch.sqrt(hbc[wj] + 1e-8))
    return {"W": W, "Wc": Wc, "b": b, "bc": bc,
            "hW": hW, "hWc": hWc, "hb": hb, "hbc": hbc}, loss


class Glove:
    """models/glove/Glove.java surface: build co-occurrences, fit, lookup.
    ``device``: None means the GPU (it raises with none); the CPU must be
    asked for with ``device="cpu"``."""

    def __init__(self, layer_size: int = 100, window: int = 5,
                 learning_rate: float = 0.05, epochs: int = 5,
                 min_word_frequency: int = 1, x_max: float = 100.0,
                 alpha: float = 0.75, batch_size: int = 1024, seed: int = 12345,
                 symmetric: bool = True, tokenizer_factory=None, device=None):
        from deeplearning4j_tpu_torch.nn.model import resolve_device

        self.layer_size = layer_size
        self.window = window
        self.lr = learning_rate
        self.epochs = epochs
        self.min_word_frequency = min_word_frequency
        self.x_max = x_max
        self.alpha = alpha
        self.batch_size = batch_size
        self.seed = seed
        self.symmetric = symmetric
        self.tokenizer_factory = tokenizer_factory
        self.device = resolve_device(device)
        self.vocab: Optional[VocabCache] = None
        self.params: Optional[dict] = None

    def _tokenize(self, sentences) -> List[List[str]]:
        from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizerFactory

        tok = self.tokenizer_factory or DefaultTokenizerFactory()
        return [tok.tokenize(s) if isinstance(s, str) else list(s) for s in sentences]

    def _cooccurrences(self, token_seqs) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        counts: Dict[Tuple[int, int], float] = defaultdict(float)
        for toks in token_seqs:
            idx = [self.vocab.index_of(t) for t in toks]
            idx = [i for i in idx if i >= 0]
            for i, wi in enumerate(idx):
                for off in range(1, self.window + 1):
                    j = i + off
                    if j >= len(idx):
                        break
                    w = 1.0 / off  # distance weighting, as GloVe does
                    counts[(wi, idx[j])] += w
                    if self.symmetric:
                        counts[(idx[j], wi)] += w
        ii = np.asarray([k[0] for k in counts], np.int32)
        jj = np.asarray([k[1] for k in counts], np.int32)
        xx = np.asarray(list(counts.values()), np.float32)
        return ii, jj, xx

    def fit(self, sentences) -> "Glove":
        token_seqs = self._tokenize(sentences() if callable(sentences) else sentences)
        if self.vocab is None:
            self.vocab = VocabConstructor(self.min_word_frequency).build(
                [" ".join(t) for t in token_seqs]
            )
        V, D = len(self.vocab), self.layer_size
        dev = self.device
        rs = np.random.RandomState(self.seed)
        init = {
            "W": (rs.rand(V, D).astype(np.float32) - 0.5) / D,
            "Wc": (rs.rand(V, D).astype(np.float32) - 0.5) / D,
            "b": np.zeros((V,), np.float32),
            "bc": np.zeros((V,), np.float32),
            "hW": np.full((V, D), 1e-8, np.float32),
            "hWc": np.full((V, D), 1e-8, np.float32),
            "hb": np.full((V,), 1e-8, np.float32),
            "hbc": np.full((V,), 1e-8, np.float32),
        }
        self.params = {k: _to_device(v, dev) for k, v in init.items()}
        ii, jj, xx = self._cooccurrences(token_seqs)
        if len(ii) == 0:
            return self
        for _ in range(self.epochs):
            order = rs.permutation(len(ii))
            for s in range(0, len(order), self.batch_size):
                sel = order[s:s + self.batch_size]
                self.params, _ = _glove_step(
                    self.params, _ids(ii[sel], V, dev, "rows"),
                    _ids(jj[sel], V, dev, "columns"), _to_device(xx[sel], dev),
                    _f32(self.lr), x_max=self.x_max, alpha=self.alpha)
        return self

    # -- lookup ------------------------------------------------------------
    @property
    def syn0(self) -> np.ndarray:
        """W + Wc for the whole vocabulary, on the host."""
        return (self.params["W"] + self.params["Wc"]).cpu().numpy()

    def get_word_vector(self, word: str) -> Optional[np.ndarray]:
        """The word's row of W + Wc, copied alone from the device."""
        i = self.vocab.index_of(word)
        if i < 0:
            return None
        return (self.params["W"][i] + self.params["Wc"][i]).cpu().numpy()

    def similarity(self, a: str, b: str) -> float:
        return _cosine(self.get_word_vector(a), self.get_word_vector(b))
