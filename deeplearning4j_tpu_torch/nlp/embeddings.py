"""SequenceVectors / Word2Vec / ParagraphVectors on PyTorch (the port of the
JAX package's ``nlp/embeddings.py``).

Capability parity with the reference's embedding stack (SURVEY.md §2.7):
models/sequencevectors/SequenceVectors.java:49 (fit:192, trainSequence:342),
learning/impl/elements/{SkipGram,CBOW}.java, models/word2vec/Word2Vec.java,
models/paragraphvectors/ParagraphVectors.java,
models/embeddings/inmemory/InMemoryLookupTable.java.

Training pairs are generated on the host into batched index arrays, as in
the JAX package, and each batch is one step of plain PyTorch on the
model's device: gathers of the embedding rows, a dot-product logistic loss
(negative sampling) or Huffman hierarchical softmax, and scatter-adds back
(``index_add_``, which sums duplicate indices as ``.at[].add`` does). The
steps update the tables in place, as the JAX package's donated buffers
are. Every host draw (subsampling, windows, host negatives, permutations)
comes from the same ``numpy.random.RandomState`` stream in the same order
as in the JAX package; the epoch-scan path draws its negatives on the
device from a ``torch.Generator`` seeded from that stream.

Index arrays are checked on the host before they are uploaded: a gather
on a CUDA tensor with an index out of range stops the process with a
device-side assert, where XLA would clamp it.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nlp.vocab import (
    VocabCache,
    VocabConstructor,
    build_huffman,
    huffman_tables,
    subsample_probs,
    unigram_table,
)

# ---------------------------------------------------------------------------
# device steps
# ---------------------------------------------------------------------------


def _others(params, *keys) -> dict:
    return {k: v for k, v in params.items() if k not in keys}


def _ns_loss(pos_dot, neg_dot):
    return -torch.mean(F.logsigmoid(pos_dot) + F.logsigmoid(-neg_dot).sum(-1))


def _sg_ns_step(params, centers, contexts, negs, lr):
    """Skip-gram negative sampling: one batch, full update.

    centers/contexts: [B] int64; negs: [B,K] int64; lr: a float or a 0-d
    f32 tensor. loss = -log σ(c·t) - Σ log σ(-c·n). Every gradient comes
    from the rows gathered before any update; syn1neg takes the context
    update, then the negatives' (duplicates summed).
    """
    syn0, syn1 = params["syn0"], params["syn1neg"]
    c = syn0[centers]                       # [B,D]
    t = syn1[contexts]                      # [B,D]
    n = syn1[negs]                          # [B,K,D]

    pos_dot = (c * t).sum(-1)                             # [B]
    neg_dot = torch.einsum("bd,bkd->bk", c, n)            # [B,K]
    loss = _ns_loss(pos_dot, neg_dot)

    gpos = torch.sigmoid(pos_dot) - 1.0                   # [B]
    gneg = torch.sigmoid(neg_dot)                         # [B,K]
    d_c = gpos[:, None] * t + torch.einsum("bk,bkd->bd", gneg, n)
    d_t = gpos[:, None] * c
    d_n = gneg[..., None] * c[:, None, :]

    syn0.index_add_(0, centers, -lr * d_c)
    syn1.index_add_(0, contexts, -lr * d_t)
    syn1.index_add_(0, negs.reshape(-1), -lr * d_n.reshape(-1, d_n.shape[-1]))
    return {"syn0": syn0, "syn1neg": syn1, **_others(params, "syn0", "syn1neg")}, loss


def _device_negatives(cum_table, generator, batch: int, negative: int):
    """[batch, negative] negatives by inverse CDF over the f32 cumulative
    unigram table: uniforms from ``generator`` on the table's device, the
    left-side ``searchsorted``, clipped to V - 1."""
    u = torch.rand((batch, negative), generator=generator, device=cum_table.device)
    return torch.searchsorted(cum_table, u).clamp_(max=cum_table.shape[0] - 1)


def _sg_ns_epoch_scan(params, centers2d, contexts2d, cum_table, generator,
                      lr0, min_lr, seen0, total, negative: int, unroll: int = 4):
    """_sg_ns_step over [N, B] pair chunks uploaded once, negatives drawn on
    the device (:func:`_device_negatives`, one draw per batch from
    ``generator``). ``seen`` is an f32 carry and the rate is computed in
    f32, ``max(lr0 * (1 - min(seen / total, 1)), min_lr)``, as the JAX
    package's ``lax.scan`` body does. ``unroll`` is accepted for the JAX
    signature and has no effect here: eager PyTorch launches each batch's
    step as it comes. Returns the params and the [N] losses."""
    del unroll
    N, B = centers2d.shape
    dev = centers2d.device
    f32 = dict(dtype=torch.float32, device=dev)
    lr0 = torch.as_tensor(lr0, **f32)
    min_lr = torch.as_tensor(min_lr, **f32)
    total = torch.as_tensor(total, **f32)
    seen = torch.as_tensor(seen0, **f32)
    losses = []
    for i in range(N):
        negs = _device_negatives(cum_table, generator, B, negative)
        frac = torch.clamp(seen / total, max=1.0)
        lr = torch.maximum(lr0 * (1.0 - frac), min_lr)
        params, loss = _sg_ns_step(params, centers2d[i], contexts2d[i], negs, lr)
        losses.append(loss)
        seen = seen + B
    return params, torch.stack(losses)


def _window_mean(syn0, context_win, win_mask, extra=None):
    ctx = syn0[context_win]                                  # [B,W,D]
    s = (ctx * win_mask[..., None]).sum(1)
    if extra is None:
        cnt = win_mask.sum(-1, keepdim=True).clamp(min=1.0)
        return s / cnt, cnt
    cnt = win_mask.sum(-1, keepdim=True) + 1.0               # + the doc vector
    return (s + extra) / cnt, cnt


def _cbow_ns_step(params, context_win, win_mask, targets, negs, lr):
    """CBOW negative sampling: mean of window vectors predicts the target.

    context_win: [B,W] int64 (padded), win_mask: [B,W], targets: [B],
    negs: [B,K].
    """
    syn0, syn1 = params["syn0"], params["syn1neg"]
    h, cnt = _window_mean(syn0, context_win, win_mask)     # [B,D]
    t = syn1[targets]
    n = syn1[negs]
    pos_dot = (h * t).sum(-1)
    neg_dot = torch.einsum("bd,bkd->bk", h, n)
    loss = _ns_loss(pos_dot, neg_dot)
    gpos = torch.sigmoid(pos_dot) - 1.0
    gneg = torch.sigmoid(neg_dot)
    d_h = gpos[:, None] * t + torch.einsum("bk,bkd->bd", gneg, n)   # [B,D]
    d_t = gpos[:, None] * h
    d_n = gneg[..., None] * h[:, None, :]
    d_ctx = (d_h / cnt)[:, None, :] * win_mask[..., None]            # [B,W,D]

    syn0.index_add_(0, context_win.reshape(-1), -lr * d_ctx.reshape(-1, d_ctx.shape[-1]))
    syn1.index_add_(0, targets, -lr * d_t)
    syn1.index_add_(0, negs.reshape(-1), -lr * d_n.reshape(-1, d_n.shape[-1]))
    return {"syn0": syn0, "syn1neg": syn1, **_others(params, "syn0", "syn1neg")}, loss


def _dm_ns_step(params, doc_ids, context_win, win_mask, targets, negs, lr):
    """PV-DM negative sampling (models/embeddings/learning/impl/sequence/
    DM.java): the document vector and the window-word average JOINTLY (mean
    over doc + context vectors) predict the center word.

    doc_ids: [B] int64 (label rows of syn0); context_win: [B,W] padded,
    win_mask: [B,W]; targets: [B]; negs: [B,K].
    """
    syn0, syn1 = params["syn0"], params["syn1neg"]
    doc = syn0[doc_ids]                                      # [B,D]
    h, cnt = _window_mean(syn0, context_win, win_mask, extra=doc)
    t = syn1[targets]
    n = syn1[negs]
    pos_dot = (h * t).sum(-1)
    neg_dot = torch.einsum("bd,bkd->bk", h, n)
    loss = _ns_loss(pos_dot, neg_dot)
    gpos = torch.sigmoid(pos_dot) - 1.0
    gneg = torch.sigmoid(neg_dot)
    d_h = gpos[:, None] * t + torch.einsum("bk,bkd->bd", gneg, n)   # [B,D]
    d_t = gpos[:, None] * h
    d_n = gneg[..., None] * h[:, None, :]
    d_shared = d_h / cnt
    d_ctx = d_shared[:, None, :] * win_mask[..., None]               # [B,W,D]

    syn0.index_add_(0, context_win.reshape(-1), -lr * d_ctx.reshape(-1, d_ctx.shape[-1]))
    syn0.index_add_(0, doc_ids, -lr * d_shared)
    syn1.index_add_(0, targets, -lr * d_t)
    syn1.index_add_(0, negs.reshape(-1), -lr * d_n.reshape(-1, d_n.shape[-1]))
    return {"syn0": syn0, "syn1neg": syn1, **_others(params, "syn0", "syn1neg")}, loss


def _hs_grad(h, syn1, codes, points, mask):
    """Huffman-path loss and gradient: ``g = (σ(dot) - (1 - code)) * mask``
    (the word2vec label is 1 - code, word2vec.c's g = 1 - code - f). A
    padded position (point 0, mask 0) gets g = 0 and adds exactly zero."""
    w = syn1[points]                                         # [B,L,D]
    dot = torch.einsum("bd,bld->bl", h, w)
    sign = 1.0 - 2.0 * codes
    loss = -(F.logsigmoid(sign * dot) * mask).sum() / mask.sum().clamp(min=1.0)
    g = (torch.sigmoid(dot) - (1.0 - codes)) * mask          # [B,L]
    return w, g, loss


def _cbow_hs_step(params, context_win, win_mask, codes, points, hmask, lr):
    """CBOW hierarchical softmax (CBOW.java HS branch): the window MEAN
    walks the target word's Huffman path.

    context_win/win_mask: [B,W] padded window; codes/points/hmask: [B,L]
    Huffman path of the TARGET word (bit, inner-node idx, validity).
    """
    syn0, syn1 = params["syn0"], params["syn1"]
    h, cnt = _window_mean(syn0, context_win, win_mask)     # [B,D]
    w, g, loss = _hs_grad(h, syn1, codes, points, hmask)
    d_h = torch.einsum("bl,bld->bd", g, w)
    d_w = g[..., None] * h[:, None, :]
    d_ctx = (d_h / cnt)[:, None, :] * win_mask[..., None]  # [B,W,D]
    syn0.index_add_(0, context_win.reshape(-1), -lr * d_ctx.reshape(-1, d_ctx.shape[-1]))
    syn1.index_add_(0, points.reshape(-1), -lr * d_w.reshape(-1, d_w.shape[-1]))
    return {"syn0": syn0, "syn1": syn1, **_others(params, "syn0", "syn1")}, loss


def _sg_hs_step(params, centers, codes, points, mask, lr):
    """Skip-gram hierarchical softmax over Huffman paths.

    centers [B]; codes/points/mask [B,L] (bit, inner-node idx, validity).
    loss = -Σ log σ((1-2*code) * c·syn1[point]).
    """
    syn0, syn1 = params["syn0"], params["syn1"]
    c = syn0[centers]                                    # [B,D]
    w, g, loss = _hs_grad(c, syn1, codes, points, mask)
    d_c = torch.einsum("bl,bld->bd", g, w)
    d_w = g[..., None] * c[:, None, :]
    syn0.index_add_(0, centers, -lr * d_c)
    syn1.index_add_(0, points.reshape(-1), -lr * d_w.reshape(-1, d_w.shape[-1]))
    return {"syn0": syn0, "syn1": syn1, **_others(params, "syn0", "syn1")}, loss


# ---------------------------------------------------------------------------
# host -> device
# ---------------------------------------------------------------------------


def _to_device(a, device, dtype=None) -> torch.Tensor:
    """A numpy array on ``device``: through pinned memory and a copy that
    does not wait for the stream on a CUDA device, so the host goes on
    generating the next batch while the card runs this one."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype is not None:
        t = t.to(dtype)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _check_ids(a, n: int, what: str) -> None:
    a = np.asarray(a)
    if a.size and (int(a.min()) < 0 or int(a.max()) >= n):
        raise ValueError(f"{what}: ids must lie in [0, {n}), got "
                         f"[{int(a.min())}, {int(a.max())}]")


def _ids(a, n: int, device, what: str) -> torch.Tensor:
    """Index array ``a`` checked against [0, n) on the host, as int64 on
    ``device``."""
    _check_ids(a, n, what)
    return _to_device(np.asarray(a, np.int64), device)


def _f32(x: float) -> float:
    """A host rate rounded to f32, as the JAX package passes it."""
    return float(np.float32(x))


def _nearest(m: torch.Tensor, v: torch.Tensor, k: int) -> List[int]:
    """Rows of ``m`` by cosine similarity to ``v``, best first: one product
    and a top-k on ``m``'s device, ``k`` rows to the host."""
    norms = torch.linalg.vector_norm(m, dim=1) * torch.linalg.vector_norm(v).clamp(min=1e-12)
    sims = (m @ v) / norms.clamp(min=1e-12)
    return torch.topk(sims, min(k, m.shape[0])).indices.cpu().tolist()


def _words_nearest(vocab: VocabCache, m: torch.Tensor, word_or_vec,
                   top_n: int) -> List[str]:
    """Cosine-nearest words of ``m``'s rows to a word (itself excluded) or
    a vector: one [V,D]x[D] product and a top-k on ``m``'s device."""
    if isinstance(word_or_vec, str):
        i = vocab.index_of(word_or_vec)
        if i < 0:
            return []
        v, exclude = m[i], {word_or_vec}
    else:
        v = torch.as_tensor(np.asarray(word_or_vec), dtype=m.dtype, device=m.device)
        exclude = set()
    out = []
    for i in _nearest(m, v, max(top_n, 1) + len(exclude)):
        w = vocab.word_at(int(i))
        if w not in exclude:
            out.append(w)
        if len(out) >= top_n:
            break
    return out


def _cosine(va, vb) -> float:
    if va is None or vb is None:
        return float("nan")
    denom = np.linalg.norm(va) * np.linalg.norm(vb)
    return float(va @ vb / denom) if denom > 0 else 0.0


# ---------------------------------------------------------------------------
# host-side pair generation
# ---------------------------------------------------------------------------


class _PairGenerator:
    """Sentence indices → (center, context) pairs with dynamic windows and
    frequent-word subsampling, batched (the role of AsyncSequencer +
    per-thread window loops in the reference)."""

    def __init__(self, window: int, keep_probs: np.ndarray, rs: np.random.RandomState):
        self.window = window
        self.keep = keep_probs
        self.rs = rs

    def generate(self, idx_seqs: Iterable[np.ndarray]):
        for idx in idx_seqs:
            if len(idx) < 2:
                continue
            keep = self.rs.rand(len(idx)) < self.keep[idx]
            idx = idx[keep]
            if len(idx) < 2:
                continue
            b = self.rs.randint(1, self.window + 1, len(idx))
            for i, center in enumerate(idx):
                lo = max(0, i - b[i])
                hi = min(len(idx), i + b[i] + 1)
                for j in range(lo, hi):
                    if j != i:
                        yield center, idx[j]

    def generate_windows(self, idx_seqs: Iterable[np.ndarray]):
        """CBOW windows (CBOW.java semantics): for each center position,
        yield (center, [context ids]) with the full dynamic window — the
        window AVERAGE predicts the center, not reversed skip-gram pairs."""
        for idx in idx_seqs:
            if len(idx) < 2:
                continue
            keep = self.rs.rand(len(idx)) < self.keep[idx]
            idx = idx[keep]
            if len(idx) < 2:
                continue
            b = self.rs.randint(1, self.window + 1, len(idx))
            for i, center in enumerate(idx):
                lo = max(0, i - b[i])
                hi = min(len(idx), i + b[i] + 1)
                ctx = [int(idx[j]) for j in range(lo, hi) if j != i]
                if ctx:
                    yield int(center), ctx


def _batched(gen, batch_size: int):
    buf_c, buf_t = [], []
    for c, t in gen:
        buf_c.append(c)
        buf_t.append(t)
        if len(buf_c) == batch_size:
            yield np.asarray(buf_c, np.int32), np.asarray(buf_t, np.int32)
            buf_c, buf_t = [], []
    if buf_c:
        yield np.asarray(buf_c, np.int32), np.asarray(buf_t, np.int32)


def _fast_pairs(idx_seqs, window: int, keep: np.ndarray,
                rs: np.random.RandomState):
    """Vectorized skip-gram pair generation: per sentence, same
    subsampling + dynamic-window SEMANTICS as _PairGenerator.generate (a
    pair (i, i±o) exists iff o <= b_i and in range) but built with per-
    offset numpy masks instead of a per-pair Python loop. Draw ORDER
    differs from the per-pair generator, so trajectories are not
    bit-identical across backends (the pair multiset per sentence is,
    given equal rng draws). Yields (centers, contexts) int32 arrays."""
    for idx in idx_seqs:
        if len(idx) < 2:
            continue
        kmask = rs.rand(len(idx)) < keep[idx]
        idx = idx[kmask]
        n = len(idx)
        if n < 2:
            continue
        b = rs.randint(1, window + 1, n)
        pos = np.arange(n)
        cs, ts = [], []
        for o in range(1, window + 1):
            sel = b >= o
            right = pos[sel & (pos + o < n)]
            left = pos[sel & (pos - o >= 0)]
            cs.append(idx[right])
            ts.append(idx[right + o])
            cs.append(idx[left])
            ts.append(idx[left - o])
        yield (np.concatenate(cs).astype(np.int32),
               np.concatenate(ts).astype(np.int32))


def _batched_arrays(gen, batch_size: int):
    """Re-chunk a stream of (centers, contexts) ARRAYS into batch_size
    pieces (array analogue of _batched)."""
    bufs_c, bufs_t, count = [], [], 0
    for c, t in gen:
        bufs_c.append(c)
        bufs_t.append(t)
        count += len(c)
        if count >= batch_size:
            cc = np.concatenate(bufs_c)
            tt = np.concatenate(bufs_t)
            while len(cc) >= batch_size:
                yield cc[:batch_size], tt[:batch_size]
                cc, tt = cc[batch_size:], tt[batch_size:]
            bufs_c, bufs_t, count = [cc], [tt], len(cc)
    if count:
        yield np.concatenate(bufs_c), np.concatenate(bufs_t)


def _batched_windows(gen, batch_size: int, max_width: int):
    """Batch (center, [contexts]) — or tagged (tag, center, [contexts]) —
    into padded [B,W] arrays + win_mask. Tagged items (the PV-DM doc id)
    yield (tags, centers, win, mask); untagged yield (centers, win, mask)."""

    def flush(tags, centers, ctxs):
        B = len(centers)
        win = np.zeros((B, max_width), np.int32)
        mask = np.zeros((B, max_width), np.float32)
        for r, ctx in enumerate(ctxs):
            L = min(len(ctx), max_width)
            win[r, :L] = ctx[:L]
            mask[r, :L] = 1.0
        out = (np.asarray(centers, np.int32), win, mask)
        return (np.asarray(tags, np.int32),) + out if tags else out

    tags, centers, ctxs = [], [], []
    for item in gen:
        if len(item) == 3:
            t, c, ctx = item
            tags.append(t)
        else:
            c, ctx = item
        centers.append(c)
        ctxs.append(ctx)
        if len(centers) == batch_size:
            yield flush(tags, centers, ctxs)
            tags, centers, ctxs = [], [], []
    if centers:
        yield flush(tags, centers, ctxs)


# ---------------------------------------------------------------------------
# SequenceVectors
# ---------------------------------------------------------------------------


class SequenceVectors:
    """Generic embedding trainer over element sequences
    (models/sequencevectors/SequenceVectors.java).

    ``sequences``: iterable of token lists (or a callable producing one per
    epoch). Algorithms: elements_learning = "skipgram" | "cbow";
    use_hierarchic_softmax switches HS on (negative=0) as in the reference.
    ``device``: None means the GPU (it raises with none); the CPU must be
    asked for with ``device="cpu"``.
    """

    def __init__(
        self,
        layer_size: int = 100,
        window: int = 5,
        negative: int = 5,
        use_hierarchic_softmax: bool = False,
        learning_rate: float = 0.025,
        min_learning_rate: float = 1e-4,
        min_word_frequency: int = 5,
        sample: float = 1e-3,
        epochs: int = 1,
        # pairs per device step; raise toward 65536 on big corpora
        batch_size: int = 8192,
        elements_learning: str = "skipgram",
        seed: int = 12345,
        # "python": per-pair generator (reference-faithful draw order);
        # "numpy": vectorized per-offset masks — same pair distribution,
        # different rng draw order (skip-gram only). With "numpy", SG-NS
        # training uploads scan_batches batches at a time and draws their
        # negatives on the device (inverse CDF over the unigram table —
        # the host draw's distribution).
        pair_backend: str = "python",
        scan_batches: int = 64,
        # the JAX package's lax.scan unroll factor: validated, no effect
        # here (eager PyTorch runs each batch's step as it comes)
        scan_unroll: int = 4,
        device=None,
    ):
        from deeplearning4j_tpu_torch.nn.model import resolve_device

        self.layer_size = layer_size
        self.window = window
        self.negative = negative
        self.use_hs = use_hierarchic_softmax
        self.lr = learning_rate
        self.min_lr = min_learning_rate
        self.min_word_frequency = min_word_frequency
        self.sample = sample
        self.epochs = epochs
        self.batch_size = batch_size
        self.elements_learning = elements_learning
        if pair_backend not in ("python", "numpy"):
            raise ValueError(f"pair_backend must be 'python' or 'numpy', got {pair_backend!r}")
        if scan_batches < 1:
            raise ValueError(f"scan_batches must be >= 1, got {scan_batches}")
        if scan_unroll < 1:
            raise ValueError(f"scan_unroll must be >= 1, got {scan_unroll}")
        self.pair_backend = pair_backend
        self.scan_batches = scan_batches
        self.scan_unroll = scan_unroll
        self.seed = seed
        self.device = resolve_device(device)
        self.vocab: Optional[VocabCache] = None
        self.params: Optional[Dict[str, torch.Tensor]] = None
        self._rs = np.random.RandomState(seed)

    # -- vocab + init ------------------------------------------------------
    def build_vocab(self, sequences: Iterable[Sequence[str]], special: Sequence[str] = ()):
        vc = VocabConstructor(self.min_word_frequency, tokenizer=_IdentityTok())
        self.vocab = vc.build(sequences, special=special)
        if self.use_hs:
            build_huffman(self.vocab)
        return self

    def _init_params(self):
        V, D = len(self.vocab), self.layer_size
        rs = np.random.RandomState(self.seed)
        p = {
            "syn0": (rs.rand(V, D).astype(np.float32) - 0.5) / D,
            "syn1neg": np.zeros((V, D), np.float32),
        }
        if self.use_hs:
            p["syn1"] = np.zeros((max(V - 1, 1), D), np.float32)
        self.params = {k: _to_device(v, self.device) for k, v in p.items()}

    # -- training ----------------------------------------------------------
    def _index_sequences(self, sequences) -> List[np.ndarray]:
        """Vocabulary indices per sequence; words not in the vocab (index
        -1) are dropped, as the JAX package does."""
        out = []
        for seq in sequences:
            idx = [self.vocab.index_of(t) for t in seq]
            out.append(np.asarray([i for i in idx if i >= 0], np.int64))
        return out

    def fit(self, sequences) -> "SequenceVectors":
        seqs = sequences() if callable(sequences) else sequences
        seqs = list(seqs)
        if self.vocab is None:
            self.build_vocab(seqs)
        if self.params is None:
            self._init_params()
        self._run_epochs(self._index_sequences(seqs), self.epochs)
        return self

    def _run_epochs(self, idx_seqs, epochs: int, *, schedule_span: Optional[int] = None,
                    schedule_offset: int = 0) -> None:
        """Train ``epochs`` passes over already-indexed sequences against the
        EXISTING vocab/params (the distributed trainer calls this one round
        at a time between parameter-averaging steps).

        ``schedule_span``/``schedule_offset``: total epochs the linear lr
        decay spans and how many are already complete — lets a multi-round
        caller anneal ONCE across all rounds instead of saw-toothing."""
        dev = self.device
        V = len(self.vocab)
        keep = subsample_probs(self.vocab, self.sample)
        table = unigram_table(self.vocab)
        if self.use_hs:
            codes, points, hmask = huffman_tables(self.vocab)
            _check_ids(points, self.params["syn1"].shape[0], "Huffman points")
            codes_d, points_d = _to_device(codes, dev), _to_device(points, dev, torch.int64)
            hmask_d = _to_device(hmask, dev)

        cum_dev = None  # unigram-table cumsum, uploaded once for all epochs
        span = schedule_span if schedule_span is not None else epochs
        pairs_per_epoch = sum(len(s) for s in idx_seqs) * self.window
        total_pairs_est = max(pairs_per_epoch * span, 1)
        seen = pairs_per_epoch * schedule_offset
        for _ in range(epochs):
            pg = _PairGenerator(self.window, keep, self._rs)
            if self.elements_learning == "cbow":
                # true CBOW (CBOW.java): the window AVERAGE predicts the
                # center — padded [B, 2*window] windows with win_mask.
                # NS and HS branches share the window batching; HS walks
                # the CENTER word's Huffman path.
                step = _cbow_hs_step if self.use_hs else _cbow_ns_step
                for centers, win, wmask in _batched_windows(
                    pg.generate_windows(idx_seqs), self.batch_size, 2 * self.window
                ):
                    frac = min(seen / total_pairs_est, 1.0)
                    lr = _f32(max(self.lr * (1.0 - frac), self.min_lr))
                    seen += len(centers)
                    win_d = _ids(win, V, dev, "context window")
                    c_d = _ids(centers, V, dev, "centers")
                    if self.use_hs:
                        self.params, _ = step(
                            self.params, win_d, _to_device(wmask, dev),
                            codes_d[c_d], points_d[c_d], hmask_d[c_d], lr)
                    else:
                        negs = self._draw_negatives(table, (len(centers), self.negative))
                        self.params, _ = step(
                            self.params, win_d, _to_device(wmask, dev), c_d,
                            _ids(negs, V, dev, "negatives"), lr)
                continue
            if self.pair_backend == "numpy" and not self.use_hs:
                # epoch-scan path: chunks of scan_batches full batches are
                # uploaded at once and draw their negatives on the device;
                # the leftover tail falls through to the per-batch path
                chunk = self.batch_size * self.scan_batches
                if cum_dev is None:
                    cum_dev = _to_device(np.cumsum(table).astype(np.float32), dev)
                # separate key stream: drawing chunk seeds from self._rs
                # would interleave with the (lazy) pair generator's draws
                # and break pair-stream reproducibility
                key_rs = np.random.RandomState(self._rs.randint(2 ** 31))
                tail_c: List[np.ndarray] = []
                tail_t: List[np.ndarray] = []
                for cc, tt in _batched_arrays(
                        _fast_pairs(idx_seqs, self.window, keep, self._rs),
                        chunk):
                    if len(cc) == chunk:
                        gen = torch.Generator(device=dev)
                        gen.manual_seed(int(key_rs.randint(2 ** 31)))
                        shape = (self.scan_batches, self.batch_size)
                        self.params, _ = _sg_ns_epoch_scan(
                            self.params,
                            _ids(cc.reshape(shape), V, dev, "centers"),
                            _ids(tt.reshape(shape), V, dev, "contexts"),
                            cum_dev, gen, _f32(self.lr), _f32(self.min_lr),
                            float(seen), float(total_pairs_est),
                            negative=self.negative, unroll=self.scan_unroll)
                        seen += len(cc)
                    else:
                        tail_c.append(cc)
                        tail_t.append(tt)
                # tail: re-chunk to batch_size for the per-batch path
                pair_stream = _batched_arrays(zip(tail_c, tail_t),
                                              self.batch_size)
            elif self.pair_backend == "numpy":
                pair_stream = _batched_arrays(
                    _fast_pairs(idx_seqs, self.window, keep, self._rs),
                    self.batch_size)
            else:
                pair_stream = _batched(pg.generate(idx_seqs), self.batch_size)
            for centers, contexts in pair_stream:
                frac = min(seen / total_pairs_est, 1.0)
                lr = _f32(max(self.lr * (1.0 - frac), self.min_lr))
                seen += len(centers)
                c_d = _ids(centers, V, dev, "centers")
                t_d = _ids(contexts, V, dev, "contexts")
                if self.use_hs:
                    self.params, _ = _sg_hs_step(
                        self.params, c_d, codes_d[t_d], points_d[t_d], hmask_d[t_d], lr)
                else:
                    negs = self._draw_negatives(table, (len(centers), self.negative))
                    self.params, _ = _sg_ns_step(
                        self.params, c_d, t_d, _ids(negs, V, dev, "negatives"), lr)

    def _draw_negatives(self, table: np.ndarray, shape) -> np.ndarray:
        # inverse-CDF sampling: identical distribution to
        # rs.choice(p=table) but ~100x faster at vocab 100K (choice-with-p
        # rebuilds its alias structures per call); cumsum cached per table
        cached = getattr(self, "_neg_cum", None)
        if cached is None or cached[0] is not table:
            cached = (table, np.cumsum(table))
            self._neg_cum = cached
        u = self._rs.random_sample(shape)
        return np.minimum(np.searchsorted(cached[1], u),
                          len(table) - 1).astype(np.int32)

    # -- lookup API (WordVectors interface) --------------------------------
    @property
    def syn0(self) -> np.ndarray:
        """The whole [V, D] table on the host (a copy from the device)."""
        return self.params["syn0"].cpu().numpy()

    def has_word(self, word: str) -> bool:
        return self.vocab is not None and word in self.vocab

    def get_word_vector(self, word: str) -> Optional[np.ndarray]:
        """The word's row, copied alone from the device."""
        i = self.vocab.index_of(word)
        return self.params["syn0"][i].cpu().numpy() if i >= 0 else None

    def similarity(self, a: str, b: str) -> float:
        return _cosine(self.get_word_vector(a), self.get_word_vector(b))

    def words_nearest(self, word_or_vec, top_n: int = 10) -> List[str]:
        """Cosine-nearest words: one [V,D]x[D] product and a top-k on the
        model's device, not a VP-tree."""
        return _words_nearest(self.vocab, self.params["syn0"], word_or_vec, top_n)


class _IdentityTok:
    def tokenize(self, s):
        return list(s) if not isinstance(s, str) else s.split()


# ---------------------------------------------------------------------------
# Word2Vec / ParagraphVectors / StaticWord2Vec
# ---------------------------------------------------------------------------


class Word2Vec(SequenceVectors):
    """models/word2vec/Word2Vec.java: SequenceVectors over tokenized
    sentences. ``fit(sentences)`` accepts strings or a sentence iterator."""

    def __init__(self, tokenizer_factory=None, **kw):
        super().__init__(**kw)
        self.tokenizer_factory = tokenizer_factory

    def _tokenize_all(self, sentences) -> List[List[str]]:
        from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizerFactory

        tok = self.tokenizer_factory or DefaultTokenizerFactory()
        out = []
        for s in sentences:
            out.append(tok.tokenize(s) if isinstance(s, str) else list(s))
        return out

    def build_vocab(self, sentences, special=()):
        return super().build_vocab(self._tokenize_all(sentences), special=special)

    def fit(self, sentences) -> "Word2Vec":
        seqs = sentences() if callable(sentences) else sentences
        return super().fit(self._tokenize_all(seqs))


class ParagraphVectors(Word2Vec):
    """models/paragraphvectors/ParagraphVectors.java: documents get their own
    vectors. ``sequence_learning="dbow"`` (default, the reference's DBOW
    impl: the label vector predicts each word) or ``"dm"`` (PV-DM,
    learning/impl/sequence/DM.java: doc vector + window average predict the
    center word)."""

    LABEL_PREFIX = "__label__"

    def __init__(self, sequence_learning: str = "dbow", **kw):
        kw.setdefault("min_word_frequency", 1)
        super().__init__(**kw)
        if sequence_learning not in ("dbow", "dm"):
            raise ValueError(f"sequence_learning must be 'dbow' or 'dm', "
                             f"got {sequence_learning!r}")
        self.sequence_learning = sequence_learning
        self.labels: List[str] = []

    def fit_documents(self, docs: Sequence[Tuple[str, str]]) -> "ParagraphVectors":
        """docs: (text, label) pairs (LabelAwareIterator surface)."""
        texts = [t for t, _ in docs]
        self.labels = [self.LABEL_PREFIX + l for _, l in docs]
        token_seqs = self._tokenize_all(texts)
        # vocab over words + labels (labels as special tokens)
        super(Word2Vec, self).build_vocab(token_seqs, special=tuple(self.labels))
        self._init_params()
        table = unigram_table(self.vocab)
        if self.sequence_learning == "dm":
            self._fit_dm(token_seqs, table)
        else:
            self._fit_dbow(token_seqs, table)
        # words also train among themselves (reference trainElementsVectors)
        super(Word2Vec, self).fit(token_seqs)
        return self

    def _fit_dbow(self, token_seqs, table):
        # DBOW: every (label, word) pair is a skip-gram pair
        dev, V = self.device, len(self.vocab)
        lr = self.lr
        for ep in range(self.epochs):
            pairs_c, pairs_t = [], []
            for label, toks in zip(self.labels, token_seqs):
                li = self.vocab.index_of(label)
                for t in toks:
                    ti = self.vocab.index_of(t)
                    if ti >= 0:
                        pairs_c.append(li)
                        pairs_t.append(ti)
            order = self._rs.permutation(len(pairs_c))
            pc = np.asarray(pairs_c, np.int32)[order]
            pt = np.asarray(pairs_t, np.int32)[order]
            for i in range(0, len(pc), self.batch_size):
                c = pc[i:i + self.batch_size]
                t = pt[i:i + self.batch_size]
                negs = self._draw_negatives(table, (len(c), self.negative))
                self.params, _ = _sg_ns_step(
                    self.params, _ids(c, V, dev, "labels"), _ids(t, V, dev, "words"),
                    _ids(negs, V, dev, "negatives"), _f32(lr))
            lr = max(lr * 0.9, self.min_lr)

    def _fit_dm(self, token_seqs, table):
        # PV-DM: (doc, window) -> center. Windows per document, batched by
        # the shared padded-window batcher with the doc's label row as tag.
        dev, V = self.device, len(self.vocab)
        keep = subsample_probs(self.vocab, self.sample)
        W = 2 * self.window
        lr = self.lr
        for ep in range(self.epochs):
            pg = _PairGenerator(self.window, keep, self._rs)
            items = []  # (doc_id, center, ctx)
            for label, toks in zip(self.labels, token_seqs):
                li = self.vocab.index_of(label)
                idx = np.asarray(
                    [i for i in (self.vocab.index_of(t) for t in toks) if i >= 0],
                    np.int64)
                for center, ctx in pg.generate_windows([idx]):
                    items.append((li, center, ctx))
            self._rs.shuffle(items)
            for docs, centers, win, mask in _batched_windows(
                    iter(items), self.batch_size, W):
                negs = self._draw_negatives(table, (len(centers), self.negative))
                self.params, _ = _dm_ns_step(
                    self.params, _ids(docs, V, dev, "labels"),
                    _ids(win, V, dev, "context window"), _to_device(mask, dev),
                    _ids(centers, V, dev, "centers"), _ids(negs, V, dev, "negatives"),
                    _f32(lr))
            lr = max(lr * 0.9, self.min_lr)

    def get_label_vector(self, label: str) -> Optional[np.ndarray]:
        return self.get_word_vector(self.LABEL_PREFIX + label)

    def infer_vector(self, text: str, steps: int = 20) -> np.ndarray:
        """Infer a vector for unseen text: average of known word vectors
        refined by DBOW steps against a frozen vocab (inferVector). Host
        numpy, as in the JAX package; the negatives are drawn first (the
        same draws in the same order) so that only the rows the steps read
        are copied from the device."""
        toks = self._tokenize_all([text])[0]
        idx = np.asarray([self.vocab.index_of(t) for t in toks], np.int64)
        idx = idx[idx >= 0]
        if len(idx) == 0:
            return np.zeros(self.layer_size, np.float32)
        dev = self.device
        v = self.params["syn0"][_to_device(idx, dev)].cpu().numpy().mean(axis=0)
        rs = np.random.RandomState(0)
        table = unigram_table(self.vocab)
        negs = [[rs.choice(len(table), size=self.negative, p=table) for _ in idx]
                for _ in range(steps)]
        rows = np.unique(np.concatenate([idx] + [n for per in negs for n in per]))
        syn1 = dict(zip(rows.tolist(),
                        self.params["syn1neg"][_to_device(rows, dev)].cpu().numpy()))
        lr = self.lr
        for per_step in negs:
            for t, draws in zip(idx, per_step):
                tv = syn1[int(t)]
                g = (1.0 / (1.0 + np.exp(-v @ tv))) - 1.0
                d = g * tv
                for nidx in draws:
                    nv = syn1[int(nidx)]
                    gn = 1.0 / (1.0 + np.exp(-v @ nv))
                    d = d + gn * nv
                v = v - lr * d
            lr *= 0.9
        return v.astype(np.float32)

    def similarity_to_label(self, text: str, label: str) -> float:
        v = self.infer_vector(text)
        lv = self.get_label_vector(label)
        if lv is None:
            return float("nan")
        return _cosine(v, lv)


class StaticWord2Vec:
    """Inference-only word vectors (models/word2vec/StaticWord2Vec.java):
    frozen host table + lookup/similarity, no trainer state."""

    def __init__(self, vocab: VocabCache, vectors: np.ndarray):
        self.vocab = vocab
        self.syn0 = np.asarray(vectors, np.float32)

    @staticmethod
    def from_model(m: SequenceVectors) -> "StaticWord2Vec":
        return StaticWord2Vec(m.vocab, m.syn0)

    def get_word_vector(self, word: str):
        i = self.vocab.index_of(word)
        return self.syn0[i] if i >= 0 else None

    def similarity(self, a: str, b: str) -> float:
        return _cosine(self.get_word_vector(a), self.get_word_vector(b))

    def words_nearest(self, word: str, top_n: int = 10) -> List[str]:
        return _words_nearest(self.vocab, torch.from_numpy(self.syn0), word, top_n)
