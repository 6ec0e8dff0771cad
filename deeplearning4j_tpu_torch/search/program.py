"""Scoring functions of the device-resident search tiers (PyTorch port of
the JAX package's ``search/program.py``).

Three tiers, plain torch on tensors (the JAX package scores with jitted
XLA, so no hand-written kernel lies on this path):

- **exact**  — brute-force matmul top-k over a fixed-capacity corpus. The
  squared-euclidean expansion ``||q||² - 2 q·x + ||x||²`` puts the scan in
  one [B, C] product; padded corpus rows are masked to -inf before the
  top-k.
- **ivf**    — coarse-quantizer assign (a [B, nlist] product against the
  k-means centroids) picks ``nprobe`` inverted lists per query, then the
  probed lists' vectors are gathered and exact-scored. Where the JAX
  package scans the lists one by one carrying a running top-k
  (``lax.scan``), this takes one top-k over the probed lists concatenated
  in probe order (in chunks of probes, carrying the top-k, when the
  gathered [B, p, L, D] block would pass ``PROBE_BYTES``): with ties broken
  by position (``knn.topk_stable``), earlier lists win ties in both, so
  the ids are the same, and a probe costs no launches of its own.
- **ivf_pq** — the same probes, candidates scored from uint8 PQ codes
  through an ADC table (``lut[b, m, code]``, one per batch), a top-``r``
  candidate set, then an exact rerank of the ``r`` survivors down to k.

Score convention: **scores are negated squared-euclidean distances**
(larger = closer), invalid slots are -inf; the index converts them back to
user-facing distances. Every top-k orders by (score descending, position
ascending), ``lax.top_k``'s rule. Products are IEEE float32: the index
runs them inside ``knn.f32_products``.

Every op is row-independent, so a query's result does not depend on the
other rows of its batch at one padded batch size (the coalescing contract
of ``serve/scheduler.py`` ``SearchWorker``).

PyTorch runs eagerly: there is no executable to compile, so the JAX
package's compile counters (``compiles_observed``, ``compiled_count``)
have no counterpart. :meth:`SearchProgram.warm` runs every signature of
the grid once, which sets up the CUDA context and cuBLAS's choices before
the first request, and returns how many distinct signatures ran.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.nn import aot
from deeplearning4j_tpu_torch.clustering.knn import f32_products, topk_stable
from deeplearning4j_tpu_torch.utils import bucketing

__all__ = [
    "PROBE_BYTES", "SITE_EXACT", "SITE_IVF", "SITE_MERGE", "SITE_PQ",
    "SearchProgram", "exact_topk", "ivf_topk", "merge_topk", "pq_topk",
]

SITE_EXACT = "search.exact"
SITE_MERGE = "search.merge"
SITE_IVF = "search.ivf"
SITE_PQ = "search.ivf_pq"

# largest gathered candidate block of one probe chunk (vectors or codes)
PROBE_BYTES = 256 * 2**20


def exact_topk(q, chunk, cnorms, n_valid: int, offset: int, k: int):
    """[B, C] exact scores + top-k. Columns at or past ``n_valid`` are
    capacity padding and never surface. ``offset`` shifts the returned ids
    into the global id space (the pending buffer scores at offset =
    main-corpus count so its hits merge correctly)."""
    qn = (q * q).sum(-1)
    d = qn[:, None] - 2.0 * (q @ chunk.T) + cnorms[None, :]
    col_ok = torch.arange(chunk.shape[0], device=q.device) < n_valid
    scores = torch.where(col_ok[None, :], -d, -torch.inf)
    best, idx = topk_stable(scores, k)
    return best, idx.to(torch.int32) + offset


def merge_topk(sa, ia, sb, ib, k: int):
    """Merge two per-query top-k result sets (main corpus + pending buffer)
    into one, keeping the global ids carried in ``ia``/``ib``."""
    best, sel = topk_stable(torch.cat([sa, sb], dim=1), k)
    return best, torch.gather(torch.cat([ia, ib], dim=1), 1, sel)


def _probe(q, qn, centroids, nprobe: int):
    centnorms = (centroids * centroids).sum(-1)
    dc = qn[:, None] - 2.0 * (q @ centroids.T) + centnorms[None, :]
    return topk_stable(-dc, nprobe)[1]                         # [B, nprobe]


def _probe_chunks(nprobe: int, per_probe_bytes: int):
    step = max(1, min(nprobe, PROBE_BYTES // max(per_probe_bytes, 1)))
    return range(0, nprobe, step), step


def _scan(q, postings, sizes, probe, width: int, per_probe_bytes: int, score):
    """Score the probed lists chunk by chunk in probe order, carrying the
    top-``width`` (seeded, as the JAX scan is, with -inf / id -1 slots).
    ``score(rows)`` returns [B, p, L] scores. Returns (scores, ids,
    candidates scored per query)."""
    B, L = q.shape[0], postings.shape[1]
    best = torch.full((B, width), -torch.inf, dtype=q.dtype, device=q.device)
    bidx = torch.full((B, width), -1, dtype=torch.int32, device=q.device)
    cnt = torch.zeros(B, dtype=torch.int32, device=q.device)
    lanes = torch.arange(L, device=q.device)
    starts, step = _probe_chunks(probe.shape[1], per_probe_bytes)
    for lo in starts:
        pid = probe[:, lo:lo + step]                           # [B, p]
        rows = postings[pid]                                   # [B, p, L]
        valid = lanes[None, None, :] < sizes[pid][..., None]
        sc = torch.where(valid, score(rows), -torch.inf).reshape(B, -1)
        best, sel = topk_stable(torch.cat([best, sc], dim=1), width)
        bidx = torch.gather(torch.cat([bidx, rows.reshape(B, -1)], dim=1), 1, sel)
        cnt = cnt + valid.sum(dim=(1, 2), dtype=torch.int32)
    return best, bidx, cnt


def ivf_topk(q, centroids, postings, sizes, corpus, cnorms, nprobe: int, k: int):
    """IVF: coarse top-nprobe lists, then the probed lists exact-scored
    under one top-k. Returns ``(scores, ids, counts)``; counts is candidates
    actually scored per query (the dl4j_search_candidates_scanned source)."""
    qn = (q * q).sum(-1)
    probe = _probe(q, qn, centroids, nprobe)
    B, L, D = q.shape[0], postings.shape[1], corpus.shape[1]

    def score(rows):
        vecs = corpus[rows]                                    # [B, p, L, D]
        dot = torch.einsum("bd,bpld->bpl", q, vecs)
        return -(qn[:, None, None] - 2.0 * dot + cnorms[rows])

    return _scan(q, postings, sizes, probe, k, B * L * D * 4, score)


def pq_topk(q, centroids, postings, sizes, codes, codebooks, corpus, cnorms,
            nprobe: int, k: int, r: int):
    """IVF-PQ: ADC-score candidates from uint8 codes (M bytes each, not D
    floats), keep a top-``r`` candidate set over the probed lists, then
    exact-rerank the r survivors down to k from the full-precision corpus."""
    B = q.shape[0]
    M, _, dsub = codebooks.shape
    L = postings.shape[1]
    qn = (q * q).sum(-1)
    probe = _probe(q, qn, centroids, nprobe)
    # ADC table: lut[b, m, j] = ||q_m - codebook[m, j]||², one build per batch
    lut = ((q.reshape(B, M, 1, dsub) - codebooks[None]) ** 2).sum(-1)

    def score(rows):
        p = rows.shape[1]
        cg = codes[rows].to(torch.int64).reshape(B, p * L, M)  # [B, pL, M]
        adc = torch.gather(lut, 2, cg.transpose(1, 2)).sum(dim=1)
        return -adc.reshape(B, p, L)

    # per probe: the int64 codes and their gather index, [B, L, M] each
    approx, cand, cnt = _scan(q, postings, sizes, probe, r, B * L * M * 16, score)
    # exact rerank of the r ADC survivors (the clip keeps the gather in
    # bounds for empty -1 slots; their -inf approx score masks them back out)
    safe = cand.clamp(0, corpus.shape[0] - 1).to(torch.int64)
    vecs = corpus[safe]                                        # [B, r, D]
    dot = torch.einsum("bd,brd->br", q, vecs)
    d = qn[:, None] - 2.0 * dot + cnorms[safe]
    sc = torch.where(torch.isfinite(approx), -d, -torch.inf)
    best, sel = topk_stable(sc, k)
    return best, torch.gather(cand, 1, sel), cnt


class SearchProgram:
    """The grid of (B, k, nprobe) signatures a request to one
    :class:`search.index.VectorIndex` can dispatch at, and its warm pass."""

    def __init__(self, index):
        self.index = index

    def signature_grid(self) -> List[Tuple[int, int, int]]:
        """Every (B, k, nprobe) combination a request can dispatch at: B and
        k walk the reachable rungs of the shared ladder up to the index's
        caps, nprobe comes from the index's probe choice set. Requests are
        padded/rounded INTO this grid, never out of it."""
        ix = self.index
        bs = bucketing.reachable_buckets(ix.config.batch_max)
        return [(b, k, p) for b in bs for k in ix.k_choices
                for p in ix.nprobe_choices]

    def warm(self) -> int:
        """Run every signature of the grid once, for every tier this index
        has (exact always; ivf/pq when trained; the pending-merge pair when
        incremental adds are enabled). Returns the number of distinct
        signatures run."""
        ix = self.index
        dev = ix.device
        ran = set()
        grid = self.signature_grid()
        with torch.inference_mode(), f32_products(dev):
            for b, k, p in grid:
                q = torch.zeros((b, ix.config.dim), dtype=torch.float32, device=dev)
                if (SITE_EXACT, b, k) not in ran:
                    ran.add((SITE_EXACT, b, k))
                    exact_topk(q, ix._corpus, ix._cnorms, 0, 0, k)
                    if ix._pending_corpus is not None:
                        ran.add((SITE_MERGE, b, k))
                        sa, ia = exact_topk(q, ix._pending_corpus,
                                            ix._pending_cnorms, 0, 0, k)
                        merge_topk(sa, ia, sa, ia, k)
                if ix._centroids is not None:
                    ran.add((SITE_IVF, b, k, p))
                    ivf_topk(q, ix._centroids, ix._postings, ix._sizes,
                             ix._corpus, ix._cnorms, p, k)
                if ix._codes is not None:
                    ran.add((SITE_PQ, b, k, p))
                    pq_topk(q, ix._centroids, ix._postings, ix._sizes,
                            ix._codes, ix._codebooks, ix._corpus, ix._cnorms,
                            p, k, ix.rerank_width(k))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        # the grid rides in the index's warm-set bundle (nn/aot.py)
        for sig in sorted(ran, key=repr):
            aot.grid_site(ix, sig[0]).mark_warm(*sig[1:])
        obs.event("search_warm", index=ix.config.name, grid=len(grid),
                  executables=len(ran))
        return len(ran)
