"""Device-resident vector index: build / search / persist lifecycle
(PyTorch port of the JAX package's ``search/index.py``).

:class:`VectorIndex` owns the device state the scoring tiers
(``search/program.py``) read — a fixed-capacity corpus tensor, the IVF
centroids/postings from ``clustering/kmeans.py``, optional PQ codes — plus
the host-side lifecycle around it:

- **build**: train the coarse quantizer on a subsample (random-init Lloyd),
  assign the full corpus through the bucketed ``kmeans.assign`` site, lay
  postings out as a padded [nlist, L] table, optionally train
  per-subspace PQ codebooks and encode. Every device array is padded to a
  bucket rung, so the signature grid is finite. The subsample, the
  k-means seeding and the PQ training draw from the host's
  ``np.random.RandomState`` in the JAX package's order, and the corpus
  norms are summed on the host as there, so both packages build the same
  layout from the same vectors (to float32 rounding of the k-means sums).
- **search**: pad the query batch up the shared ladder, dispatch the
  requested tier, merge the pending buffer's exact scores, slice back to
  the real rows/k — bit-exact under coalescing at one padded batch size
  because every op is row-independent and a top-k's column prefix is
  stable.
- **incremental adds**: a fixed-shape pending buffer is searchable
  immediately (exact tier + merge); ``merge_pending`` folds it into the
  main structure off the hot path.
- **persist/restore**: real-shaped arrays in a CRC'd zip with a JSON
  manifest, the JAX package's format: each package reads the other's
  files. The padded device layout is re-derived identically on load, and
  ``conf`` / ``dtype`` give ``nn/aot.py`` the model-shaped surface its
  bundles key on (``register_index(bundle=)``).

The index lives on one device (``device=None``: the GPU, raising without
one). Its products are IEEE float32 (``clustering/knn.f32_products``).
"""

from __future__ import annotations

import io
import json
import os
import threading
import zlib
from dataclasses import asdict, dataclass, replace
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.clustering.kmeans import KMeansClustering, assign_points
from deeplearning4j_tpu_torch.clustering.knn import f32_products
from deeplearning4j_tpu_torch.search.program import (
    SITE_EXACT, SITE_IVF, SITE_PQ, SearchProgram, exact_topk, ivf_topk,
    merge_topk, pq_topk)
from deeplearning4j_tpu_torch.utils import bucketing
from deeplearning4j_tpu_torch.utils.serialization import _atomic_write_zip

__all__ = ["IndexConfig", "VectorIndex"]

INDEX_FORMAT_VERSION = 1
_MANIFEST = "manifest.json"

_METRICS = ("euclidean", "cosine")


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"{name} must be an integer, got {raw!r}")


@dataclass(frozen=True)
class IndexConfig:
    """Build-time configuration (the JAX package's fields, in its order: a
    manifest's ``config`` builds either package's). ``nlist`` / ``nprobe`` /
    ``batch_max`` left at 0 read ``DL4J_TPU_IVF_NLIST`` /
    ``DL4J_TPU_IVF_NPROBE`` / ``DL4J_TPU_SEARCH_BATCH_MAX`` at BUILD time."""

    dim: int
    name: str = "default"
    metric: str = "euclidean"          # "euclidean" | "cosine"
    ivf: bool = True                   # train the IVF tier at build
    nlist: int = 0                     # 0 = env DL4J_TPU_IVF_NLIST, else auto
    nprobe: int = 0                    # 0 = env DL4J_TPU_IVF_NPROBE, else 8
    pq_m: int = 0                      # subquantizers; 0 = PQ tier off
    pq_ksub: int = 256                 # codewords per subquantizer (<= 256)
    rerank: int = 64                   # PQ exact-rerank candidate width
    max_k: int = 16                    # largest k a request may ask for
    batch_max: int = 0                 # 0 = env DL4J_TPU_SEARCH_BATCH_MAX, else 32
    pending_cap: int = 1024            # incremental-add buffer rows; 0 = off
    train_sample: int = 20000          # centroid-training subsample cap
    kmeans_iters: int = 8
    seed: int = 12345
    k_choices: Optional[Tuple[int, ...]] = None       # override the k grid
    nprobe_choices: Optional[Tuple[int, ...]] = None  # override the probe grid

    def __post_init__(self):
        if self.metric not in _METRICS:
            raise ValueError(f"metric must be one of {_METRICS}, "
                             f"got {self.metric!r}")
        if self.pq_m and self.dim % self.pq_m:
            raise ValueError(
                f"pq_m={self.pq_m} must divide dim={self.dim}")
        if self.pq_ksub > 256:
            raise ValueError("pq_ksub > 256 does not fit uint8 codes")


class _Conf:
    """Minimal ``model.conf`` stand-in: ``aot.model_signature`` hashes
    ``conf.to_json()``, so the JSON carries the config plus every derived
    device shape — two indexes with different layouts never share a
    bundle (the JAX package's ``_Conf``)."""

    def __init__(self, d: Dict):
        self._d = d

    def to_json(self) -> str:
        return json.dumps(self._d, sort_keys=True)


class VectorIndex:
    """Build with :meth:`build`, restore with :meth:`load`; then
    :meth:`search` / :meth:`add` / :meth:`save`."""

    dtype = "float32"

    def __init__(self, config: IndexConfig, device=None):
        from deeplearning4j_tpu_torch.nn.model import resolve_device

        self.config = config
        self.device = resolve_device(device)
        self.n = 0
        self._vectors = np.zeros((0, config.dim), np.float32)  # host copy
        self._corpus = None            # [capacity, D] device
        self._cnorms = None            # [capacity]
        self._centroids = None         # [nlist, D] or None (no IVF)
        self._assign = None            # [n] host list id per row
        self._postings = None          # [nlist, L] int32
        self._sizes = None             # [nlist] int32
        self._codes = None             # [capacity, M] uint8 or None
        self._codebooks = None         # [M, ksub, dsub]
        self._pending_np = None        # [pending_bucket, D] host
        self._pending_corpus = None    # device mirror
        self._pending_cnorms = None
        self._pending_n = 0
        self._lock = threading.RLock()
        self.stats: Dict = {}
        self.program = SearchProgram(self)

    # ------------------------------------------------------------------
    # build / load
    # ------------------------------------------------------------------

    @classmethod
    def build(cls, vectors, config: IndexConfig, device=None) -> "VectorIndex":
        """Train + lay out the index for ``vectors`` ([n, dim]) on
        ``device`` (None: the GPU)."""
        vectors = np.ascontiguousarray(np.asarray(vectors, np.float32))
        if vectors.ndim != 2 or vectors.shape[1] != config.dim:
            raise ValueError(
                f"vectors must be [n, {config.dim}], got {vectors.shape}")
        n = vectors.shape[0]
        if n < 1:
            raise ValueError("cannot build an empty index")
        config = cls._resolve_config(config, n)
        ix = cls(config, device=device)
        if config.metric == "cosine":
            vectors = _l2_normalize(vectors)
        centroids = codebooks = None
        assign = np.zeros(n, np.int32)
        codes = None
        rs = np.random.RandomState(config.seed)
        if config.ivf and config.nlist > 1:
            sample = _subsample(vectors, config.train_sample, rs)
            km = KMeansClustering(
                config.nlist, config.kmeans_iters, "euclidean",
                seed=config.seed, init="random", device=ix.device)
            centroids = km.apply_to(sample).centers.astype(np.float32)
            assign, _ = assign_points(vectors, centroids, device=ix.device)
            if config.pq_m:
                codebooks, codes = _train_pq(vectors, sample, config, ix.device)
        ix._install(vectors, centroids, assign, codebooks, codes)
        ix._measure_recall()
        obs.event("search_index_built", index=config.name, points=n,
                  nlist=int(config.nlist if centroids is not None else 0),
                  tier=ix.default_tier, **{"dim": config.dim})
        return ix

    @staticmethod
    def _resolve_config(config: IndexConfig, n: int) -> IndexConfig:
        """Fill the env/auto sentinels with concrete values for corpus size
        ``n``."""
        ladder = bucketing.ladder_from_env()
        batch_max = config.batch_max or _env_int(
            "DL4J_TPU_SEARCH_BATCH_MAX", 32)
        nprobe = config.nprobe or _env_int("DL4J_TPU_IVF_NPROBE", 8)
        nlist = config.nlist or _env_int("DL4J_TPU_IVF_NLIST", 0)
        if config.ivf and nlist == 0:
            # auto: ~sqrt(n) lists rounded up the ladder, capped so the
            # average list keeps enough occupants to be worth probing
            nlist = min(ladder.bucket(max(int(np.ceil(np.sqrt(n))), 1)),
                        max(n // 8, 1))
        nlist = min(nlist, n)
        nprobe = max(1, min(nprobe, max(nlist, 1)))
        return replace(config, batch_max=int(batch_max), nlist=int(nlist),
                       nprobe=int(nprobe))

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

    def _install(self, vectors, centroids, assign, codebooks, codes):
        """Derive the padded device layout from real-shaped host arrays.
        Deterministic in its inputs: build and load produce identical
        shapes."""
        cfg = self.config
        ladder = bucketing.ladder_from_env()
        n = vectors.shape[0]
        capacity = ladder.bucket(max(n, 1))
        self.n = n
        self._vectors = vectors
        corpus = np.zeros((capacity, cfg.dim), np.float32)
        corpus[:n] = vectors
        self._corpus = self._to_dev(corpus)
        self._cnorms = self._to_dev(np.sum(corpus * corpus, axis=1))
        if centroids is not None:
            nlist = centroids.shape[0]
            counts = np.bincount(assign, minlength=nlist)
            L = ladder.bucket(max(int(counts.max()), 1))
            postings = np.zeros((nlist, L), np.int32)
            sizes = counts.astype(np.int32)
            order = np.argsort(assign, kind="stable")
            off = 0
            for c in range(nlist):
                postings[c, :counts[c]] = order[off:off + counts[c]]
                off += counts[c]
            self._centroids = self._to_dev(np.asarray(centroids, np.float32))
            self._assign = np.asarray(assign, np.int32)
            self._postings = self._to_dev(postings)
            self._sizes = self._to_dev(sizes)
        else:
            self._centroids = self._postings = self._sizes = None
            self._assign = None
        if codes is not None:
            padded = np.zeros((capacity, codes.shape[1]), np.uint8)
            padded[:n] = codes
            self._codes = self._to_dev(padded)
            self._codebooks = self._to_dev(np.asarray(codebooks, np.float32))
        else:
            self._codes = self._codebooks = None
        if cfg.pending_cap > 0:
            pcap = ladder.bucket(cfg.pending_cap)
            self._pending_np = np.zeros((pcap, cfg.dim), np.float32)
            self._pending_corpus = self._to_dev(self._pending_np)
            self._pending_cnorms = torch.zeros(pcap, dtype=torch.float32,
                                               device=self.device)
        self._pending_n = 0
        self.stats.update({
            "points": n, "capacity": int(capacity),
            "nlist": 0 if centroids is None else int(centroids.shape[0]),
            "tier": self.default_tier, "metric": cfg.metric,
        })

    # -- the model-shaped surface nn/aot.py expects -----------------------

    @property
    def conf(self) -> _Conf:
        cfg = asdict(self.config)
        cfg["k_choices"] = list(self.k_choices)
        cfg["nprobe_choices"] = list(self.nprobe_choices)
        derived = {
            "capacity": 0 if self._corpus is None else int(self._corpus.shape[0]),
            "list_width": 0 if self._postings is None else int(self._postings.shape[1]),
            "nlist": 0 if self._centroids is None else int(self._centroids.shape[0]),
            "pq": None if self._codebooks is None else list(self._codebooks.shape),
            "pending": 0 if self._pending_corpus is None else int(
                self._pending_corpus.shape[0]),
        }
        return _Conf({"index": cfg, "derived": derived})

    # ------------------------------------------------------------------
    # grids
    # ------------------------------------------------------------------

    @property
    def k_choices(self) -> Tuple[int, ...]:
        if self.config.k_choices:
            return tuple(self.config.k_choices)
        cap = self._corpus.shape[0] if self._corpus is not None else self.config.max_k
        ks = [b for b in bucketing.reachable_buckets(self.config.max_k) if b <= cap]
        return tuple(ks) or (min(self.config.max_k, cap),)

    @property
    def nprobe_choices(self) -> Tuple[int, ...]:
        if self._centroids is None:
            return ()
        nlist = int(self._centroids.shape[0])
        if self.config.nprobe_choices:
            return tuple(min(p, nlist) for p in self.config.nprobe_choices)
        return (min(self.config.nprobe, nlist),)

    def rerank_width(self, k: int) -> int:
        cap = int(self._corpus.shape[0])
        return min(max(self.config.rerank, k), cap)

    @property
    def default_tier(self) -> str:
        if self._codes is not None:
            return "ivf_pq"
        if self._centroids is not None:
            return "ivf"
        return "exact"

    def available_tiers(self) -> Tuple[str, ...]:
        out = ["exact"]
        if self._centroids is not None:
            out.append("ivf")
        if self._codes is not None:
            out.append("ivf_pq")
        return tuple(out)

    def warm(self) -> int:
        """Run every reachable request signature once (delegates to the
        program; the registry calls this at register time)."""
        return self.program.warm()

    # ------------------------------------------------------------------
    # search
    # ------------------------------------------------------------------

    def search(self, queries, k: int = 10, nprobe: Optional[int] = None,
               tier: Optional[str] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Top-``k`` ids + distances for ``queries`` ([B, dim]).

        Returns ``(ids, distances)`` as [B, k] host arrays; empty slots
        (k > live points) carry id -1 and distance +inf. Oversized batches
        are host-looped in ``batch_max`` slices; each slice pads up the
        shared ladder onto a warmed signature."""
        q = np.atleast_2d(np.asarray(queries, np.float32))
        if q.ndim != 2 or q.shape[1] != self.config.dim:
            raise ValueError(
                f"queries must be [B, {self.config.dim}], got "
                f"{np.asarray(queries).shape}")
        if not 1 <= k <= self.config.max_k:
            raise ValueError(
                f"k must be in [1, {self.config.max_k}], got {k}")
        tier = tier or self.default_tier
        if tier not in self.available_tiers():
            raise ValueError(
                f"tier {tier!r} not available; index has "
                f"{self.available_tiers()}")
        if self.config.metric == "cosine":
            q = _l2_normalize(q)
        kb = min((c for c in self.k_choices if c >= k),
                 default=self.k_choices[-1])
        p = self._resolve_nprobe(nprobe) if tier != "exact" else 0
        ids_out, dist_out = [], []
        bm = self.config.batch_max
        with self._lock, torch.inference_mode(), f32_products(self.device):
            for lo in range(0, q.shape[0], bm):
                ids, dists = self._search_slice(q[lo:lo + bm], kb, p, tier)
                ids_out.append(ids[:, :k])
                dist_out.append(dists[:, :k])
        obs.counter(
            "dl4j_search_requests_total",
            "search dispatches by index and scoring tier",
            ("index", "tier")).inc(index=self.config.name, tier=tier)
        return np.concatenate(ids_out), np.concatenate(dist_out)

    def _resolve_nprobe(self, nprobe: Optional[int]) -> int:
        choices = self.nprobe_choices
        if nprobe is None:
            return choices[0]
        # round up into the warmed grid (never out of it)
        return min((c for c in choices if c >= nprobe), default=choices[-1])

    def _search_slice(self, q: np.ndarray, kb: int, p: int, tier: str):
        rows = q.shape[0]
        b = bucketing.bucket_size(rows) if bucketing.bucketing_enabled() else rows
        tel = bucketing.telemetry()
        qd = self._to_dev(bucketing.pad_rows_zero(q, b))
        scanned = None
        if tier == "exact":
            tel.record_hit(SITE_EXACT, rows, b)
            scores, ids = exact_topk(qd, self._corpus, self._cnorms, self.n, 0, kb)
        elif tier == "ivf":
            tel.record_hit(SITE_IVF, rows, b)
            scores, ids, scanned = ivf_topk(
                qd, self._centroids, self._postings, self._sizes,
                self._corpus, self._cnorms, p, kb)
        else:
            tel.record_hit(SITE_PQ, rows, b)
            scores, ids, scanned = pq_topk(
                qd, self._centroids, self._postings, self._sizes,
                self._codes, self._codebooks, self._corpus, self._cnorms,
                p, kb, self.rerank_width(kb))
        if self._pending_n > 0:
            tel.record_hit(SITE_EXACT, rows, b)
            ps, pi = exact_topk(qd, self._pending_corpus, self._pending_cnorms,
                                self._pending_n, self.n, kb)
            scores, ids = merge_topk(scores, ids, ps, pi, kb)
        s = scores[:rows].cpu().numpy()
        i = ids[:rows].cpu().numpy()
        scanned = (np.full(rows, self.n, np.int64) if scanned is None
                   else scanned[:rows].cpu().numpy().astype(np.int64))
        scanned = scanned + self._pending_n
        hist = obs.histogram(
            "dl4j_search_candidates_scanned",
            "candidates exactly/ADC-scored per query by tier",
            ("index", "tier"))
        for c in scanned:
            hist.observe(float(c), index=self.config.name, tier=tier)
        dead = ~np.isfinite(s)
        i = np.where(dead, -1, i)
        if self.config.metric == "cosine":
            d = np.where(dead, np.inf, np.maximum(-s, 0.0) / 2.0)
        else:
            d = np.where(dead, np.inf, np.sqrt(np.maximum(-s, 0.0)))
        return i, d.astype(np.float32)

    # ------------------------------------------------------------------
    # incremental adds
    # ------------------------------------------------------------------

    def add(self, vectors) -> np.ndarray:
        """Append rows; returns their ids. New rows live in the pending
        buffer (searchable immediately through the exact+merge pair) until
        ``merge_pending`` folds them into the main structure. A full buffer
        forces a synchronous merge — the backpressure is deliberate."""
        if self._pending_np is None:
            raise ValueError("index built with pending_cap=0: read-only")
        v = np.atleast_2d(np.asarray(vectors, np.float32))
        if v.shape[1] != self.config.dim:
            raise ValueError(f"vectors must be [*, {self.config.dim}]")
        if self.config.metric == "cosine":
            v = _l2_normalize(v)
        with self._lock:
            ids = []
            for row in v:
                if self._pending_n >= self.config.pending_cap:
                    self.merge_pending()
                self._pending_np[self._pending_n] = row
                ids.append(self.n + self._pending_n)
                self._pending_n += 1
            self._pending_corpus = self._to_dev(self._pending_np)
            self._pending_cnorms = self._to_dev(
                np.sum(self._pending_np * self._pending_np, axis=1))
        return np.asarray(ids, np.int64)

    def merge_pending(self) -> int:
        """Fold the pending buffer into the main structure (an admin path:
        capacity/list width may grow a rung, which re-warms). Ids are
        stable: pending row i keeps id n+i. The coarse quantizer is NOT
        retrained; new rows join their nearest existing list."""
        with self._lock:
            if self._pending_n == 0:
                return 0
            merged = np.concatenate(
                [self._vectors, self._pending_np[:self._pending_n]])
            moved = self._pending_n
            centroids = (None if self._centroids is None
                         else self._centroids.cpu().numpy())
            assign = codes = codebooks = None
            if centroids is not None:
                new_assign, _ = assign_points(
                    self._pending_np[:moved], centroids, device=self.device)
                assign = np.concatenate([self._assign, new_assign])
                if self._codebooks is not None:
                    codebooks = self._codebooks.cpu().numpy()
                    old_codes = self._codes[:self.n].cpu().numpy()
                    new_codes = _encode_pq(
                        self._pending_np[:moved], codebooks, self.device)
                    codes = np.concatenate([old_codes, new_codes])
            old_shapes = (self._corpus.shape,
                          None if self._postings is None
                          else self._postings.shape)
            self._install(merged, centroids, assign, codebooks, codes)
            new_shapes = (self._corpus.shape,
                          None if self._postings is None
                          else self._postings.shape)
            if new_shapes != old_shapes:
                self.program.warm()
            obs.event("search_pending_merged", index=self.config.name,
                      moved=moved, points=self.n,
                      grew=bool(new_shapes != old_shapes))
            return moved

    # ------------------------------------------------------------------
    # recall probe
    # ------------------------------------------------------------------

    def _measure_recall(self, k: int = 10, probes: int = 64):
        """Held-out probe set sampled at build time: corpus rows + small
        deterministic noise, recall@k of each ANN tier vs the exact tier.
        Feeds the dl4j_search_recall_at_k gauge and ``stats``."""
        k = min(k, self.config.max_k, self.n)
        if k < 1 or self.n < 2:
            return
        rs = np.random.RandomState(self.config.seed + 1)
        m = min(probes, self.n)
        base = self._vectors[rs.choice(self.n, size=m, replace=False)]
        scale = float(np.std(base)) or 1.0
        queries = base + rs.normal(0, 0.05 * scale, base.shape).astype(np.float32)
        exact_ids, _ = self.search(queries, k=k, tier="exact")
        gauge = obs.gauge(
            "dl4j_search_recall_at_k",
            "build-time recall vs the exact tier on a held-out probe set",
            ("index", "tier"))
        self.stats["recall_k"] = k
        for tier in self.available_tiers()[1:]:
            ids, _ = self.search(queries, k=k, tier=tier)
            hits = sum(len(np.intersect1d(a[a >= 0], b[b >= 0]))
                       for a, b in zip(exact_ids, ids))
            recall = hits / float(exact_ids.shape[0] * k)
            gauge.set(recall, index=self.config.name, tier=tier)
            self.stats[f"recall_at_{k}_{tier}"] = round(recall, 4)

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------

    def save(self, path) -> str:
        """Real-shaped arrays + manifest in a CRC'd zip (atomic write).
        Merge the pending buffer first so nothing is lost."""
        with self._lock:
            if self._pending_n:
                self.merge_pending()
            arrays = {"vectors": self._vectors}
            if self._centroids is not None:
                arrays["centroids"] = self._centroids.cpu().numpy()
                arrays["assign"] = self._assign
            if self._codebooks is not None:
                arrays["codebooks"] = self._codebooks.cpu().numpy()
                arrays["codes"] = self._codes[:self.n].cpu().numpy()
            blobs = {}
            for name, arr in arrays.items():
                buf = io.BytesIO()
                np.save(buf, arr)
                blobs[f"{name}.npy"] = buf.getvalue()
            manifest = {
                "format_version": INDEX_FORMAT_VERSION,
                "config": asdict(self.config),
                "points": self.n,
                "stats": self.stats,
                "entries": {name: {"crc32": zlib.crc32(b) & 0xFFFFFFFF,
                                   "size": len(b)}
                            for name, b in blobs.items()},
            }

            def write_entries(zf):
                zf.writestr(_MANIFEST, json.dumps(manifest, indent=2))
                for name, b in blobs.items():
                    zf.writestr(name, b)

            _atomic_write_zip(path, write_entries)
            obs.event("search_index_saved", index=self.config.name,
                      path=str(path), points=self.n)
            return str(path)

    @classmethod
    def load(cls, path, device=None) -> "VectorIndex":
        """Rebuild the device layout on ``device`` (None: the GPU) from a
        saved index (either package's) — no retraining, no re-assignment."""
        import zipfile

        with zipfile.ZipFile(path) as zf:
            manifest = json.loads(zf.read(_MANIFEST))
            if manifest.get("format_version") != INDEX_FORMAT_VERSION:
                raise ValueError(
                    f"index format {manifest.get('format_version')} != "
                    f"{INDEX_FORMAT_VERSION}")
            blobs = {}
            for name, meta in manifest["entries"].items():
                b = zf.read(name)
                if (zlib.crc32(b) & 0xFFFFFFFF) != meta["crc32"]:
                    raise ValueError(f"index entry {name} failed CRC")
                blobs[name] = np.load(io.BytesIO(b))
        cfg_d = manifest["config"]
        for key in ("k_choices", "nprobe_choices"):
            if cfg_d.get(key) is not None:
                cfg_d[key] = tuple(cfg_d[key])
        config = IndexConfig(**cfg_d)
        ix = cls(config, device=device)
        ix._install(
            np.asarray(blobs["vectors.npy"], np.float32),
            blobs.get("centroids.npy"),
            blobs.get("assign.npy"),
            blobs.get("codebooks.npy"),
            blobs.get("codes.npy"),
        )
        for key, val in manifest.get("stats", {}).items():
            ix.stats.setdefault(key, val)
        obs.event("search_index_loaded", index=config.name, path=str(path),
                  points=ix.n)
        return ix


# ---------------------------------------------------------------------------
# build helpers
# ---------------------------------------------------------------------------


def _l2_normalize(v: np.ndarray) -> np.ndarray:
    norms = np.linalg.norm(v, axis=1, keepdims=True)
    return (v / np.maximum(norms, 1e-12)).astype(np.float32)


def _subsample(vectors: np.ndarray, cap: int,
               rs: np.random.RandomState) -> np.ndarray:
    if vectors.shape[0] <= cap:
        return vectors
    return vectors[rs.choice(vectors.shape[0], size=cap, replace=False)]


def _train_pq(vectors, sample, config: IndexConfig, device):
    """Per-subspace codebooks (random-init Lloyd on the training sample)
    and uint8 codes for the full corpus, encoded through the bucketed
    ``kmeans.assign`` site."""
    m, ksub = config.pq_m, config.pq_ksub
    dsub = config.dim // m
    ksub_eff = min(ksub, sample.shape[0])
    books = np.zeros((m, ksub, dsub), np.float32)
    codes = np.zeros((vectors.shape[0], m), np.uint8)
    for j in range(m):
        sub = np.ascontiguousarray(sample[:, j * dsub:(j + 1) * dsub])
        km = KMeansClustering(ksub_eff, config.kmeans_iters, "euclidean",
                              seed=config.seed + 7 * j + 1, init="random",
                              device=device)
        centers = km.apply_to(sub).centers.astype(np.float32)
        books[j, :ksub_eff] = centers
        if ksub_eff < ksub:           # unused codebook slots: never encoded
            books[j, ksub_eff:] = centers[0]
        full_sub = np.ascontiguousarray(
            vectors[:, j * dsub:(j + 1) * dsub])
        a, _ = assign_points(full_sub, centers, device=device)
        codes[:, j] = a.astype(np.uint8)
    return books, codes


def _encode_pq(vectors: np.ndarray, codebooks: np.ndarray, device) -> np.ndarray:
    m, _, dsub = codebooks.shape
    codes = np.zeros((vectors.shape[0], m), np.uint8)
    for j in range(m):
        sub = np.ascontiguousarray(vectors[:, j * dsub:(j + 1) * dsub])
        a, _ = assign_points(sub, codebooks[j], device=device)
        codes[:, j] = a.astype(np.uint8)
    return codes
