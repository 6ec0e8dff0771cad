"""Elastic multi-process data-parallel training on the membership runtime
(the PyTorch port of ``deeplearning4j_tpu/train/elastic.py``).

``ElasticTrainer`` runs synchronous data-parallel SGD across N worker
*processes*, each a single-process PyTorch instance on its device,
exchanging explicit gradient payloads through the ``parallel/elastic.py``
:class:`FileStore` or the ``parallel/netstore.py`` TCP store (optionally
ternary-compressed through ``parallel/compress.py``). When a worker's lease
lapses mid-epoch the survivors drain to the step boundary, re-form at the
reduced world size — re-sharding the arXiv 2004.13336 optimizer-state
segments — and keep training; the preempted worker rejoins through a live
handoff or the distributed checkpoint layout (per-rank shards + CRC'd
manifest, ``train/resilience.py``).

Three design decisions make elasticity *bit-exact* rather than merely
tolerant (the tests assert equality, not closeness):

- **Virtual shards.** The global batch of every step is split into ``v``
  fixed-shape padded micro-shards (``v`` frozen at bootstrap). Vshard ``j``
  of step ``s`` always has the same rows, padded shape and weight
  ``n_j / N``, and draws its randomness from its own ``torch.Generator`` on
  the model's device seeded from the model's base seed and ``s*v + j``
  (the port's counterpart of the JAX package's ``fold_in(base, s*v + j)``).
  Membership only decides WHICH worker computes a vshard (``j % world``).
  Each vshard's gradient reaches the host as f32 numpy and the payloads are
  summed there in vshard order, so the sum is bitwise invariant under
  shrink and grow.
- **Segmented optimizer state with R-way mirrors.** Eligible layers'
  updater statistics live as flat per-rank segments (each worker updates
  1/W of the vector); the segments of rank ``t`` are also kept by
  :func:`mirror_ranks` (rack-aware; ``DL4J_TPU_ELASTIC_MIRRORS``, default
  2), so a single worker's death loses nothing. Layers with gradient
  normalization, constraints or mixed dtypes take dense replicated updates
  (the same rule as ``parallel/grads.py``).
- **Step-boundary reconfiguration.** Membership changes surface as
  :class:`MembershipChanged` and are handled only between steps: survivors
  re-publish state under the new generation, re-slice segments, and re-run
  the interrupted step at the new world — nothing is half-applied.

The payloads, handoff blobs and checkpoint files are the JAX package's npz
layout under the same keys. The port cannot hold the JAX package's
threefry key, so its ``meta`` records ``base_seed``. Not ported: the
elastic-of-slices composition (a member that is a mesh of several ranks,
``slice_spec``), ROADMAP Queue 1 item 7's remnant. Each rank writes its
warm-set bundle beside its checkpoint shard
(``aot.save_distributed_bundle``, ``ckpt_<tag>_r<rank>.aotbundle``).

The CLI (``python -m deeplearning4j_tpu_torch.train.elastic worker|launch
[--device cpu]``) drives the synthetic MLP workload; ``launch`` supervises
N local worker processes and can relaunch killed ones (the rejoin path).
"""

from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.nn import aot
from deeplearning4j_tpu_torch.obs import fleet
from deeplearning4j_tpu_torch.parallel import compress as compression
from deeplearning4j_tpu_torch.parallel.elastic import (
    ElasticRuntime,
    MembershipChanged,
    View,
)
from deeplearning4j_tpu_torch.parallel.netstore import open_store
from deeplearning4j_tpu_torch.train import resilience
from deeplearning4j_tpu_torch.train.updaters import apply_gradient_normalization
from deeplearning4j_tpu_torch.utils import bucketing
from deeplearning4j_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten_like

__all__ = ["ElasticTrainer", "mirror_ranks"]

SLICES_ITEM = "ROADMAP Queue 1 item 7 (elastic-of-slices)"


def mirror_ranks(t: int, W: int, R: int,
                 racks: Sequence[str] = ()) -> List[int]:
    """Ranks holding mirrors of rank ``t``'s optimizer segments under
    replication factor ``R`` (owner + R-1 mirrors, capped at the world
    size) with rack-aware placement: candidates in OTHER racks than the
    owner's sort first, ties broken by ring distance ``(t - r) % W`` —
    nearest predecessor first. With uniform racks and R=2 this is the
    classic buddy (the mirror of ``t`` sits at ``(t-1) % W``). Deterministic
    in its inputs, so every member derives the same placement from the
    view's recorded rack labels."""
    W = int(W)
    R = min(int(R), W)
    if R <= 1 or W <= 1:
        return []
    owner_rack = racks[t] if t < len(racks) else ""
    return sorted(
        (r for r in range(W) if r != t),
        key=lambda r: ((racks[r] if r < len(racks) else "") == owner_rack,
                       (t - r) % W))[:R - 1]


def _slice_ranks(slice_spec) -> int:
    """The rank count of a ``d[,t[,s]]`` slice spec (1 for None/empty)."""
    if not slice_spec:
        return 1
    n = 1
    for part in str(slice_spec).split(","):
        if part.strip():
            n *= int(part)
    return n


def _vshard_seed(base: int, index: int) -> int:
    """The seed of vshard ``index`` (= ``s*v + j``) of a model seeded
    ``base``: one 63-bit value per (base, index)."""
    return (int(base) * 0x9E3779B97F4A7C15 + int(index)) % (1 << 63)


# ---------------------------------------------------------------------------
# npz framing for store payloads, host <-> device
# ---------------------------------------------------------------------------


def _pack_arrays(arrays: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _unpack_arrays(data: bytes) -> Dict[str, np.ndarray]:
    with np.load(io.BytesIO(data), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _json_to_array(value: dict) -> np.ndarray:
    return np.frombuffer(json.dumps(value).encode("utf-8"), np.uint8)


def _array_to_json(arr: np.ndarray) -> dict:
    return json.loads(arr.tobytes().decode("utf-8"))


def _np(t: torch.Tensor) -> np.ndarray:
    """A tensor on the host as numpy (bf16, which numpy lacks, as f32:
    lossless both ways)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _flat_np(tree) -> np.ndarray:
    leaves = tree_leaves(tree)
    return np.concatenate([np.ravel(_np(l)) for l in leaves]) if leaves else np.zeros(0)


# ---------------------------------------------------------------------------
# Exchange plan (per layer), mirroring parallel/grads.py eligibility
# ---------------------------------------------------------------------------


@dataclass
class _Entry:
    key: int
    template: Any              # the layer's params tree (structure and dtypes)
    shapes: Tuple[Tuple[int, ...], ...]
    n: int
    dtype: Any                 # the leaves' one torch dtype (flat mode)
    mode: str                  # "flat" | "dense"
    updater: Any
    cfg: Any


class _JobDone(Exception):
    """Internal: the job completed while this worker was expelled; the final
    state was adopted from the ``done`` blob rank 0 leaves in the store."""


class _Prefetcher:
    """Asynchronous payload fetch: polls the store for a set of keys from a
    daemon thread so the fetch overlaps with in-process compute (my own
    vshard backward passes, the dense update) instead of serializing behind
    it at the boundary wait. ``drain()`` hands finished payloads to the
    consumer; the boundary wait only blocks on whatever the overlap didn't
    already cover — that residue is the measured
    ``dl4j_elastic_boundary_stall_seconds``. Purely an ordering
    optimization: payload bytes and the fixed-order combine are untouched
    (``DL4J_TPU_ELASTIC_ASYNC=0`` falls back to the synchronous fetch)."""

    def __init__(self, store, keys: Dict[Any, str], poll: float):
        self.store = store
        self._pending = dict(keys)
        self.poll = float(poll)
        self._lock = threading.Lock()
        self._got: Dict[Any, Dict[str, np.ndarray]] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="elastic-prefetch", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while self._pending and not self._stop.is_set():
            for ident, key in list(self._pending.items()):
                if self._stop.is_set():
                    return
                try:
                    data = self.store.get(key)
                    arrays = None if data is None else _unpack_arrays(data)
                except (OSError, ValueError):
                    return  # store gone / garbage: the sync path takes over
                if arrays is not None:
                    with self._lock:
                        self._got[ident] = arrays
                    del self._pending[ident]
            if self._pending:
                self._stop.wait(self.poll)

    def drain(self) -> Dict[Any, Dict[str, np.ndarray]]:
        with self._lock:
            got = dict(self._got)
            self._got.clear()
        return got

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)


class ElasticTrainer:
    """Synchronous elastic data-parallel trainer for a MultiLayerNetwork
    (see the module docstring). ``store_dir`` is a directory, ``file:DIR``
    or ``tcp://host:port``."""

    def __init__(self, model, store_dir, worker_id: str, *, world: int = 2,
                 vshards: Optional[int] = None, compress: bool = False,
                 threshold: float = 1e-3, ckpt_dir=None, ckpt_every: int = 0,
                 ttl: Optional[float] = None, poll: Optional[float] = None,
                 replication: Optional[int] = None,
                 rack: Optional[str] = None, slice_spec=None,
                 async_exchange: Optional[bool] = None):
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

        if isinstance(model, ComputationGraph):
            raise NotImplementedError(
                "ElasticTrainer drives MultiLayerNetwork models; wrap CG "
                "training in the single-host paths meanwhile")
        if _slice_ranks(slice_spec) != 1:
            raise NotImplementedError(
                f"slice_spec={slice_spec!r}: an elastic member of more than one rank "
                f"(elastic-of-slices) is not ported; see {SLICES_ITEM}")
        if model.params is None:
            model.init()
        model.init_opt_state()
        self.model = model
        self.store = open_store(store_dir)
        self.wid = str(worker_id)
        self.world = int(world)
        self.vshards = None if vshards is None else int(vshards)
        self.compress = bool(compress)
        self.threshold = float(threshold)
        self.ckpt_dir = None if ckpt_dir is None else os.fspath(ckpt_dir)
        self.ckpt_every = int(ckpt_every)
        self.replication = max(1, int(
            os.environ.get("DL4J_TPU_ELASTIC_MIRRORS", "2")
            if replication in (None, 0) else replication))
        self.async_exchange = bool(
            os.environ.get("DL4J_TPU_ELASTIC_ASYNC", "1") != "0"
            if async_exchange is None else async_exchange)
        self.rt = ElasticRuntime(self.store, self.wid, ttl=ttl, poll=poll,
                                 rack=rack)
        obs.gauge("dl4j_mirror_replication_factor",
                  "Configured optimizer-segment replication factor R "
                  "(owner + R-1 mirrors, capped at world size)").set(
                      self.replication)
        self.stall_s = 0.0        # cumulative boundary time blocked on payloads
        self.payload_bytes = 0    # bytes this worker wrote into the store for steps
        # fleet observability: per-rank step-wall skew detection (rank 0
        # evaluates), snapshot publication throttle (~1/s into the store)
        self._straggler = fleet.StragglerDetector()
        self._stragglers: set = set()
        self._last_publish = 0.0
        self._build_plan()
        self._base_seed = int(model.conf.seed)
        self._vgen = torch.Generator(device=model.device)
        # formed state: segment stats per flat entry {key: {rank: [S, m]}},
        # dense structured opt per dense entry, residuals per owned vshard
        self._segs: Dict[int, Dict[int, np.ndarray]] = {}
        self._dense_opt: Dict[int, Any] = {}
        self._residuals: Dict[int, np.ndarray] = {}
        self._m: Dict[int, int] = {}
        self._formed = False
        self.losses: List[float] = []
        self.epoch = 0
        self.step_in_epoch = 0
        self._steps_per_epoch = 0

    # -- plan ---------------------------------------------------------------
    def _build_plan(self):
        model = self.model
        entries: Dict[int, _Entry] = {}
        order = list(range(len(model.layers)))
        for key in order:
            p = model.params[key]
            leaves = tree_leaves(p)
            if not leaves:
                continue
            cfg = model.layers[key]
            n = sum(int(l.numel()) for l in leaves)
            dtypes = {l.dtype for l in leaves}
            uniform_float = len(dtypes) == 1 and next(iter(dtypes)).is_floating_point
            eligible = (uniform_float and not getattr(cfg, "gradient_normalization", None)
                        and not getattr(cfg, "constraints", None))
            entries[key] = _Entry(
                key=key, template=p, shapes=tuple(tuple(l.shape) for l in leaves), n=n,
                dtype=next(iter(dtypes)) if uniform_float else None,
                mode="flat" if eligible else "dense",
                updater=model._updaters[key], cfg=cfg)
        self._entries = entries
        self._order = order
        self._flat_keys = [k for k in order if k in entries and entries[k].mode == "flat"]
        self._dense_keys = [k for k in order if k in entries and entries[k].mode == "dense"]
        self._total_n = sum(entries[k].n for k in self._flat_keys)

    def _dev(self, a: np.ndarray, dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=self.model.device,
                                                            dtype=dtype)

    def _unflat(self, flat: torch.Tensor, e: _Entry):
        """A flat vector back into the layer's params tree."""
        out, off = [], 0
        for shp in e.shapes:
            k = int(np.prod(shp)) if shp else 1
            out.append(flat[off:off + k].reshape(shp))
            off += k
        return tree_unflatten_like(e.template, out)

    def _stat_template(self, e: _Entry, m: int):
        """The updater state of one ``[m]`` segment (its structure, leaf
        count and the statistics' dtype)."""
        template = e.updater.init(torch.zeros((m,), dtype=e.dtype, device=self.model.device))
        leaves = tree_leaves(template)
        dt = leaves[0].dtype if leaves else e.dtype
        return template, len(leaves), dt

    # -- structured <-> flat optimizer stats --------------------------------
    def _stats_full_from_structured(self, e: _Entry, structured,
                                    length: int) -> np.ndarray:
        """Per-layer structured opt state -> ``[n_stats, length]`` host
        stack (outer-stat-major leaf grouping, the layout of
        ``DataParallelStep._to_flat_opt``)."""
        leaves = tree_leaves(structured)
        n_inner = len(e.shapes)
        if leaves and len(leaves) % n_inner != 0:
            raise ValueError(
                f"opt state for layer {e.key} has {len(leaves)} leaves, not "
                f"a multiple of the {n_inner} param leaves")
        stats = []
        for i in range(0, len(leaves), n_inner):
            flat = np.concatenate([np.ravel(_np(l)) for l in leaves[i:i + n_inner]])
            row = np.zeros((length,), flat.dtype)
            row[:e.n] = flat
            stats.append(row)
        if not stats:
            return np.zeros((0, length), np.float32)
        return np.stack(stats)

    def _stats_structured_from_full(self, e: _Entry, full: np.ndarray):
        """Inverse: ``[n_stats, >=n]`` stack -> the model's structured
        per-layer opt state."""
        template, _, dt = self._stat_template(e, e.n)
        subtrees = [self._unflat(self._dev(row[:e.n], dt), e) for row in full]
        return tree_unflatten_like(template, subtrees)

    # -- vshard / mirror geometry --------------------------------------------
    def _view_racks(self, view: View, prev: bool = False) -> List[str]:
        members = view.prev_members if prev else view.members
        labels = view.prev_racks if prev else view.racks
        return [labels.get(m, "") for m in members]

    def _held_ranks(self, rank: int, W: int,
                    racks: Sequence[str] = ()) -> List[int]:
        """Segments this worker carries: its primary plus every rank whose
        R-way rack-aware mirror set includes it (R=2, uniform racks ⇒ the
        classic ``[rank, (rank+1) % W]`` buddy pair)."""
        return [rank] + [t for t in range(W) if t != rank
                         and rank in mirror_ranks(t, W, self.replication, racks)]

    def _vshard_owner(self, j: int) -> int:
        return j % self.rt.view.world

    def _my_vshards(self) -> List[int]:
        r = self.rt.view.rank_of(self.wid)
        W = self.rt.view.world
        return [j for j in range(self.vshards) if j % W == r]

    # -- forming / re-forming ------------------------------------------------
    def _slice_segs_from_full(self, full_by_key: Dict[int, np.ndarray], view: View):
        """(Re-)slice my primary + R-way mirror segments for the new world
        out of the full per-layer stat stacks."""
        W = view.world
        r = view.rank_of(self.wid)
        held = self._held_ranks(r, W, self._view_racks(view))
        segs: Dict[int, Dict[int, np.ndarray]] = {}
        m_of: Dict[int, int] = {}
        for key in self._flat_keys:
            e = self._entries[key]
            m = -(-e.n // W)
            m_of[key] = m
            full = full_by_key[key]
            n_pad = m * W
            padded = np.zeros((full.shape[0], n_pad), full.dtype)
            padded[:, :min(full.shape[1], n_pad)] = full[:, :n_pad]
            segs[key] = {t: padded[:, t * m:(t + 1) * m].copy() for t in held}
        self._segs = segs
        self._m = m_of

    def _form_fresh(self, view: View):
        """Bootstrap form: every worker derives identical state from the
        (seed-deterministic) model init — no handoff needed."""
        model = self.model
        full = {key: self._stats_full_from_structured(
            self._entries[key], model.opt_state[key], self._entries[key].n)
            for key in self._flat_keys}
        self._slice_segs_from_full(full, view)
        self._dense_opt = {k: model.opt_state[k] for k in self._dense_keys}
        self._residuals = {j: np.zeros(self._total_n, np.float32)
                           for j in range(self.vshards)
                           if self._vshard_owner(j) == view.rank_of(self.wid)}
        self._formed = True

    def _load_replicated(self, arrays: Dict[str, np.ndarray], *, opt_keys, meta: dict):
        """Params, the updater state of ``opt_keys``, layer state and the
        position from a handoff / checkpoint / done blob."""
        model = self.model
        params = []
        for key in self._order:
            e = self._entries.get(key)
            if e is None:
                params.append(model.params[key])
                continue
            like = tree_leaves(model.params[key])
            params.append(tree_unflatten_like(e.template, [
                self._dev(arrays[f"p{key}_{li}"], l.dtype) for li, l in enumerate(like)]))
        model.params = tuple(params)
        opt = {}
        for key in opt_keys:
            like = tree_leaves(model.opt_state[key])
            opt[key] = tree_unflatten_like(model.opt_state[key], [
                self._dev(arrays[f"o{key}_{li}"], l.dtype) for li, l in enumerate(like)])
        st_like = tree_leaves(model.state)
        model.state = tree_unflatten_like(model.state, [
            self._dev(arrays[f"st{li}"], l.dtype) for li, l in enumerate(st_like)])
        self._base_seed = int(meta.get("base_seed", self._base_seed))
        self.losses = [float(v) for v in meta.get("losses", [])]
        return opt

    def _replicated_arrays(self, opt_state) -> Dict[str, np.ndarray]:
        """The inverse of :meth:`_load_replicated` (``opt_state``: {key:
        structured state} of the layers whose updater state goes along)."""
        model = self.model
        full: Dict[str, np.ndarray] = {}
        for key in self._order:
            if key not in self._entries:
                continue
            for li, leaf in enumerate(tree_leaves(model.params[key])):
                full[f"p{key}_{li}"] = _np(leaf)
        for key, o in opt_state.items():
            for li, leaf in enumerate(tree_leaves(o)):
                full[f"o{key}_{li}"] = _np(leaf)
        for li, leaf in enumerate(tree_leaves(model.state)):
            full[f"st{li}"] = _np(leaf)
        return full

    def _meta(self, **extra) -> np.ndarray:
        return _json_to_array(dict({
            "iteration": int(self.model.iteration), "epoch": self.epoch,
            "step": self.step_in_epoch, "base_seed": self._base_seed,
            "losses": [float(v) for v in self.losses]}, **extra))

    def _form_from_checkpoint(self, view: View, ckpt: dict) -> bool:
        """Full-group restart: rebuild params/opt/position from the newest
        valid distributed checkpoint (``resilience.load_distributed_...``)."""
        man = ckpt["manifest"]
        pa = ckpt["params"]
        meta = _array_to_json(pa["meta"])
        self._dense_opt.update(self._load_replicated(pa, opt_keys=self._dense_keys, meta=meta))
        self.model.iteration = int(meta["iteration"])
        self.epoch, self.step_in_epoch = int(meta["epoch"]), int(meta["step"])
        # optimizer segments: assemble the full stacks from the per-rank
        # shard files (each carries primary + mirrors; any shard can serve a
        # dropped one's segments), then re-slice for the new world
        W_old = int(man["world"])
        full = {}
        for key in self._flat_keys:
            full[key] = self._assemble_full_stats(
                self._entries[key], W_old, lambda t, k=key: self._ckpt_seg(ckpt, k, t))
            if full[key] is None:
                return False
        self._slice_segs_from_full(full, view)
        self._restore_residuals(view, lambda j: self._ckpt_res(ckpt, W_old, j))
        self._formed = True
        obs.event("elastic_restart_restore", manifest=ckpt["path"],
                  iteration=self.model.iteration, epoch=self.epoch,
                  step=self.step_in_epoch)
        return True

    def _ckpt_seg(self, ckpt, key, t):
        for arrays in ckpt["shards"].values():
            a = arrays.get(f"k{key}_t{t}")
            if a is not None:
                return a
        return None

    def _ckpt_res(self, ckpt, W_old, j):
        return ckpt["shards"].get(j % W_old, {}).get(f"res{j}")

    def _assemble_full_stats(self, e: _Entry, W_old: int, seg_of):
        """Rebuild one layer's full ``[n_stats, m_old * W_old]`` stat stack
        from per-rank segment sources (handoff files or checkpoint shards);
        ``seg_of(t)`` returns rank ``t``'s segment from primary or mirror,
        or None when unrecoverable."""
        m_old = -(-e.n // W_old)
        _, n_stats, dt = self._stat_template(e, m_old)
        full = np.zeros((n_stats, m_old * W_old), _np(torch.zeros((), dtype=dt)).dtype)
        for t in range(W_old):
            seg = seg_of(t)
            if seg is None:
                obs.event("elastic_segment_unrecoverable", layer=e.key, rank=t, world=W_old)
                return None
            full[:, t * m_old:(t + 1) * m_old] = seg
        return full

    def _restore_residuals(self, view: View, res_of):
        """Residuals move with vshard ownership; a dead worker's pending
        sub-threshold gradient mass is lost (zeros) — the documented,
        tolerance-bounded cost of compressed elasticity."""
        r = view.rank_of(self.wid)
        W = view.world
        res: Dict[int, np.ndarray] = {}
        for j in range(self.vshards):
            if j % W != r:
                continue
            a = res_of(j)
            res[j] = (np.zeros(self._total_n, np.float32) if a is None
                      else np.asarray(a, np.float32).copy())
        self._residuals = res

    # -- reform (handoff) ----------------------------------------------------
    def _reform(self, view: View):
        """Adopt ``view`` and re-form training state at its world size,
        looping through any further churn that lands mid-handoff."""
        while True:
            try:
                self._do_reform(view)
                return
            except MembershipChanged as mc:
                view = mc.view

    def _do_reform(self, view: View):
        self.rt.adopt(view)
        if self.wid not in view.members:
            # expelled (partition outlived the TTL): wait for the survivors
            # to grow the view back around our renewed lease, then take the
            # handoff as a joiner. If the job finishes first (rank 0 leaves
            # the terminal `done` blob), adopt that final state instead.
            self._formed = False
            view = self.rt.await_readmission(should_stop=lambda: self.store.exists("done"))
            if view is None:
                self._adopt_done()
                raise _JobDone()
            raise MembershipChanged(view)
        if self.vshards is None:
            self.vshards = max(view.world, 1)
        holders = view.holders()
        if not holders:
            # bootstrap or full-group restart: no live state to hand off
            ckpt = (resilience.load_distributed_checkpoint(self.ckpt_dir)
                    if self.ckpt_dir else None)
            if ckpt is not None and self._form_from_checkpoint(view, ckpt):
                return
            if view.reason == "restart":
                obs.event("elastic_restart_fresh", gen=view.gen)
            self._sync_to(view)
            self._form_fresh(view)
            return
        g = view.gen
        if self.wid in holders and self._formed:
            self._publish_handoff(view)
        full, hands = self._await_handoff(view)
        # adopt the coordinator's full copy (identical to a survivor's own
        # state; REQUIRED for a joiner)
        meta = _array_to_json(full["meta"])
        self._dense_opt.update(self._load_replicated(full, opt_keys=self._dense_keys,
                                                     meta=meta))
        self._sync_to(view)
        # optimizer segments: primary from the old owner's hand file, a
        # mirror's copy when the owner died, then re-slice
        W_old = len(view.prev_members)
        full_stats = {}
        for key in self._flat_keys:
            full_stats[key] = self._assemble_full_stats(
                self._entries[key], W_old,
                lambda t, k=key: self._hand_seg(hands, view, k, t))
            if full_stats[key] is None:
                raise RuntimeError(
                    f"elastic reform gen {g}: layer {key} optimizer "
                    "segments unrecoverable (owner and mirror both lost, "
                    "no checkpoint)")
        self._slice_segs_from_full(full_stats, view)
        self._restore_residuals(view, lambda j: self._hand_res(hands, view, j))
        self._formed = True

    def _sync_to(self, view: View):
        self.model.iteration = int(view.iteration)
        self.epoch = int(view.epoch)
        self.step_in_epoch = int(view.step)

    def _hand_seg(self, hands, view: View, key: int, t: int):
        """Rank ``t``'s outgoing segment from its old owner or ANY of its
        old mirrors (R-way, in the previous view's geometry)."""
        prev = view.prev_members
        sources = [t] + mirror_ranks(t, len(prev), self.replication,
                                     self._view_racks(view, prev=True))
        for s in sources:
            a = hands.get(prev[s], {}).get(f"k{key}_t{t}")
            if a is not None:
                return a
        return None

    def _hand_res(self, hands, view: View, j: int):
        prev = view.prev_members
        if not prev:
            return None
        return hands.get(prev[j % len(prev)], {}).get(f"res{j}")

    def _seg_arrays(self) -> Dict[str, np.ndarray]:
        return {f"k{key}_t{t}": seg for key in self._flat_keys
                for t, seg in self._segs[key].items()}

    def _publish_handoff(self, view: View):
        g = view.gen
        arrays = self._seg_arrays()
        for j, res in self._residuals.items():
            arrays[f"res{j}"] = res
        self.store.set(f"hand/{g}/{self.wid}", _pack_arrays(arrays))
        if view.holders()[0] != self.wid:
            return
        full = self._replicated_arrays({k: self._dense_opt[k] for k in self._dense_keys})
        full["meta"] = self._meta(vshards=int(self.vshards))
        self.store.set(f"hand/{g}/full", _pack_arrays(full))

    def _await_handoff(self, view: View):
        g = view.gen
        holders = list(view.holders())
        want = {wid: f"hand/{g}/{wid}" for wid in holders}
        want["__full__"] = f"hand/{g}/full"
        got: Dict[str, Dict[str, np.ndarray]] = {}
        deadline = time.monotonic() + self.rt.wait_timeout
        while want:
            for wid, key in list(want.items()):
                data = self.store.get(key)
                if data is not None:
                    got[wid] = _unpack_arrays(data)
                    del want[wid]
            if not want:
                break
            self.rt.check_for_change()
            dead = [wid for wid in want if wid != "__full__"
                    and not self.rt.member_alive(wid)]
            if dead or ("__full__" in want and holders
                        and not self.rt.member_alive(holders[0])):
                # a holder died mid-handoff (the coordinator, if the full
                # copy is missing): shrink again and retry at the new view
                self.rt.report_dead(dead or [holders[0]],
                                    (view.epoch, view.step, view.iteration))
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"elastic handoff gen {g}: still waiting on "
                    f"{sorted(want)} after {self.rt.wait_timeout:.0f}s")
            time.sleep(self.rt.poll)
        full = got.pop("__full__")
        return full, got

    # -- the step ------------------------------------------------------------
    def _partition(self, secs: float, event: str, **fields):
        """The mechanics of net_partition / rack_partition: stop
        heartbeating and stall. A stall longer than the TTL gets us
        expelled; on waking we renew the lease and rejoin through the
        handoff."""
        self.rt.membership.suspend(secs + self.rt.ttl)
        obs.event(event, **dict(fields, phase="begin", seconds=secs))
        time.sleep(secs)
        self.rt.membership.heartbeat_now()
        obs.event(event, **dict(fields, phase="end"))

    def _chaos_hooks(self, it: int, rank: int):
        chaos = resilience.active_chaos()
        if chaos is None:
            return
        chaos.maybe_host_kill(it, rank=rank)
        # a member process IS its slice (one rank), so a slice preemption
        # is one SIGKILL here (elastic rank == slice index)
        chaos.maybe_slice_kill(it, slice_index=rank)
        secs = chaos.partition_seconds(it, rank=rank)
        if secs > 0:
            self._partition(secs, "elastic_partition", wid=self.wid, rank=rank,
                            iteration=it)
        rsecs = chaos.rack_partition_seconds(it, rack=self.rt.rack)
        if rsecs > 0:
            # rack-wide blast radius: every worker with the matching
            # DL4J_TPU_RACK label goes dark at once
            self._partition(rsecs, "rack_partition", wid=self.wid, rack=self.rt.rack,
                            rank=rank, iteration=it)
        chaos.maybe_preempt(it)
        chaos.maybe_slow(it, rank=rank)

    def _vshard_payload(self, j: int, xb, yb, it: int) -> bytes:
        """Compute vshard ``j``'s weighted contribution and frame it for the
        store. Weights (``n_j / N``) and the generator's seed depend only on
        (step, j) — the membership invariance that makes elastic runs
        bit-exact."""
        from deeplearning4j_tpu_torch.nn.model import _cast_labels, _cast_mask

        model = self.model
        c = self._vshard_rows
        lo, hi = j * c, min((j + 1) * c, len(xb))
        n_j = max(hi - lo, 0)
        if n_j <= 0:
            return _pack_arrays({"n": np.asarray(0, np.int64)})
        w = np.float32(n_j) / np.float32(len(xb))
        x_j, y_j, fm, lm, ew = bucketing.pad_fit_batch(
            xb[lo:hi], yb[lo:hi], None, None, c, site="elastic.fit")
        dt, dev = model.dtype, model.device
        self._vgen.manual_seed(_vshard_seed(self._base_seed, it * self.vshards + j))
        gen, model._gen = model._gen, self._vgen
        args = (model._features(x_j), _cast_labels(y_j, dt, dev), _cast_mask(fm, dt, dev),
                _cast_mask(lm, dt, dev), _cast_mask(ew, dt, dev))
        # the vshard shape rides in the rank's warm-set bundle (nn/aot.py)
        aot.grid_site(model, "elastic.vshard").note_seen(*args)
        try:
            loss, new_state, grads, _ = model._value_and_grad(model.state, *args)
        finally:
            model._gen = gen
        arrays: Dict[str, np.ndarray] = {
            "n": np.asarray(n_j, np.int64),
            "loss": np.float32(_np(loss)) * w,
        }
        if self._flat_keys:
            gflat = _np(torch.cat([torch.cat([g.reshape(-1).float() for g in
                                              tree_leaves(grads[k])])
                                   for k in self._flat_keys])) * w
            if self.compress:
                packed, new_res = compression.encode_packed(
                    torch.from_numpy(gflat), torch.from_numpy(self._residuals[j]),
                    self.threshold)
                self._residuals[j] = new_res.numpy()
                arrays["q"] = packed.numpy()
            else:
                arrays["g"] = gflat
        for key in self._dense_keys:
            for li, leaf in enumerate(tree_leaves(grads[key])):
                arrays[f"d{key}_{li}"] = _np(leaf.float()) * w
        for li, leaf in enumerate(tree_leaves(new_state)):
            a = _np(leaf)
            if np.issubdtype(a.dtype, np.floating):
                a = a.astype(np.float32) * w
            arrays[f"s{li}"] = a
        return _pack_arrays(arrays)

    def _await_vshards(self, g: int, it: int, view: View, sync,
                       prefetch: Optional[_Prefetcher] = None,
                       ) -> List[Dict[str, np.ndarray]]:
        """Collect every vshard's payload for this step. A dead owner is
        unrecoverable mid-step (only it computed those gradients), so a
        lapsed lease drives a shrink and the survivors re-run the step."""
        v = self.vshards
        want = {j: f"grad/{g}/{it}/{j}" for j in range(v)}
        got: Dict[int, Dict[str, np.ndarray]] = {}
        deadline = time.monotonic() + self.rt.wait_timeout
        while want:
            if prefetch is not None:
                for j, arrays in prefetch.drain().items():
                    if j in want:
                        got[j] = arrays
                        del want[j]
            for j, key in list(want.items()):
                data = self.store.get(key)
                if data is not None:
                    got[j] = _unpack_arrays(data)
                    del want[j]
            if not want:
                break
            self.rt.check_for_change()
            dead = sorted({view.members[j % view.world] for j in want
                           if not self.rt.member_alive(view.members[j % view.world])})
            if dead:
                self.rt.report_dead(dead, sync)
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"elastic step {it}: vshard payloads {sorted(want)} "
                    f"missing after {self.rt.wait_timeout:.0f}s")
            time.sleep(self.rt.poll)
        return [got[j] for j in range(v)]

    def _combine(self, payloads: List[Dict[str, np.ndarray]]):
        """Fixed-order (ascending vshard) sums of the weighted payloads on
        the host, in f32: loss, flat gradient, dense per-leaf gradients,
        float state leaves. Order never depends on membership — the
        bit-exactness anchor."""
        loss = np.float32(0.0)
        gflat = np.zeros(self._total_n, np.float32)
        dense: Dict[str, np.ndarray] = {}
        state_f: Dict[str, np.ndarray] = {}
        state_i: Dict[str, np.ndarray] = {}
        packed = []
        for p in payloads:
            if int(p["n"]) == 0:
                continue
            loss = loss + p["loss"].astype(np.float32)
            if "q" in p:
                packed.append(p["q"])
            elif "g" in p:
                gflat += p["g"]
            for k, a in p.items():
                if k.startswith("d"):
                    dense[k] = dense[k] + a if k in dense else a.copy()
                elif k.startswith("s"):
                    if np.issubdtype(a.dtype, np.floating):
                        state_f[k] = state_f[k] + a if k in state_f else a.copy()
                    elif k not in state_i:
                        state_i[k] = a
        if packed:
            gflat = compression.decode_gathered(
                torch.from_numpy(np.stack(packed)), self._total_n, self.threshold,
                torch.float32).numpy()
        # re-assemble the model state tree from the summed leaves
        new_leaves = []
        for li, old in enumerate(tree_leaves(self.model.state)):
            k = f"s{li}"
            if k in state_f:
                new_leaves.append(self._dev(state_f[k], old.dtype))
            elif k in state_i:
                new_leaves.append(self._dev(state_i[k], old.dtype))
            else:
                new_leaves.append(old)
        return loss, gflat, dense, tree_unflatten_like(self.model.state, new_leaves)

    def _segment_update(self, gflat: np.ndarray, it: int, view: View):
        """Sharded optimizer update (arXiv 2004.13336): each worker updates
        its primary 1/W segment AND every segment it mirrors (R-way), on
        the model's device. Elementwise updater math means a segment's
        values are bitwise identical to the same elements of a full-vector
        update. Returns ``(new_segs, pnew_segs, my_pseg_arrays)`` —
        committed only after the whole step succeeds."""
        W = view.world
        r = view.rank_of(self.wid)
        held = self._held_ranks(r, W, self._view_racks(view))
        new_segs: Dict[int, Dict[int, np.ndarray]] = {}
        pnew: Dict[Tuple[int, int], np.ndarray] = {}
        off = 0
        with torch.no_grad():
            for key in self._flat_keys:
                e = self._entries[key]
                m = self._m[key]
                n_pad = m * W
                g_pad = np.zeros(n_pad, np.float32)
                g_pad[:e.n] = gflat[off:off + e.n]
                off += e.n
                p_full = _flat_np(self.model.params[key])
                p_pad = np.zeros(n_pad, p_full.dtype)
                p_pad[:e.n] = p_full
                template, _, dt = self._stat_template(e, m)
                new_segs[key] = {}
                for t in held:
                    sl = slice(t * m, (t + 1) * m)
                    g_seg = self._dev(g_pad[sl], e.dtype)
                    p_seg = self._dev(p_pad[sl], e.dtype)
                    o_tree = tree_unflatten_like(
                        template, [self._dev(row, dt) for row in self._segs[key][t]])
                    upd, o_new = e.updater.update(g_seg, o_tree, p_seg, it)
                    leaves = tree_leaves(o_new)
                    new_segs[key][t] = (np.stack([_np(l) for l in leaves]) if leaves
                                        else np.zeros((0, m), np.float32))
                    pnew[(key, t)] = _np(p_seg - upd)
        my_pseg = {f"k{key}": pnew[(key, r)] for key in self._flat_keys}
        return new_segs, pnew, my_pseg

    def _dense_update(self, dense_g: Dict[str, np.ndarray], it: int):
        """Replicated exact update for gn/constraint/mixed-dtype layers —
        the same math as ``model._update_params``, run identically on every
        worker."""
        new_params: Dict[int, Any] = {}
        new_opt: Dict[int, Any] = {}
        with torch.no_grad():
            for key in self._dense_keys:
                e = self._entries[key]
                p = self.model.params[key]
                g = tree_unflatten_like(e.template, [
                    self._dev(dense_g[f"d{key}_{li}"], l.dtype)
                    for li, l in enumerate(tree_leaves(p))])
                gn = getattr(e.cfg, "gradient_normalization", None)
                if gn:
                    g = apply_gradient_normalization(
                        gn, getattr(e.cfg, "gradient_normalization_threshold", 1.0), g)
                upd, o_new = e.updater.update(g, self._dense_opt[key], p, it)
                p_new = tree_map(lambda a, d: a - d, p, upd)
                if getattr(e.cfg, "constraints", None):
                    from deeplearning4j_tpu_torch.nn.constraints import apply_constraints

                    p_new = apply_constraints(e.cfg, p_new)
                new_params[key] = p_new
                new_opt[key] = o_new
        return new_params, new_opt

    def _await_psegs(self, g: int, it: int, view: View, sync,
                     my_pseg: Dict[str, np.ndarray],
                     pnew: Dict[Tuple[int, int], np.ndarray],
                     prefetch: Optional[_Prefetcher] = None):
        """Collect every rank's updated param segment. A dead rank's segment
        is recoverable while ANY of its R-1 mirrors survives: the first
        surviving mirror (in placement order — every worker derives the
        same order) computed the identical update and serves it
        (``dl4j_elastic_mirror_serves_total``); only the loss of the owner
        AND all its mirrors forces the shrink-and-rerun path."""
        W = view.world
        r = view.rank_of(self.wid)
        racks = self._view_racks(view)
        got: Dict[int, Dict[str, np.ndarray]] = {r: my_pseg}
        want = {t: f"pseg/{g}/{it}/{t}" for t in range(W) if t != r}
        deadline = time.monotonic() + self.rt.wait_timeout
        while want:
            if prefetch is not None:
                for t, arrays in prefetch.drain().items():
                    if t in want:
                        got[t] = arrays
                        del want[t]
            for t, key in list(want.items()):
                data = self.store.get(key)
                if data is not None:
                    got[t] = _unpack_arrays(data)
                    del want[t]
            if not want:
                break
            self.rt.check_for_change()
            unrecoverable = []
            for t in list(want):
                if self.rt.member_alive(view.members[t]):
                    continue
                mirrors = mirror_ranks(t, W, self.replication, racks)
                alive = [s for s in mirrors if s == r
                         or self.rt.member_alive(view.members[s])]
                if not alive:
                    unrecoverable.append(view.members[t])
                elif alive[0] == r:
                    served = {f"k{key}": pnew[(key, t)] for key in self._flat_keys}
                    self.store.set(f"pseg/{g}/{it}/{t}", _pack_arrays(served))
                    got[t] = served
                    del want[t]
                    obs.counter("dl4j_elastic_mirror_serves_total",
                                "Dead ranks' param segments served from a "
                                "surviving mirror").inc()
                    obs.event("elastic_mirror_serve", rank=t, by=self.wid,
                              iteration=it, gen=g)
                # else: an earlier surviving mirror serves; keep waiting on
                # the pseg key it will publish
            if unrecoverable:
                self.rt.report_dead(sorted(set(unrecoverable)), sync)
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"elastic step {it}: param segments {sorted(want)} "
                    f"missing after {self.rt.wait_timeout:.0f}s")
            time.sleep(self.rt.poll)
        return got

    def _assemble_params(self, got: Dict[int, Dict[str, np.ndarray]],
                         dense_params: Dict[int, Any], view: View):
        params = []
        for key in self._order:
            e = self._entries.get(key)
            if e is None:
                params.append(self.model.params[key])
            elif e.mode == "dense":
                params.append(dense_params[key])
            else:
                flat = np.concatenate([got[t][f"k{key}"] for t in range(view.world)])[:e.n]
                params.append(self._unflat(self._dev(flat, e.dtype), e))
        self.model.params = tuple(params)

    def _put(self, key: str, data: bytes) -> None:
        self.store.set(key, data)
        self.payload_bytes += len(data)

    def _run_step(self, xb, yb):
        view = self.rt.view
        it = int(self.model.iteration)
        sync = (self.epoch, self.step_in_epoch, it)
        r = view.rank_of(self.wid)
        W = view.world
        # the work-wall window opens BEFORE the chaos hooks: an injected
        # slow_iter stall is exactly the straggler signal the skew
        # detector exists to catch
        t_start = time.monotonic()
        self._chaos_hooks(it, r)
        self.rt.poll_boundary(sync)
        g = view.gen
        mine = set(self._my_vshards())
        fetchers: List[_Prefetcher] = []
        stall0 = self.stall_s
        try:
            with obs.span("elastic.step"):
                if self.async_exchange and len(mine) < self.vshards:
                    # overlap fetching the peers' vshard payloads with
                    # computing my own backward passes
                    fetchers.append(_Prefetcher(
                        self.store, {j: f"grad/{g}/{it}/{j}"
                                     for j in range(self.vshards) if j not in mine},
                        self.rt.poll))
                for j in self._my_vshards():
                    self._put(f"grad/{g}/{it}/{j}", self._vshard_payload(j, xb, yb, it))
                t0 = time.monotonic()
                payloads = self._await_vshards(
                    g, it, view, sync, prefetch=fetchers[0] if fetchers else None)
                self.stall_s += time.monotonic() - t0
                loss, gflat, dense_g, new_state = self._combine(payloads)
                new_segs, pnew, my_pseg = self._segment_update(gflat, it, view)
                self._put(f"pseg/{g}/{it}/{r}", _pack_arrays(my_pseg))
                pf = None
                if self.async_exchange and W > 1:
                    # overlap fetching the peers' param segments with the
                    # dense (replicated) update below
                    pf = _Prefetcher(self.store, {t: f"pseg/{g}/{it}/{t}"
                                                  for t in range(W) if t != r},
                                     self.rt.poll)
                    fetchers.append(pf)
                dense_params, dense_opt = self._dense_update(dense_g, it)
                t0 = time.monotonic()
                got = self._await_psegs(g, it, view, sync, my_pseg, pnew, prefetch=pf)
                self.stall_s += time.monotonic() - t0
                # commit: nothing above mutated trainer/model state, so a
                # membership change mid-step leaves us at the exact boundary
                # the re-formed group re-runs from
                self._assemble_params(got, dense_params, view)
                self._segs = new_segs
                self._dense_opt.update(dense_opt)
                self.model.state = new_state
                self.model.iteration = it + 1
                self.losses.append(float(loss))
        finally:
            for f in fetchers:
                f.stop()
        stall = self.stall_s - stall0
        obs.histogram("dl4j_elastic_boundary_stall_seconds",
                      "Per-step time blocked waiting on payloads "
                      "(vshards + param segments)").observe(stall)
        # straggler detection input: the WORK wall (total minus time spent
        # blocked on peers' payloads), which attributes skew to its cause
        work_s = max(time.monotonic() - t_start - stall, 0.0)
        self._publish_stepwall(g, it, r, W, work_s)
        if r == 0 and it >= 2:
            self.store.prune(f"grad/{g}/{it - 2}")
            self.store.prune(f"pseg/{g}/{it - 2}")
            self.store.prune(f"obs/stepwall/{g}/{it - 2}")
        return float(loss)

    def _publish_stepwall(self, g: int, it: int, r: int, W: int, work_s: float) -> None:
        """Publish this rank's per-step work wall and (on rank 0) evaluate
        the skew detector over iteration ``it - 1``, whose walls every rank
        has published — the pseg exchange of step ``it`` cannot complete
        before every rank finished step ``it - 1``."""
        try:
            self.store.set(fleet.stepwall_key(g, it, r),
                           json.dumps({"wall_s": work_s}).encode())
            if r != 0 or it < 1 or W < 2:
                return
            walls: Dict[int, float] = {}
            for t in range(W):
                raw = self.store.get(fleet.stepwall_key(g, it - 1, t))
                if raw is None:
                    return  # gen reformed mid-window: skip this boundary
                walls[t] = float(json.loads(raw.decode())["wall_s"])
            self._stragglers.update(self._straggler.observe(it - 1, walls))
        except Exception:
            pass  # observability must never fail the step

    # -- distributed checkpoints ---------------------------------------------
    def _maybe_checkpoint(self):
        if (not self.ckpt_dir or self.ckpt_every <= 0
                or self.model.iteration % self.ckpt_every != 0):
            return
        view = self.rt.view
        r = view.rank_of(self.wid)
        tag = f"{int(self.model.iteration):08d}"
        os.makedirs(self.ckpt_dir, exist_ok=True)
        arrays = self._seg_arrays()
        for j, res in self._residuals.items():
            arrays[f"res{j}"] = res
        shard_name = f"shard_{tag}_r{r}.npz"
        shard_path = os.path.join(self.ckpt_dir, shard_name)
        resilience.write_bytes_durable(shard_path, _pack_arrays(arrays))
        self.store.set_json(f"ckmeta/{view.gen}/{tag}/{r}", {
            "file": shard_name, "crc": resilience.crc32_file(shard_path),
            "size": os.path.getsize(shard_path), "rank": r, "wid": self.wid})
        aot.save_distributed_bundle(self.model, os.path.join(self.ckpt_dir, f"ckpt_{tag}"), r)
        if r != 0:
            return
        # rank 0 writes the replicated arrays + the CRC'd manifest (the
        # commit point: a manifest only lands after every shard checks in)
        pa = self._replicated_arrays({k: self._dense_opt[k] for k in self._dense_keys})
        pa["meta"] = self._meta(vshards=int(self.vshards))
        params_name = f"ckpt_{tag}_params.npz"
        params_path = os.path.join(self.ckpt_dir, params_name)
        resilience.write_bytes_durable(params_path, _pack_arrays(pa))
        metas: Dict[int, dict] = {}
        deadline = time.monotonic() + max(2 * self.rt.ttl, 5.0)
        while len(metas) < view.world:
            for t in range(view.world):
                if t not in metas:
                    d = self.store.get_json(f"ckmeta/{view.gen}/{tag}/{t}")
                    if d is not None:
                        metas[t] = d
            if len(metas) == view.world:
                break
            if time.monotonic() > deadline:
                obs.event("elastic_checkpoint_aborted", tag=tag,
                          have=sorted(metas), world=view.world)
                return
            time.sleep(self.rt.poll)
        manifest = {
            "format": 1, "tag": tag, "iteration": int(self.model.iteration),
            "epoch": self.epoch, "step": self.step_in_epoch,
            "world": view.world, "members": list(view.members),
            "vshards": int(self.vshards),
            "params": {"file": params_name,
                       "crc": resilience.crc32_file(params_path),
                       "size": os.path.getsize(params_path)},
            "shards": {str(t): metas[t] for t in range(view.world)},
        }
        resilience.write_json_durable(
            os.path.join(self.ckpt_dir, f"manifest_{tag}.json"), manifest)
        obs.counter("dl4j_elastic_checkpoints_total",
                    "Distributed checkpoints committed (manifest written)").inc()
        obs.event("elastic_checkpoint", tag=tag, world=view.world,
                  iteration=int(self.model.iteration))

    # -- finalization --------------------------------------------------------
    def _final_gather(self):
        """Assemble the full structured optimizer state back onto the model
        (the fit-exit contract: outside a fit the model stays
        serializable/usable, like ``DataParallelStep.finish``)."""
        view = self.rt.view
        g = view.gen
        arrays = self._seg_arrays()
        self.store.set(f"fin/{g}/{self.wid}", _pack_arrays(arrays))
        sync = (self.epoch, self.step_in_epoch, int(self.model.iteration))
        want = {wid: f"fin/{g}/{wid}" for wid in view.members if wid != self.wid}
        got = {self.wid: arrays}
        deadline = time.monotonic() + self.rt.wait_timeout
        while want:
            for wid, key in list(want.items()):
                data = self.store.get(key)
                if data is not None:
                    got[wid] = _unpack_arrays(data)
                    del want[wid]
            if not want:
                break
            self.rt.check_for_change()
            dead = [wid for wid in want if not self.rt.member_alive(wid)]
            if dead:
                self.rt.report_dead(dead, sync)
            if time.monotonic() > deadline:
                raise TimeoutError(f"elastic finalize gen {g}: waiting on {sorted(want)}")
            time.sleep(self.rt.poll)
        W = view.world
        racks = self._view_racks(view)

        def seg_of(k, t):
            for s in [t] + mirror_ranks(t, W, self.replication, racks):
                a = got.get(view.members[s], {}).get(f"k{k}_t{t}")
                if a is not None:
                    return a
            return None

        new_opt = []
        for key in self._order:
            e = self._entries.get(key)
            if e is None:
                new_opt.append(self.model.opt_state[key])
            elif e.mode == "dense":
                new_opt.append(self._dense_opt[key])
            else:
                full = self._assemble_full_stats(e, W, lambda t, k=key: seg_of(k, t))
                if full is None:
                    raise RuntimeError(f"elastic finalize: layer {key} segments missing")
                new_opt.append(self._stats_structured_from_full(e, full))
        self.model.opt_state = tuple(new_opt)

    def _publish_done(self):
        """Rank 0's terminal blob: the fully-gathered final model state, so
        a worker partitioned through the END of the job still lands on the
        uninterrupted run's parameters instead of hanging on readmission."""
        opt = {k: self.model.opt_state[k] for k in self._order if k in self._entries}
        full = self._replicated_arrays(opt)
        full["meta"] = self._meta()
        self.store.set("done", _pack_arrays(full))

    def _adopt_done(self):
        model = self.model
        full = _unpack_arrays(self.store.get("done"))
        meta = _array_to_json(full["meta"])
        keys = [k for k in self._order if k in self._entries]
        opt = self._load_replicated(full, opt_keys=keys, meta=meta)
        model.opt_state = tuple(opt.get(k, model.opt_state[k]) for k in self._order)
        model.iteration = int(meta["iteration"])
        self.epoch, self.step_in_epoch = int(meta["epoch"]), int(meta["step"])
        obs.event("elastic_done_adopted", wid=self.wid, iteration=model.iteration)

    # -- fit -----------------------------------------------------------------
    def fit(self, x, y, *, epochs: int, batch_size: int) -> dict:
        """Train for ``epochs`` over ``(x, y)`` elastically; returns a result
        dict (loss curve, final membership). Deterministic batch order; the
        global batch of step ``s`` is rows ``[s*bs, (s+1)*bs)``."""
        x = np.asarray(x)
        y = np.asarray(y)
        bs = int(batch_size)
        self._steps_per_epoch = max(-(-len(x) // bs), 1)
        view = self.rt.bootstrap(self.world)
        epochs = int(epochs)
        try:
            self._reform(view)
            self._vshard_rows = -(-bs // self.vshards)
            while self.epoch < epochs:
                lo = self.step_in_epoch * bs
                xb, yb = x[lo:lo + bs], y[lo:lo + bs]
                try:
                    self._run_step(xb, yb)
                except MembershipChanged as mc:
                    self._reform(mc.view)
                    self._vshard_rows = -(-bs // self.vshards)
                    continue
                self.step_in_epoch += 1
                if self.step_in_epoch >= self._steps_per_epoch:
                    self.step_in_epoch = 0
                    self.epoch += 1
                self._maybe_checkpoint()
                self._maybe_publish_snapshot()
            while True:
                try:
                    self._final_gather()
                    break
                except MembershipChanged as mc:
                    self._reform(mc.view)
            if self.rt.view.rank_of(self.wid) == 0:
                self._publish_done()
        except _JobDone:
            pass
        self._maybe_publish_snapshot(force=True)
        view = self.rt.view
        return {
            "wid": self.wid,
            "rank": view.rank_of(self.wid),
            "world": view.world,
            "gen": view.gen,
            "iteration": int(self.model.iteration),
            "losses": [float(v) for v in self.losses],
            "final_loss": float(self.losses[-1]) if self.losses else float("nan"),
            "stall_s": float(self.stall_s),
            "payload_bytes": int(self.payload_bytes),
            "replication": int(self.replication),
            "rack": self.rt.rack,
            "store_backend": getattr(self.store, "backend", "file"),
            "async_exchange": bool(self.async_exchange),
            "stragglers": sorted(self._stragglers),
        }

    def _maybe_publish_snapshot(self, force: bool = False) -> None:
        """Publish this worker's metrics snapshot for the fleet collector —
        report-time only, throttled to ~1/s."""
        now = time.monotonic()
        if not force and now - self._last_publish < 1.0:
            return
        self._last_publish = now
        try:
            fleet.publish_snapshot(self.store, self.wid)
        except Exception:
            pass  # observability must never fail training

    def close(self):
        self.rt.leave()


# ---------------------------------------------------------------------------
# CLI: worker + local launcher
# ---------------------------------------------------------------------------


def _build_model(args):
    from deeplearning4j_tpu_torch.nn.input_type import InputType
    from deeplearning4j_tpu_torch.nn.layers import Dense, OutputLayer
    from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration, MultiLayerNetwork

    hidden = [int(h) for h in str(args.hidden).split(",") if h]
    layers = tuple(Dense(n_out=h, activation="tanh") for h in hidden) + (
        OutputLayer(n_out=int(args.classes), activation="softmax"),)
    conf = MultiLayerConfiguration(
        layers=layers, input_type=InputType.feed_forward(int(args.features)),
        updater={"type": "adam", "lr": float(args.lr)}, seed=int(args.seed))
    return MultiLayerNetwork(conf, device=args.device).init()


def _make_data(args):
    rs = np.random.RandomState(int(args.seed))
    n, f, c = int(args.n), int(args.features), int(args.classes)
    x = rs.randn(n, f).astype(np.float32)
    y = np.eye(c, dtype=np.float32)[rs.randint(0, c, n)]
    return x, y


def _write_atomic(path: str, write) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def run_worker(args, model=None, data=None) -> dict:
    """One elastic worker: train ``model`` (default: the CLI's MLP) on
    ``data`` (default: the CLI's synthetic rows) and publish
    ``params_<id>.npz`` and ``result_<id>.json`` into ``--outdir``
    atomically (a relaunch supervisor may read them while a preemption
    kills this process). Returns the result dict."""
    os.makedirs(args.outdir, exist_ok=True)
    obs.configure_event_log(os.path.join(args.outdir, f"events_{args.id}.jsonl"))
    if model is None:
        model = _build_model(args)
    trainer = ElasticTrainer(
        model, args.store, args.id, world=args.world,
        vshards=args.vshards, compress=args.compress, threshold=args.threshold,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        ttl=args.ttl, poll=args.poll, replication=args.replication or None,
        rack=args.rack if args.rack else None, slice_spec=args.mesh or None,
        async_exchange=None if args.async_exchange < 0 else bool(args.async_exchange))
    x, y = _make_data(args) if data is None else data
    try:
        result = trainer.fit(x, y, epochs=args.epochs, batch_size=args.batch)
    finally:
        trainer.close()
    params = {f"p{key}_{li}": _np(leaf) for key, p in enumerate(model.params)
              for li, leaf in enumerate(tree_leaves(p))}
    _write_atomic(os.path.join(args.outdir, f"params_{args.id}.npz"),
                  lambda f: np.savez(f, **params))
    _write_atomic(os.path.join(args.outdir, f"result_{args.id}.json"),
                  lambda f: f.write(json.dumps(result).encode()))
    return result


def _cmd_worker(args) -> int:
    print(json.dumps(run_worker(args)))
    return 0


WORKER_CMD = [sys.executable, "-m", "deeplearning4j_tpu_torch.train.elastic", "worker"]


def _cmd_launch(args, worker_cmd: Optional[List[str]] = None,
                env: Optional[Dict[str, str]] = None) -> int:
    """Local supervisor: spawn N workers, optionally relaunch killed ones
    (the preempted-worker-rejoins path). Relaunched processes get the chaos
    env stripped — the one-shot fault already fired in the dead process and
    must not re-fire at the (now higher) resume iteration. ``worker_cmd``
    replaces the worker entry (``WORKER_CMD``; the worker's flags follow
    it) and ``env`` the workers' environment (``os.environ``)."""
    procs: Dict[str, subprocess.Popen] = {}
    relaunches = int(args.relaunch)
    allowed_failures = int(args.allow_failures)
    failures: List[str] = []
    racks = [r.strip() for r in args.racks.split(",")] if args.racks else []

    def spawn(wid: str, chaos: bool) -> subprocess.Popen:
        worker_env = dict(os.environ if env is None else env)
        if not chaos:
            worker_env.pop("DL4J_TPU_CHAOS", None)
        cmd = list(worker_cmd or WORKER_CMD) + [
            "--store", args.store, "--outdir", args.outdir,
            "--id", wid, "--world", str(args.world),
            "--epochs", str(args.epochs), "--batch", str(args.batch),
            "--n", str(args.n), "--features", str(args.features),
            "--classes", str(args.classes), "--hidden", str(args.hidden),
            "--lr", str(args.lr), "--seed", str(args.seed),
            "--ttl", str(args.ttl), "--poll", str(args.poll),
            "--threshold", str(args.threshold)]
        if args.device:
            cmd += ["--device", args.device]
        if racks:
            cmd += ["--rack", racks[int(wid[1:]) % len(racks)]]
        if args.replication:
            cmd += ["--replication", str(args.replication)]
        if args.mesh:
            cmd += ["--mesh", args.mesh]
        if args.async_exchange >= 0:
            cmd += ["--async-exchange", str(args.async_exchange)]
        if args.vshards:
            cmd += ["--vshards", str(args.vshards)]
        if args.compress:
            cmd += ["--compress"]
        if args.ckpt_dir:
            cmd += ["--ckpt-dir", args.ckpt_dir, "--ckpt-every", str(args.ckpt_every)]
        return subprocess.Popen(cmd, env=worker_env)

    wids = [f"w{i}" for i in range(int(args.workers))]
    for wid in wids:
        procs[wid] = spawn(wid, chaos=True)
    httpd = None
    if args.fleet_port >= 0:
        # fleet metrics federation: serve the merged exposition of every
        # worker's published snapshot while the run is live
        httpd, _, bound = fleet.serve_collector(open_store(args.store), port=args.fleet_port)
        print(json.dumps({"fleet_port": bound}), flush=True)
    deadline = time.monotonic() + float(args.timeout)
    done: Dict[str, int] = {}
    try:
        while len(done) < len(wids):
            for wid, p in list(procs.items()):
                rc = p.poll()
                if rc is None:
                    continue
                del procs[wid]
                if rc == 0:
                    done[wid] = 0
                elif relaunches > 0:
                    relaunches -= 1
                    print(f"[launch] worker {wid} exited rc={rc}; relaunching", flush=True)
                    procs[wid] = spawn(wid, chaos=False)
                elif len(failures) < allowed_failures:
                    failures.append(wid)
                    done[wid] = rc
                    print(f"[launch] worker {wid} exited rc={rc} (allowed failure)",
                          flush=True)
                else:
                    print(f"[launch] worker {wid} exited rc={rc}; aborting", flush=True)
                    return 1
            if time.monotonic() > deadline:
                print("[launch] timeout", flush=True)
                return 1
            time.sleep(0.05)
    finally:
        for q in procs.values():
            q.kill()
            q.wait()
        if httpd is not None:
            httpd.shutdown()
    survivors = [w for w in wids if done[w] == 0]
    print(json.dumps({"survivors": survivors, "failures": failures}), flush=True)
    return 0 if survivors else 1


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.train.elastic",
        description="Elastic data-parallel training: worker process and "
                    "local launcher for the synthetic workload")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--store", required=True,
                       help="shared rendezvous/exchange store: a directory "
                            "(or file:DIR) for FileStore, tcp://host:port "
                            "for the network store")
        p.add_argument("--outdir", required=True)
        p.add_argument("--world", type=int, default=2)
        p.add_argument("--epochs", type=int, default=3)
        p.add_argument("--batch", type=int, default=16)
        p.add_argument("--n", type=int, default=48)
        p.add_argument("--features", type=int, default=10)
        p.add_argument("--classes", type=int, default=4)
        p.add_argument("--hidden", default="16,8")
        p.add_argument("--lr", type=float, default=5e-3)
        p.add_argument("--seed", type=int, default=7)
        p.add_argument("--vshards", type=int, default=0)
        p.add_argument("--compress", action="store_true")
        p.add_argument("--threshold", type=float, default=1e-3)
        p.add_argument("--ckpt-dir", dest="ckpt_dir", default=None)
        p.add_argument("--ckpt-every", dest="ckpt_every", type=int, default=0)
        p.add_argument("--ttl", type=float, default=2.0)
        p.add_argument("--poll", type=float, default=0.02)
        p.add_argument("--rack", default="",
                       help="failure-domain label for this worker "
                            "(mirror placement avoids the owner's rack)")
        p.add_argument("--replication", type=int, default=0,
                       help="R-way mirror replication factor (0 = env/default)")
        p.add_argument("--mesh", default="",
                       help="per-member slice spec 'd[,t[,s]]'; only a slice of "
                            f"one rank is ported ({SLICES_ITEM})")
        p.add_argument("--async-exchange", dest="async_exchange", type=int, default=-1,
                       help="1/0 force async payload prefetch on/off (-1 = env/default)")
        p.add_argument("--device", default=None,
                       help="the workers' device (default: the GPU; 'cpu' for the "
                            "plain versions)")

    w = sub.add_parser("worker", help="run one elastic worker")
    common(w)
    w.add_argument("--id", required=True)
    w.set_defaults(fn=_cmd_worker)

    l = sub.add_parser("launch", help="supervise N local workers")
    common(l)
    l.add_argument("--workers", type=int, default=2)
    l.add_argument("--racks", default="",
                   help="comma-separated rack label per worker "
                        "(w0,w1,... ; cycled if shorter than --workers)")
    l.add_argument("--slice-devices", dest="slice_devices", type=int, default=0,
                   help="devices per elastic-of-slices member (with --mesh; "
                        f"{SLICES_ITEM})")
    l.add_argument("--relaunch", type=int, default=0,
                   help="relaunch budget for killed workers (rejoin path)")
    l.add_argument("--fleet-port", dest="fleet_port", type=int, default=-1,
                   help="serve the fleet metrics collector "
                        "(/fleet/metrics) on this port while workers run "
                        "(0 = OS-assigned; -1 = off)")
    l.add_argument("--allow-failures", dest="allow_failures", type=int, default=0)
    l.add_argument("--timeout", type=float, default=300.0)
    l.set_defaults(fn=_cmd_launch)
    return ap


def parse_args(argv=None):
    args = _parser().parse_args(argv)
    if getattr(args, "vshards", 0) == 0:
        args.vshards = None
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
