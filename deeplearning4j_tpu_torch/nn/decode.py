"""KV-cache decode engine: the autoregressive serving step (PyTorch port).

Counterpart of ``deeplearning4j_tpu/nn/decode.py``. Training and batch
inference run whole sequences through ``model.output``; autoregressive
generation runs one new token (or one prefill chunk) per step against an
ever-growing key/value history. :class:`DecodeProgram` keeps that history
in device-resident pools and runs the step on the model's device:

- **Unified step.** One function serves both phases: prefill is the step
  at chunk width ``Tc`` (a bucket of ``prefill_chunk``), decode the same
  step at ``Tc = 1``. It embeds the chunk, walks the transformer stack
  through the layers' ``decode_apply`` paths (attention of the chunk
  against the cache, ``ops.flash_attention.decode_attention``), writes the
  chunk's k/v into the cache, and returns next-token logits and greedy ids.

- **Paged cache on the bucket ladder.** The cache is a page pool
  ``[P, page_tokens, H, D]`` per transformer block plus a host-managed page
  table: each stream owns an ordered page list, and a dispatch passes a
  ``[B_bucket, NP_bucket]`` table slice. Every dispatch-visible shape (batch
  rows, chunk width, table width) lies on the shared bucket ladder
  (``utils/bucketing.py``), so the set of dispatch shapes is finite:
  :meth:`DecodeProgram.signature_grid` lists it and :meth:`DecodeProgram.warm`
  runs each point once. Warming pays for CUDA and cuBLAS set-up; the grid
  is registered on the model's ``decode.step`` site (``nn/aot.py``
  ``grid_site``), so it rides in the model's warm-set bundle. The program
  records every shape it dispatches, so ``off_grid_dispatches`` counts
  request-path dispatches whose shape the warm pass did not run (the
  port's counterpart of the JAX package's zero-compile gate). Page 0 is a scratch page:
  padded batch rows and padded chunk slots write there, so padding never
  touches a real stream's history.

- **Contiguous mode** (``paged=False``) keeps one ``[S+1, L+1, H, D]``
  strip per slot (row S and column L are the padding scratch; the step
  reads the first L columns, the paged layout's widest span): the same
  step math, dispatch shapes keyed by batch and chunk only.

- **Zero-filled pools.** A masked cache slot gets an exact-zero softmax
  weight, but 0 * NaN is NaN: the pools are allocated with ``torch.zeros``
  so that a never-written page holds finite values.

- **Batched equals solo.** Rows are independent and every padded or
  masked cache position contributes an exact-zero softmax weight, so greedy
  decode batched gives each row the tokens it gets alone. On the card that
  holds bit for bit only while every reduction of the step is per row and
  blind to the span's padding: the layer norm's statistics come from a
  per-row kernel (``nn/layers/normalization.py``), and both layouts read
  spans of whole pages.

The program mutates no model state: only the cache pools evolve, updated
in place (``index_put_``) where the JAX program donates them. The step
runs under ``torch.inference_mode()`` on the model's device.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.nn import aot
from deeplearning4j_tpu_torch.utils import bucketing

__all__ = ["DecodeProgram"]

SITE = "decode.step"


# ---------------------------------------------------------------------------
# Cache views: what a layer's decode_apply sees (paging stays out of layers)
# ---------------------------------------------------------------------------


class _PagedView:
    """One transformer block's window onto the page pool for one dispatch.

    ``pool`` {"k","v"}: [P, page_tokens, H, D]; ``table`` [B, NP] int64
    (page ids per stream, in order: gathered index g along the flattened
    span IS absolute position g); ``positions`` [B, Tc]; ``valid`` [B, Tc]
    marks real chunk slots (padding writes land on scratch page 0)."""

    def __init__(self, pool, table, positions, valid, page_tokens: int):
        self.pool = pool
        self._table = table
        self._pos = positions
        self._valid = valid
        self._pg = page_tokens

    def append(self, k_new, v_new):
        npages = self._table.shape[1]
        slot = (self._pos // self._pg).clamp(0, npages - 1)
        page = torch.gather(self._table, 1, slot)                  # [B, Tc]
        off = self._pos % self._pg
        page = torch.where(self._valid, page, 0)   # padding -> scratch page
        off = torch.where(self._valid, off, 0)
        dt = self.pool["k"].dtype
        self.pool["k"].index_put_((page, off), k_new.to(dt))
        self.pool["v"].index_put_((page, off), v_new.to(dt))

    def gathered(self):
        B, npages = self._table.shape
        shape = (B, npages * self._pg) + tuple(self.pool["k"].shape[2:])
        return (self.pool["k"][self._table].reshape(shape),
                self.pool["v"][self._table].reshape(shape))


class _ContiguousView:
    """Contiguous-strip cache window: ``pool`` {"k","v"}: [S+1, L+1, H, D]
    (row S and column L are padding scratch); ``slots`` [B] int64."""

    def __init__(self, pool, slots, positions, valid):
        self.pool = pool
        self._slots = slots
        self._pos = positions
        self._valid = valid

    def append(self, k_new, v_new):
        n_slots, length = self.pool["k"].shape[:2]
        row = self._slots[:, None].expand(self._pos.shape)
        row = torch.where(self._valid, row, n_slots - 1)
        col = torch.where(self._valid, self._pos.clamp(0, length - 1),
                          length - 1)
        dt = self.pool["k"].dtype
        self.pool["k"].index_put_((row, col), k_new.to(dt))
        self.pool["v"].index_put_((row, col), v_new.to(dt))

    def gathered(self):
        # column L is write-only scratch whose slot no query may attend
        # (every position is < L), so the span read is the page grid's L
        # columns: the widest span the paged layout reads. On the card
        # softmax over an odd span (L + 1) rounds otherwise than over the
        # paged spans, and the two layouts' tokens would part at a near-tie
        length = self.pool["k"].shape[1] - 1
        return (self.pool["k"][self._slots, :length],
                self.pool["v"][self._slots, :length])


# ---------------------------------------------------------------------------
# The program
# ---------------------------------------------------------------------------


class DecodeProgram:
    """The decode/prefill step and the device cache pools for ONE model.

    Owns the layer plan (which layers cache, which are positionwise), the
    page pool or contiguous strips, and the record of dispatch shapes.
    Host-side page accounting (free lists, per-stream page lists) belongs
    to the caller (``serve/scheduler.GenerateWorker``); the program only
    takes table slices whose SHAPES are already on the ladder.
    """

    def __init__(self, model, *, page_tokens: int = 64, max_batch: int = 8,
                 prefill_chunk: int = 64, paged: bool = True,
                 capacity: Optional[int] = None,
                 ladder: Optional[bucketing.BucketLadder] = None):
        from deeplearning4j_tpu_torch.nn.layers import (
            ActivationLayer, DropoutLayer, EmbeddingSequence, LayerNorm,
            PositionalEmbedding, TransformerBlock)

        if model.params is None:
            model.init()
        self.model = model
        self.device = torch.device(model.device)
        self.ladder = ladder or bucketing.ladder_from_env()
        self.page_tokens = int(page_tokens)
        self.max_batch = int(max_batch)
        self.prefill_chunk = int(prefill_chunk)
        self.paged = bool(paged)
        if self.page_tokens < 1 or self.max_batch < 1 or self.prefill_chunk < 1:
            raise ValueError("page_tokens, max_batch and prefill_chunk must "
                             "be >= 1")

        # layer plan: every layer must be cache-aware or provably
        # positionwise (token t's output depends only on token t); anything
        # else would silently corrupt incremental decode
        positionwise = (EmbeddingSequence, LayerNorm, DropoutLayer,
                        ActivationLayer)
        plan: List[Tuple[str, object]] = []
        pos_cap = None
        for i, layer in enumerate(model.layers):
            last = i == len(model.layers) - 1
            if isinstance(layer, TransformerBlock):
                plan.append(("block", layer))
            elif isinstance(layer, PositionalEmbedding):
                plan.append(("pos", layer))
                cap = int(layer.max_len)
                pos_cap = cap if pos_cap is None else min(pos_cap, cap)
            elif last and hasattr(layer, "preactivation"):
                plan.append(("out", layer))
            elif isinstance(layer, positionwise):
                plan.append(("through", layer))
            else:
                raise ValueError(
                    f"DecodeProgram: layer {i} ({type(layer).__name__}) has "
                    f"no decode path and is not positionwise — incremental "
                    f"decode would be wrong")
        if plan[-1][0] != "out":
            raise ValueError("DecodeProgram: the final layer must expose "
                             "preactivation() (logits head)")
        self._plan = plan
        self._blocks = [l for kind, l in plan if kind == "block"]
        if not self._blocks:
            raise ValueError("DecodeProgram: model has no TransformerBlock "
                             "to cache")
        first = model.layers[0]
        self.vocab = (int(model.params[0]["W"].shape[0])
                      if isinstance(first, EmbeddingSequence) else None)

        self.capacity = int(capacity if capacity is not None
                            else (pos_cap or 512))
        self.max_pages = max(1, math.ceil(self.capacity / self.page_tokens))
        # contiguous strips align to the page grid so both layouts mask the
        # same maximal span
        self.contig_len = self.max_pages * self.page_tokens

        # per-block head geometry from the resolved input types
        self._geom = []
        for i, layer in enumerate(model.layers):
            if isinstance(layer, TransformerBlock):
                C = model.layer_input_types[i].size
                self._geom.append((int(layer.n_heads),
                                   C // int(layer.n_heads)))
        self.pools = self._alloc_pools()
        # dispatch shapes: those the warm pass ran, those seen since, and
        # the request-path dispatches whose shape the warm pass never ran
        self.warmed: set = set()
        self._site = aot.grid_site(model, SITE)
        self.shapes_seen: set = set()
        self.off_grid_dispatches = 0

    # -- cache allocation ---------------------------------------------------

    def _alloc_pools(self):
        dt = self.model.dtype
        pools = []
        for H, D in self._geom:
            if self.paged:
                P = 1 + self.max_batch * self.max_pages  # +1: scratch page 0
                shape = (P, self.page_tokens, H, D)
            else:
                shape = (self.max_batch + 1, self.contig_len + 1, H, D)
            # zeros, never empty: see the module docstring
            pools.append({"k": torch.zeros(shape, dtype=dt, device=self.device),
                          "v": torch.zeros(shape, dtype=dt, device=self.device)})
        return tuple(pools)

    def reset(self):
        """Zero the cache pools (stream isolation is by page/slot ownership,
        so this is for tests, not per-request hygiene)."""
        self.pools = self._alloc_pools()

    def pool_bytes(self) -> int:
        """Device bytes held by the cache pools (k and v, every block)."""
        return sum(t.numel() * t.element_size()
                   for p in self.pools for t in p.values())

    # -- the step ------------------------------------------------------------

    def _device_scope(self):
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _step(self, table, lengths, tokens, n_new):
        """One decode/prefill step. ``table``: [B, NP] page table slice
        (paged) or [B] slot ids (contiguous); ``lengths`` [B]: tokens
        already cached per row; ``tokens`` [B, Tc] chunk (padding 0);
        ``n_new`` [B]: real tokens in each row's chunk. Updates the pools
        in place and returns ``(logits [B, V] f32 at each row's last real
        token, greedy ids [B] int32)``."""
        params, state = self.model.params, self.model.state
        B, Tc = tokens.shape
        steps = torch.arange(Tc, device=tokens.device)
        positions = lengths[:, None] + steps[None]
        valid = steps[None] < n_new[:, None]
        a = tokens
        bi = 0
        logits = None
        for li, (kind, layer) in enumerate(self._plan):
            p = params[li]
            if kind == "block":
                if self.paged:
                    view = _PagedView(self.pools[bi], table, positions, valid,
                                      self.page_tokens)
                else:
                    view = _ContiguousView(self.pools[bi], table, positions,
                                           valid)
                a = layer.decode_apply(p, a, cache=view, positions=positions)
                bi += 1
            elif kind == "pos":
                a = layer.decode_apply(p, a, positions)
            elif kind == "out":
                last = (n_new - 1).clamp(0, Tc - 1)
                a_last = a[torch.arange(B, device=a.device), last]   # [B, C]
                logits = layer.preactivation(p, a_last).float()
            else:  # positionwise passthrough, eval mode
                a, _ = layer.apply(p, state[li], a, train=False, rng=None,
                                   mask=None)
        ids = torch.argmax(logits, dim=-1).to(torch.int32)  # first index on ties
        return logits, ids

    def _as_device(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int64)).to(self.device)

    def dispatch(self, table, lengths, tokens, n_new, *, _warm: bool = False):
        """Run one step over the live pools. Array arguments are host
        arrays shaped to ladder buckets by the caller; returns ``(logits,
        ids)`` still on the device."""
        table, lengths, tokens, n_new = (self._as_device(a) for a in
                                         (table, lengths, tokens, n_new))
        key = (int(tokens.shape[0]), int(tokens.shape[1]),
               int(table.shape[1]) if self.paged else None)
        if _warm:
            self.warmed.add(key)
            self._site.mark_warm(*key)
        else:
            if key not in self.shapes_seen:
                self._site.note_seen(*key)
            self.shapes_seen.add(key)
            if self.warmed and key not in self.warmed:
                self.off_grid_dispatches += 1
        with torch.inference_mode(), self._device_scope():
            out = self._step(table, lengths, tokens, n_new)
        if not _warm:
            self._site.guard()
        return out

    # -- warm ----------------------------------------------------------------

    def signature_grid(self):
        """The exact (B, Tc, NP) dispatch grid the serving tier can reach:
        decode at Tc=1 over every (batch bucket x table bucket), prefill at
        B=1 over every (chunk bucket x table bucket). NP is None in
        contiguous mode (table width is not a dispatch axis)."""
        b_buckets = bucketing.reachable_buckets(self.max_batch, self.ladder)
        t_buckets = bucketing.reachable_buckets(self.prefill_chunk, self.ladder)
        p_buckets = (bucketing.reachable_buckets(self.max_pages, self.ladder)
                     if self.paged else [None])
        grid = []
        for np_b in p_buckets:
            for b in b_buckets:
                grid.append((b, 1, np_b))
            for tc in t_buckets:
                if tc != 1:
                    grid.append((1, tc, np_b))
        return grid

    def warm(self) -> int:
        """Run every point of :meth:`signature_grid` once on the device (all
        writes land on the scratch page / row, since no chunk slot is
        valid), so the request path meets no shape the warm pass did not
        run. Returns how many points ran."""
        t0 = time.perf_counter()
        grid = self.signature_grid()
        for b, tc, np_b in grid:
            table = (np.zeros((b, np_b), np.int64) if self.paged
                     else np.full((b,), self.max_batch, np.int64))
            self.dispatch(table, np.zeros(b), np.zeros((b, tc)), np.zeros(b),
                          _warm=True)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        obs.event("decode_warmup", site=SITE, shapes=len(grid),
                  duration_s=round(time.perf_counter() - t0, 6))
        return len(grid)
