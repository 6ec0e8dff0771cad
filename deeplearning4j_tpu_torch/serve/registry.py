"""Model registry: the restore → warm → persist → serve pipeline, per model pool.

Counterpart of ``deeplearning4j_tpu/serve/registry.py``.
``ModelRegistry`` owns every :class:`~.scheduler.ModelWorker` in the
process. ``register(name, model)`` puts an already-constructed model (a
MultiLayerNetwork or a one-input ComputationGraph: anything with
``output``, ``dummy_input``, ``takes_ids`` and ``device``) behind a
continuous-batching worker; ``load(name, path)`` imports a file first. Either
way the model runs the warm pipeline before it takes traffic:

1. **tune** — with ``DL4J_TPU_TUNE=auto`` the tuning DB's serve-scope
   winner for the model is applied (``tune.maybe_apply``);
2. **restore** — an ``.aotbundle`` (``bundle=``, or ``<path>.aotbundle``
   beside a loaded file) replays its recorded signatures with their
   recorded costs (``nn/aot.py``);
3. **warm** — ``aot.warm_serving`` runs the output site once per bucket
   reachable by coalesced batches up to the worker's ``max_batch``, priced
   by a counting pass, so the first requests pay for no CUDA context
   set-up, cuBLAS heuristics or kernel build;
4. **persist** — the warm set is saved back to the bundle path.

``register_generate(name, model)`` puts an autoregressive LM behind a
token-level :class:`~.scheduler.GenerateWorker` over a
:class:`~deeplearning4j_tpu_torch.nn.decode.DecodeProgram`, whose grid is
registered on the model's ``decode.step`` site and warmed whole.

``register_index(name, index)`` puts a
:class:`~deeplearning4j_tpu_torch.search.index.VectorIndex` behind a
signature-coalescing :class:`~.scheduler.SearchWorker` (``/v1/search`` and
the legacy ``/knn`` / ``/knnnew`` / ``/status`` routes) after running its
(B, k, nprobe) signature grid once. Both take ``bundle=`` like ``register``.

The registry lives on one device (``device=None`` → the GPU, raising when
there is none); a model registered on another device is refused.

All latency measurements share one :class:`~.admission.LatencyModel`
(single ``dl4j_serve_exec_seconds`` family on /metrics), keyed per model.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

import torch

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.nn import aot
from deeplearning4j_tpu_torch.nn.model import resolve_device
from deeplearning4j_tpu_torch.serve.admission import (
    GenerateConfig, LatencyModel, ServeConfig)
from deeplearning4j_tpu_torch.serve.scheduler import (
    GenerateWorker, ModelWorker, SearchWorker)
from deeplearning4j_tpu_torch.utils import bucketing

__all__ = ["ModelRegistry"]


class ModelRegistry:
    def __init__(self, config: Optional[ServeConfig] = None, device=None):
        self.device = resolve_device(device)
        self.config = config or ServeConfig.from_env()
        self.latency = LatencyModel(min_samples=self.config.min_samples)
        self._lock = threading.Lock()
        self._workers: Dict[str, ModelWorker] = {}
        self._generators: Dict[str, GenerateWorker] = {}
        self._searchers: Dict[str, SearchWorker] = {}
        self._meta: Dict[str, Dict[str, object]] = {}

    # -- intake ------------------------------------------------------------

    def _check_device(self, name: str, model):
        if torch.device(model.device).type != self.device.type:
            raise ValueError(f"model {name!r} lives on {model.device}, the "
                             f"registry serves {self.device}")

    def register(self, name: str, model, warm: bool = True,
                 bundle: Optional[str] = None) -> ModelWorker:
        """Put ``model`` behind a continuous-batching worker under ``name``.
        Replaces (and shuts down) any worker already bound to the name."""
        self._check_device(name, model)
        meta = self._warm_pipeline(model, warm=warm, bundle=bundle)
        worker = ModelWorker(name, model, config=self.config,
                             latency=self.latency)
        with self._lock:
            old = self._workers.pop(name, None)
            self._workers[name] = worker
            self._meta[name] = meta
        if old is not None:
            old.shutdown()
        obs.event("serve_model_loaded", model=name, **{
            k: meta[k] for k in ("source", "model_class", "warmed", "restored",
                                 "warm_seconds")})
        return worker

    def load(self, name: str, path: str, warm: bool = True,
             bundle: Optional[str] = None) -> ModelWorker:
        """Import the model at ``path`` (Keras ``.h5`` or DL4J ``.zip``,
        format auto-detected by ``modelimport.import_model``) onto the
        registry's device and register it. ``bundle`` defaults to the
        ``<path>.aotbundle`` sidecar."""
        from deeplearning4j_tpu_torch import modelimport

        model = modelimport.import_model(path, device=self.device)
        if bundle is None:
            bundle = aot.bundle_path_for(path)
        worker = self.register(name, model, warm=warm, bundle=bundle)
        with self._lock:
            self._meta[name]["source"] = str(path)
        return worker

    def register_generate(self, name: str, model, warm: bool = True,
                          bundle: Optional[str] = None,
                          config: Optional[GenerateConfig] = None,
                          capacity: Optional[int] = None) -> GenerateWorker:
        """Put an autoregressive LM behind a token-level continuous-batching
        decode engine under ``name`` (``:generate``). Builds the
        :class:`~deeplearning4j_tpu_torch.nn.decode.DecodeProgram` (its
        pools on the registry's device), runs every point of its
        signature grid once (``warm``), then starts the engine. Replaces
        (and shuts down) any generator already bound to the name. The tuning
        DB's serve-scope winner lands first (``GenerateConfig`` is read after
        ``tune.maybe_apply``); a ``bundle`` restores the grid recorded on the
        model's ``decode.step`` site before the warm, and the warm set
        persists back to it."""
        from deeplearning4j_tpu_torch.nn.decode import DecodeProgram

        self._check_device(name, model)
        if getattr(model, "params", None) is None:
            model.init()
        if os.environ.get("DL4J_TPU_TUNE"):
            from deeplearning4j_tpu_torch import tune

            tune.maybe_apply(model, "serve")
        cfg = config or GenerateConfig.from_env()
        program = DecodeProgram(
            model, page_tokens=cfg.kv_page_tokens,
            max_batch=cfg.decode_batch_max, prefill_chunk=cfg.prefill_chunk,
            paged=cfg.paged, capacity=capacity)
        restored = aot.restore_bundle(model, bundle) if bundle else 0
        warmed = 0
        warm_dt = 0.0
        if warm:
            t0 = time.perf_counter()
            warmed = program.warm()
            warm_dt = time.perf_counter() - t0
            if bundle:
                aot.save_bundle(model, bundle)
        worker = GenerateWorker(name, model, program, config=cfg,
                                latency=self.latency)
        meta = {
            "source": "object",
            "model_class": type(model).__name__,
            "warmed": int(warmed),
            "restored": int(restored),
            "warm_seconds": round(warm_dt, 4),
            "bundle": bundle,
            "kv_pool_bytes": program.pool_bytes(),
            "device": str(model.device),
            "generate": True,
        }
        with self._lock:
            old = self._generators.pop(name, None)
            self._generators[name] = worker
            self._meta[f"generate:{name}"] = meta
        if old is not None:
            old.shutdown()
        obs.event("serve_model_loaded", model=name, mode="generate", **{
            k: meta[k] for k in ("source", "model_class", "warmed",
                                 "restored", "warm_seconds")})
        return worker

    def register_index(self, name: str, index, warm: bool = True,
                       bundle: Optional[str] = None) -> SearchWorker:
        """Put a :class:`~deeplearning4j_tpu_torch.search.index.VectorIndex`
        behind a signature-coalescing worker under ``name``
        (``/v1/search``). With ``warm`` the index runs its (B, k, nprobe)
        signature grid once first. The tier knobs (``DL4J_TPU_IVF_NLIST`` /
        ``DL4J_TPU_IVF_NPROBE`` / ``DL4J_TPU_SEARCH_BATCH_MAX``) act at index
        BUILD time. Replaces (and shuts down) any index already bound to the
        name. A ``bundle`` restores the grid recorded on the index's search
        sites before the warm, and the warm set persists back to it."""
        if index.device.type != self.device.type:
            raise ValueError(f"index {name!r} lives on {index.device}, the "
                             f"registry serves {self.device}")
        restored = aot.restore_bundle(index, bundle) if bundle else 0
        warmed = 0
        warm_dt = 0.0
        if warm:
            t0 = time.perf_counter()
            warmed = index.warm()
            warm_dt = time.perf_counter() - t0
            if bundle:
                aot.save_bundle(index, bundle)
        worker = SearchWorker(name, index, config=self.config,
                              latency=self.latency)
        meta = {
            "source": "object",
            "model_class": type(index).__name__,
            "warmed": int(warmed),
            "restored": int(restored),
            "warm_seconds": round(warm_dt, 4),
            "bundle": bundle,
            "device": str(index.device),
            "search": True,
        }
        with self._lock:
            old = self._searchers.pop(name, None)
            self._searchers[name] = worker
            self._meta[f"search:{name}"] = meta
        if old is not None:
            old.shutdown()
        obs.event("serve_model_loaded", model=name, mode="search", **{
            k: meta[k] for k in ("source", "model_class", "warmed",
                                 "restored", "warm_seconds")})
        return worker

    def _warm_pipeline(self, model, warm: bool,
                       bundle: Optional[str]) -> Dict[str, object]:
        if getattr(model, "params", None) is None:
            model.init()
        if os.environ.get("DL4J_TPU_TUNE"):
            # the tuning DB's winner lands before the warm reads its knobs
            from deeplearning4j_tpu_torch import tune

            tune.maybe_apply(model, "serve")
        buckets: List[int] = []
        restored = warmed = 0
        warm_dt = 0.0
        if warm:
            buckets = (bucketing.reachable_buckets(self.config.max_batch)
                       if bucketing.bucketing_enabled()
                       else [self.config.max_batch])
            t0 = time.perf_counter()
            restored, warmed = aot.warm_serving_bundled(
                model, self.config.max_batch, bundle)
            warm_dt = time.perf_counter() - t0
        elif bundle:
            restored = aot.restore_bundle(model, bundle)
        return {
            "source": "object",
            "model_class": type(model).__name__,
            "warmed": int(warmed),
            "restored": int(restored),
            "warm_buckets": buckets,
            "warm_seconds": round(warm_dt, 4),
            "bundle": bundle,
            "device": str(model.device),
        }

    # -- lookup / introspection -------------------------------------------

    def worker(self, name: str) -> Optional[ModelWorker]:
        with self._lock:
            return self._workers.get(name)

    def generator(self, name: str) -> Optional[GenerateWorker]:
        with self._lock:
            return self._generators.get(name)

    def searcher(self, name: Optional[str] = None) -> Optional[SearchWorker]:
        """Search worker by name; with ``name=None`` (or "default") and
        exactly one index registered, that index — the legacy /knn routes
        carry no index name."""
        with self._lock:
            if name in (None, "default") and name not in self._searchers:
                if len(self._searchers) == 1:
                    return next(iter(self._searchers.values()))
                return None
            return self._searchers.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(set(self._workers) | set(self._generators)
                          | set(self._searchers))

    def describe(self) -> List[Dict[str, object]]:
        """One JSON-friendly row per served model (GET /v1/models)."""
        with self._lock:
            pairs = [(self._workers[n], dict(self._meta.get(n, {})))
                     for n in sorted(self._workers)]
            pairs += [(self._generators[n],
                       dict(self._meta.get(f"generate:{n}", {})))
                      for n in sorted(self._generators)]
            pairs += [(self._searchers[n],
                       dict(self._meta.get(f"search:{n}", {})))
                      for n in sorted(self._searchers)]
        rows = []
        for worker, meta in pairs:
            row = worker.stats()
            row.update(meta)
            rows.append(row)
        return rows

    def shutdown(self):
        with self._lock:
            workers = (list(self._workers.values())
                       + list(self._generators.values())
                       + list(self._searchers.values()))
            self._workers.clear()
            self._generators.clear()
            self._searchers.clear()
            self._meta.clear()
        for w in workers:
            w.shutdown()
