"""StatsListener: the producer side of the observability chain.

Reference: BaseStatsListener.java:43 (iterationDone:304 collects score,
per-parameter histograms/means/stdev of weights and updates, memory,
timing; gc stats at :389). Here the same signals come off the param tree:
per-layer/per-tensor mean, stdev, L2 norm, histogram of weights and of the
step's parameter UPDATE (delta since the listener last looked), update/
parameter ratio (the reference UI's key learning-rate-health chart), plus
wall-clock timing and throughput. Parameter keys are the JAX package's
paths (``"0/W"`` for a MultiLayerNetwork layer, ``"<vertex>/W"`` for a
graph), so a dashboard reads either package's records alike.
"""

from __future__ import annotations

import time
import uuid
from typing import Dict, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.train.listeners import TrainingListener
from deeplearning4j_tpu_torch.ui.storage import StatsStorage


def _tensor_stats(arr: np.ndarray, bins: int) -> dict:
    flat = arr.ravel()
    hist, edges = np.histogram(flat, bins=bins)
    return {
        "mean": float(flat.mean()),
        "stdev": float(flat.std()),
        "norm2": float(np.linalg.norm(flat)),
        "min": float(flat.min()),
        "max": float(flat.max()),
        "histogram": {"counts": hist.tolist(),
                      "lo": float(edges[0]), "hi": float(edges[-1])},
    }


def _host(t) -> np.ndarray:
    """A copy on the host: params are updated in place, so a view would
    move with them and every update would read 0."""
    import torch

    t = t.detach()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.to("cpu", copy=True).numpy()


def _flatten_params(params) -> Dict[str, np.ndarray]:
    """Param tree -> {"0/W": array, ...} with layer-index/name paths, in
    JAX treedef order (sequences by index, dict keys sorted)."""
    out: Dict[str, np.ndarray] = {}

    def visit(t, path):
        if t is None:
            return
        if isinstance(t, dict):
            for k in sorted(t):
                visit(t[k], path + (str(k),))
        elif isinstance(t, (tuple, list)):
            for i, x in enumerate(t):
                visit(x, path + (str(i),))
        else:
            out["/".join(path)] = _host(t)

    visit(params, ())
    return out


class StatsListener(TrainingListener):
    """Attachable stats producer: feeds a StatsStorage every
    ``frequency`` iterations.

    ``StatsListener(storage)`` mirrors new StatsListener(statsStorage) in
    the reference; session_id groups one training run.
    """

    def __init__(self, storage: StatsStorage, frequency: int = 1,
                 session_id: Optional[str] = None, worker_id: str = "0",
                 histogram_bins: int = 20, collect_histograms: bool = True):
        self.storage = storage
        self.frequency = max(1, frequency)
        self.session_id = session_id or f"session-{uuid.uuid4().hex[:8]}"
        self.worker_id = worker_id
        self.bins = histogram_bins
        self.collect_histograms = collect_histograms
        self._last_params: Optional[Dict[str, np.ndarray]] = None
        self._last_time: Optional[float] = None
        self._static_sent = False
        self._samples = 0

    # -- hooks -------------------------------------------------------------
    def _send_static(self, model) -> None:
        import torch

        from deeplearning4j_tpu_torch.utils.tree import tree_leaves

        dev = torch.device(getattr(model, "device", "cpu"))
        cuda = dev.type == "cuda"
        self.storage.put_static_info({
            "session_id": self.session_id,
            "worker_id": self.worker_id,
            "type_id": "StatsInitializationReport",
            "model_class": type(model).__name__,
            "n_layers": getattr(model, "n_layers", None),
            "n_params": int(sum(int(p.numel()) for p in tree_leaves(model.params))),
            "backend": "cuda" if cuda else "cpu",
            "devices": ([torch.cuda.get_device_name(i)
                         for i in range(torch.cuda.device_count())] if cuda else ["cpu"]),
        })
        self._static_sent = True

    def iteration_done(self, model, iteration, score, batch_size=0):
        self._samples += batch_size
        if not self._static_sent:
            self._send_static(model)
        if iteration % self.frequency != 0:
            return
        now = time.perf_counter()
        dt = (now - self._last_time) if self._last_time is not None else None
        cur = _flatten_params(model.params)

        param_stats: Dict[str, dict] = {}
        update_stats: Dict[str, dict] = {}
        ratios: Dict[str, float] = {}
        for name, arr in cur.items():
            st = _tensor_stats(arr, self.bins)
            if not self.collect_histograms:
                st.pop("histogram", None)
            param_stats[name] = st
            if self._last_params is not None and name in self._last_params:
                upd = arr - self._last_params[name]
                ust = _tensor_stats(upd, self.bins)
                if not self.collect_histograms:
                    ust.pop("histogram", None)
                update_stats[name] = ust
                pn = st["norm2"]
                ratios[name] = float(ust["norm2"] / pn) if pn > 0 else 0.0

        self.storage.put_update({
            "session_id": self.session_id,
            "worker_id": self.worker_id,
            "type_id": "StatsReport",
            "iteration": int(iteration),
            "score": float(score),
            "duration_sec": dt,
            "samples_per_sec": (self._samples / dt) if dt else None,
            "batch_size": batch_size,
            "parameters": param_stats,
            "updates": update_stats,
            "update_ratios": ratios,
        })
        # mirror the headline scalars into the obs registry so /metrics
        # serves them without a StatsStorage reader
        from deeplearning4j_tpu_torch import obs

        obs.gauge("dl4j_training_score",
                  "Last reported training score",
                  ("session",)).set(float(score), session=self.session_id)
        obs.counter("dl4j_training_iterations_total",
                    "Iterations observed by StatsListener",
                    ("session",)).inc(session=self.session_id)
        if dt and self._samples:
            obs.gauge("dl4j_training_samples_per_second",
                      "Recent training throughput",
                      ("session",)).set(self._samples / dt,
                                        session=self.session_id)
        self._last_params = cur
        self._last_time = now
        self._samples = 0
