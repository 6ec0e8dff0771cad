"""Memory report (MemoryReport parity) — PyTorch port of ``nn/memory.py``.

Parity: nn/conf/memory/{MemoryReport.java:70, LayerMemoryReport,
NetworkMemoryReport}. The JAX package reads XLA's ``memory_analysis`` of
the compiled train and inference executables; PyTorch compiles nothing, so
the port measures one real dispatch of each:

- ``params_bytes`` and ``opt_state_bytes`` are exact (numel x itemsize over
  the trees; the updater state the first update would build, where none
  exists yet) and equal the JAX package's for the same configuration;
- ``inference``: one forward at ``batch_size`` rows;
- ``training``: one training step on a snapshot of params, updater state,
  layer state, counters and generator, restored afterwards: the report
  never trains.

On the card ``temp_bytes`` is the caching allocator's peak over the pass
above what was allocated before it, less what the pass allocates to keep
(the forward's output; a step's loss and, for a first step, the updater
state it builds); on the CPU it is the peak of the storages the pass
allocates and holds, as a dispatch mode follows them, less the same. The
card's reading resets the allocator's peak statistic: a report is an
explicit request for it. ``output_bytes`` is
the forward's output, or for a step what it writes: params, updater
state, layer state and the loss. The dummy input is
``dummy_input``: int ids for a sequence embedding, zeros otherwise.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import torch

from deeplearning4j_tpu_torch.utils.tree import tree_leaves

__all__ = ["MemoryReport", "memory_report"]


def _tree_bytes(tree) -> int:
    return sum(int(t.numel()) * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


@dataclass
class MemoryReport:
    """Network memory report (NetworkMemoryReport surface): fixed memory
    (params + updater state), and per-mode measured footprints."""

    model_class: str
    batch_size: int
    params_bytes: int
    opt_state_bytes: int
    inference: Dict[str, int] = field(default_factory=dict)
    training: Dict[str, int] = field(default_factory=dict)

    def total_training_bytes(self) -> int:
        return (self.params_bytes + self.opt_state_bytes
                + self.training.get("temp_bytes", 0)
                + self.training.get("output_bytes", 0))

    def total_inference_bytes(self) -> int:
        return (self.params_bytes + self.inference.get("temp_bytes", 0)
                + self.inference.get("output_bytes", 0))

    def to_string(self) -> str:
        mb = lambda b: f"{b / 2**20:.2f} MB"  # noqa: E731
        return "\n".join([
            f"MemoryReport: {self.model_class} (batch={self.batch_size})",
            f"  parameters:     {mb(self.params_bytes)}",
            f"  updater state:  {mb(self.opt_state_bytes)}",
            f"  inference:      temp {mb(self.inference.get('temp_bytes', 0))}, "
            f"output {mb(self.inference.get('output_bytes', 0))}, "
            f"total {mb(self.total_inference_bytes())}",
            f"  training:       temp {mb(self.training.get('temp_bytes', 0))}, "
            f"output {mb(self.training.get('output_bytes', 0))}, "
            f"total {mb(self.total_training_bytes())}",
        ])


def _measure(model, fn) -> Dict[str, int]:
    """Run ``fn()``, which returns (result, the bytes it writes, the bytes
    it allocates to keep), and measure its footprint."""
    from deeplearning4j_tpu_torch.obs import profile

    dev = torch.device(model.device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out, out_bytes, kept = fn()
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        del out
        return {"temp_bytes": int(max(peak - base - kept, 0)),
                "output_bytes": int(out_bytes), "peak_bytes": int(peak)}
    with profile._bytes_mode(track_live=True) as mode:
        out, out_bytes, kept = fn()
    del out
    return {"temp_bytes": int(max(mode.peak - kept, 0)), "output_bytes": int(out_bytes)}


def _opt_state_bytes(model) -> int:
    if model.opt_state is not None:
        return _tree_bytes(model.opt_state)
    with torch.no_grad():
        built = model.init_opt_state()
    n = _tree_bytes(built)
    model.opt_state = None
    return n


def memory_report(model, batch_size: int = 32) -> MemoryReport:
    """Measure ``model``'s inference and training footprints at
    ``batch_size`` rows (MultiLayerNetwork and ComputationGraph,
    NetworkMemoryReport parity). Leaves params, updater state, layer state
    and the generator bit-identical."""
    from deeplearning4j_tpu_torch.nn import aot
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    if model.params is None:
        model.init()
    is_graph = isinstance(model, ComputationGraph)
    feats = aot._dummy_features(model, batch_size)
    out_types = model.output_types if is_graph else (model.output_type,)
    dev = model.device
    labels = tuple(torch.zeros(t.batch_shape(batch_size), dtype=model.dtype, device=dev)
                   for t in out_types)
    params_bytes = _tree_bytes(model.params)
    opt_bytes = _opt_state_bytes(model)
    had_opt = model.opt_state is not None

    def infer():
        with torch.inference_mode():
            out = model._infer(feats, None)
        n = _tree_bytes(out)
        return out, n, n

    def train():
        if is_graph:
            loss = model._step(dict(zip(model.conf.inputs, feats)), labels, None, None, None)
        else:
            loss = model._step(feats, labels[0], None, None, None)
        loss_bytes = loss.numel() * loss.element_size()
        written = (params_bytes + _tree_bytes(model.opt_state)
                   + _tree_bytes(model.state) + loss_bytes)
        return loss, written, loss_bytes + (0 if had_opt else _tree_bytes(model.opt_state))

    inference = _measure(model, infer)
    # the snapshot is taken before the measured step, so its copies are
    # not counted as the step's
    with aot._ModelSnapshot(model):
        training = _measure(model, train)
    return MemoryReport(
        model_class=type(model).__name__,
        batch_size=batch_size,
        params_bytes=params_bytes,
        opt_state_bytes=opt_bytes,
        inference=inference,
        training=training,
    )
