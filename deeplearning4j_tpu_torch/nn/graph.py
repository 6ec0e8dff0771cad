"""ComputationGraph: DAG models with many inputs and outputs (PyTorch).

Counterpart of ``deeplearning4j_tpu/nn/graph.py`` (DL4J's
ComputationGraph and ComputationGraphConfiguration). The configuration
classes, the vertex types and their ``@vtype`` tags are the same and read
and write the same JSON and YAML, ``"format"`` tag included. The network
keeps the JAX package's surface: ``params`` is a dict ``{vertex_name: layer
params}`` (``{}`` for a param-free vertex), ``state`` and ``opt_state`` are
dicts keyed the same way, and every layout is NHWC or [batch, time, feat],
so MergeVertex, SubsetVertex and L2Vertex work on the last axis and Stack /
Unstack on the batch axis, whatever the input kind.

Training: one step is the forward over the topological order, the sum of
every output head's average score plus the L1/L2 penalties, and
``torch.autograd.grad`` over the whole DAG, which sums the gradients of a
vertex with many consumers (no activation is modified in place). Then each
vertex updates on its own: gradient normalization, its updater (the
vertex's own or the network's), constraints; a vertex with no trainable
params, or a frozen one (``trainable=False``, the noop updater, no gradient
asked for), keeps its params and updater state. Gradient accumulation
(``DL4J_TPU_GRAD_ACCUM``) is the MultiLayerNetwork's. ``fit`` takes
arrays, tuples, dicts and MultiDataSet-style tuples of features / labels /
masks, pads a partial tail batch to the full row count with its padded
rows weighted out of the loss and out of BatchNorm's statistics, and runs
truncated BPTT over the recurrent inputs when the configuration asks for
it; ``rnn_time_step`` streams one or more steps at a time.

The training runtime around ``fit`` is the MultiLayerNetwork's:
``fit(resume_from=)`` with exact resume, ``set_divergence_guard`` (the
skip_batch select on the device), the chaos hooks, chained K-step dispatch
(``DL4J_TPU_CHAIN_STEPS``, off by default), device prefetch on a side stream
(``DL4J_TPU_DEVICE_PREFETCH=1``, off by default) and ``DataSet`` /
``MultiDataSet`` input. The data-parallel gradient exchange
(``parallel/grads.py``, driven by ``parallel/wrapper.py`` ParallelWrapper)
runs a graph through ``_as_multi_batch``, ``_to_device`` and
``_value_and_grad`` and updates its vertices itself. The dispatch sites
``cg.output``, ``cg.step`` and ``cg.step.tbptt`` record their signatures
for the warm layer (``nn/aot.py``); ``DL4J_TPU_AOT=1`` warms the first
step and ``DL4J_TPU_TUNE=auto`` applies the tuning DB's winner in ``fit``.

The network lives on one device, chosen at construction: ``device=None``
means the GPU, and raises when there is none; ``device="cpu"`` must be
asked for. The training RNG is one ``torch.Generator`` on that device,
seeded from ``conf.seed``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.nn import aot
from deeplearning4j_tpu_torch.nn.config import LayerConfig, _encode_value, layer_from_dict
from deeplearning4j_tpu_torch.nn.constraints import apply_constraints
from deeplearning4j_tpu_torch.nn.input_type import InputType
from deeplearning4j_tpu_torch.nn.layers import BaseRecurrent, Embedding, EmbeddingSequence
from deeplearning4j_tpu_torch.nn.model import (
    _cast_input,
    _cast_labels,
    _cast_mask,
    _device_prefetch_enabled,
    _select,
    resolve_device,
    torch_dtype,
)
from deeplearning4j_tpu_torch.nn.preprocessors import infer_preprocessor
from deeplearning4j_tpu_torch.nn.step_program import (
    accum_applicable,
    accum_value_and_grad,
    chain_batches,
    chain_k_from_env,
    grad_accum_from_env,
)
from deeplearning4j_tpu_torch.train.listeners import close_listeners
from deeplearning4j_tpu_torch.train.updaters import (
    apply_gradient_normalization,
    make_updater,
    scale_lr,
)
from deeplearning4j_tpu_torch.utils import bucketing
from deeplearning4j_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten_like

__all__ = [
    "ComputationGraph", "ComputationGraphConfiguration", "DuplicateToTimeSeriesVertex",
    "ElementWiseVertex", "GraphBuilder", "GraphVertex", "L2NormalizeVertex", "L2Vertex",
    "LastTimeStepVertex", "MergeVertex", "PreprocessorVertex", "ReshapeVertex",
    "ReverseTimeSeriesVertex", "ScaleVertex", "ShiftVertex", "StackVertex",
    "SubsetVertex", "UnstackVertex", "VertexSpec", "register_vertex", "vertex_registry",
]

# ---------------------------------------------------------------------------
# Vertex configs
# ---------------------------------------------------------------------------

vertex_registry: Dict[str, type] = {}


def register_vertex(type_name: str):
    """Class decorator registering a vertex config under a stable JSON tag."""

    def deco(cls):
        cls._vtype_name = type_name
        vertex_registry[type_name] = cls
        return cls

    return deco


@dataclass
class GraphVertex:
    """Base for the DAG's non-layer nodes (nn/conf/graph/GraphVertex.java).

    Contract (list-valued inputs):
    - ``output_type(input_types) -> InputType``
    - ``init(gen, input_types, dtype, device) -> params`` ({}: param-free)
    - ``apply(params, state, xs, *, train, rng, masks) -> (y, new_state)``
    - ``propagate_mask(masks, input_types) -> mask``
    """

    _vtype_name = "vertex"
    trainable = True
    l1 = 0.0
    l2 = 0.0
    updater = None

    def to_dict(self) -> dict:
        d = {"@vtype": self._vtype_name}
        for f in dataclasses.fields(self):
            d[f.name] = _encode_value(getattr(self, f.name))
        return d

    @staticmethod
    def from_dict(d: dict) -> "GraphVertex":
        tag = d.get("@vtype")
        if tag not in vertex_registry:
            raise ValueError(f"Unknown vertex type '{tag}'. Known: {sorted(vertex_registry)}")
        cls = vertex_registry[tag]
        names = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in d.items() if k in names}
        # JSON arrays -> tuples for shape-like fields
        kwargs = {k: tuple(v) if isinstance(v, list) else v for k, v in kwargs.items()}
        return cls(**kwargs)

    def output_type(self, input_types: List[InputType]) -> InputType:
        return input_types[0]

    def init(self, gen, input_types: List[InputType], dtype=torch.float32, device=None):
        return {}

    def init_state(self, input_types: List[InputType]):
        return {}

    def apply(self, params, state, xs, *, train=False, rng=None, masks=None):
        raise NotImplementedError

    def propagate_mask(self, masks, input_types: List[InputType]):
        for m in masks or ():
            if m is not None:
                return m
        return None

    def uses_rng(self) -> bool:
        return False


@register_vertex("merge")
@dataclass
class MergeVertex(GraphVertex):
    """Concatenation along the feature / channel axis (MergeVertex.java):
    the last axis for every input kind."""

    def output_type(self, input_types):
        it0 = input_types[0]
        if it0.kind == "conv":
            return InputType.convolutional(
                it0.height, it0.width, sum(t.channels for t in input_types))
        if it0.kind == "recurrent":
            return InputType.recurrent(sum(t.size for t in input_types), it0.timesteps)
        return InputType.feed_forward(sum(t.flat_size() for t in input_types))

    def apply(self, params, state, xs, *, train=False, rng=None, masks=None):
        return torch.cat(xs, dim=-1), state


@register_vertex("elementwise")
@dataclass
class ElementWiseVertex(GraphVertex):
    """Pointwise add / subtract / product / average / max across the inputs
    (ElementWiseVertex.java; the residual connection). Out of place: an
    input may feed other vertices too."""

    op: str = "add"

    def apply(self, params, state, xs, *, train=False, rng=None, masks=None):
        if self.op in ("add", "average"):
            y = xs[0]
            for x in xs[1:]:
                y = y + x
            if self.op == "average":
                y = y / len(xs)
        elif self.op == "subtract":
            y = xs[0] - xs[1]
        elif self.op == "product":
            y = xs[0]
            for x in xs[1:]:
                y = y * x
        elif self.op == "max":
            y = xs[0]
            for x in xs[1:]:
                y = torch.maximum(y, x)
        else:
            raise ValueError(f"Unknown elementwise op '{self.op}'")
        return y, state


@register_vertex("stack")
@dataclass
class StackVertex(GraphVertex):
    """Concatenation along the batch axis (StackVertex.java); with Unstack,
    weight sharing across branches."""

    def apply(self, params, state, xs, *, train=False, rng=None, masks=None):
        return torch.cat(xs, dim=0), state


@register_vertex("unstack")
@dataclass
class UnstackVertex(GraphVertex):
    """Batch segment ``from_index`` of ``stack_size`` equal parts
    (UnstackVertex.java)."""

    from_index: int = 0
    stack_size: int = 1

    def apply(self, params, state, xs, *, train=False, rng=None, masks=None):
        x = xs[0]
        step = x.shape[0] // self.stack_size
        return x[self.from_index * step:(self.from_index + 1) * step], state


@register_vertex("subset")
@dataclass
class SubsetVertex(GraphVertex):
    """Feature range [from_index, to_index], both ends INCLUSIVE
    (SubsetVertex.java)."""

    from_index: int = 0
    to_index: int = 0

    def output_type(self, input_types):
        n = self.to_index - self.from_index + 1
        it = input_types[0]
        if it.kind == "recurrent":
            return InputType.recurrent(n, it.timesteps)
        if it.kind == "conv":
            return InputType.convolutional(it.height, it.width, n)
        return InputType.feed_forward(n)

    def apply(self, params, state, xs, *, train=False, rng=None, masks=None):
        return xs[0][..., self.from_index:self.to_index + 1], state


@register_vertex("scale")
@dataclass
class ScaleVertex(GraphVertex):
    scale: float = 1.0

    def apply(self, params, state, xs, *, train=False, rng=None, masks=None):
        return xs[0] * self.scale, state


@register_vertex("shift")
@dataclass
class ShiftVertex(GraphVertex):
    shift: float = 0.0

    def apply(self, params, state, xs, *, train=False, rng=None, masks=None):
        return xs[0] + self.shift, state


@register_vertex("l2")
@dataclass
class L2Vertex(GraphVertex):
    """Pairwise L2 distance of two inputs -> [batch, 1] (L2Vertex.java; the
    triplet-loss nets)."""

    eps: float = 1e-8

    def output_type(self, input_types):
        return InputType.feed_forward(1)

    def apply(self, params, state, xs, *, train=False, rng=None, masks=None):
        a = xs[0].reshape(xs[0].shape[0], -1)
        b = xs[1].reshape(xs[1].shape[0], -1)
        return torch.sqrt(torch.sum((a - b) ** 2, dim=-1, keepdim=True) + self.eps), state


@register_vertex("l2normalize")
@dataclass
class L2NormalizeVertex(GraphVertex):
    """x / ||x||_2 over every non-batch axis (L2NormalizeVertex.java)."""

    eps: float = 1e-8

    def apply(self, params, state, xs, *, train=False, rng=None, masks=None):
        x = xs[0]
        axes = tuple(range(1, x.dim()))
        return x / torch.sqrt(torch.sum(x * x, dim=axes, keepdim=True) + self.eps), state


@register_vertex("reshape")
@dataclass
class ReshapeVertex(GraphVertex):
    """Reshape to ``shape`` (-1 allowed for the batch axis)
    (ReshapeVertex.java)."""

    shape: Tuple[int, ...] = ()
    output: Optional[dict] = None  # explicit InputType dict for shape inference

    def output_type(self, input_types):
        if self.output is not None:
            return InputType.from_dict(dict(self.output))
        s = [d for d in self.shape if d != -1]
        if len(s) == 1:
            return InputType.feed_forward(s[0])
        if len(s) == 3:
            return InputType.convolutional(s[0], s[1], s[2])
        if len(s) == 2:
            return InputType.recurrent(s[1], s[0])
        return input_types[0]

    def apply(self, params, state, xs, *, train=False, rng=None, masks=None):
        return xs[0].reshape(self.shape), state


@register_vertex("preprocessor")
@dataclass
class PreprocessorVertex(GraphVertex):
    """Any param-free LayerConfig (the preprocessors) as a DAG node
    (PreprocessorVertex.java)."""

    preprocessor: Any = None

    def output_type(self, input_types):
        return self.preprocessor.output_type(input_types[0])

    def apply(self, params, state, xs, *, train=False, rng=None, masks=None):
        y, _ = self.preprocessor.apply({}, {}, xs[0], train=train, rng=rng,
                                       mask=masks[0] if masks else None)
        return y, state

    def to_dict(self):
        return {"@vtype": self._vtype_name, "preprocessor": self.preprocessor.to_dict()}

    @staticmethod
    def _decode(d):
        return PreprocessorVertex(preprocessor=layer_from_dict(d["preprocessor"]))


@register_vertex("last_time_step")
@dataclass
class LastTimeStepVertex(GraphVertex):
    """[b, t, f] -> [b, f]: the last time step, or the last UNMASKED one when
    the named network input ``mask_input`` has a mask
    (rnn/LastTimeStepVertex.java)."""

    mask_input: Optional[str] = None

    def output_type(self, input_types):
        return InputType.feed_forward(input_types[0].size)

    def apply(self, params, state, xs, *, train=False, rng=None, masks=None):
        x = xs[0]
        m = masks[0] if masks else None
        if m is None:
            return x[:, -1, :], state
        # the last index where the mask is set (left-padded masks too)
        T = x.shape[1]
        rev = torch.flip(m > 0, dims=(1,)).to(torch.int32)
        idx = T - 1 - torch.argmax(rev, dim=1)
        return torch.take_along_dim(x, idx[:, None, None], dim=1)[:, 0, :], state

    def propagate_mask(self, masks, input_types):
        return None


@register_vertex("duplicate_to_time_series")
@dataclass
class DuplicateToTimeSeriesVertex(GraphVertex):
    """[b, f] -> [b, t, f], t (and the mask) taken from the second input
    (rnn/DuplicateToTimeSeriesVertex.java; the builder wires the named
    network input in as input #2)."""

    def output_type(self, input_types):
        t = input_types[1].timesteps if len(input_types) > 1 else None
        return InputType.recurrent(input_types[0].flat_size(), t)

    def apply(self, params, state, xs, *, train=False, rng=None, masks=None):
        x, ref = xs[0], xs[1]
        return x[:, None, :].expand(x.shape[0], ref.shape[1], x.shape[-1]), state

    def propagate_mask(self, masks, input_types):
        return masks[1] if masks and len(masks) > 1 else None


@register_vertex("reverse_time_series")
@dataclass
class ReverseTimeSeriesVertex(GraphVertex):
    """The time axis reversed; with a mask only the valid prefix is
    (rnn/ReverseTimeSeriesVertex.java)."""

    def apply(self, params, state, xs, *, train=False, rng=None, masks=None):
        x = xs[0]
        m = masks[0] if masks else None
        if m is None:
            return torch.flip(x, dims=(1,)), state
        lengths = torch.sum(m > 0, dim=1)                     # [b]
        j = torch.arange(x.shape[1], device=x.device)[None, :]
        # index j -> len-1-j inside the valid prefix; padding stays in place
        idx = torch.where(j < lengths[:, None], lengths[:, None] - 1 - j, j)
        return torch.take_along_dim(x, idx[:, :, None], dim=1), state


# ---------------------------------------------------------------------------
# Configuration + builder
# ---------------------------------------------------------------------------


@dataclass
class VertexSpec:
    """One DAG node: a LayerConfig or a GraphVertex plus its input names."""

    config: Any
    inputs: Tuple[str, ...]

    def is_layer(self) -> bool:
        return isinstance(self.config, LayerConfig)


@dataclass
class ComputationGraphConfiguration:
    """DAG config (ComputationGraphConfiguration.java), the same fields and
    JSON as the JAX package's."""

    inputs: Tuple[str, ...] = ()
    input_types: Dict[str, InputType] = field(default_factory=dict)
    vertices: Dict[str, VertexSpec] = field(default_factory=dict)  # insertion-ordered
    outputs: Tuple[str, ...] = ()
    seed: int = 12345
    updater: Any = "sgd"
    dtype: str = "float32"
    # truncated BPTT over the DAG: "standard" | "tbptt", one chunk length
    backprop_type: str = "standard"
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20

    def to_dict(self) -> dict:
        return {
            "format": "deeplearning4j_tpu/ComputationGraphConfiguration",
            "version": 1,
            "inputs": list(self.inputs),
            "input_types": {k: v.to_dict() for k, v in self.input_types.items()},
            "vertices": [
                {
                    "name": name,
                    "inputs": list(spec.inputs),
                    ("layer" if spec.is_layer() else "vertex"): spec.config.to_dict(),
                }
                for name, spec in self.vertices.items()
            ],
            "outputs": list(self.outputs),
            "seed": self.seed,
            "updater": _encode_value(self.updater),
            "dtype": self.dtype,
            "backprop_type": self.backprop_type,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_back_length": self.tbptt_back_length,
        }

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @staticmethod
    def from_dict(d: dict) -> "ComputationGraphConfiguration":
        vertices: Dict[str, VertexSpec] = {}
        for v in d["vertices"]:
            if "layer" in v:
                cfg = layer_from_dict(v["layer"])
            elif v["vertex"].get("@vtype") == "preprocessor":
                cfg = PreprocessorVertex._decode(v["vertex"])
            else:
                cfg = GraphVertex.from_dict(v["vertex"])
            vertices[v["name"]] = VertexSpec(cfg, tuple(v["inputs"]))
        return ComputationGraphConfiguration(
            inputs=tuple(d["inputs"]),
            input_types={k: InputType.from_dict(t) for k, t in d["input_types"].items()},
            vertices=vertices,
            outputs=tuple(d["outputs"]),
            seed=d.get("seed", 12345),
            updater=d.get("updater", "sgd"),
            dtype=d.get("dtype", "float32"),
            backprop_type=d.get("backprop_type", "standard"),
            tbptt_fwd_length=d.get("tbptt_fwd_length", 20),
            tbptt_back_length=d.get("tbptt_back_length", 20),
        )

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        return ComputationGraphConfiguration.from_dict(json.loads(s))

    def to_yaml(self) -> str:
        from deeplearning4j_tpu_torch.nn.config import yaml_dump

        return yaml_dump(self.to_dict())

    @staticmethod
    def from_yaml(s: str) -> "ComputationGraphConfiguration":
        from deeplearning4j_tpu_torch.nn.config import yaml_load

        return ComputationGraphConfiguration.from_dict(yaml_load(s))

    @staticmethod
    def builder() -> "GraphBuilder":
        return GraphBuilder()


class GraphBuilder:
    """Fluent DAG builder (ComputationGraphConfiguration.GraphBuilder)."""

    def __init__(self):
        self._inputs: List[str] = []
        self._input_types: Dict[str, InputType] = {}
        self._vertices: Dict[str, VertexSpec] = {}
        self._outputs: List[str] = []
        self._seed = 12345
        self._updater: Any = "sgd"
        self._dtype = "float32"
        self._backprop_type = "standard"
        self._tbptt_length = 20

    def add_inputs(self, *names: str) -> "GraphBuilder":
        self._inputs.extend(names)
        return self

    def set_input_types(self, *types: InputType) -> "GraphBuilder":
        if len(types) != len(self._inputs):
            raise ValueError("set_input_types: one InputType per declared input")
        self._input_types = dict(zip(self._inputs, types))
        return self

    def add_layer(self, name: str, layer: LayerConfig, *inputs: str) -> "GraphBuilder":
        return self.add_vertex(name, layer, *inputs)

    def add_vertex(self, name: str, v: Any, *inputs: str) -> "GraphBuilder":
        if name in self._vertices or name in self._inputs:
            raise ValueError(f"Duplicate vertex name '{name}'")
        known = set(self._inputs) | set(self._vertices)
        for i in inputs:
            if i not in known:
                raise ValueError(f"Vertex '{name}' input '{i}' is not defined (yet)")
        self._vertices[name] = VertexSpec(v, tuple(inputs))
        return self

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self._outputs = list(names)
        return self

    def seed(self, s: int) -> "GraphBuilder":
        self._seed = s
        return self

    def updater(self, u: Any) -> "GraphBuilder":
        self._updater = u
        return self

    def dtype(self, d: str) -> "GraphBuilder":
        self._dtype = d
        return self

    def tbptt(self, length: int) -> "GraphBuilder":
        """Truncated BPTT with chunks of ``length`` steps."""
        self._backprop_type = "tbptt"
        self._tbptt_length = length
        return self

    def build(self) -> ComputationGraphConfiguration:
        if not self._inputs:
            raise ValueError("ComputationGraph needs at least one input")
        if not self._outputs:
            raise ValueError("ComputationGraph needs at least one output")
        for o in self._outputs:
            if o not in self._vertices:
                raise ValueError(f"Output '{o}' is not a vertex")
        if set(self._input_types) != set(self._inputs):
            raise ValueError("set_input_types is required (one per input)")
        return ComputationGraphConfiguration(
            inputs=tuple(self._inputs),
            input_types=self._input_types,
            vertices=self._vertices,
            outputs=tuple(self._outputs),
            seed=self._seed,
            updater=self._updater,
            dtype=self._dtype,
            backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_length,
            tbptt_back_length=self._tbptt_length,
        )


# ---------------------------------------------------------------------------
# Runtime model
# ---------------------------------------------------------------------------


@dataclass
class _RuntimeVertex:
    name: str
    spec: VertexSpec
    inputs: Tuple[str, ...]
    pre: Optional[LayerConfig]          # auto-inserted preprocessor (layer vertices)
    input_types: List[InputType]        # per runtime input, after the preprocessor
    out_type: InputType
    config: Any                         # resolved (n_in inferred) layer or vertex


def _tbptt_slice_t(x, sl, T, kind):
    """The tBPTT time-axis chunking rule for one tensor: inputs DECLARED
    recurrent (``feat_td``: [B, T, F] streams and [B, T] integer id streams)
    chunk on axis 1, static inputs (``feat``) pass whole even where their
    middle dim equals T; labels chunk when [B, T, C] or sparse integer
    [B, T]; masks [B, T] chunk."""
    if x is None:
        return None
    if x.dim() == 3 and x.shape[1] == T and kind in ("feat_td", "label", "mask"):
        return x[:, sl]
    if x.dim() == 2 and x.shape[1] == T:
        if kind in ("mask", "feat_td") or (kind == "label" and not x.is_floating_point()):
            return x[:, sl]
    return x


def _toposort(conf: ComputationGraphConfiguration) -> List[str]:
    """Kahn's algorithm over vertex names; raises on a cycle."""
    indeg = {n: 0 for n in conf.vertices}
    dependents: Dict[str, List[str]] = {n: [] for n in conf.vertices}
    for name, spec in conf.vertices.items():
        for i in spec.inputs:
            if i in conf.vertices:
                indeg[name] += 1
                dependents[i].append(name)
    ready = [n for n, d in indeg.items() if d == 0]
    order: List[str] = []
    while ready:
        n = ready.pop(0)
        order.append(n)
        for m in dependents[n]:
            indeg[m] -= 1
            if indeg[m] == 0:
                ready.append(m)
    if len(order) != len(conf.vertices):
        cyc = sorted(set(conf.vertices) - set(order))
        raise ValueError(f"Graph has a cycle involving: {cyc}")
    return order


def _is_arr(v) -> bool:
    return isinstance(v, (np.ndarray, torch.Tensor)) or hasattr(v, "__array__")


def _as_tuple(v, n: int):
    """Features, labels or masks as an n-tuple (one array fills the first
    slot), or None."""
    if v is None:
        return None
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) + (None,) * (n - 1)


class ComputationGraph:
    """Model facade over a DAG configuration; the reference's API
    (init / fit / output / rnn_time_step / score / evaluate).

    Host state: ``params``, ``state`` and ``opt_state`` (dicts keyed by
    vertex name; ``opt_state`` None until the first update needs it),
    ``iteration``/``epoch``, ``listeners``, ``device`` and ``dtype``."""

    def __init__(self, conf: ComputationGraphConfiguration, device=None):
        self.conf = conf
        self.device = resolve_device(device)
        self.dtype = torch_dtype(conf.dtype)
        self._resolve()
        self.params: Optional[dict] = None
        self.state: Optional[dict] = None
        self.opt_state: Optional[dict] = None
        self.iteration = 0
        self.epoch = 0
        self.batch_in_epoch = 0
        self.listeners: list = []
        self._rnn_carries: Optional[dict] = None
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(conf.seed)
        self.divergence_guard = None
        self._lr_scale = 1.0

    # -- resolution --------------------------------------------------------
    def _resolve(self):
        conf = self.conf
        self.topo_order = _toposort(conf)
        types: Dict[str, InputType] = dict(conf.input_types)
        self.rt: Dict[str, _RuntimeVertex] = {}
        for name in self.topo_order:
            spec = conf.vertices[name]
            in_types = [types[i] for i in spec.inputs]
            pre = None
            cfg = spec.config
            if spec.is_layer():
                if len(spec.inputs) != 1:
                    raise ValueError(f"Layer vertex '{name}' must have exactly one input")
                pre = infer_preprocessor(in_types[0], cfg)
                if pre is not None:
                    in_types = [pre.output_type(in_types[0])]
                if hasattr(cfg, "with_n_in"):
                    cfg = cfg.with_n_in(cfg.infer_n_in(in_types[0]))
                out_t = cfg.output_type(in_types[0])
            else:
                out_t = cfg.output_type(in_types)
            types[name] = out_t
            self.rt[name] = _RuntimeVertex(name=name, spec=spec, inputs=spec.inputs, pre=pre,
                                           input_types=in_types, out_type=out_t, config=cfg)
        self.vertex_types = types
        self.output_types = [types[o] for o in conf.outputs]
        # layer vertices with a time-stepped carry: tBPTT and rnn_time_step
        # thread state through exactly these
        self._carry_vertices = [
            name for name in self.topo_order
            if self.rt[name].spec.is_layer()
            and isinstance(self.rt[name].config, BaseRecurrent)
            and getattr(self.rt[name].config, "SUPPORTS_CARRY", False)]
        # wrappers holding an inner RNN (Bidirectional, MaskZero,
        # LastTimeStep) have no carry channel: streaming and tBPTT refuse them
        self._wrapped_rnn_vertices = [
            name for name in self.topo_order
            if self.rt[name].spec.is_layer()
            and getattr(self.rt[name].config, "rnn", None) is not None]
        self._loss_vertices = [o for o in conf.outputs if hasattr(self.rt[o].config, "score")]
        # Stack/Unstack cut the BATCH axis into fixed segments: padded rows
        # would land in the wrong branch, so output() does not bucket them
        self._has_batch_vertices = any(
            isinstance(self.rt[name].config, (StackVertex, UnstackVertex))
            for name in self.topo_order)

    # -- init --------------------------------------------------------------
    def init(self, seed: Optional[int] = None) -> "ComputationGraph":
        """Draw every vertex's params from one ``torch.Generator`` on the
        model's device, in topological order; build the per-vertex updaters
        (their state is built at the first update); reset the counters."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.conf.seed if seed is None else seed)
        self.params, self.state = {}, {}
        with torch.no_grad():
            for name in self.topo_order:
                v = self.rt[name]
                its = v.input_types[0] if v.spec.is_layer() else v.input_types
                self.params[name] = v.config.init(gen, its, self.dtype, self.device)
                self.state[name] = tree_map(lambda t: t.to(self.device),
                                            v.config.init_state(its))
        self._build_updaters()
        self.opt_state = None
        self.iteration = 0
        self.epoch = 0
        return self

    def _build_updaters(self):
        """One updater per vertex: the vertex's own ``updater`` overrides
        the network default; frozen vertices get ``noop``. Every rate is
        scaled by ``_lr_scale``, the divergence guard's rollback backoff."""
        scale = float(getattr(self, "_lr_scale", 1.0))
        default = scale_lr(self.conf.updater, scale)
        self._updaters = {}
        for name in self.topo_order:
            cfg = self.rt[name].config
            if not getattr(cfg, "trainable", True):
                self._updaters[name] = make_updater("noop")
            elif getattr(cfg, "updater", None) is not None:
                self._updaters[name] = make_updater(scale_lr(cfg.updater, scale))
            else:
                self._updaters[name] = make_updater(default)

    def uses_rng(self) -> bool:
        """Does a training step draw randomness (dropout, weight noise)?"""
        return any(getattr(self.rt[n].config, "uses_rng", lambda: False)()
                   for n in self.topo_order)

    def init_opt_state(self):
        """The per-vertex updater state, built from the params on first use."""
        if self.opt_state is None:
            with torch.no_grad():
                self.opt_state = {name: self._updaters[name].init(self.params[name])
                                  for name in self.topo_order}
        return self.opt_state

    def num_params(self) -> int:
        return sum(int(p.numel()) for p in tree_leaves(self.params))

    def _trainable(self, name: str) -> bool:
        return bool(getattr(self.rt[name].config, "trainable", True))

    # -- forward -----------------------------------------------------------
    def _forward(self, params, state, inputs: Dict[str, torch.Tensor], *, train, rng=None,
                 masks: Optional[Dict[str, Any]] = None, stop_at: Optional[set] = None,
                 ex_weight=None, carries: Optional[dict] = None,
                 deterministic: bool = False):
        """Walk the topological order. Returns (acts, new_state, mask_acts,
        new_carries).

        ``stop_at``: loss-head vertices whose activation is their INPUT
        (after the preprocessor): the loss applies them. ``ex_weight``: the
        per-example [B] validity weight for layer vertices that declare
        CONSUMES_EXAMPLE_WEIGHT (BatchNorm). ``carries``: {vertex: carry}
        for the recurrent layer vertices, which then run ``apply_seq`` from
        them; their final carries are returned. ``deterministic``: vertices
        whose train-mode apply draws randomness run in eval mode."""
        acts: Dict[str, torch.Tensor] = dict(inputs)
        mask_acts: Dict[str, Any] = dict(masks or {})
        for n in self.conf.inputs:
            mask_acts.setdefault(n, None)
        new_carries = dict(carries) if carries is not None else None
        new_state = {}
        for name in self.topo_order:
            v = self.rt[name]
            xs = [acts[i] for i in v.inputs]
            in_masks = [mask_acts.get(i) for i in v.inputs]
            if stop_at and name in stop_at:
                x, m = xs[0], in_masks[0]
                if v.pre is not None:
                    x, _ = v.pre.apply({}, {}, x, train=train, rng=None, mask=m)
                    m = v.pre.propagate_mask(m, self.vertex_types[v.inputs[0]])
                acts[name] = x
                mask_acts[name] = m
                new_state[name] = state[name]
                continue
            vtrain = train and not (deterministic and v.config.uses_rng())
            if v.spec.is_layer():
                x, m = xs[0], in_masks[0]
                it = self.vertex_types[v.inputs[0]]
                if v.pre is not None:
                    x, _ = v.pre.apply({}, {}, x, train=vtrain, rng=None, mask=m)
                    m = v.pre.propagate_mask(m, it)
                    it = v.input_types[0]
                p_v = params[name]
                if vtrain and v.config.weight_noise and rng is not None:
                    p_v = v.config.maybe_weight_noise(p_v, vtrain, rng)
                if new_carries is not None and name in new_carries:
                    x2 = v.config.maybe_dropout_input(x, vtrain, rng)
                    y, new_carries[name] = v.config.apply_seq(p_v, x2, new_carries[name], m)
                    ns = state[name]
                else:
                    kw = {}
                    if ex_weight is not None and getattr(
                            v.config, "CONSUMES_EXAMPLE_WEIGHT", False):
                        kw["ex_weight"] = ex_weight
                    y, ns = v.config.apply(p_v, state[name], x, train=vtrain, rng=rng,
                                           mask=m, **kw)
                mask_acts[name] = v.config.propagate_mask(m, it)
            else:
                # mask_input: the vertex reads the mask of a NAMED network
                # input, not its propagated one (LastTimeStepVertex)
                ms = getattr(v.config, "mask_input", None)
                if ms is not None:
                    in_masks = [mask_acts.get(ms)] + in_masks[1:]
                y, ns = v.config.apply(params[name], state[name], xs, train=vtrain, rng=rng,
                                       masks=in_masks)
                mask_acts[name] = v.config.propagate_mask(in_masks, v.input_types)
            acts[name] = y
            new_state[name] = ns
        return acts, new_state, mask_acts, new_carries

    # -- loss and the training step ----------------------------------------
    def _loss(self, params, state, inputs, labels, fmasks, lmasks, rng, train=True,
              ex_weight=None, carries=None, deterministic=False):
        """The sum over the output heads of each average score, plus every
        vertex's L1/L2 penalty; returns (loss, (new_state, new_carries))."""
        stop = set(self._loss_vertices)
        acts, new_state, mask_acts, new_carries = self._forward(
            params, state, inputs, train=train, rng=rng, masks=fmasks, stop_at=stop,
            ex_weight=ex_weight, carries=carries, deterministic=deterministic)
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for i, oname in enumerate(self.conf.outputs):
            if oname not in stop:
                continue
            v = self.rt[oname]
            y = labels[i] if isinstance(labels, (tuple, list)) else labels
            lm = None
            if lmasks is not None:
                lm = lmasks[i] if isinstance(lmasks, (tuple, list)) else lmasks
            if lm is None:
                lm = mask_acts.get(oname)
            total = total + v.config.score(params[oname], acts[oname], y, mask=lm,
                                           average=True)
        for name in self.topo_order:
            if tree_leaves(params[name]):
                total = total + self.rt[name].config.regularization_penalty(params[name])
        return total, (new_state, new_carries)

    def _value_and_grad(self, state, inputs, labels, fmasks, lmasks, ex_weight,
                        carries=None):
        """Loss, new vertex state, the gradient dict (the params' shape;
        zeros where a param does not reach the loss or its vertex is
        frozen) and the final carries, detached (None without
        ``carries``), on one batch."""
        live, leaves_by = [], {}
        params = {}
        for name in self.topo_order:
            p = self.params[name]
            leaves = tree_leaves(p)
            if leaves and self._trainable(name):
                lv = [t.detach().requires_grad_(True) for t in leaves]
                live += lv
                leaves_by[name] = lv
                params[name] = tree_unflatten_like(p, lv)
            else:
                params[name] = p
        loss, (new_state, new_carries) = self._loss(
            params, state, inputs, labels, fmasks, lmasks, self._gen, ex_weight=ex_weight,
            carries=carries)
        grads_flat = torch.autograd.grad(loss, live, allow_unused=True) if live else []
        it = iter(grads_flat)
        grads = {}
        for name in self.topo_order:
            p = self.params[name]
            if name in leaves_by:
                gs = [next(it) for _ in leaves_by[name]]
                grads[name] = tree_unflatten_like(p, [
                    torch.zeros_like(t) if g is None else g
                    for t, g in zip(leaves_by[name], gs)])
            else:
                grads[name] = tree_map(torch.zeros_like, p)
        # vertex state (BatchNorm's running statistics) carries no graph
        new_state = tree_map(lambda s: s.detach(), new_state)
        if new_carries is not None:
            new_carries = tree_map(lambda c: c.detach(), new_carries)
        return loss.detach(), new_state, grads, new_carries

    def _update_params(self, grads, ok=None):
        """The per-vertex update (gradient normalization, updater,
        constraints), in place under ``torch.no_grad()``; a vertex without
        params, or a frozen one, keeps its params and updater state. With
        ``ok`` (the skip_batch guard's device bool) the new values are
        computed out of place and ``torch.where(ok, new, old)`` is written
        back."""
        self.init_opt_state()
        new_opt = dict(self.opt_state)
        with torch.no_grad():
            for name in self.topo_order:
                g = grads[name]
                if not tree_leaves(g) or not self._trainable(name):
                    continue
                cfg = self.rt[name].config
                gn = getattr(cfg, "gradient_normalization", None)
                if gn:
                    g = apply_gradient_normalization(
                        gn, getattr(cfg, "gradient_normalization_threshold", 1.0), g)
                p = self.params[name]
                upd, new_opt[name] = self._updaters[name].update(
                    g, self.opt_state[name], p, self.iteration)
                if ok is None:
                    for pi, d in zip(tree_leaves(p), tree_leaves(upd)):
                        pi.sub_(d)
                    if getattr(cfg, "constraints", None):
                        self.params[name] = apply_constraints(cfg, p)
                    continue
                cand = tree_map(lambda a, d: a - d, p, upd)
                if getattr(cfg, "constraints", None):
                    cand = apply_constraints(cfg, cand)
                for pi, c in zip(tree_leaves(p), tree_leaves(cand)):
                    pi.copy_(torch.where(ok, c, pi))
                new_opt[name] = _select(ok, new_opt[name], self.opt_state[name])
        self.opt_state = new_opt

    def _apply_step(self, loss, new_state, grads):
        """Update params, updater state and vertex state from one batch's
        gradients, under the skip_batch select when that guard is on."""
        g = self.divergence_guard
        if g is not None and g.policy == "skip_batch":
            from deeplearning4j_tpu_torch.train.resilience import guard_ok

            ok = guard_ok(loss, g.spike_limit)
            self._update_params(grads, ok)
            self.state = _select(ok, new_state, self.state)
        else:
            self._update_params(grads)
            self.state = new_state

    def _step(self, inputs, labels, fmasks, lmasks, ex_weight):
        """One training step on tensors already on the device; returns the
        loss as a device scalar."""
        accum = grad_accum_from_env()
        names = self.conf.inputs
        ni, no = len(names), len(self.conf.outputs)
        # one flat tuple of batch-major tensors (None allowed): features,
        # labels, feature masks, label masks, example weight
        flat = (tuple(inputs[n] for n in names)
                + (tuple(labels) if labels is not None else (None,) * no)
                + tuple((fmasks or {}).get(n) for n in names)
                + (tuple(lmasks) if lmasks is not None else (None,) * no)
                + (ex_weight,))
        if accum_applicable(accum, flat):
            def vg(mb, st):
                l, lm = mb[ni:ni + no], mb[2 * ni + no:2 * ni + 2 * no]
                return self._value_and_grad(
                    st, dict(zip(names, mb[:ni])), None if labels is None else l,
                    None if fmasks is None else dict(zip(names, mb[ni + no:2 * ni + no])),
                    None if lmasks is None else lm, mb[-1])[:3]

            loss, new_state, grads = accum_value_and_grad(
                accum, self.params, self.state, flat, vg)
        else:
            loss, new_state, grads, _ = self._value_and_grad(
                self.state, inputs, labels, fmasks, lmasks, ex_weight)
        self._apply_step(loss, new_state, grads)
        self.iteration += 1
        return loss

    # -- data normalization ------------------------------------------------
    def _as_multi_batch(self, batch):
        """(x, y), (x, y, fmask, lmask) with array-or-tuple members, a dict
        with those keys, or an object with ``as_tuple()`` (DataSet /
        MultiDataSet) as host tuples (features, labels, fmasks, lmasks)."""
        if hasattr(batch, "as_tuple"):
            batch = batch.as_tuple()
        if isinstance(batch, dict):
            f, l = batch["features"], batch.get("labels")
            fm, lm = batch.get("features_mask"), batch.get("labels_mask")
        else:
            f = batch[0]
            l = batch[1] if len(batch) > 1 else None
            fm = batch[2] if len(batch) > 2 else None
            lm = batch[3] if len(batch) > 3 else None
        ni, no = len(self.conf.inputs), len(self.conf.outputs)
        return _as_tuple(f, ni), _as_tuple(l, no), _as_tuple(fm, ni), _as_tuple(lm, no)

    def _to_device(self, f, l, fm, lm):
        """A host (features, labels, fmasks, lmasks) batch as the step's
        device tensors: an input dict, a labels tuple, a mask dict and a
        labels-mask tuple."""
        dev, dt = self.device, self.dtype
        feats = tuple(_cast_input(x, dt, dev) for x in f)
        labels = None if l is None else tuple(_cast_labels(y, dt, dev) for y in l)
        fms = None if fm is None else dict(zip(self.conf.inputs,
                                               (_cast_mask(m, dt, dev) for m in fm)))
        lms = None if lm is None else tuple(_cast_mask(m, dt, dev) for m in lm)
        return dict(zip(self.conf.inputs, feats)), labels, fms, lms

    def _is_single_multibatch(self, data) -> bool:
        """True when ``data`` is ONE in-memory batch (features one array for a
        one-input graph, or a tuple of exactly len(inputs) arrays), not an
        iterable of batches."""
        ni = len(self.conf.inputs)

        def features_like(f):
            if _is_arr(f):
                return ni == 1
            return (isinstance(f, (tuple, list)) and len(f) == ni
                    and all(_is_arr(e) for e in f))

        return (isinstance(data, dict)
                or (isinstance(data, (tuple, list)) and 2 <= len(data) <= 4
                    and features_like(data[0])))

    def _fit_pad_target_multi(self, data, batch_size) -> Optional[int]:
        """The uniform per-batch row count of a fit over one in-memory batch
        whose length is not a multiple of ``batch_size``, else None."""
        if batch_size is None:
            return None
        if hasattr(data, "as_tuple"):
            data = data.as_tuple()
        if self._is_single_multibatch(data):
            f = self._as_multi_batch(data)[0]
            n = len(f[0])
            if n > batch_size and n % batch_size != 0:
                return batch_size
        return None

    def _iter_multi(self, data, batch_size):
        """Host batches (f, l, fm, lm) of tuples: one in-memory batch,
        minibatched when ``batch_size`` is given, or any iterable of
        batches."""
        if hasattr(data, "as_tuple"):
            data = data.as_tuple()
        if self._is_single_multibatch(data):
            f, l, fm, lm = self._as_multi_batch(data)
            n = len(f[0])
            if batch_size is None or batch_size >= n:
                yield (f, l, fm, lm)
                return
            sl_t = lambda t, s: (tuple(x[s] if x is not None else None for x in t)  # noqa: E731
                                 if t else None)
            for i in range(0, n, batch_size):
                s = slice(i, min(i + batch_size, n))
                yield (sl_t(f, s), sl_t(l, s), sl_t(fm, s), sl_t(lm, s))
            return
        for b in data:
            yield self._as_multi_batch(b)

    def _time_distributed_inputs(self):
        """Inputs declared recurrent: the time axes tBPTT chunks (2-D integer
        id streams included)."""
        return [n for n in self.conf.inputs if self.conf.input_types[n].kind == "recurrent"]

    def _initial_carries(self, batch: int) -> dict:
        if self._wrapped_rnn_vertices:
            raise NotImplementedError(
                "tBPTT / rnn_time_step cannot thread state through wrapper "
                f"RNN vertices {self._wrapped_rnn_vertices}: their inner RNN "
                "has no carry channel and would silently reset each chunk. "
                "Use the bare recurrent layer, or full-sequence calls.")
        return {name: self.rt[name].config.initial_carry(batch, self.dtype, self.device)
                for name in self._carry_vertices}

    # -- training ----------------------------------------------------------
    def set_listeners(self, *listeners):
        self.listeners = list(listeners)
        return self

    def set_divergence_guard(self, guard) -> "ComputationGraph":
        """Install a train/resilience.DivergenceGuard (None to remove)."""
        self.divergence_guard = guard
        return self

    def _chain_k(self) -> int:
        """Steps chained per group in fit()'s loop (0 = per step); the
        MultiLayerNetwork's gate (nn/step_program.py chain_k_from_env)."""
        return chain_k_from_env(self.uses_rng(), self.num_params())

    def fit(self, data, epochs: int = 1, batch_size: Optional[int] = None,
            resume_from=None):
        """Train on one in-memory batch or a DataSet / MultiDataSet
        (minibatched by ``batch_size``; a partial tail is padded to
        ``batch_size`` rows weighted out of the loss and of BatchNorm's
        statistics, DL4J_TPU_BUCKETING=0 turns that off), an iterable of
        batches, or a callable returning a fresh iterable per epoch. Under
        tBPTT each batch is cut into time chunks instead, one update per
        chunk.

        ``resume_from``: a CheckpointListener directory; restores the newest
        valid checkpoint and continues, ``epochs`` the TOTAL budget and the
        interrupted epoch's used batches skipped (MultiLayerNetwork.fit's
        contract)."""
        from deeplearning4j_tpu_torch.train import resilience

        if self.params is None:
            self.init()
        resume_skip = 0
        if resume_from is not None:
            if resilience.resume(self, resume_from) is not None:
                resume_skip = int(self.batch_in_epoch)
                epochs = max(epochs - self.epoch, 0)
        if os.environ.get("DL4J_TPU_TUNE"):
            # the tuning DB's winner, before chain_k / the warm / the step
            # read their knobs (MultiLayerNetwork.fit's hook)
            from deeplearning4j_tpu_torch import tune

            tune.maybe_apply(self, "fit")
        guard = self.divergence_guard
        if aot.enabled():
            # epoch 0's first step runs once on a snapshot (nn/aot.py), under
            # the per-epoch tbptt / chain gating below
            tbptt0 = (self.conf.backprop_type == "tbptt"
                      and bool(self._time_distributed_inputs()))
            chain0 = (self._chain_k()
                      if not (self.listeners or tbptt0) and guard is None else 0)
            if not tbptt0 and chain0 <= 1:
                aot.warm_fit(self, data, batch_size)
        try:
            for _ in range(epochs):
                skip_n, resume_skip = resume_skip, 0
                self.batch_in_epoch = skip_n
                for lis in self.listeners:
                    lis.on_epoch_start(self, self.epoch)
                source = data() if callable(data) else data
                tbptt = (self.conf.backprop_type == "tbptt"
                         and bool(self._time_distributed_inputs()))
                chain_k = (self._chain_k()
                           if not (self.listeners or tbptt) and guard is None else 0)
                # chained batches go to the device in one stacked copy
                prefetch = (chain_k <= 1 and self.device.type == "cuda"
                            and _device_prefetch_enabled())
                pad_target = (self._fit_pad_target_multi(source, batch_size)
                              if chain_k <= 1 and not tbptt
                              and bucketing.bucketing_enabled() else None)

                def batches():
                    it = self._iter_multi(source, batch_size)
                    # resume: the interrupted epoch's used batches are
                    # skipped here, without drawing from the generator
                    for _ in range(skip_n):
                        if next(it, None) is None:
                            return
                    for f, l, fm, lm in it:
                        n = len(f[0])   # the real rows, before padding
                        if pad_target is not None:
                            yield bucketing.pad_fit_multi(
                                f, l, fm, lm, pad_target, site="cg.fit") + (n,)
                        else:
                            yield (f, l, fm, lm, None, n)

                stream = batches()
                if chain_k > 1:
                    stream = chain_batches(
                        stream, chain_k, self.device,
                        lambda b: (b[2] is None and b[3] is None and b[4] is None
                                   and b[1] is not None
                                   and all(y is not None for y in b[1])))
                elif prefetch:   # the next batch copied on a side stream
                    from deeplearning4j_tpu_torch.datasets.iterator import prefetch_to_device

                    stream = prefetch_to_device(stream, device=self.device)
                for f, l, fm, lm, ew, n_real in stream:
                    batch = (f, l, fm, lm)
                    with obs.span("cg.fit_batch"):
                        if tbptt:
                            score = self._fit_tbptt(*batch)
                        else:
                            score = self.fit_batch(batch, ew=ew)
                    self.batch_in_epoch += 1
                    if guard is not None:
                        guard.observe(self, score)
                    # the loss stays on the device unless a listener reads it
                    if self.listeners:
                        score = float(score)
                        resilience.note_score(score)
                        for lis in self.listeners:
                            lis.iteration_done(self, self.iteration, score, n_real)
                if guard is not None:
                    guard.flush(self)
                for lis in self.listeners:
                    lis.on_epoch_end(self, self.epoch)
                self.epoch += 1
        finally:
            close_listeners(self.listeners)
        return self

    def fit_batch(self, batch, ew=None):
        """One step on one batch (any form ``fit`` takes for a single batch);
        returns the loss as a device scalar. ``ew``: optional per-example
        validity weight."""
        from deeplearning4j_tpu_torch.train import resilience

        f, l, fm, lm = self._as_multi_batch(batch)
        chaos = resilience.active_chaos()
        if chaos is not None:
            chaos.maybe_preempt(self.iteration)
            chaos.maybe_slow(self.iteration)
            f = chaos.maybe_nan_batch(self.iteration, f)
        inputs, labels, fms, lms = self._to_device(f, l, fm, lm)
        return self._get_step_fn()(inputs, labels, fms, lms,
                                   _cast_mask(ew, self.dtype, self.device))

    def _fit_tbptt(self, f, l, fm, lm):
        """Truncated BPTT over the DAG (doTruncatedBPTT): the time axis of
        every recurrent input (and of time-distributed labels and masks) cut
        into ``tbptt_fwd_length`` chunks, one update per chunk, the carries
        of the recurrent vertices passed on detached. Static inputs are fed
        whole to every chunk (the DuplicateToTimeSeriesVertex case).
        Returns the mean chunk loss as a device scalar. The chaos hooks run
        once per batch (``nan_grad`` poisons the whole batch)."""
        from deeplearning4j_tpu_torch.train import resilience

        chaos = resilience.active_chaos()
        if chaos is not None:
            chaos.maybe_preempt(self.iteration)
            chaos.maybe_slow(self.iteration)
            f = chaos.maybe_nan_batch(self.iteration, f)
        inputs, labels, fms, lms = self._to_device(f, l, fm, lm)
        td = set(self._time_distributed_inputs())
        T = max(x.shape[1] for n, x in inputs.items() if n in td)
        L = self.conf.tbptt_fwd_length
        B = next(iter(inputs.values())).shape[0]
        carries = self._initial_carries(B)
        step = self._get_tbptt_fn()
        total, nchunks = 0.0, 0
        for t0 in range(0, T, L):
            sl = slice(t0, min(t0 + L, T))
            ic = {n: _tbptt_slice_t(x, sl, T, "feat_td" if n in td else "feat")
                  for n, x in inputs.items()}
            lc = None if labels is None else tuple(
                _tbptt_slice_t(y, sl, T, "label") for y in labels)
            fmc = None if fms is None else {n: _tbptt_slice_t(m, sl, T, "mask")
                                            for n, m in fms.items()}
            lmc = None if lms is None else tuple(_tbptt_slice_t(m, sl, T, "mask")
                                                 for m in lms)
            loss, carries = step(ic, lc, fmc, lmc, carries)
            total = total + loss
            nchunks += 1
        return total / max(nchunks, 1)

    def _tbptt_chunk(self, inputs, labels, fmasks, lmasks, carries):
        """One tBPTT update on one time chunk; returns (loss, the final
        carries, detached)."""
        loss, new_state, grads, carries = self._value_and_grad(
            self.state, inputs, labels, fmasks, lmasks, None, carries=carries)
        self._apply_step(loss, new_state, grads)
        self.iteration += 1
        return loss, carries

    # -- dispatch sites (nn/aot.py) ------------------------------------------
    def _get_output_fn(self):
        """The ``cg.output`` site: one forward at a bucketed batch."""
        return aot.site(self, "cg.output", self._infer_site, stateful=False)

    def _get_step_fn(self, tbptt: bool = False):
        """The ``cg.step`` site: one training step on device tensors."""
        if tbptt:
            return self._get_tbptt_fn()
        return aot.site(self, "cg.step", self._step, stateful=True)

    def _get_tbptt_fn(self):
        """The ``cg.step.tbptt`` site: one tBPTT chunk update."""
        return aot.site(self, "cg.step.tbptt", self._tbptt_chunk, stateful=True)

    def _infer_site(self, feats, fm):
        with torch.inference_mode():
            return self._infer(feats, fm)

    # -- inference ---------------------------------------------------------
    def output(self, *xs, fmasks=None):
        """The outputs of every output vertex (ComputationGraph.output),
        tensors on the model's device; one tensor for a one-output graph.
        Batch rows are padded up to the shared bucket ladder and sliced
        back (not for graphs with Stack/Unstack vertices, whose batch
        arithmetic padding would corrupt; DL4J_TPU_BUCKETING=0 turns it
        off). Runs under ``torch.inference_mode()``."""
        if self.params is None:
            raise RuntimeError("call init() (or load params) before output()")
        if len(xs) == 1 and isinstance(xs[0], (tuple, list)):
            xs = tuple(xs[0])
        with torch.inference_mode():
            feats = tuple(_cast_input(x, self.dtype, self.device) for x in xs)
            fm = _as_tuple(fmasks, len(self.conf.inputs))
            if fm is not None:
                fm = tuple(_cast_mask(m, self.dtype, self.device) for m in fm)
            n = feats[0].shape[0] if feats else 0
            with obs.span("cg.output"):
                if bucketing.bucketing_enabled() and n > 0 and not self._has_batch_vertices:
                    target = bucketing.bucket_size(n)
                    bucketing.telemetry().record_hit("cg.output", n, target)
                    if target > n:
                        feats = tuple(bucketing.pad_rows_zero(x, target) for x in feats)
                        if fm is not None:
                            fm = tuple(bucketing.pad_rows_zero(m, target) for m in fm)
                        outs = tuple(bucketing.unpad(o, n)
                                     for o in self._get_output_fn()(feats, fm))
                        return outs[0] if len(outs) == 1 else outs
                outs = self._get_output_fn()(feats, fm)
        return outs[0] if len(outs) == 1 else outs

    def _infer(self, feats, fm):
        masks = None if fm is None else dict(zip(self.conf.inputs, fm))
        acts = self._forward(self.params, self.state, dict(zip(self.conf.inputs, feats)),
                             train=False, masks=masks)[0]
        return tuple(acts[o] for o in self.conf.outputs)

    def rnn_time_step(self, *xs):
        """Feed one or more steps per recurrent input, carrying the recurrent
        vertices' state between calls (rnnTimeStep). A [B, F] float input
        (or a [B] id stream) of a recurrent input is one step and the
        outputs then lose their time axis; static inputs pass whole. A call
        with another batch size starts from zero carries. Runs under
        ``torch.inference_mode()``."""
        if len(xs) == 1 and isinstance(xs[0], (tuple, list)):
            xs = tuple(xs[0])
        with torch.inference_mode():
            feats, squeeze = [], False
            for name, x in zip(self.conf.inputs, xs):
                x = _cast_input(x, self.dtype, self.device)
                if self.conf.input_types[name].kind == "recurrent":
                    if not x.is_floating_point():
                        if x.dim() == 1:    # an id stream: [B] is one step
                            x = x[:, None]
                            squeeze = True
                    elif x.dim() == 2:
                        x = x[:, None, :]
                        squeeze = True
                feats.append(x)
            B = feats[0].shape[0]
            leaves = tree_leaves(self._rnn_carries)
            if self._rnn_carries is None or (leaves and leaves[0].shape[0] != B):
                self._rnn_carries = self._initial_carries(B)
            acts, _, _, self._rnn_carries = self._forward(
                self.params, self.state, dict(zip(self.conf.inputs, feats)), train=False,
                carries=self._rnn_carries)
            outs = tuple(a[:, 0, :] if squeeze and a.dim() == 3 and a.shape[1] == 1 else a
                         for a in (acts[o] for o in self.conf.outputs))
        return outs[0] if len(outs) == 1 else outs

    def rnn_clear_previous_state(self):
        """Forget the carries that ``rnn_time_step`` kept."""
        self._rnn_carries = None

    def score(self, batch, train: bool = False) -> float:
        """Average loss on a batch, penalties included. ``train=True``
        scores with training-mode statistics (BatchNorm's batch mean and
        variance) while dropout and weight noise stay off."""
        f, l, fm, lm = self._as_multi_batch(batch)
        inputs, labels, fms, lms = self._to_device(f, l, fm, lm)
        with torch.no_grad():
            loss, _ = self._loss(self.params, self.state, inputs, labels, fms, lms,
                                 rng=None, train=train, deterministic=True)
        return float(loss)

    def evaluate(self, data, batch_size: Optional[int] = None, top_n: int = 1):
        """Classification metrics (eval/Evaluation) of the first output."""
        from deeplearning4j_tpu_torch.eval import Evaluation

        ev = Evaluation(top_n=top_n)
        for f, l, fm, lm in self._iter_multi(data, batch_size):
            preds = self.output(*f, fmasks=fm)
            if isinstance(preds, tuple):
                preds = preds[0]
            y = l[0]
            y = y.cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
            m = lm[0] if lm else None
            if isinstance(m, torch.Tensor):
                m = m.cpu().numpy()
            ev.eval(y, preds.float().cpu().numpy(),
                    mask=np.asarray(m) if m is not None else None)
        return ev

    # -- serving -----------------------------------------------------------
    def _input_consumers(self, name: str):
        return [self.rt[v].config for v in self.topo_order if name in self.rt[v].inputs]

    @property
    def takes_ids(self) -> bool:
        """Does the (first) input feed an embedding, taking integer ids?"""
        return any(isinstance(c, (Embedding, EmbeddingSequence))
                   for c in self._input_consumers(self.conf.inputs[0]))

    def dummy_input(self, batch: int) -> torch.Tensor:
        """A zero batch of ``batch`` rows for a one-input graph (what
        ModelRegistry warms with): ids when the input feeds an embedding,
        else zeros of the input type's shape in the model dtype."""
        if len(self.conf.inputs) != 1:
            raise ValueError("dummy_input serves one-input graphs; this one has "
                             f"{len(self.conf.inputs)} inputs")
        it = self.conf.input_types[self.conf.inputs[0]]
        cons = self._input_consumers(self.conf.inputs[0])
        if any(isinstance(c, EmbeddingSequence) for c in cons):
            return torch.zeros((batch, it.timesteps or 16), dtype=torch.int64,
                               device=self.device)
        if any(isinstance(c, Embedding) for c in cons):
            return torch.zeros((batch, 1), dtype=torch.int64, device=self.device)
        return torch.zeros(it.batch_shape(batch), dtype=self.dtype, device=self.device)

    # -- copies and description ------------------------------------------------
    def clone(self) -> "ComputationGraph":
        """A deep copy on the same device: params, vertex state, optimizer
        state and the step counters."""
        m = ComputationGraph(self.conf, device=self.device)
        if self.params is not None:
            m.init()
            with torch.no_grad():
                copy = lambda t: tree_map(lambda x: x.detach().clone(), t)  # noqa: E731
                m.params = copy(self.params)
                m.state = copy(self.state)
                m.opt_state = copy(self.opt_state)
            m.iteration = self.iteration
            m.epoch = self.epoch
        return m

    def summary(self) -> str:
        """One line per vertex (name, type, inputs, output shape, params)
        and the total, as the JAX package's ``summary`` prints them."""
        lines = [f"{'name':<24} {'type':<24} {'inputs':<30} {'output':<22} {'params':<10}"]
        for name in self.topo_order:
            v = self.rt[name]
            tname = getattr(v.config, "_type_name", getattr(v.config, "_vtype_name", "?"))
            n = (sum(int(p.numel()) for p in tree_leaves(self.params[name]))
                 if self.params is not None else "?")
            lines.append(f"{name:<24} {tname:<24} {','.join(v.inputs)[:30]:<30} "
                         f"{str(v.out_type.batch_shape())[:22]:<22} {n:<10}")
        lines.append(f"Total params: {self.num_params() if self.params is not None else '?'}")
        return "\n".join(lines)
