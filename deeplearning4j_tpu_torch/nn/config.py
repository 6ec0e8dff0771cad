"""Layer-config base classes, registry, and JSON serde (PyTorch port).

Counterpart of ``deeplearning4j_tpu/nn/config.py``: dataclass layer
configs that round-trip to the same JSON, with the same polymorphic
``@type`` tags and the same fields and defaults, so a config written by
either package loads in the other. A model is a list of these configs;
``init`` builds a dict of tensors and ``apply`` is a plain function of
(params, state, x).

Layer contract
--------------
- ``output_type(input_type) -> InputType``      config-time shape inference
- ``init(gen, input_type, dtype, device) -> params``  dict of tensors
- ``init_state(input_type) -> state``           non-trainable state; {} if none
- ``apply(params, state, x, *, train, rng, mask) -> (y, new_state)``
  (``rng`` is a ``torch.Generator`` or None)
- ``propagate_mask(mask, input_type) -> mask``  mask flow (default identity)

Only the layer types of the ported slices are registered; loading a config
with another ``@type`` raises, naming the type.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn import activations
from deeplearning4j_tpu_torch.nn.initializers import Distribution
from deeplearning4j_tpu_torch.nn.input_type import InputType

layer_registry: Dict[str, type] = {}


def register_layer(type_name: str):
    """Class decorator registering a layer config under a stable JSON tag."""

    def deco(cls):
        cls._type_name = type_name
        layer_registry[type_name] = cls
        return cls

    return deco


def _encode_value(v):
    if isinstance(v, Distribution):
        return {"@distribution": v.to_dict()}
    if isinstance(v, InputType):
        return {"@input_type": v.to_dict()}
    if isinstance(v, LayerConfig):
        return v.to_dict()
    if isinstance(v, (tuple, list)):
        return [_encode_value(x) for x in v]
    if isinstance(v, dict):
        return {k: _encode_value(x) for k, x in v.items()}
    if callable(v):
        # Custom activation/init functions can't round-trip; store a marker.
        return {"@callable": getattr(v, "__name__", "lambda")}
    return v


def _decode_value(v):
    if isinstance(v, dict):
        if "@distribution" in v:
            return Distribution.from_dict(v["@distribution"])
        if "@input_type" in v:
            return InputType.from_dict(v["@input_type"])
        if "@type" in v:
            return layer_from_dict(v)
        if "@callable" in v:
            raise ValueError(
                f"Config contained a non-serializable callable '{v['@callable']}'; "
                "it cannot be restored from JSON."
            )
        return {k: _decode_value(x) for k, x in v.items()}
    if isinstance(v, list):
        # JSON arrays come back as lists; configs store shape-like fields as
        # tuples — normalize so a config round-trips to an EQUAL dataclass.
        return tuple(_decode_value(x) for x in v)
    return v


def yaml_dump(d: dict) -> str:
    """The one yaml encoding used by every config class."""
    import yaml

    return yaml.safe_dump(d, sort_keys=False)


def yaml_load(s: str) -> dict:
    import yaml

    return yaml.safe_load(s)


def layer_from_dict(d: dict) -> "LayerConfig":
    tag = d.get("@type")
    if tag not in layer_registry:
        raise ValueError(
            f"Layer type '{tag}' is not ported to deeplearning4j_tpu_torch "
            f"yet. Ported: {sorted(layer_registry)}")
    cls = layer_registry[tag]
    kwargs = {k: _decode_value(v) for k, v in d.items() if k != "@type"}
    # Dataclass fields may evolve across versions: ignore unknown keys so old
    # JSON keeps loading.
    names = {f.name for f in dataclasses.fields(cls)}
    for k in set(kwargs) - names:
        kwargs.pop(k)
    return cls(**kwargs)


@dataclass
class LayerConfig:
    """Base for all layer configs: the knobs on DL4J's BaseLayer conf
    (activation, weight init, l1/l2, per-layer updater override, dropout,
    name, constraints, gradient normalization, weight noise)."""

    name: Optional[str] = None
    dropout: float = 0.0            # input dropout, DL4J semantics (keep-prob = 1-dropout)
    l1: float = 0.0
    l2: float = 0.0
    updater: Optional[dict] = None  # per-layer updater override (train/updaters.py)
    trainable: bool = True          # False == FrozenLayer wrapper in the reference
    # parameter constraints applied after each update (nn/constraints.py)
    constraints: Any = ()
    # per-layer gradient normalization (train/updaters.py
    # apply_gradient_normalization names the modes)
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: float = 1.0
    # train-time weight noise:
    #   {"type": "dropconnect", "p": 0.95}  p = weight RETAIN probability,
    #       inverted scaling
    #   {"type": "gaussian", "stddev": 0.01, "additive": true}
    weight_noise: Optional[dict] = None

    # Param names treated as bias-class: excluded from l1/l2, weight noise
    # and constraints unless a spec asks otherwise.
    BIAS_PARAM_NAMES = frozenset({"b", "vb", "bias", "beta", "gamma"})

    def uses_rng(self) -> bool:
        """Does a TRAIN-mode apply() draw randomness? Layers with extra
        noise sources (attention dropout) extend this; ``score(train=True)``
        runs such layers in eval mode so its result is deterministic."""
        inner = getattr(self, "rnn", None)
        return (bool(self.dropout) or self.weight_noise is not None
                or (inner is not None and inner.uses_rng()))

    # -- registry / serde --------------------------------------------------
    _type_name = "base"

    def to_dict(self) -> dict:
        d = {"@type": self._type_name}
        for f in dataclasses.fields(self):
            d[f.name] = _encode_value(getattr(self, f.name))
        return d

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    def to_yaml(self) -> str:
        return yaml_dump(self.to_dict())

    @staticmethod
    def from_dict(d: dict) -> "LayerConfig":
        return layer_from_dict(d)

    @staticmethod
    def from_json(s: str) -> "LayerConfig":
        return layer_from_dict(json.loads(s))

    @staticmethod
    def from_yaml(s: str) -> "LayerConfig":
        return layer_from_dict(yaml_load(s))

    # -- shape/param contract ---------------------------------------------
    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def init(self, gen: torch.Generator, input_type: InputType,
             dtype=torch.float32, device=None) -> Dict[str, torch.Tensor]:
        return {}

    def init_state(self, input_type: InputType) -> Dict[str, torch.Tensor]:
        return {}

    def apply(
        self,
        params: Dict[str, torch.Tensor],
        state: Dict[str, torch.Tensor],
        x: torch.Tensor,
        *,
        train: bool = False,
        rng: Optional[torch.Generator] = None,
        mask: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        raise NotImplementedError

    def propagate_mask(self, mask, input_type: InputType):
        return mask

    # -- helpers -----------------------------------------------------------
    def activation_fn(self):
        return activations.get(getattr(self, "activation", "identity"))

    def maybe_dropout_input(self, x, train: bool, rng):
        """Input dropout as configured on the layer (inverted dropout)."""
        return dropout(x, self.dropout, train, rng,
                       f"Layer {self.name or self._type_name}")

    def maybe_weight_noise(self, params, train: bool, rng):
        """Perturb weight-class params at train time per ``weight_noise``
        (DropConnect / WeightNoise): a new param tree, gradients flow
        through the noise; identity at inference. Leaves draw from ``rng``
        in sorted-key order."""
        wn = self.weight_noise
        if not wn or not train or not params:
            return params
        if rng is None:
            raise ValueError(f"Layer {self.name or self._type_name}: "
                             "weight noise requires an rng generator")
        kind = wn.get("type", "dropconnect")
        if kind not in ("dropconnect", "gaussian"):
            raise ValueError(f"unknown weight_noise type {kind!r}")

        def visit(p):
            out = {}
            for name in sorted(p):
                v = p[name]
                if isinstance(v, dict):
                    out[name] = visit(v)
                elif name in self.BIAS_PARAM_NAMES and not wn.get("apply_to_bias", False):
                    out[name] = v
                elif kind == "dropconnect":
                    keep = float(wn.get("p", 0.5))
                    m = torch.rand(v.shape, generator=rng, device=v.device) < keep
                    out[name] = torch.where(m, v / keep, torch.zeros_like(v))
                else:
                    noise = float(wn.get("stddev", 0.01)) * torch.randn(
                        v.shape, generator=rng, device=v.device, dtype=v.dtype)
                    out[name] = v + noise if wn.get("additive", True) else v * (1.0 + noise)
            return {k: out[k] for k in p}

        return visit(params)

    def nested_param_layers(self) -> dict:
        """Sub-layer configs owning nested param-dict subtrees, keyed by the
        subtree name (TransformerBlock's ``attn`` params belong to its
        MultiHeadAttention). The tensor-parallel rules resolve nested
        params through this hook (``parallel/tp.py``)."""
        return {}

    def regularization_penalty(self, params: Dict[str, torch.Tensor]) -> torch.Tensor:
        """L1/L2 penalty (f32 scalar) over this layer's weight-class params,
        recursing into nested param dicts."""
        leaves = []

        def visit(p):
            for pname, v in p.items():
                if isinstance(v, dict):
                    visit(v)
                elif pname not in self.BIAS_PARAM_NAMES:
                    leaves.append(v)

        visit(params)
        dev = leaves[0].device if leaves else None
        pen = torch.zeros((), dtype=torch.float32, device=dev)
        if self.l1 == 0.0 and self.l2 == 0.0:
            return pen
        for v in leaves:
            if self.l1:
                pen = pen + self.l1 * torch.sum(torch.abs(v))
            if self.l2:
                pen = pen + 0.5 * self.l2 * torch.sum(v * v)
        return pen


_ROW_CUT: contextvars.ContextVar = contextvars.ContextVar("row_cut", default=None)


@contextlib.contextmanager
def row_cut(rows: int, lo: int, hi: int):
    """Inside this block the layers compute rows ``[lo, hi)`` of a
    ``rows``-row batch (one rank of an elastic slice, ``train/elastic.py``):
    :func:`batch_draw` draws at the whole batch's shape and keeps those
    rows, so the randomness matches the whole batch's, whatever the cut.
    The whole batch (``lo == 0``, ``hi == rows``) is no cut."""
    whole = int(lo) == 0 and int(hi) == int(rows)
    token = _ROW_CUT.set(None if whole else (int(rows), int(lo), int(hi)))
    try:
        yield
    finally:
        _ROW_CUT.reset(token)


def batch_draw(fn, shape, **kw) -> torch.Tensor:
    """``fn(shape, **kw)`` (``torch.rand`` or ``torch.randn`` with a
    ``generator``) for a draw whose leading axis is the batch's rows.

    Under :func:`row_cut` the leading axis must be ``k`` times the cut's
    rows (``k`` = 1, or the time steps of a ``[b, t, f] -> [b*t, f]``
    flatten, which is row-major): the draw is made at ``k`` times the whole
    batch's rows and rows ``[lo*k, hi*k)`` are kept. Any other shape
    raises, since its cut is not known."""
    cut = _ROW_CUT.get()
    shape = tuple(int(n) for n in shape)
    if cut is None:
        return fn(shape, **kw)
    rows, lo, hi = cut
    if not shape or shape[0] % (hi - lo):
        raise ValueError(
            f"a draw of shape {shape} under a row cut [{lo}, {hi}) of {rows} rows: its "
            f"leading axis is not a multiple of the cut's {hi - lo} rows")
    k = shape[0] // (hi - lo)
    return fn((rows * k,) + shape[1:], **kw)[lo * k:hi * k]


def dropout(x: torch.Tensor, rate: float, train: bool,
            rng: Optional[torch.Generator], who: str = "dropout") -> torch.Tensor:
    """Inverted dropout with drop probability ``rate``; identity unless
    training with ``rate > 0``. Draws from ``rng`` (a torch.Generator on
    x's device)."""
    if not train or rate <= 0.0:
        return x
    if rng is None:
        raise ValueError(f"{who}: dropout requires an rng generator")
    keep = 1.0 - rate
    m = batch_draw(torch.rand, x.shape, generator=rng, device=x.device) < keep
    return torch.where(m, x / keep, torch.zeros_like(x))


@dataclass
class FeedForwardLayerConfig(LayerConfig):
    """Base for layers with n_in/n_out + activation + weight init."""

    n_in: Optional[int] = None     # inferred from the previous layer when None
    n_out: int = 0
    activation: Any = "identity"
    weight_init: Any = "xavier"
    bias_init: float = 0.0

    def with_n_in(self, n_in: int):
        if self.n_in is None:
            return dataclasses.replace(self, n_in=int(n_in))
        return self

    def infer_n_in(self, input_type: InputType) -> int:
        return input_type.flat_size()
