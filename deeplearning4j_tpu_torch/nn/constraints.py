"""Parameter constraints, applied after each update (PyTorch port of
``nn/constraints.py``).

DL4J's MaxNormConstraint, MinMaxNormConstraint, UnitNormConstraint and
NonNegativeConstraint: per-output-unit norms over the non-output axes,
weight-class params only unless a spec sets ``apply_to_biases``. Specs are
the same JSON-friendly dicts on ``LayerConfig.constraints``:
    {"type": "max_norm", "max_norm": 2.0}
    {"type": "min_max_norm", "min_norm": 0.5, "max_norm": 2.0, "rate": 1.0}
    {"type": "unit_norm"}
    {"type": "non_negative"}
"""

from __future__ import annotations

from typing import Any, Dict

import torch

_EPS = 1e-9


def _unit_axes(w: torch.Tensor) -> tuple:
    """Norm-reduction axes: everything except the last (output-unit) axis."""
    return tuple(range(w.dim() - 1)) if w.dim() > 1 else (0,)


def _norms(w: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(w * w, dim=_unit_axes(w), keepdim=True) + _EPS)


def max_norm(w: torch.Tensor, max_norm_v: float) -> torch.Tensor:
    n = _norms(w)
    return w * torch.clamp_max(n, max_norm_v) / n


def min_max_norm(w: torch.Tensor, min_v: float, max_v: float, rate: float = 1.0) -> torch.Tensor:
    n = _norms(w)
    target = rate * torch.clamp(n, min_v, max_v) + (1.0 - rate) * n
    return w * target / n


def unit_norm(w: torch.Tensor) -> torch.Tensor:
    return w / _norms(w)


def non_negative(w: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(w, 0.0)


def _apply_one(spec: Dict[str, Any], w: torch.Tensor) -> torch.Tensor:
    t = spec.get("type")
    if t == "max_norm":
        return max_norm(w, float(spec.get("max_norm", 2.0)))
    if t == "min_max_norm":
        return min_max_norm(w, float(spec.get("min_norm", 0.0)),
                            float(spec.get("max_norm", 2.0)),
                            float(spec.get("rate", 1.0)))
    if t == "unit_norm":
        return unit_norm(w)
    if t == "non_negative":
        return non_negative(w)
    raise ValueError(f"unknown constraint type {t!r}")


def apply_constraints(layer, params):
    """Project a layer's params per its ``constraints`` specs: a new param
    dict (nested dicts recursed); weight-class params only unless a spec
    sets ``apply_to_biases``."""
    specs = tuple(getattr(layer, "constraints", ()) or ())
    if not specs or not params:
        return params
    bias_names = layer.BIAS_PARAM_NAMES

    def visit(p):
        out = {}
        for name, v in p.items():
            if isinstance(v, dict):
                out[name] = visit(v)
                continue
            for spec in specs:
                if name in bias_names and not spec.get("apply_to_biases", False):
                    continue
                v = _apply_one(spec, v)
            out[name] = v
        return out

    return visit(params)
