"""Updaters (optimizers), learning-rate schedules, gradient normalization.

PyTorch port of ``deeplearning4j_tpu/train/updaters.py``: ND4J's
``GradientUpdater`` family (SGD, Adam, AdaMax, Nadam, AMSGrad, Nesterovs,
AdaGrad, AdaDelta, RMSProp, NoOp), the LR decay policies and DL4J's
per-layer ``GradientNormalization`` modes, with the same spec dicts,
defaults and formulas.

An updater is a pair of plain functions over a param tree (nested dicts of
tensors): ``init(params) -> state`` and ``update(grads, state, params,
step, inplace=False) -> (updates, new_state)``, applied by the model as
``params - updates`` (in place). With ``inplace`` the new state is written
into ``state``'s own tensors (``out=``; same bits), as the model's step
keeps every leaf it took (``analysis/donation_guard.py``). The model builds one per layer (DL4J's
per-layer updater override). Every updater is wrapped for mixed precision:
bf16/fp16 params keep f32 moments, the update is computed in f32 and only
the returned delta is cast to the param dtype. Schedules are evaluated in
f32, as the JAX package evaluates them.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.utils.tree import tree_leaves, tree_map

__all__ = [
    "Updater",
    "apply_gradient_normalization",
    "make_updater",
    "normalize_updater",
    "scale_lr",
    "schedule_value",
]

# ---------------------------------------------------------------------------
# Spec normalization
# ---------------------------------------------------------------------------

_DEFAULTS: Dict[str, Dict[str, float]] = {
    "sgd": {"lr": 0.1},
    "adam": {"lr": 1e-3, "beta1": 0.9, "beta2": 0.999, "eps": 1e-8},
    "adamax": {"lr": 2e-3, "beta1": 0.9, "beta2": 0.999, "eps": 1e-8},
    "nadam": {"lr": 1e-3, "beta1": 0.9, "beta2": 0.999, "eps": 1e-8},
    "amsgrad": {"lr": 1e-3, "beta1": 0.9, "beta2": 0.999, "eps": 1e-8},
    "nesterovs": {"lr": 0.1, "momentum": 0.9},
    "adagrad": {"lr": 0.1, "eps": 1e-6},
    "adadelta": {"rho": 0.95, "eps": 1e-6},
    "rmsprop": {"lr": 1e-3, "decay": 0.95, "eps": 1e-8},
    "noop": {},
}

_ALIASES = {"momentum": "nesterovs", "nesterov": "nesterovs", "none": "noop"}


def normalize_updater(spec: Any) -> dict:
    """Accept ``"adam"``, ``{"type": "adam", "lr": 1e-3, ...}``, or an
    already normalized dict; return a full dict with defaults filled in."""
    if spec is None:
        spec = "sgd"
    if isinstance(spec, str):
        spec = {"type": spec}
    t = str(spec.get("type", "sgd")).lower()
    t = _ALIASES.get(t, t)
    if t not in _DEFAULTS:
        raise ValueError(f"Unknown updater '{t}'. Known: {sorted(_DEFAULTS)}")
    out = {"type": t}
    out.update(_DEFAULTS[t])
    for k, v in spec.items():
        if k != "type":
            out[k] = v
    return out


def scale_lr(spec: Any, scale: float) -> dict:
    """Normalized updater spec with its base LR multiplied by ``scale``; a
    no-op at 1.0 and for LR-free updaters (adadelta, noop)."""
    cfg = normalize_updater(spec)
    if scale != 1.0 and "lr" in cfg:
        cfg = dict(cfg, lr=cfg["lr"] * float(scale))
    return cfg


# ---------------------------------------------------------------------------
# Learning-rate schedules
# ---------------------------------------------------------------------------


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def schedule_value(spec: Any, base_lr, step) -> torch.Tensor:
    """An LR schedule at ``step``, as a 0-dim f32 CPU tensor (it combines
    with tensors on any device as a scalar).

    ``spec`` may be None (constant), or a dict:
      {"policy": "exponential", "decay_rate": g}          lr * g^step
      {"policy": "inverse", "gamma": g, "power": p}       lr / (1+g*step)^p
      {"policy": "poly", "power": p, "max_iter": n}       lr * (1-step/n)^p
      {"policy": "sigmoid", "gamma": g, "step_size": s}   lr / (1+exp(-g*(step-s)))
      {"policy": "step", "decay_rate": g, "step_size": s} lr * g^floor(step/s)
      {"policy": "map", "schedule": {"0": lr0, "1000": lr1}}  piecewise-constant
      {"policy": "warmup_cosine", "warmup": w, "max_iter": n, "min_lr": m}
    """
    step = _f32(step)
    base = _f32(base_lr)
    if spec is None:
        return base
    policy = str(spec.get("policy", "constant")).lower()
    if policy == "constant":
        return base
    if policy == "exponential":
        return base * _f32(spec.get("decay_rate", 0.99)) ** step
    if policy == "inverse":
        g, p = spec.get("gamma", 1e-3), spec.get("power", 1.0)
        return base / (1.0 + g * step) ** p
    if policy == "poly":
        p, n = spec.get("power", 1.0), float(spec.get("max_iter", 10000))
        return base * torch.clamp(1.0 - step / n, 0.0, 1.0) ** p
    if policy == "sigmoid":
        g, s = spec.get("gamma", 0.01), float(spec.get("step_size", 0))
        return base / (1.0 + torch.exp(-g * (step - s)))
    if policy == "step":
        g, s = spec.get("decay_rate", 0.1), float(spec.get("step_size", 1000))
        return base * _f32(g) ** torch.floor(step / s)
    if policy == "map":
        sched = {int(k): float(v) for k, v in spec["schedule"].items()}
        lr = base
        for boundary in sorted(sched):
            lr = torch.where(step >= boundary, _f32(sched[boundary]), lr)
        return lr
    if policy == "warmup_cosine":
        w = float(spec.get("warmup", 0))
        n = float(spec.get("max_iter", 10000))
        m = float(spec.get("min_lr", 0.0))
        warm = base * step / max(w, 1.0)
        t = torch.clamp((step - w) / max(n - w, 1.0), 0.0, 1.0)
        cos = m + 0.5 * (base - m) * (1.0 + torch.cos(math.pi * t))
        return torch.where(step < w, warm, cos)
    raise ValueError(f"Unknown LR policy '{policy}'")


# ---------------------------------------------------------------------------
# Updater transforms
# ---------------------------------------------------------------------------


class Updater(NamedTuple):
    """A plain optimizer transform over a param tree."""

    init: Callable[[Any], Any]
    update: Callable[..., Tuple[Any, Any]]  # (grads, state, params, step, inplace) -> (updates, new_state)
    spec: dict


def _zeros_like_tree(params):
    return tree_map(torch.zeros_like, params)


def _into(old, inplace: bool):
    """The ``out=`` of a state leaf's new value: the old tensor itself when
    the update is in place, else a new tensor."""
    return old if inplace else None


_LOW_PRECISION = (torch.bfloat16, torch.float16)


def _mixed_precision(raw: Updater) -> Updater:
    """Accumulators live in f32, the update is computed in f32 and only the
    returned delta is cast to the param dtype, so bf16 training keeps f32
    optimizer statistics and params stay bf16 across steps."""

    def up32(x):
        return x.float() if x.dtype in _LOW_PRECISION else x

    def init(params):
        return raw.init(tree_map(up32, params))

    def update(g, s, params, step, inplace=False):
        upd, ns = raw.update(tree_map(up32, g), s, tree_map(up32, params), step, inplace)
        return tree_map(lambda u, p: u.to(p.dtype), upd, params), ns

    return Updater(init, update, raw.spec)


def make_updater(spec: Any) -> Updater:
    """Build an :class:`Updater` from a spec. Its ``update`` returns the
    quantity SUBTRACTED from the params (DL4J convention)."""
    return _mixed_precision(_make_raw_updater(spec))


def _make_raw_updater(spec: Any) -> Updater:
    cfg = normalize_updater(spec)
    t = cfg["type"]
    sched = cfg.get("schedule")

    def lr_at(step):
        return schedule_value(sched, cfg.get("lr", 0.0), step)

    if t == "noop":
        return Updater(lambda params: (),
                       lambda g, s, params, step, inplace=False:
                       (tree_map(torch.zeros_like, g), s), cfg)

    if t == "sgd":
        def sgd_update(g, s, params, step, inplace=False):
            lr = lr_at(step)
            return tree_map(lambda gi: lr * gi, g), s

        return Updater(lambda params: (), sgd_update, cfg)

    if t == "nesterovs":
        mu = cfg["momentum"]
        mu_sched = cfg.get("momentum_schedule")

        def init(params):
            return {"v": _zeros_like_tree(params)}

        def update(g, s, params, step, inplace=False):
            lr = lr_at(step)
            m = schedule_value(mu_sched, mu, step) if mu_sched else mu
            # DL4J NesterovsUpdater: v' = mu*v - lr*g ; update = -(mu*v' - lr*g)
            v_new = tree_map(lambda vi, gi: torch.sub(m * vi, lr * gi, out=_into(vi, inplace)),
                             s["v"], g)
            upd = tree_map(lambda vn, gi: -(m * vn - lr * gi), v_new, g)
            return upd, {"v": v_new}

        return Updater(init, update, cfg)

    if t == "adagrad":
        eps = cfg["eps"]

        def init(params):
            return {"h": _zeros_like_tree(params)}

        def update(g, s, params, step, inplace=False):
            lr = lr_at(step)
            h_new = tree_map(lambda hi, gi: torch.add(hi, gi * gi, out=_into(hi, inplace)),
                             s["h"], g)
            upd = tree_map(lambda hi, gi: lr * gi / (torch.sqrt(hi) + eps), h_new, g)
            return upd, {"h": h_new}

        return Updater(init, update, cfg)

    if t == "rmsprop":
        d, eps = cfg["decay"], cfg["eps"]

        def init(params):
            return {"c": _zeros_like_tree(params)}

        def update(g, s, params, step, inplace=False):
            lr = lr_at(step)
            c_new = tree_map(lambda ci, gi: torch.add(d * ci, (1 - d) * gi * gi,
                                                      out=_into(ci, inplace)), s["c"], g)
            upd = tree_map(lambda ci, gi: lr * gi / torch.sqrt(ci + eps), c_new, g)
            return upd, {"c": c_new}

        return Updater(init, update, cfg)

    if t == "adadelta":
        rho, eps = cfg["rho"], cfg["eps"]

        def init(params):
            return {"eg": _zeros_like_tree(params), "edx": _zeros_like_tree(params)}

        def update(g, s, params, step, inplace=False):
            eg_new = tree_map(lambda e, gi: torch.add(rho * e, (1 - rho) * gi * gi,
                                                      out=_into(e, inplace)), s["eg"], g)
            upd = tree_map(lambda e, dx, gi: gi * torch.sqrt(dx + eps) / torch.sqrt(e + eps),
                           eg_new, s["edx"], g)
            edx_new = tree_map(lambda dx, u: torch.add(rho * dx, (1 - rho) * u * u,
                                                       out=_into(dx, inplace)), s["edx"], upd)
            return upd, {"eg": eg_new, "edx": edx_new}

        return Updater(init, update, cfg)

    if t in ("adam", "adamax", "nadam", "amsgrad"):
        b1, b2, eps = cfg["beta1"], cfg["beta2"], cfg["eps"]

        def init(params):
            s = {"m": _zeros_like_tree(params), "v": _zeros_like_tree(params)}
            if t == "amsgrad":
                s["vmax"] = _zeros_like_tree(params)
            return s

        def update(g, s, params, step, inplace=False):
            lr = lr_at(step)
            tt = _f32(step) + 1.0
            bc1 = 1.0 - _f32(b1) ** tt
            bc2 = 1.0 - _f32(b2) ** tt
            m_new = tree_map(lambda mi, gi: torch.add(b1 * mi, (1 - b1) * gi,
                                                      out=_into(mi, inplace)), s["m"], g)
            if t == "adamax":
                v_new = tree_map(lambda vi, gi: torch.maximum(b2 * vi, torch.abs(gi),
                                                              out=_into(vi, inplace)),
                                 s["v"], g)
                upd = tree_map(lambda mi, vi: lr / bc1 * mi / (vi + eps), m_new, v_new)
                return upd, {"m": m_new, "v": v_new}
            v_new = tree_map(lambda vi, gi: torch.add(b2 * vi, (1 - b2) * gi * gi,
                                                      out=_into(vi, inplace)), s["v"], g)
            if t == "amsgrad":
                vmax = tree_map(lambda mx, vi: torch.maximum(mx, vi, out=_into(mx, inplace)),
                                s["vmax"], v_new)
                upd = tree_map(lambda mi, vi: lr * (mi / bc1) / (torch.sqrt(vi / bc2) + eps),
                               m_new, vmax)
                return upd, {"m": m_new, "v": v_new, "vmax": vmax}
            if t == "nadam":
                upd = tree_map(
                    lambda mi, vi, gi: lr * (b1 * mi / bc1 + (1 - b1) * gi / bc1)
                    / (torch.sqrt(vi / bc2) + eps),
                    m_new, v_new, g)
                return upd, {"m": m_new, "v": v_new}
            upd = tree_map(lambda mi, vi: lr * (mi / bc1) / (torch.sqrt(vi / bc2) + eps),
                           m_new, v_new)
            return upd, {"m": m_new, "v": v_new}

        return Updater(init, update, cfg)

    raise AssertionError(t)


# ---------------------------------------------------------------------------
# Gradient normalization (DL4J GradientNormalization, applied per layer
# before the updater)
# ---------------------------------------------------------------------------


def _sumsq(g):
    return torch.sum(g * g)


def apply_gradient_normalization(mode: Optional[str], threshold: float, layer_grads,
                                 sumsq=None):
    """Apply one of DL4J's per-layer gradient normalization modes to a
    layer's grad dict (possibly nested); returns the transformed grads.
    ``sumsq`` maps the grads to a tree of per-leaf sums of squares (the
    default sums each leaf itself; the tensor-parallel trainer all-reduces
    the sums of its sharded leaves, ``parallel/tp.py``)."""
    if not mode or mode == "none":
        return layer_grads
    mode = str(mode).lower()
    eps = 1e-8

    def squares():
        return tree_map(_sumsq, layer_grads) if sumsq is None else sumsq(layer_grads)

    if mode in ("renormalizel2perlayer", "renormalize_l2_per_layer"):
        norm = torch.sqrt(sum(tree_leaves(squares())) + eps)
        return tree_map(lambda g: g / norm, layer_grads)
    if mode in ("renormalizel2perparamtype", "renormalize_l2_per_param_type"):
        return tree_map(lambda g, s: g / torch.sqrt(s + eps), layer_grads, squares())
    if mode in ("clipelementwiseabsolutevalue", "clip_elementwise_absolute_value"):
        thr = float(threshold)
        return tree_map(lambda g: torch.clamp(g, -thr, thr), layer_grads)
    if mode in ("clipl2perlayer", "clip_l2_per_layer"):
        norm = torch.sqrt(sum(tree_leaves(squares())) + eps)
        scale = torch.clamp_max(threshold / norm, 1.0)
        return tree_map(lambda g: g * scale, layer_grads)
    if mode in ("clipl2perparamtype", "clip_l2_per_param_type"):
        return tree_map(lambda g, s: g * torch.clamp_max(threshold / torch.sqrt(s + eps), 1.0),
                        layer_grads, squares())
    raise ValueError(f"Unknown gradient normalization mode '{mode}'")
