"""Loss functions (PyTorch port of ``nn/losses.py``).

ND4J's ``ILossFunction`` family as used by the reference's output layers:
MCXENT (NEGATIVELOGLIKELIHOOD), MSE, MAE, L1, L2, XENT, HINGE,
SQUARED_HINGE, KL_DIVERGENCE, POISSON, COSINE_PROXIMITY, MSLE, MAPE,
WASSERSTEIN, under the same names and aliases as the JAX package.

Each loss is a plain function
    ``loss(labels, output, weights=None) -> per-example scores [batch]``
of the POST-activation output (DL4J convention). :func:`per_example_scores`
takes PRE-activation values and fuses the unstable pairs: softmax+mcxent
becomes log-softmax cross-entropy (with dense one-hot or sparse integer
labels), sigmoid+xent becomes logits BCE.

Masks follow the reference's masked scoring: a [B, T] mask on rank-3
output zeroes masked timesteps before the time sum and
:func:`average_score` divides by the mask's sum; a [B] mask weights whole
examples and the average still divides by the full batch size. The
per-example convention sums over time and averages over examples.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from deeplearning4j_tpu_torch.nn import activations as _act

EPS = 1e-7

LossFn = Callable[..., torch.Tensor]

_REGISTRY: Dict[str, LossFn] = {}


def register(name: str, *aliases: str):
    def deco(fn: LossFn) -> LossFn:
        _REGISTRY[name.lower()] = fn
        for a in aliases:
            _REGISTRY[a.lower()] = fn
        return fn

    return deco


def get(name_or_fn) -> LossFn:
    if callable(name_or_fn):
        return name_or_fn
    key = str(name_or_fn).lower()
    if key not in _REGISTRY:
        raise ValueError(f"Unknown loss '{name_or_fn}'. Known: {sorted(_REGISTRY)}")
    return _REGISTRY[key]


def names() -> list:
    return sorted(_REGISTRY)


def _sum_features(x: torch.Tensor) -> torch.Tensor:
    """Sum over all non-batch axes -> per-example score [batch]."""
    return x.sum(dim=tuple(range(1, x.dim()))) if x.dim() > 1 else x


def _apply_weights(x: torch.Tensor, weights) -> torch.Tensor:
    if weights is None:
        return x
    return x * torch.as_tensor(weights, dtype=x.dtype, device=x.device)


def _n_out(labels) -> int:
    return labels.shape[-1] if labels.dim() > 1 else 1


@register("mse")
def mse(labels, output, weights=None):
    # DL4J LossMSE divides by the number of output features (L2 does not)
    return _sum_features(_apply_weights((output - labels) ** 2, weights)) / _n_out(labels)


@register("l2")
def l2(labels, output, weights=None):
    return _sum_features(_apply_weights((output - labels) ** 2, weights))


@register("mae")
def mae(labels, output, weights=None):
    return _sum_features(_apply_weights(torch.abs(output - labels), weights)) / _n_out(labels)


@register("l1")
def l1(labels, output, weights=None):
    return _sum_features(_apply_weights(torch.abs(output - labels), weights))


@register("mcxent", "negativeloglikelihood")
def mcxent(labels, output, weights=None):
    """Multi-class cross entropy on probabilities: -sum(y * log(p))."""
    logp = torch.log(torch.clamp(output, EPS, 1.0))
    return _sum_features(_apply_weights(-labels * logp, weights))


@register("xent")
def xent(labels, output, weights=None):
    """Binary cross entropy on probabilities (per-output independent)."""
    p = torch.clamp(output, EPS, 1.0 - EPS)
    ce = -(labels * torch.log(p) + (1.0 - labels) * torch.log(1.0 - p))
    return _sum_features(_apply_weights(ce, weights))


@register("hinge")
def hinge(labels, output, weights=None):
    # labels in {-1, +1}
    return _sum_features(_apply_weights(torch.clamp_min(1.0 - labels * output, 0.0), weights))


@register("squared_hinge", "squaredhinge")
def squared_hinge(labels, output, weights=None):
    h = torch.clamp_min(1.0 - labels * output, 0.0)
    return _sum_features(_apply_weights(h * h, weights))


@register("kl_divergence", "kld", "reconstruction_crossentropy")
def kld(labels, output, weights=None):
    y = torch.clamp(labels, EPS, 1.0)
    p = torch.clamp(output, EPS, 1.0)
    return _sum_features(_apply_weights(y * (torch.log(y) - torch.log(p)), weights))


@register("poisson")
def poisson(labels, output, weights=None):
    p = torch.clamp_min(output, EPS)
    return _sum_features(_apply_weights(p - labels * torch.log(p), weights))


@register("cosine_proximity")
def cosine_proximity(labels, output, weights=None):
    yn = labels / torch.clamp_min(torch.linalg.vector_norm(labels, dim=-1, keepdim=True), EPS)
    pn = output / torch.clamp_min(torch.linalg.vector_norm(output, dim=-1, keepdim=True), EPS)
    return _sum_features(_apply_weights(-yn * pn, weights))


@register("msle")
def msle(labels, output, weights=None):
    d = (torch.log1p(torch.clamp_min(output, -1 + EPS))
         - torch.log1p(torch.clamp_min(labels, -1 + EPS)))
    return _sum_features(_apply_weights(d * d, weights)) / _n_out(labels)


@register("mape")
def mape(labels, output, weights=None):
    d = torch.abs((labels - output) / torch.clamp_min(torch.abs(labels), EPS)) * 100.0
    return _sum_features(_apply_weights(d, weights)) / _n_out(labels)


@register("wasserstein")
def wasserstein(labels, output, weights=None):
    return _sum_features(_apply_weights(labels * output, weights))


# ---------------------------------------------------------------------------
# Fused, numerically stable entry point used by output layers.
# ---------------------------------------------------------------------------


def _is_softmax_mcxent(loss_name, activation) -> bool:
    return (loss_name in ("mcxent", "negativeloglikelihood")
            and str(activation).lower() == "softmax")


def per_example_scores(loss, labels: torch.Tensor, preact: torch.Tensor,
                       activation: str = "identity",
                       mask: Optional[torch.Tensor] = None,
                       weights=None) -> torch.Tensor:
    """Per-example loss scores [batch] from PRE-activation output.

    Fuses (softmax, mcxent) and (sigmoid, xent) into stable logit-space
    forms; otherwise applies the activation, then the probability-space
    loss. Integer labels of rank ``preact.dim() - 1`` are SPARSE class
    indices, taken by the softmax+mcxent head only (no one-hot tensor is
    built). For rank-3 [B, T, C] output a [B, T] mask zeroes masked
    timesteps before the time sum."""
    loss_name = loss.lower() if isinstance(loss, str) else None
    sparse = (labels.dim() == preact.dim() - 1
              and not labels.is_floating_point() and labels.dtype != torch.bool)
    if sparse and not _is_softmax_mcxent(loss_name, activation):
        raise ValueError(
            "integer (sparse) labels are only supported for the "
            "softmax+mcxent loss head; one-hot labels required for "
            f"loss={loss_name!r} activation={activation!r}")

    if _is_softmax_mcxent(loss_name, activation):
        logp = torch.log_softmax(preact, dim=-1)
        if sparse:
            lab = labels.to(torch.int64)
            ce = -torch.gather(logp, -1, lab[..., None])[..., 0]
            if weights is not None:
                ce = ce * torch.as_tensor(weights, dtype=ce.dtype, device=ce.device)[lab]
            if preact.dim() == 3 and mask is not None and mask.dim() == 2:
                return torch.sum(ce * mask, dim=-1)
            if preact.dim() == 3:
                # dense convention: per-example score sums over time
                ce = torch.sum(ce, dim=-1)
            if mask is not None:
                # a [B] example mask applies after the time sum
                ce = ce * mask.reshape(ce.shape)
            return ce
        elem = _apply_weights(-labels * logp, weights)
    elif loss_name == "xent" and str(activation).lower() == "sigmoid":
        # stable BCE with logits: logaddexp(0, z) - z*y, whose derivative is
        # sigmoid(z) - y everywhere (z == 0 included)
        elem = _apply_weights(
            torch.logaddexp(torch.zeros_like(preact), preact) - preact * labels, weights)
    else:
        out = _act.get(activation)(preact)
        fn = get(loss)
        if mask is not None and preact.dim() == 3 and mask.dim() == 2:
            elem_scores = fn(labels.reshape(-1, labels.shape[-1]),
                             out.reshape(-1, out.shape[-1]),
                             weights=weights).reshape(mask.shape)
            return torch.sum(elem_scores * mask, dim=-1)
        per_ex = fn(labels, out, weights=weights)
        if mask is not None:
            per_ex = per_ex * mask.reshape(per_ex.shape)
        return per_ex

    if elem.dim() == 3 and mask is not None and mask.dim() == 2:
        return torch.sum(torch.sum(elem, dim=-1) * mask, dim=-1)
    per_ex = _sum_features(elem)
    if mask is not None:
        per_ex = per_ex * mask.reshape(per_ex.shape)
    return per_ex


def average_score(loss, labels: torch.Tensor, preact: torch.Tensor,
                  activation: str = "identity",
                  mask: Optional[torch.Tensor] = None, weights=None) -> torch.Tensor:
    """Mean loss over examples (over unmasked timesteps for rank-3 output
    with a [B, T] mask). A [B] example mask zeroes contributions without
    shrinking the denominator (the reference's BaseOutputLayer.computeScore
    divides by the minibatch size); the fit loop's padding masks are
    pre-scaled by B_pad/n for that reason (``utils/bucketing.py``)."""
    scores = per_example_scores(loss, labels, preact, activation, mask, weights)
    if mask is not None and preact.dim() == 3 and mask.dim() == 2:
        return torch.sum(scores) / torch.clamp_min(torch.sum(mask), 1.0)
    if mask is not None:
        return torch.sum(scores) / scores.shape[0]
    return torch.mean(scores)
