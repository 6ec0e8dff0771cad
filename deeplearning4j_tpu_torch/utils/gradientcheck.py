"""Numerical-vs-analytic gradient checking (PyTorch port of
``deeplearning4j_tpu/utils/gradientcheck.py``).

Parity: gradientcheck/GradientCheckUtil.java:109 (MLN), :331 (graph) — the
correctness backbone of the reference's test suite. Central differences in
float64 on the CPU against autograd's gradient of the model's loss.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten_like

__all__ = ["check_gradients"]


def _to64(t):
    """A tree of arrays or tensors as float64 CPU tensors (integer leaves,
    token ids and sparse labels, keep their type)."""
    def one(a):
        a = a.detach().cpu() if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
        return a.double() if a.is_floating_point() else a

    return None if t is None else tree_map(one, t)


def _cpu_twin(model):
    """``model`` itself on the CPU, or a CPU copy of its params and state."""
    if model.device.type == "cpu":
        return model
    twin = type(model)(model.conf, device="cpu").init()
    twin.params = tree_map(lambda t: t.detach().cpu(), model.params)
    twin.state = tree_map(lambda t: t.detach().cpu(), model.state)
    return twin


def check_gradients(
    model,
    x,
    y,
    fmask=None,
    lmask=None,
    epsilon: float = 1e-6,
    max_rel_error: float = 1e-3,
    min_abs_error: float = 1e-8,
    subset: Optional[int] = None,
    seed: int = 12345,
    print_results: bool = False,
) -> bool:
    """Central-difference check of d(loss)/d(params) for a MultiLayerNetwork
    or ComputationGraph (x, y, masks: tuples of arrays for a graph), in
    float64 on the CPU, layers in eval mode.

    ``subset``: check only N randomly chosen parameters per tensor (the
    reference checks all; sub-sampling keeps CI fast for big nets).
    """
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    net = _cpu_twin(model)
    params64 = _to64(net.params)
    state64 = _to64(net.state)
    if isinstance(net, ComputationGraph):
        f, l, fm, lm = (_to64(t) for t in net._as_multi_batch((x, y, fmask, lmask)))
        names = net.conf.inputs
        args = (dict(zip(names, f)), l, None if fm is None else dict(zip(names, fm)), lm)
    else:
        args = tuple(_to64(t) for t in (x, y, fmask, lmask))

    def loss_fn(p):
        loss, _ = net._loss(p, state64, *args, None, train=False)
        return loss

    flat_p = tree_leaves(params64)
    live = [p.clone().requires_grad_(True) for p in flat_p]
    loss = loss_fn(tree_unflatten_like(params64, live))
    analytic = torch.autograd.grad(loss, live, allow_unused=True)
    rng = np.random.RandomState(seed)
    n_fail = 0
    n_checked = 0
    max_err = 0.0

    with torch.no_grad():
        for ti, (p, g) in enumerate(zip(flat_p, analytic)):
            gn = (np.zeros(tuple(p.shape)) if g is None
                  else g.detach().numpy().astype(np.float64))
            pn = p.numpy()   # a view: perturbations write into params64
            size = pn.size
            if subset is not None and size > subset:
                idxs = rng.choice(size, subset, replace=False)
            else:
                idxs = np.arange(size)
            for flat_idx in idxs:
                orig = pn.flat[flat_idx]
                pn.flat[flat_idx] = orig + epsilon
                plus = float(loss_fn(params64))
                pn.flat[flat_idx] = orig - epsilon
                minus = float(loss_fn(params64))
                pn.flat[flat_idx] = orig

                numeric = (plus - minus) / (2 * epsilon)
                a = gn.flat[flat_idx]
                denom = abs(a) + abs(numeric)
                rel = abs(a - numeric) / denom if denom > 0 else 0.0
                n_checked += 1
                if rel > max_rel_error and abs(a - numeric) > min_abs_error:
                    n_fail += 1
                    if print_results:
                        print(f"FAIL tensor {ti} idx {flat_idx}: analytic={a:.8g} "
                              f"numeric={numeric:.8g} rel={rel:.4g}")
                max_err = max(max_err, rel if abs(a - numeric) > min_abs_error else 0.0)

    if print_results:
        print(f"Gradient check: {n_checked - n_fail}/{n_checked} passed, "
              f"max rel error {max_err:.4g}")
    return n_fail == 0
