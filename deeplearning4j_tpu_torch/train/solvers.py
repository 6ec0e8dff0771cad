"""Deterministic solvers: line search, conjugate gradient, L-BFGS (PyTorch
port of ``deeplearning4j_tpu/train/solvers.py``).

Parity: optimize/Solver.java:50-80 (dispatch on OptimizationAlgorithm),
optimize/solvers/{BaseOptimizer.java:54, LineGradientDescent.java,
ConjugateGradient.java, LBFGS.java, BackTrackLineSearch.java}.

The solvers run over ONE flat vector of every param leaf, in the order of
the JAX package's ``ravel_pytree(model.params)`` (JAX treedef order: dict
keys sorted at every level, ``utils/tree.py``), so an L-BFGS history holds
the same vectors in both packages. The loss and its gradient over the flat
vector come from autograd (the leaves are views of the vector); the
two-loop recursion and the CG direction are vector ops on the model's
device, and the host reads only the scalars the reference reads (the loss,
dot products, the line search's comparisons). Each new batch signature
counts a compile at the ``solver`` site, which the retrace guard bounds by
its bucket hits, and the optimized params are written into the model's
tensors in place.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn import aot
from deeplearning4j_tpu_torch.utils import bucketing
from deeplearning4j_tpu_torch.utils.tree import assign_leaves, tree_leaves, tree_unflatten_like

__all__ = ["BackTrackLineSearch", "Solver"]


class BackTrackLineSearch:
    """Armijo backtracking (BackTrackLineSearch.java): shrink the step until
    f(x + a*d) <= f(x) + c1 * a * g.d."""

    def __init__(self, c1: float = 1e-4, rho: float = 0.5, max_iterations: int = 20,
                 initial_step: float = 1.0):
        self.c1 = c1
        self.rho = rho
        self.max_iterations = max_iterations
        self.initial_step = initial_step

    def search(self, f: Callable, x: torch.Tensor, f0: float, g: torch.Tensor,
               direction: torch.Tensor) -> Tuple[float, float]:
        """Returns (alpha, f_new). alpha=0 if no improving step found."""
        slope = float(g @ direction)
        if slope >= 0:  # not a descent direction
            return 0.0, f0
        alpha = self.initial_step
        for _ in range(self.max_iterations):
            f_new = float(f(x + alpha * direction))
            if math.isfinite(f_new) and f_new <= f0 + self.c1 * alpha * slope:
                return alpha, f_new
            alpha *= self.rho
        return 0.0, f0


class Solver:
    """``Solver(model, algorithm).optimize(data, iterations)`` — full-batch
    deterministic optimization of a MultiLayerNetwork's loss.

    algorithm: "lbfgs" | "conjugate_gradient" | "line_gradient_descent".
    ``m`` is the L-BFGS history length.
    """

    def __init__(self, model, algorithm: str = "lbfgs", m: int = 10,
                 line_search: Optional[BackTrackLineSearch] = None):
        self.model = model
        self.algorithm = algorithm.lower()
        if self.algorithm not in ("lbfgs", "conjugate_gradient", "line_gradient_descent"):
            raise ValueError(f"unknown algorithm {self.algorithm!r}")
        self.m = m
        self.line_search = line_search or BackTrackLineSearch()
        self._f = None
        self._vg = None

    # -- the loss over the flat vector -------------------------------------
    def _unravel(self, flat: torch.Tensor):
        """The model's param tree whose leaves are views of ``flat``."""
        template = self.model.params
        leaves, off = [], 0
        for p in tree_leaves(template):
            n = p.numel()
            leaves.append(flat[off:off + n].view(p.shape))
            off += n
        return tree_unflatten_like(template, leaves)

    def _build(self, x, y, fm, lm):
        """Bind the batch: ``_f(flat)`` is the loss as a device scalar,
        ``_vg(flat)`` the loss and its gradient over ``flat``. The objective
        draws no randomness (eval-mode layers, no dropout)."""
        model = self.model
        state = model.state
        flat0 = torch.cat([p.detach().reshape(-1) for p in tree_leaves(model.params)])

        def loss_of(flat):
            loss, _ = model._loss(self._unravel(flat), state, x, y, fm, lm, None,
                                  train=False)
            return loss

        def f(flat):
            with torch.no_grad():
                return loss_of(flat)

        def vg(flat):
            live = flat.detach().requires_grad_(True)
            loss = loss_of(live)
            (g,) = torch.autograd.grad(loss, live)
            return loss.detach(), g

        self._f, self._vg = f, vg
        return flat0

    def optimize(self, data, iterations: int = 100, tolerance: float = 1e-6) -> float:
        """Minimize over ``iterations`` solver steps; returns the final loss
        and writes the optimized params back into the model."""
        from deeplearning4j_tpu_torch.nn.model import _as_batch, _cast_labels, _cast_mask

        model = self.model
        x, y, fm, lm = _as_batch(data)
        n = len(x)
        if bucketing.bucketing_enabled() and n > 0 and y is not None:
            # the batch padded up the shared ladder, as the JAX package does;
            # the objective is eval-mode, so tiled pad rows only need zero
            # loss weight: the pre-scaled validity mask keeps the loss the
            # exact mean over the n real rows
            target = bucketing.bucket_size(n)
            bucketing.telemetry().record_hit("solver", n, target)
            pad = target - n
            if pad:
                x = bucketing.tile_pad(x, pad)
                y = bucketing.tile_pad(y, pad)
                fm = bucketing.tile_pad(fm, pad)
                lm = bucketing.tile_pad(lm, pad) if lm is not None else None
            lm = bucketing.padded_label_mask(y, lm, n)
        x = model._features(x)
        y = _cast_labels(y, model.dtype, model.device)
        fm = _cast_mask(fm, model.dtype, model.device)
        lm = _cast_mask(lm, model.dtype, model.device)
        site = aot.grid_site(model, "solver")
        site.note_seen(x, y, fm, lm)
        flat = self._build(x, y, fm, lm)

        f0, g = self._vg(flat)
        f0 = float(f0)
        if self.algorithm == "lbfgs":
            flat, f0 = self._lbfgs(flat, f0, g, iterations, tolerance)
        elif self.algorithm == "conjugate_gradient":
            flat, f0 = self._cg(flat, f0, g, iterations, tolerance)
        else:
            flat, f0 = self._gd(flat, f0, g, iterations, tolerance)
        model.params = assign_leaves(model.params, self._unravel(flat.detach()))
        site.guard()
        return f0

    # -- algorithms --------------------------------------------------------
    def _gd(self, x, f0, g, iterations, tol):
        for _ in range(iterations):
            d = -g
            alpha, f_new = self.line_search.search(self._f, x, f0, g, d)
            if alpha == 0.0 or f0 - f_new < tol:
                break
            x = x + alpha * d
            f0, g = self._vg(x)
            f0 = float(f0)
        return x, f0

    def _cg(self, x, f0, g, iterations, tol):
        d = -g
        for _ in range(iterations):
            alpha, f_new = self.line_search.search(self._f, x, f0, g, d)
            if alpha == 0.0 or f0 - f_new < tol:
                break
            x = x + alpha * d
            f_prev_g = g
            f0, g = self._vg(x)
            f0 = float(f0)
            # Polak-Ribiere+ with automatic restart (ConjugateGradient.java)
            beta = float(torch.clamp(
                (g @ (g - f_prev_g)) / torch.clamp(f_prev_g @ f_prev_g, min=1e-12),
                min=0.0))
            d = -g + beta * d
            if float(g @ d) >= 0:  # not descent -> restart
                d = -g
        return x, f0

    def _lbfgs(self, x, f0, g, iterations, tol):
        s_hist: List[torch.Tensor] = []
        y_hist: List[torch.Tensor] = []
        rho_hist: List[float] = []
        for _ in range(iterations):
            d = self._two_loop(g, s_hist, y_hist, rho_hist)
            ls = BackTrackLineSearch(
                c1=self.line_search.c1, rho=self.line_search.rho,
                max_iterations=self.line_search.max_iterations,
                initial_step=1.0 if s_hist else min(
                    1.0, 1.0 / max(float(torch.linalg.norm(g)), 1e-12)),
            )
            alpha, f_new = ls.search(self._f, x, f0, g, d)
            if alpha == 0.0 or f0 - f_new < tol:
                break
            x_new = x + alpha * d
            _, g_new = self._vg(x_new)
            s = x_new - x
            yv = g_new - g
            sy = float(s @ yv)
            if sy > 1e-10:  # curvature condition
                s_hist.append(s)
                y_hist.append(yv)
                rho_hist.append(1.0 / sy)
                if len(s_hist) > self.m:
                    s_hist.pop(0)
                    y_hist.pop(0)
                    rho_hist.pop(0)
            x, f0, g = x_new, f_new, g_new
        return x, f0

    @staticmethod
    def _two_loop(g, s_hist, y_hist, rho_hist):
        """Standard L-BFGS two-loop recursion (LBFGS.java's implicit-Hessian
        direction)."""
        q = -g
        if not s_hist:
            return q
        alphas = []
        for s, yv, rho in zip(reversed(s_hist), reversed(y_hist), reversed(rho_hist)):
            a = rho * float(s @ q)
            alphas.append(a)
            q = q - a * yv
        gamma = float(s_hist[-1] @ y_hist[-1]) / max(float(y_hist[-1] @ y_hist[-1]), 1e-12)
        q = gamma * q
        for (s, yv, rho), a in zip(zip(s_hist, y_hist, rho_hist), reversed(alphas)):
            b = rho * float(yv @ q)
            q = q + (a - b) * s
        return q
