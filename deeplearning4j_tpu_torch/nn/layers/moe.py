"""Mixture-of-Experts FFN layer (PyTorch port of ``nn/layers/moe.py``).

Switch-transformer-style top-1 routing with a fixed per-expert capacity:
each token goes to one expert's [capacity, C] buffer, each expert runs an
FFN as one batched product over [E, capacity, ·], and the results come
back weighted by the router gate. Tokens past an expert's capacity pass
through the residual unchanged (the capacity-drop policy).

The JAX package writes dispatch and combine as einsums with a dense
[N, E, capacity] one-hot tensor. Each of those sums has exactly one
non-zero term per output, so the port computes the same function by
index: a token's slot is its f32 ``cumsum`` rank among the tokens routed
to its expert (flattened token order), the dispatch is an ``index_copy``
of the tokens into the [E * capacity, C] buffer (dropped ones into a
scratch row that is cut off), and the combine a gather of each token's
row times its gate (the scratch row is zeros). At the full TransformerLM
width (N = 32768 tokens, capacity 5120) the dense tensors would hold
1.34e9 elements each.

Expert parallelism (``parallel/tp.py``): under a mesh whose ``model`` axis
is larger than 1, params holding this rank's ``E / model`` experts route
every token as before (the router is replicated), run the tokens of the
local experts only, and a SUM all-reduce over ``model`` combines the
ranks' outputs (``parallel/comm.py``); the tokens and the router's weight
enter through ``copy_to``, so their gradients are summed over the ranks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from deeplearning4j_tpu_torch.nn import initializers
from deeplearning4j_tpu_torch.nn.config import LayerConfig, register_layer
from deeplearning4j_tpu_torch.nn.input_type import InputType
from deeplearning4j_tpu_torch.parallel import comm
from deeplearning4j_tpu_torch.parallel.context import mesh_sub


@register_layer("mixture_of_experts")
@dataclass
class MixtureOfExperts(LayerConfig):
    """Top-1 (switch) MoE over [B, T, C] token streams, residual style:
    ``y = x + combine(expert_ffn(dispatch(x)))``."""

    n_experts: int = 8
    ffn_mult: int = 4
    capacity_factor: float = 1.25
    activation: Any = "gelu"
    weight_init: Any = "xavier"

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def init(self, gen, input_type, dtype=torch.float32, device=None):
        C = input_type.size
        F = self.ffn_mult * C
        E = self.n_experts

        def init(shape, fan_in, fan_out):
            return initializers.initialize(self.weight_init, gen, shape, fan_in,
                                           fan_out, dtype, device)

        return {
            "Wg": init((C, E), C, E),
            "Wi": torch.stack([init((C, F), C, F) for _ in range(E)]),
            "bi": torch.zeros((E, F), dtype=dtype, device=device),
            "Wo": torch.stack([init((F, C), F, C) for _ in range(E)]),
            "bo": torch.zeros((E, C), dtype=dtype, device=device),
        }

    def _capacity(self, n_tokens: int) -> int:
        cap = int(self.capacity_factor * n_tokens / self.n_experts)
        return max(cap, 1)

    def route(self, params, xt, mask=None):
        """Routing of the flattened tokens ``xt`` [N, C]: ``(expert [N],
        gate [N] in xt's dtype, slot [N] int64, keep [N] bool)``. The router
        product runs in the operand dtype, then everything in f32 (a bf16
        cumsum loses integer precision past 256); the argmax takes the
        first index on ties; a token's slot is its rank among the tokens
        routed to its expert; padded tokens (``mask`` 0) route nowhere."""
        E = self.n_experts
        N = xt.shape[0]
        cap = self._capacity(N)
        gates = torch.softmax((xt @ params["Wg"]).float(), dim=-1)   # [N, E]
        expert = torch.argmax(gates, dim=-1)
        gate = gates.gather(1, expert[:, None])[:, 0].to(xt.dtype)
        onehot = torch.nn.functional.one_hot(expert, E).float()
        if mask is not None and mask.dim() >= 2:
            onehot = onehot * mask.reshape(N).float()[:, None]
        pos = torch.cumsum(onehot, dim=0) * onehot - 1.0              # slot per token
        slot = pos.gather(1, expert[:, None])[:, 0]
        keep = (slot >= 0) & (slot < cap)
        return expert, gate, slot.long(), keep

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        x = self.maybe_dropout_input(x, train, rng)
        B, T, C = x.shape
        E = params["Wi"].shape[0]        # this rank's experts
        N = B * T
        cap = self._capacity(N)
        xt = x.reshape(N, C)
        tp = mesh_sub("model") if E != self.n_experts else None
        router = params
        if tp is not None:
            xt = comm.copy_to(xt, tp)
            router = {"Wg": comm.copy_to(params["Wg"], tp)}
        expert, gate, slot, keep = self.route(router, xt, mask)
        if tp is not None:       # the local experts are [lo, lo + E)
            expert = expert - tp.index * E
            keep = keep & (expert >= 0) & (expert < E)
        # each token's row of the [E * cap] buffer; dropped and padded
        # tokens (and, sharded, the other ranks' tokens) all point at one
        # scratch row past the end, which is cut off before the experts run
        # (so no host sync on the kept count)
        where = torch.where(keep, expert * cap + slot, E * cap)
        xe = xt.new_zeros((E * cap + 1, C)).index_copy(0, where, xt)
        xe = xe[:E * cap].view(E, cap, C)
        he = self.activation_fn()(torch.bmm(xe, params["Wi"]) + params["bi"][:, None])
        ye = torch.bmm(he, params["Wo"]) + params["bo"][:, None]     # [E, cap, C]
        ye = torch.cat([ye.reshape(E * cap, C), ye.new_zeros((1, C))])
        yt = ye[where] * gate[:, None]                  # scratch row: exact 0
        if tp is not None:
            yt = comm.reduce_from(yt, tp)
        return x + yt.reshape(B, T, C), state

    def dropped_tokens(self, params, x, mask=None) -> int:
        """Tokens of ``x`` [B, T, C] that route to an expert past its
        capacity (they pass through the residual alone)."""
        xt = x.reshape(-1, x.shape[-1])
        expert, _, slot, keep = self.route(params, xt, mask)
        return int(((slot >= 0) & ~keep).sum())

    def load_balance_loss(self, params, x) -> torch.Tensor:
        """Auxiliary load-balancing loss (Switch §2.2): E · Σ_e f_e · P_e."""
        N = x.shape[0] * x.shape[1]
        logits = (x.reshape(N, -1) @ params["Wg"]).float()
        gates = torch.softmax(logits, dim=-1)
        frac = torch.nn.functional.one_hot(
            torch.argmax(gates, dim=-1), self.n_experts).float().mean(dim=0)
        prob = gates.mean(dim=0)
        return self.n_experts * torch.sum(frac * prob)
