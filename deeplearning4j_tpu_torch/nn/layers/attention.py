"""Attention / transformer layers (PyTorch port of ``nn/layers/attention.py``).

- ``MultiHeadAttention``: fused qkv projection ([C, 3C], one matmul),
  optional causal masking, attention core in ``_attend``, and sequence
  parallelism: with ``sequence_parallel=True`` under a mesh whose ``seq``
  axis is larger than 1 (``parallel/context.py``), the core is ring
  attention over that axis (``parallel/ring.py``), each rank holding one
  time chunk.
- ``TransformerBlock``: pre-LN block (LN→MHA→residual, LN→MLP→residual).
- ``PositionalEmbedding``: learned positions added to token embeddings;
  under a ``seq`` axis a rank's chunk takes positions ``[r T, (r + 1) T)``
  of the table (GSPMD does that for the JAX package's global arrays; the
  port's SPMD ranks hold their chunk alone).

Parameters keep the JAX package's names and layouts (``Wqkv`` [C, 3C],
``Wo`` [C, C], ``Wi`` [C, F], ...; x @ W, not ``nn.Linear``'s [out, in]),
activations are [B, T, C] and the attention core works on [B, T, H, D].

``use_flash`` keeps its meaning: under ``"auto"`` and ``True`` the core is
:func:`~deeplearning4j_tpu_torch.ops.flash_attention.flash_attention` — the
hand-written CUDA kernels (forward, and the dq and dk/dv backward under
autograd) for CUDA tensors, their plain versions for CPU tensors;
``False`` takes ``local_attention``. Attention dropout (``attn_dropout``)
applies to the attention OUTPUT, as in the JAX package, so it never gates
the kernels. ``DL4J_TPU_REMAT_BLOCKS=1`` (read at each call, as in the
JAX package) recomputes each TransformerBlock's forward in the backward
instead of keeping its activations (``torch.utils.checkpoint``,
non-reentrant), so kernel #1 runs twice a block in a training step.
The ring takes the flash route (the chunk kernels) under
``use_flash=True`` or under ``"auto"`` with CUDA tensors (the port's
counterpart of "on TPU"), else the einsum ring; without a ``seq`` axis a
``sequence_parallel`` layer runs single-device attention, as in the JAX
package. The block-size env knobs have no counterpart here (the CUDA
kernels fix their tiles).

Tensor parallelism (``parallel/tp.py``): under a mesh whose ``model``
axis is larger than 1, a layer whose params hold this rank's shard (a
``Wqkv`` narrower than ``3C``, a ``Wi`` narrower than ``ffn_mult * C``)
runs its local heads (``n_heads / model``; ``Wqkv`` holds their columns of
q, k and v) and its slice of the FFN, with Megatron's pair of collectives
(``parallel/comm.py``) around each column- then row-parallel product; the
output biases are added once, after the all-reduce.

Each layer also has ``decode_apply``, its eval-mode forward for a
new-token chunk on the decode path (``nn/decode.py``): positions are
per-row absolute indices, and attention runs against a KV-cache view
through ``ops.flash_attention.decode_attention`` (plain torch ops).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from deeplearning4j_tpu_torch.nn import initializers
from deeplearning4j_tpu_torch.nn.config import LayerConfig, dropout, register_layer
from deeplearning4j_tpu_torch.nn.input_type import InputType
from deeplearning4j_tpu_torch.nn.layers.normalization import layer_norm
from deeplearning4j_tpu_torch.ops.flash_attention import (
    decode_attention, flash_attention, local_attention)
from deeplearning4j_tpu_torch.parallel import comm
from deeplearning4j_tpu_torch.parallel.context import current_mesh, mesh_axis_size, mesh_sub
from deeplearning4j_tpu_torch.parallel.ring import ring_self_attention


def _seq_rank() -> int:
    """This rank's coordinate on the active mesh's ``seq`` axis (0 without
    one): the index of the time chunk it holds."""
    return current_mesh().axis_index("seq") if mesh_axis_size("seq") > 1 else 0


@register_layer("positional_embedding")
@dataclass
class PositionalEmbedding(LayerConfig):
    """Learned positional embedding added to the input sequence [B,T,C]."""

    max_len: int = 512

    def init(self, gen, input_type, dtype=torch.float32, device=None):
        x = torch.randn((self.max_len, input_type.size), generator=gen,
                        dtype=torch.float32, device=device)
        return {"pos": (x * 0.02).to(dtype)}

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        T = x.shape[1]
        off = _seq_rank() * T   # this rank's time chunk under a seq axis
        return x + params["pos"][off:off + T][None, :, :], state

    def decode_apply(self, params, x, positions):
        """Decode mode: ``positions`` [B, Tc] are per-row absolute indices
        (a chunk mid-stream starts where the row's cache ends). Clipped,
        not wrapped: padded chunk slots may carry positions past the table,
        and their activations are dead either way."""
        idx = positions.clamp(0, params["pos"].shape[0] - 1)
        return x + params["pos"][idx]


@register_layer("multi_head_attention")
@dataclass
class MultiHeadAttention(LayerConfig):
    """Multi-head self-attention over [B, T, C]."""

    n_heads: int = 8
    causal: bool = False
    sequence_parallel: bool = False
    attn_dropout: float = 0.0
    weight_init: Any = "xavier"
    use_flash: Any = "auto"

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def uses_rng(self) -> bool:
        return super().uses_rng() or self.attn_dropout > 0.0

    def init(self, gen, input_type, dtype=torch.float32, device=None):
        C = input_type.size
        if C % self.n_heads:
            raise ValueError(f"n_heads={self.n_heads} must divide model dim {C}")
        return {
            "Wqkv": initializers.initialize(self.weight_init, gen, (C, 3 * C), C,
                                            3 * C, dtype, device),
            "bqkv": torch.zeros((3 * C,), dtype=dtype, device=device),
            "Wo": initializers.initialize(self.weight_init, gen, (C, C), C, C,
                                          dtype, device),
            "bo": torch.zeros((C,), dtype=dtype, device=device),
        }

    def _attend(self, q, k, v, kmask=None, head_axis=None):
        if self.sequence_parallel and mesh_axis_size("seq") > 1:
            flash = self.use_flash is True or (self.use_flash == "auto" and q.is_cuda)
            return ring_self_attention(q, k, v, current_mesh(), causal=self.causal,
                                       kmask=kmask, use_flash=flash, head_axis=head_axis)
        if self.use_flash in ("auto", True):
            return flash_attention(q, k, v, kmask=kmask, causal=self.causal)
        return local_attention(q, k, v, causal=self.causal, kmask=kmask)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        x = self.maybe_dropout_input(x, train, rng)
        B, T, C = x.shape
        D = C // self.n_heads
        # a head-sharded Wqkv: this rank's heads (tensor parallelism)
        tp = mesh_sub("model") if params["Wqkv"].shape[1] != 3 * C else None
        H = params["Wqkv"].shape[1] // (3 * D)
        if tp is not None:
            x = comm.copy_to(x, tp)
        qkv = x @ params["Wqkv"] + params["bqkv"]
        # views into qkv: the kernel reads them through their strides
        q, k, v = qkv.view(B, T, 3 * H, D).split(H, dim=2)
        kmask = None
        if mask is not None and mask.dim() >= 2:
            kmask = mask.reshape(B, T)  # [B,T] key validity from feature mask
        out = self._attend(q, k, v, kmask, head_axis="model" if tp is not None else None)
        out = dropout(out.reshape(B, T, H * D), self.attn_dropout, train, rng,
                      "attention dropout")
        if tp is not None:
            return comm.reduce_from(out @ params["Wo"], tp) + params["bo"], state
        return out @ params["Wo"] + params["bo"], state

    def decode_apply(self, params, x, *, cache, positions):
        """Attention of a new-token chunk ``x`` [B, Tc, C] against a KV
        cache (``nn/decode.py``); eval mode, no dropout. ``cache`` is a
        view (``append`` and ``gathered``; the layer never sees the
        paging), ``positions`` [B, Tc] the chunk's absolute positions. The
        chunk's own k/v are appended BEFORE the gather, so attention within
        the chunk and over the history is one masked span."""
        B, Tc, C = x.shape
        H = self.n_heads
        qkv = x @ params["Wqkv"] + params["bqkv"]
        q, k, v = qkv.view(B, Tc, 3 * H, C // H).split(H, dim=2)
        cache.append(k, v)
        k_all, v_all = cache.gathered()
        out = decode_attention(q, k_all, v_all, positions).reshape(B, Tc, C)
        return out @ params["Wo"] + params["bo"]


@register_layer("transformer_block")
@dataclass
class TransformerBlock(LayerConfig):
    """Pre-LN transformer block: x + MHA(LN(x)); x + MLP(LN(x)).

    MLP is a fused [C,4C]→gelu→[4C,C] pair (``ffn_mult`` configurable).
    """

    n_heads: int = 8
    ffn_mult: int = 4
    causal: bool = True
    sequence_parallel: bool = False
    activation: Any = "gelu"
    weight_init: Any = "xavier"
    eps: float = 1e-5
    use_flash: Any = "auto"  # forwarded to the nested MultiHeadAttention

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def _mha(self) -> MultiHeadAttention:
        return MultiHeadAttention(
            n_heads=self.n_heads,
            causal=self.causal,
            sequence_parallel=self.sequence_parallel,
            weight_init=self.weight_init,
            use_flash=self.use_flash,
        )

    def nested_param_layers(self) -> dict:
        return {"attn": self._mha()}

    def init(self, gen, input_type, dtype=torch.float32, device=None):
        C = input_type.size
        F = self.ffn_mult * C

        def ln():
            return {"gamma": torch.ones((C,), dtype=dtype, device=device),
                    "beta": torch.zeros((C,), dtype=dtype, device=device)}

        return {
            "attn": self._mha().init(gen, input_type, dtype, device),
            "ln1": ln(),
            "ln2": ln(),
            "Wi": initializers.initialize(self.weight_init, gen, (C, F), C, F,
                                          dtype, device),
            "bi": torch.zeros((F,), dtype=dtype, device=device),
            "Wo": initializers.initialize(self.weight_init, gen, (F, C), F, C,
                                          dtype, device),
            "bo": torch.zeros((C,), dtype=dtype, device=device),
        }

    def _ln(self, p, x):
        return layer_norm(x, p["gamma"], p["beta"], self.eps)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        if os.environ.get("DL4J_TPU_REMAT_BLOCKS") == "1" and torch.is_grad_enabled():
            return self._apply_remat(params, x, train, rng, mask), state
        return self._apply_inner(params, x, train, rng, mask), state

    def _apply_remat(self, params, x, train, rng, mask):
        """Per-block rematerialisation: the backward recomputes the block's
        forward from its input instead of keeping its activations. The
        recompute must draw the same dropout masks, and the model's
        generator must end where a plain step leaves it: the forward draws
        from ``rng`` itself, and the recompute from a generator restored to
        ``rng``'s state on entry. (``preserve_rng_state`` would save only
        the default generators, not an explicit one.)"""
        entry = rng.get_state() if rng is not None else None
        calls = []

        def body(xx):
            r = rng
            if calls and rng is not None:   # the recompute
                r = torch.Generator(device=rng.device)
                r.set_state(entry)
            calls.append(1)
            return self._apply_inner(params, xx, train, r, mask)

        return checkpoint(body, x, use_reentrant=False, preserve_rng_state=False)

    def _apply_inner(self, params, x, train, rng, mask):
        x = self.maybe_dropout_input(x, train, rng)
        h = self._ln(params["ln1"], x)
        a, _ = self._mha().apply(params["attn"], {}, h, train=train, rng=rng, mask=mask)
        x = x + a
        h = self._ln(params["ln2"], x)
        # a column-sharded Wi: this rank's slice of the FFN (tensor parallelism)
        tp = mesh_sub("model") if params["Wi"].shape[1] != self.ffn_mult * x.shape[-1] else None
        if tp is not None:
            h = comm.copy_to(h, tp)
        h = self.activation_fn()(h @ params["Wi"] + params["bi"])
        if tp is not None:
            return x + (comm.reduce_from(h @ params["Wo"], tp) + params["bo"])
        return x + (h @ params["Wo"] + params["bo"])

    def decode_apply(self, params, x, *, cache, positions):
        """The block's eval-mode forward for a new-token chunk against a KV
        cache: the composition of :meth:`_apply_inner` with the attention
        swapped for :meth:`MultiHeadAttention.decode_apply`."""
        h = self._ln(params["ln1"], x)
        a = self._mha().decode_apply(params["attn"], h, cache=cache,
                                     positions=positions)
        x = x + a
        h = self._ln(params["ln2"], x)
        h = self.activation_fn()(h @ params["Wi"] + params["bi"])
        return x + (h @ params["Wo"] + params["bo"])
