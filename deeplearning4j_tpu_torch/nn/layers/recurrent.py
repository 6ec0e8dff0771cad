"""Recurrent layers (PyTorch port of ``nn/layers/recurrent.py``): LSTM,
GravesLSTM (peepholes), GRU, SimpleRnn, Bidirectional, LastTimeStep,
BidirectionalLastTimeStep, MaskZero and RnnOutputLayer.

Every recurrent layer exposes the carry API of the JAX package:
``initial_carry(batch, dtype, device)`` and ``apply_seq(params, x, carry,
mask) -> (out, new_carry)``, so truncated BPTT walks chunks with carried
state and ``rnn_time_step`` is a one-step call with a stored carry
(``nn/model.py``). The input projection ``x @ Wx + b`` is computed for the
whole sequence up front (``_input_proj``); the step loop consumes the
projected rows (``_cell_from_proj``).

LSTM and GravesLSTM take the fused recurrence (``ops/fused_lstm.py``:
kernels #4/#5 on CUDA tensors, their plain versions on CPU tensors) under
the JAX package's policy, with "on the TPU" read as "on any device":
``DL4J_TPU_FUSED_LSTM`` unset, ``auto`` or ``1`` fuses a layer that passes
``_fused_eligible``; ``0`` takes the step-by-step loop everywhere; a layer
that is not eligible always takes the loop.

Layout: [batch, time, features]; mask [batch, time]. Masked steps pass the
carry through unchanged and output zeros.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Optional

import torch

from deeplearning4j_tpu_torch.nn import activations, initializers, losses
from deeplearning4j_tpu_torch.nn.config import (
    FeedForwardLayerConfig,
    LayerConfig,
    register_layer,
)
from deeplearning4j_tpu_torch.nn.input_type import InputType
from deeplearning4j_tpu_torch.ops.fused_lstm import fused_lstm
from deeplearning4j_tpu_torch.parallel import comm
from deeplearning4j_tpu_torch.parallel.context import mesh_sub
from deeplearning4j_tpu_torch.utils.tree import tree_map


def _mask_step(mask_t, new, old):
    """Where mask_t == 0 keep ``old``, else ``new``. mask_t: [batch]."""
    return torch.where(mask_t[:, None] > 0, new, old)


def _last_valid(mask):
    """Index of the last step with mask > 0 in each row (left-padded masks
    included)."""
    T = mask.shape[1]
    rev = torch.flip(mask > 0, dims=[1]).to(torch.int32)
    return T - 1 - torch.argmax(rev, dim=1)


def _take_step(y, idx):
    """y [B, T, F] at step idx [B] -> [B, F]."""
    return torch.gather(y, 1, idx[:, None, None].expand(-1, 1, y.shape[-1]))[:, 0]


@dataclass
class BaseRecurrent(FeedForwardLayerConfig):
    """Common recurrent scaffolding."""

    # True for layers with a time-stepped carry (LSTM, SimpleRnn, ...): tBPTT
    # chunking and rnn_time_step carry their state through the model.
    SUPPORTS_CARRY = True

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timesteps)

    def initial_carry(self, batch: int, dtype=torch.float32, device=None):
        raise NotImplementedError

    def _cell(self, params, x_t, carry):
        """One step from a raw input row: project it and delegate to
        ``_cell_from_proj``."""
        proj = self._input_proj(params, x_t)
        if proj is None:
            raise NotImplementedError(
                f"{type(self).__name__} must implement _cell or _input_proj")
        return self._cell_from_proj(params, proj, carry)

    def _input_proj(self, params, x):
        """The input projection of the whole [b, t, f] sequence, or None to
        step over raw inputs."""
        return None

    def _cell_from_proj(self, params, zx_t, carry):
        """One step from a precomputed input projection row."""
        raise NotImplementedError

    def _carry_output(self, carry):
        """The per-step output h of a carry."""
        return carry

    def apply_seq(self, params, x, carry, mask=None):
        """[b, t, f] -> ([b, t, h], final carry), one step at a time. Masked
        steps pass the carry through unchanged and emit zeros."""
        zx = self._input_proj(params, x)
        if zx is not None:
            stream = zx
            cell = lambda c, v: self._cell_from_proj(params, v, c)   # noqa: E731
        else:
            stream = x
            cell = lambda c, v: self._cell(params, v, c)             # noqa: E731
        ms = mask.to(x.dtype) if mask is not None else None
        outs = []
        for t in range(stream.shape[1]):
            new_c = cell(carry, stream[:, t])
            if ms is not None:
                m_t = ms[:, t]
                new_c = tree_map(lambda n, o: _mask_step(m_t, n, o), new_c, carry)
                outs.append(self._carry_output(new_c) * m_t[:, None])
            else:
                outs.append(self._carry_output(new_c))
            carry = new_c
        return torch.stack(outs, 1), carry

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        x = self.maybe_dropout_input(x, train, rng)
        carry = self.initial_carry(x.shape[0], x.dtype, x.device)
        y, _ = self.apply_seq(params, x, carry, mask)
        return y, state


@register_layer("lstm")
@dataclass
class LSTM(BaseRecurrent):
    """Standard (non-peephole) LSTM (nn/conf/layers/LSTM.java). Gate order
    [i, f, g, o]; the forget-gate bias starts at 1.0 (DL4J's default)."""

    activation: Any = "tanh"
    gate_activation: Any = "sigmoid"
    forget_gate_bias_init: float = 1.0

    def init(self, gen, input_type, dtype=torch.float32, device=None):
        n_in = self.n_in if self.n_in is not None else input_type.size
        H = self.n_out
        Wx = initializers.initialize(self.weight_init, gen, (n_in, 4 * H), n_in, H,
                                     dtype, device)
        Wh = initializers.initialize(self.weight_init, gen, (H, 4 * H), H, H,
                                     dtype, device)
        b = torch.zeros((4 * H,), dtype=dtype, device=device)
        b[H:2 * H] = self.forget_gate_bias_init     # the forget-gate block
        return {"Wx": Wx, "Wh": Wh, "b": b}

    def initial_carry(self, batch: int, dtype=torch.float32, device=None):
        H = self.n_out
        return (torch.zeros((batch, H), dtype=dtype, device=device),
                torch.zeros((batch, H), dtype=dtype, device=device))

    def _carry_output(self, carry):
        return carry[0]

    def _input_proj(self, params, x):
        return x @ params["Wx"] + params["b"]

    def _fused_eligible(self) -> bool:
        """The fused recurrence covers the standard and peephole cells with
        the default activations and a hidden width that is a multiple of
        128 (the JAX package's rule)."""
        return (self.activation == "tanh"
                and self.gate_activation == "sigmoid"
                and self.n_out % 128 == 0
                and type(self) in (LSTM, GravesLSTM))

    def apply_seq(self, params, x, carry, mask=None):
        policy = os.environ.get("DL4J_TPU_FUSED_LSTM", "auto")
        if policy not in ("auto", "1") or not self._fused_eligible():
            return super().apply_seq(params, x, carry, mask)
        zx = self._input_proj(params, x)
        h0, c0 = carry
        out, (hT, cT) = fused_lstm(zx, params["Wh"], h0, c0, mask,
                                   params.get("peephole"))
        return out, (hT, cT)

    def _cell_from_proj(self, params, zx_t, carry):
        h, cell = carry
        H = self.n_out
        gate = activations.get(self.gate_activation)
        act = activations.get(self.activation)
        z = zx_t + h @ params["Wh"]
        i = gate(z[:, 0 * H:1 * H])
        f = gate(z[:, 1 * H:2 * H])
        g = act(z[:, 2 * H:3 * H])
        o = gate(z[:, 3 * H:4 * H])
        new_cell = f * cell + i * g
        new_h = o * act(new_cell)
        return (new_h, new_cell)


@register_layer("graves_lstm")
@dataclass
class GravesLSTM(LSTM):
    """LSTM with peephole connections (GravesLSTM.java): c_{t-1} feeds the
    i and f gates, c_t feeds o (LSTMHelpers.java)."""

    def init(self, gen, input_type, dtype=torch.float32, device=None):
        params = super().init(gen, input_type, dtype, device)
        params["peephole"] = torch.zeros((3 * self.n_out,), dtype=dtype,
                                         device=device)   # [p_i, p_f, p_o]
        return params

    def _cell_from_proj(self, params, zx_t, carry):
        h, cell = carry
        H = self.n_out
        act = activations.get(self.activation)
        gate = activations.get(self.gate_activation)
        p = params["peephole"]
        p_i, p_f, p_o = p[:H], p[H:2 * H], p[2 * H:]
        z = zx_t + h @ params["Wh"]
        i = gate(z[:, 0 * H:1 * H] + cell * p_i)
        f = gate(z[:, 1 * H:2 * H] + cell * p_f)
        g = act(z[:, 2 * H:3 * H])
        new_cell = f * cell + i * g
        o = gate(z[:, 3 * H:4 * H] + new_cell * p_o)
        new_h = o * act(new_cell)
        return (new_h, new_cell)


@register_layer("gru")
@dataclass
class GRU(BaseRecurrent):
    """Gated recurrent unit, gate order [z, r, h], Keras's ``reset_after``
    switch (the cuDNN-compatible variant when True, the default)."""

    activation: Any = "tanh"
    gate_activation: Any = "sigmoid"
    reset_after: bool = True

    def init(self, gen, input_type, dtype=torch.float32, device=None):
        n_in = self.n_in if self.n_in is not None else input_type.size
        H = self.n_out
        p = {
            "Wx": initializers.initialize(self.weight_init, gen, (n_in, 3 * H), n_in, H,
                                          dtype, device),
            "Wh": initializers.initialize(self.weight_init, gen, (H, 3 * H), H, H,
                                          dtype, device),
            "b_in": torch.zeros((3 * H,), dtype=dtype, device=device),
        }
        if self.reset_after:
            # a separate recurrent bias exists only in the reset_after variant
            p["b_rec"] = torch.zeros((3 * H,), dtype=dtype, device=device)
        return p

    def initial_carry(self, batch: int, dtype=torch.float32, device=None):
        return torch.zeros((batch, self.n_out), dtype=dtype, device=device)

    def _input_proj(self, params, x):
        return x @ params["Wx"] + params["b_in"]

    def _cell_from_proj(self, params, zx_t, carry):
        h = carry
        H = self.n_out
        gate = activations.get(self.gate_activation)
        act = activations.get(self.activation)
        if self.reset_after:
            rec = h @ params["Wh"] + params["b_rec"]
            z = gate(zx_t[:, :H] + rec[:, :H])
            r = gate(zx_t[:, H:2 * H] + rec[:, H:2 * H])
            hh = act(zx_t[:, 2 * H:] + r * rec[:, 2 * H:])
        else:
            rec_zr = h @ params["Wh"][:, :2 * H]
            z = gate(zx_t[:, :H] + rec_zr[:, :H])
            r = gate(zx_t[:, H:2 * H] + rec_zr[:, H:])
            hh = act(zx_t[:, 2 * H:] + (r * h) @ params["Wh"][:, 2 * H:])
        return z * h + (1.0 - z) * hh


@register_layer("simple_rnn")
@dataclass
class SimpleRnn(BaseRecurrent):
    """Elman RNN: h_t = act(x_t Wx + h_{t-1} Wh + b) (SimpleRnn.java)."""

    activation: Any = "tanh"

    def init(self, gen, input_type, dtype=torch.float32, device=None):
        n_in = self.n_in if self.n_in is not None else input_type.size
        H = self.n_out
        return {
            "Wx": initializers.initialize(self.weight_init, gen, (n_in, H), n_in, H,
                                          dtype, device),
            "Wh": initializers.initialize(self.weight_init, gen, (H, H), H, H,
                                          dtype, device),
            "b": torch.full((H,), self.bias_init, dtype=dtype, device=device),
        }

    def initial_carry(self, batch: int, dtype=torch.float32, device=None):
        return torch.zeros((batch, self.n_out), dtype=dtype, device=device)

    def _input_proj(self, params, x):
        return x @ params["Wx"] + params["b"]

    def _cell_from_proj(self, params, zx_t, carry):
        return self.activation_fn()(zx_t + carry @ params["Wh"])


@register_layer("bidirectional")
@dataclass
class Bidirectional(LayerConfig):
    """Bidirectional wrapper (Bidirectional.java, GravesBidirectionalLSTM):
    the wrapped RNN over the sequence and over its time reversal, combined
    by CONCAT | ADD | MUL | AVERAGE."""

    rnn: Optional[LayerConfig] = None
    mode: str = "concat"

    def output_type(self, input_type: InputType) -> InputType:
        inner = self.rnn.output_type(input_type)
        if self.mode == "concat":
            return InputType.recurrent(inner.size * 2, inner.timesteps)
        return inner

    def init(self, gen, input_type, dtype=torch.float32, device=None):
        return {"fwd": self.rnn.init(gen, input_type, dtype, device),
                "bwd": self.rnn.init(gen, input_type, dtype, device)}

    def nested_param_layers(self) -> dict:
        return {"fwd": self.rnn, "bwd": self.rnn}

    def regularization_penalty(self, params):
        pen = super().regularization_penalty(params)
        return (pen + self.rnn.regularization_penalty(params["fwd"])
                + self.rnn.regularization_penalty(params["bwd"]))

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        # both the wrapper's and the wrapped RNN's input dropout apply
        x = self.maybe_dropout_input(x, train, rng)
        if train and self.rnn.dropout > 0.0:
            x = self.rnn.maybe_dropout_input(x, train, rng)
        carry_f = self.rnn.initial_carry(x.shape[0], x.dtype, x.device)
        carry_b = self.rnn.initial_carry(x.shape[0], x.dtype, x.device)
        yf, _ = self.rnn.apply_seq(params["fwd"], x, carry_f, mask)
        xr = torch.flip(x, dims=[1])
        mr = torch.flip(mask, dims=[1]) if mask is not None else None
        yb, _ = self.rnn.apply_seq(params["bwd"], xr, carry_b, mr)
        yb = torch.flip(yb, dims=[1])
        if self.mode == "concat":
            return torch.cat([yf, yb], dim=-1), state
        if self.mode == "add":
            return yf + yb, state
        if self.mode == "mul":
            return yf * yb, state
        if self.mode in ("average", "avg"):
            return 0.5 * (yf + yb), state
        raise ValueError(f"Unknown Bidirectional mode '{self.mode}'")


@register_layer("last_time_step")
@dataclass
class LastTimeStep(LayerConfig):
    """Wraps an RNN layer and returns only its last (unmasked) step
    (LastTimeStepLayer.java): [b, t, f] -> [b, f]."""

    rnn: Optional[LayerConfig] = None

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.rnn.output_type(input_type).size)

    def init(self, gen, input_type, dtype=torch.float32, device=None):
        return self.rnn.init(gen, input_type, dtype, device)

    def regularization_penalty(self, params):
        return super().regularization_penalty(params) + self.rnn.regularization_penalty(params)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        y, _ = self.rnn.apply(params, {}, x, train=train, rng=rng, mask=mask)
        if mask is None:
            return y[:, -1, :], state
        return _take_step(y, _last_valid(mask)), state

    def propagate_mask(self, mask, input_type):
        return None


@register_layer("bidir_last_time_step")
@dataclass
class BidirectionalLastTimeStep(LayerConfig):
    """Keras ``Bidirectional(rnn, return_sequences=False)`` over a wrapped
    :class:`Bidirectional` in concat mode: the forward half's last step
    beside the backward half's step 0, the backward RNN's final state."""

    rnn: Optional[LayerConfig] = None   # a Bidirectional, mode="concat"

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.rnn.output_type(input_type).size)

    def init(self, gen, input_type, dtype=torch.float32, device=None):
        if getattr(self.rnn, "mode", "concat") != "concat":
            raise ValueError(
                "BidirectionalLastTimeStep requires mode='concat' (merged "
                "fwd/bwd halves are not separable for other modes)")
        return self.rnn.init(gen, input_type, dtype, device)

    def regularization_penalty(self, params):
        return super().regularization_penalty(params) + self.rnn.regularization_penalty(params)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        y, _ = self.rnn.apply(params, {}, x, train=train, rng=rng, mask=mask)
        H = y.shape[-1] // 2
        if mask is None:
            return torch.cat([y[:, -1, :H], y[:, 0, H:]], dim=-1), state
        # masked: the forward half at the last valid step, the backward half
        # at the first valid step (masked steps emit zeros)
        first = torch.argmax((mask > 0).to(torch.int32), dim=1)
        fwd = _take_step(y[..., :H], _last_valid(mask))
        bwd = _take_step(y[..., H:], first)
        return torch.cat([fwd, bwd], dim=-1), state

    def propagate_mask(self, mask, input_type):
        return None


@register_layer("mask_zero")
@dataclass
class MaskZero(LayerConfig):
    """Masks the steps whose features all equal ``mask_value`` and applies
    the wrapped RNN with that mask (MaskZeroLayer.java)."""

    rnn: Optional[LayerConfig] = None
    mask_value: float = 0.0

    def output_type(self, input_type: InputType) -> InputType:
        return self.rnn.output_type(input_type)

    def init(self, gen, input_type, dtype=torch.float32, device=None):
        return self.rnn.init(gen, input_type, dtype, device)

    def regularization_penalty(self, params):
        return super().regularization_penalty(params) + self.rnn.regularization_penalty(params)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        derived = torch.any(x != self.mask_value, dim=-1).to(x.dtype)
        if mask is not None:
            derived = derived * mask
        return self.rnn.apply(params, state, x, train=train, rng=rng, mask=derived)


@register_layer("rnn_output")
@dataclass
class RnnOutputLayer(BaseRecurrent):
    """Time-distributed output layer (RnnOutputLayer.java): dense + activation
    applied at every timestep of [batch, time, feat], with its loss."""

    SUPPORTS_CARRY = False   # no recurrence of its own

    activation: Any = "softmax"
    loss: Any = "mcxent"
    has_bias: bool = True

    def init(self, gen, input_type, dtype=torch.float32, device=None):
        n_in = self.n_in if self.n_in is not None else input_type.size
        params = {
            "W": initializers.initialize(self.weight_init, gen, (n_in, self.n_out),
                                         n_in, self.n_out, dtype, device)
        }
        if self.has_bias:
            params["b"] = torch.full((self.n_out,), self.bias_init, dtype=dtype,
                                     device=device)
        return params

    def preactivation(self, params, x):
        W = params["W"]
        if W.shape[-1] != self.n_out:   # column-sharded (GPipe's head under tp_axis)
            tp = mesh_sub("model")
            y = comm.gather_dim(comm.copy_to(x, tp) @ W, x.dim() - 1, tp)
        else:
            y = x @ W
        if self.has_bias:
            y = y + params["b"]
        return y

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        x = self.maybe_dropout_input(x, train, rng)
        y = self.activation_fn()(self.preactivation(params, x))
        if mask is not None:
            y = y * mask[..., None]
        return y, state

    def score(self, params, x, labels, mask=None, average=True, weights=None):
        """The loss head on the layer's input ``x`` [B, T, n_in]: the mean
        score (``average``) or per-example scores, from the preactivation
        (softmax+mcxent fused; integer labels [B, T] are sparse)."""
        preact = self.preactivation(params, x)
        if average:
            return losses.average_score(self.loss, labels, preact, self.activation,
                                        mask, weights)
        return losses.per_example_scores(self.loss, labels, preact, self.activation,
                                         mask, weights)
