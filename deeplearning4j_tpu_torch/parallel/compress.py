"""Threshold gradient compression with residual error feedback (the
PyTorch port of ``parallel/compress.py``).

- :func:`threshold_encode`: accumulate the gradient into the residual,
  emit ``sign(acc) * threshold`` wherever ``|acc| >= threshold`` and carry
  the remainder forward, so ``q + new_residual == grad + residual``
  exactly (every component is transmitted eventually).
- :func:`pack_ternary` / :func:`unpack_ternary`: 2 bits per element
  (codes 0 -> 0, +1 -> 1, -1 -> 2), 4 per byte, the first element in the
  low bits: the same bytes as the JAX package's, a 16x smaller payload
  than float32 gradients. Replicas exchange the packed bytes by all-gather
  (encodings are not summable) and every replica decodes and sums them in
  the same order (:func:`decode_gathered`).

Plain torch on tensors; there is no kernel here.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["decode_gathered", "encode_packed", "pack_ternary", "packed_nbytes",
           "threshold_decode", "threshold_encode", "unpack_ternary"]

_ELEMS_PER_BYTE = 4


def packed_nbytes(n: int) -> int:
    """Wire bytes for an ``n``-element ternary-packed gradient."""
    return (n + _ELEMS_PER_BYTE - 1) // _ELEMS_PER_BYTE


def threshold_encode(grad, residual, threshold) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``grad + residual`` to {-threshold, 0, +threshold}; returns
    ``(q, new_residual)`` with ``q + new_residual == grad + residual``."""
    acc = grad + residual
    thr = torch.as_tensor(threshold, dtype=acc.dtype, device=acc.device)
    q = torch.where(acc.abs() >= thr, torch.sign(acc) * thr, torch.zeros_like(acc))
    return q, acc - q


def threshold_decode(q, target):
    """Apply an encoded update to ``target`` (decode accumulates)."""
    return target + q


def pack_ternary(signs) -> torch.Tensor:
    """Pack a 1-D tensor of {-1, 0, +1} into 2-bit codes, 4 per byte (uint8
    of ``packed_nbytes(n)`` bytes; the last byte's spare slots are 0)."""
    n = signs.shape[0]
    codes = (signs > 0).to(torch.int32) + 2 * (signs < 0).to(torch.int32)
    pad = (-n) % _ELEMS_PER_BYTE
    if pad:
        codes = torch.cat([codes, codes.new_zeros((pad,))])
    codes = codes.reshape(-1, _ELEMS_PER_BYTE)
    weights = torch.tensor([1, 4, 16, 64], dtype=torch.int32, device=codes.device)
    return (codes * weights).sum(dim=1).to(torch.uint8)


def unpack_ternary(packed, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_ternary`; takes a leading batch axis (the
    all-gathered ``[R, nbytes]`` payload) and returns float32 signs
    ``[..., n]``."""
    b = packed.to(torch.int32)
    codes = torch.stack([(b >> s) & 3 for s in (0, 2, 4, 6)], dim=-1)
    flat = codes.reshape(tuple(packed.shape[:-1]) + (-1,))[..., :n]
    return (flat == 1).to(torch.float32) - (flat == 2).to(torch.float32)


def encode_packed(grad, residual, threshold):
    """One replica's wire payload: ``(packed_uint8, new_residual)``."""
    q, new_residual = threshold_encode(grad, residual, threshold)
    return pack_ternary(torch.sign(q)), new_residual


def decode_gathered(gathered, n: int, threshold, dtype):
    """Decode the all-gathered ``[R, nbytes]`` payloads and sum over the
    replicas in float32, in order (axis 0), then cast to ``dtype``."""
    signs = unpack_ternary(gathered, n)
    total = signs.sum(dim=0) * torch.tensor(threshold, dtype=torch.float32,
                                            device=signs.device)
    return total.to(dtype)
