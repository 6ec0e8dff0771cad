"""Ring attention: sequence parallelism over the ``seq`` mesh axis (the
PyTorch port of ``parallel/ring.py``).

Each rank holds one block of the sequence, ``[B/d, T/s, H, D]`` of q, k
and v. The k/v blocks (and the key mask with them) travel around the ring
while every rank accumulates its own queries' attention, so no rank ever
holds the whole [T, T] problem. The JAX package rotates with ``ppermute``
inside ``shard_map``; here one rotation is a ``dist.batch_isend_irecv`` on
the ``seq`` sub-group, each rank sending its current block to rank
(r + 1) mod s and receiving from (r - 1) mod s, wrapped in an autograd
function whose backward sends the cotangents back the other way (the
transpose of a rotation).

- :func:`_ring_attention_shard` — the einsum ring (``use_flash=False``):
  the streaming-softmax recurrence over blocks, scores in the operand
  dtype, accumulators in f32 for bf16.
- :func:`_ring_flash_shard` — the flash ring: each block through the chunk
  kernels (``flash_attention_block_grad``: kernels #1-#3 on the card), the
  partial results merged by their lse (``merge_attention_blocks``). Under a
  causal mask step 0 holds the rank's own block (the local causal kernel)
  and a later step's block is either wholly in the past (allowed) or wholly
  in the future, whose lse is set to -1e30 so that its merge weight is 0,
  as the JAX package's ``where`` does.
- :func:`ring_self_attention` — the entry point on a mesh.

Both shard routines take the rotation as an argument: on a mesh it is
:func:`ring_rotation`; :func:`ring_in_one_process` runs the same routine
for every shard of a sequence in one process, handing shard r at step i
the blocks of shard (r - i) mod s, as the ring would deliver them.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.ops.flash_attention import (
    flash_attention_block_grad,
    local_attention,
    merge_attention_blocks,
)

__all__ = ["local_attention", "ring_in_one_process", "ring_rotation",
           "ring_self_attention"]

_NEG_BIG = -1e30


def _block_attend(q, k, v, scale, q_off, k_off, causal, m, l, acc, kmask=None):
    """One block of the streaming-softmax recurrence. q [B, Tq, H, D] the
    local queries, k/v [B, Tk, H, D] the current ring block; m and l
    [B, H, Tq] the running max and normaliser, acc [B, Tq, H, D] the
    output; ``kmask`` [B, Tk] this block's key validity."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        Tq, Tk = q.shape[1], k.shape[1]
        qpos = q_off + torch.arange(Tq, device=q.device)
        kpos = k_off + torch.arange(Tk, device=q.device)
        s = s.masked_fill(kpos[None, None, None, :] > qpos[None, None, :, None],
                          float("-inf"))
    if kmask is not None:
        s = s.masked_fill(~(kmask[:, None, None, :] > 0), float("-inf"))
    m_new = torch.maximum(m, s.amax(dim=-1))
    m_new = torch.clamp_min(m_new, _NEG_BIG)   # finite when a block is fully masked
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.to(p.dtype))
    acc_new = acc * corr.transpose(1, 2)[..., None] + pv
    return m_new, l_new, acc_new


def _ring_attention_shard(q, k, v, kmask, *, rotate: Callable, axis_size: int,
                          axis_index: int, causal: bool):
    """The einsum ring on one rank's shards [B, T_local, H, D] (``kmask``
    [B, T_local] or None). ``rotate(k, v, kmask)`` returns the blocks of
    the previous rank of the ring."""
    B, Tq, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    # f32 accumulators for bf16 activations: l sums thousands of terms and
    # acc is rescaled every ring step
    acc_dtype = torch.float32 if q.dtype == torch.bfloat16 else q.dtype
    m = torch.full((B, H, Tq), _NEG_BIG, dtype=acc_dtype, device=q.device)
    l = torch.zeros((B, H, Tq), dtype=acc_dtype, device=q.device)
    acc = torch.zeros(q.shape, dtype=acc_dtype, device=q.device)
    q_off = axis_index * Tq
    kc, vc, kmc = k, v, kmask
    for i in range(axis_size):
        src = (axis_index - i) % axis_size     # whose block this rank now holds
        m, l, acc = _block_attend(q, kc, vc, scale, q_off, src * Tq, causal, m, l, acc, kmc)
        if i + 1 < axis_size:
            kc, vc, kmc = rotate(kc, vc, kmc)
    l = torch.clamp_min(l, 1e-20)
    return (acc / l.transpose(1, 2)[..., None]).to(q.dtype)


def _ring_flash_shard(q, k, v, kmask=None, *, rotate: Callable, axis_size: int,
                      axis_index: int, causal: bool):
    """The flash ring on one rank's shards: each arriving block attended
    with the chunk kernels and the partial results merged by the
    streaming-softmax identity, differentiable in q, k and v (the blocks'
    backward takes the lse cotangent). Step 0 is the rank's own block, so
    under a causal mask it runs the local causal kernel; a later block from
    a shard after this one is wholly in the future and its lse becomes
    -1e30 (merge weight 0)."""
    parts = []
    kc, vc, kmc = k, v, kmask
    for i in range(axis_size):
        o_i, lse_i = flash_attention_block_grad(q, kc, vc, kmask=kmc,
                                                causal=causal and i == 0)
        if causal and i > 0:
            src = (axis_index - i) % axis_size
            if not src < axis_index:           # strictly past blocks only
                lse_i = torch.full_like(lse_i, _NEG_BIG)
        parts.append((o_i, lse_i))
        if i + 1 < axis_size:
            kc, vc, kmc = rotate(kc, vc, kmc)
    return merge_attention_blocks(parts)


def _exchange(xs: Sequence[torch.Tensor], to: int, frm: int, group) -> List[torch.Tensor]:
    """Send each of ``xs`` to global rank ``to`` and receive as many
    tensors of the same shapes from ``frm``, in one batch of P2P ops."""
    xs = [x.contiguous() for x in xs]
    outs = [torch.empty_like(x) for x in xs]
    ops = ([dist.P2POp(dist.isend, x, to, group) for x in xs]
           + [dist.P2POp(dist.irecv, o, frm, group) for o in outs])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


class _Rotate(torch.autograd.Function):
    """One step of the ring: the first ``n_diff`` tensors are
    differentiable (k and v), the rest ride along (the key mask). The
    backward sends the cotangents back to the rank the values came from."""

    @staticmethod
    def forward(ctx, group, to, frm, n_diff, *xs):
        ctx.route = (group, to, frm, n_diff)
        outs = _exchange(xs, to, frm, group)
        ctx.mark_non_differentiable(*outs[n_diff:])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        group, to, frm, n_diff = ctx.route
        back = _exchange(grads[:n_diff], frm, to, group)   # materialised: never None
        return (None, None, None, None, *back, *([None] * (len(grads) - n_diff)))


def ring_rotation(mesh, axis: str = "seq") -> Callable:
    """The ring's rotation along ``axis`` of ``mesh``: ``rotate(k, v,
    kmask)`` sends this rank's blocks to the next rank of the axis
    ((r + 1) mod s) and returns those of the previous one ((r - 1) mod s),
    differentiable in k and v."""
    ranks = mesh.axis_ranks(axis)
    i, s = mesh.axis_index(axis), len(ranks)
    to, frm, group = ranks[(i + 1) % s], ranks[(i - 1) % s], mesh.group(axis)

    def rotate(k, v, kmask=None):
        extra = () if kmask is None else (kmask,)
        out = _Rotate.apply(group, to, frm, 2, k, v, *extra)
        return out[0], out[1], (out[2] if kmask is not None else None)

    return rotate


def ring_in_one_process(shard_fn: Callable, qs, ks, vs, kmasks=None, *,
                        causal: bool) -> list:
    """Run a ring shard routine (:func:`_ring_flash_shard` or
    :func:`_ring_attention_shard`) once for every shard of a sequence in
    one process: shard r gets at step i the k/v (and key mask) of shard
    (r - i) mod s, the blocks the ring's rotation would deliver. Returns
    the shards' outputs, differentiable in every shard's q, k and v."""
    s = len(qs)
    outs = []
    for r in range(s):
        step = [0]

        def rotate(k, v, kmask=None, r=r, step=step):
            step[0] += 1
            j = (r - step[0]) % s
            return ks[j], vs[j], (kmasks[j] if kmasks is not None else None)

        outs.append(shard_fn(qs[r], ks[r], vs[r], kmasks[r] if kmasks is not None else None,
                             rotate=rotate, axis_size=s, axis_index=r, causal=causal))
    return outs


def ring_self_attention(q, k, v, mesh, *, causal: bool = False, kmask=None,
                        data_axis: Optional[str] = "data", seq_axis: str = "seq",
                        head_axis: Optional[str] = None, use_flash: bool = False):
    """Ring attention on this rank's shards: q, k, v [B/d, T/s, H, D] (the
    batch cut over ``data_axis``, the sequence over ``seq_axis``; rank r of
    the seq axis holds positions [r T/s, (r + 1) T/s)), ``kmask`` [B/d, T/s]
    or None. Returns this rank's [B/d, T/s, H, D] of the attention over the
    whole sequence. Every rank of the seq axis must call it.
    ``use_flash=True`` takes the flash ring (the chunk kernels on CUDA
    tensors), else the einsum ring. ``head_axis`` (``"model"`` under tensor
    parallelism) names the axis the heads are sharded over: q, k and v then
    hold this rank's ``H / model`` heads, and the ring runs on them along
    ``seq_axis`` as it is, with no gather over ``head_axis``."""
    for name, axis in (("data_axis", data_axis), ("seq_axis", seq_axis),
                       ("head_axis", head_axis)):
        if axis is not None and axis not in mesh.shape:
            raise ValueError(f"{name}={axis!r} is not an axis of the mesh {mesh.shape}")
    fn = _ring_flash_shard if use_flash else _ring_attention_shard
    return fn(q, k, v, kmask, rotate=ring_rotation(mesh, seq_axis),
              axis_size=mesh.shape[seq_axis], axis_index=mesh.axis_index(seq_axis),
              causal=causal)
