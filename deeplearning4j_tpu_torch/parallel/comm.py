"""The collectives of the parallel trainers, in one place.

Every collective that the port's parallel code runs goes through this
module: the plain ones (:func:`all_reduce`, :func:`all_gather`,
:func:`gather`, :func:`reduce_scatter`, :func:`broadcast`, :func:`send`,
:func:`recv`)
and the ones autograd must see through:

- :func:`copy_to` and :func:`reduce_from` — Megatron's pair around a
  tensor-parallel region: identity forward with a SUM all-reduce backward,
  and a SUM all-reduce forward with identity backward;
- :func:`gather_dim` — all-gather along a dim; its backward is this rank's
  slice of the gradient (``grad="slice"``, for a gathered tensor that every
  rank then uses alike) or the reduce-scatter of it (``grad="sum"``, the
  true adjoint, for a gathered tensor whose users differ by rank);
- :func:`all_reduce_sum` — a SUM all-reduce whose backward is the SUM
  all-reduce of the gradients (each rank's users differ).

Each takes a :class:`~deeplearning4j_tpu_torch.parallel.mesh.SubGroup`; a
group of one rank is the identity. NCCL takes device tensors for all of
them. Gloo takes CUDA tensors only for ``all_reduce``, ``broadcast`` and
``barrier`` (torch's backend table): for the others, on a gloo group, a
CUDA tensor is copied to host memory, the collective runs there and the
result is copied back. The choice is made by the group's backend name.
Gloo has no reduce-scatter; on a gloo group it is a SUM all-reduce of which
each rank keeps its slice.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

__all__ = ["all_gather", "all_reduce", "all_reduce_sum", "backend", "broadcast",
           "copy_to", "gather", "gather_dim", "recv", "reduce_from", "reduce_scatter",
           "send"]

# what gloo takes on CUDA tensors (torch.distributed's backend table)
_GLOO_CUDA_OPS = frozenset({"all_reduce", "broadcast"})


def backend(sub) -> str:
    return dist.get_backend(sub.group)


def _staged(sub, t: torch.Tensor, op: str) -> bool:
    """Does ``op`` on ``t`` go through host memory on this group?"""
    return t.is_cuda and backend(sub) == "gloo" and op not in _GLOO_CUDA_OPS


# -- plain collectives ---------------------------------------------------------

def all_reduce(t: torch.Tensor, sub) -> torch.Tensor:
    """SUM all-reduce of ``t`` in place over ``sub``; returns ``t``."""
    if sub.size > 1:
        dist.all_reduce(t, group=sub.group)
    return t


def broadcast(t: torch.Tensor, src_index: int, sub) -> torch.Tensor:
    """``t`` from the rank at ``src_index`` of ``sub``, in place."""
    if sub.size > 1:
        dist.broadcast(t, src=sub.ranks[src_index], group=sub.group)
    return t


def all_gather(t: torch.Tensor, sub) -> List[torch.Tensor]:
    """Every rank's ``t`` (same shape on all), in the group's rank order."""
    if sub.size == 1:
        return [t]
    t = t.contiguous()
    if _staged(sub, t, "all_gather"):
        h = t.cpu()
        parts = [torch.empty_like(h) for _ in range(sub.size)]
        dist.all_gather(parts, h, group=sub.group)
        return [p.to(t.device) for p in parts]
    parts = [torch.empty_like(t) for _ in range(sub.size)]
    dist.all_gather(parts, t, group=sub.group)
    return parts


def gather(t: torch.Tensor, dst_index: int, sub) -> Optional[List[torch.Tensor]]:
    """Every rank's ``t`` (same shape on all), in the group's rank order, on
    the rank at ``dst_index`` of ``sub``; None on the others."""
    if sub.size == 1:
        return [t]
    t = t.contiguous()
    dst = sub.ranks[dst_index]
    staged = _staged(sub, t, "gather")
    src = t.cpu() if staged else t
    parts = ([torch.empty_like(src) for _ in range(sub.size)]
             if sub.index == dst_index else None)
    dist.gather(src, parts, dst=dst, group=sub.group)
    if parts is None:
        return None
    return [p.to(t.device) for p in parts] if staged else parts


def reduce_scatter(flat: torch.Tensor, sub) -> torch.Tensor:
    """The SUM over the group of ``flat`` (1-D, its length a multiple of the
    group size), of which this rank keeps slice ``sub.index``."""
    if sub.size == 1:
        return flat
    m = flat.shape[0] // sub.size
    if backend(sub) == "gloo":
        total = all_reduce(flat.clone(), sub)
        return total[sub.index * m:(sub.index + 1) * m].clone()
    out = flat.new_empty((m,))
    dist.reduce_scatter_tensor(out, flat.contiguous(), group=sub.group)
    return out


def send(t: torch.Tensor, dst_index: int, sub) -> None:
    t = t.contiguous()
    dst = sub.ranks[dst_index]
    if _staged(sub, t, "send"):
        dist.send(t.cpu(), dst, group=sub.group)
    else:
        dist.send(t, dst, group=sub.group)


def recv(shape, dtype, device, src_index: int, sub) -> torch.Tensor:
    src = sub.ranks[src_index]
    out = torch.empty(shape, dtype=dtype, device=device)
    if _staged(sub, out, "recv"):
        h = torch.empty(shape, dtype=dtype)
        dist.recv(h, src, group=sub.group)
        return h.to(device)
    dist.recv(out, src, group=sub.group)
    return out


# -- collectives under autograd -------------------------------------------------

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sub):
        ctx.sub = sub
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.sub), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sub):
        return all_reduce(x.contiguous().clone(), sub)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sub):
        ctx.sub = sub
        return all_reduce(x.contiguous().clone(), sub)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.sub), None


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, sub, grad):
        ctx.dim, ctx.sub, ctx.grad, ctx.n = dim, sub, grad, x.shape[dim]
        return torch.cat(all_gather(x, sub), dim=dim)

    @staticmethod
    def backward(ctx, g):
        sub, dim, n = ctx.sub, ctx.dim, ctx.n
        if ctx.grad == "sum":
            g = all_reduce(g.contiguous().clone(), sub)
        return g.narrow(dim, sub.index * n, n).contiguous(), None, None, None


def copy_to(x: torch.Tensor, sub) -> torch.Tensor:
    """Identity forward; the backward SUM-all-reduces the gradient (the
    input of a column-parallel product, used by every rank's shard)."""
    return x if sub.size == 1 else _CopyTo.apply(x, sub)


def reduce_from(x: torch.Tensor, sub) -> torch.Tensor:
    """SUM all-reduce forward (the partial outputs of a row-parallel
    product); identity backward."""
    return x if sub.size == 1 else _ReduceFrom.apply(x, sub)


def all_reduce_sum(x: torch.Tensor, sub) -> torch.Tensor:
    """SUM all-reduce whose backward SUM-all-reduces the gradients: the
    adjoint, for a sum that every rank then uses in its own way."""
    return x if sub.size == 1 else _AllReduceSum.apply(x, sub)


def gather_dim(x: torch.Tensor, dim: int, sub, grad: str = "slice") -> torch.Tensor:
    """All-gather along ``dim`` (every rank's ``x`` has the same shape).
    ``grad="slice"``: the backward keeps this rank's slice (every rank
    then computes the same thing from the gathered tensor); ``"sum"``: the
    backward reduce-scatters (each rank uses the gathered tensor in its
    own way)."""
    if sub.size == 1:
        return x
    if grad not in ("slice", "sum"):
        raise ValueError(f"grad={grad!r}: want 'slice' or 'sum'")
    return _GatherDim.apply(x, dim, sub, grad)
