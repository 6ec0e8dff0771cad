"""graftlint fixture: collective-consistency true positives."""

import torch.distributed as dist

from graftlint_torch.parallel import comm


def rank_zero_reduce(t):
    if dist.get_rank() == 0:
        dist.all_reduce(t)                  # BAD: the other ranks hang


def context_rank_reduce(ctx, t, sub):
    if ctx.rank == 0:
        comm.all_reduce(t, sub)             # BAD


def uniform_reduce(t, sub):
    out = comm.all_reduce(t, sub)           # OK: every rank
    if dist.get_rank() == 0:
        print(out)                          # OK: no collective in the branch
    return out


def own_group():
    return dist.new_group([0, 1])           # BAD: not the mesh's
