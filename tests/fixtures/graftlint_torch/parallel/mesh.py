"""graftlint fixture: the mesh, the one place groups are made."""

import torch.distributed as dist


def make_groups(ranks):
    return dist.new_group(ranks)            # OK: parallel/mesh.py
