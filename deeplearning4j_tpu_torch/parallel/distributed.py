"""Multi-process setup (the PyTorch port of ``parallel/distributed.py``).

The JAX package joins a ``jax.distributed`` cluster and lets every process
feed its rows of a global array. The port runs one process per card under
``torch.distributed``: :func:`init_distributed` forms the process group
(NCCL for a CUDA device, gloo when the caller asks for the CPU), and the
helpers below cut this rank's shard out of a global numpy batch
(:func:`global_array`) and broadcast a tree of tensors from rank 0
(:func:`replicate_global`). Nothing here reads a cluster from the
environment by itself: the caller gives the address (``tcp://host:port``
or ``file:///path``), the world size and the rank, or sets the
``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK`` variables that
``env://`` reads.
"""

from __future__ import annotations

import datetime
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["default_device", "global_array", "init_distributed", "is_multihost",
           "process_count", "replicate_global", "shutdown_distributed"]

_DEVICE: Optional[torch.device] = None


def init_distributed(init_method: str = "env://", world_size: Optional[int] = None,
                     rank: Optional[int] = None, *, device=None,
                     timeout_s: float = 300.0, backend: Optional[str] = None) -> torch.device:
    """Join (or form) the default process group and return this rank's
    device. ``device``: None means the GPU (``cuda:<current>``; it raises
    with no GPU), ``"cpu"`` must be asked for. ``backend``: None follows
    the device, NCCL for a CUDA device and gloo for the CPU; ``"gloo"`` on
    a CUDA device puts several ranks on one card (NCCL refuses that), the
    collectives then staging through host memory where gloo takes no CUDA
    tensors (``parallel/comm.py``). ``timeout_s`` bounds every collective,
    the rendezvous included."""
    global _DEVICE
    from deeplearning4j_tpu_torch.nn.model import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {}
    if world_size is not None:
        kw["world_size"] = world_size
    if rank is not None:
        kw["rank"] = rank
    dist.init_process_group(backend, init_method=init_method,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    _DEVICE = dev
    return dev


def shutdown_distributed() -> None:
    """Leave the default process group (a no-op when there is none). The
    ranks meet at a barrier first: a gloo rank that tears its connections
    down while a peer still uses them can abort the peer's process."""
    global _DEVICE
    if dist.is_available() and dist.is_initialized():
        if dist.get_world_size() > 1:
            dist.barrier()
        dist.destroy_process_group()
    _DEVICE = None


def default_device(device=None) -> torch.device:
    """``device`` if given, else the device :func:`init_distributed` chose,
    else the GPU (raising with none)."""
    from deeplearning4j_tpu_torch.nn.model import resolve_device

    if device is None and _DEVICE is not None:
        return _DEVICE
    return resolve_device(device)


def process_count() -> int:
    """Processes in the default group (1 without one)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def is_multihost() -> bool:
    return process_count() > 1


def global_array(mesh, global_data, spec: Optional[Sequence[Optional[str]]] = None):
    """This rank's shard of a global batch (a numpy array or a tensor):
    dimension i is cut into ``mesh.shape[spec[i]]`` equal parts and this
    rank keeps part ``mesh.coords[spec[i]]`` (None, or a spec shorter than
    the array, keeps the dimension whole). ``spec`` defaults to the batch
    axis over ``data``, as the JAX package's ``global_array``. Raises when
    a dimension does not divide."""
    spec = ("data",) if spec is None else tuple(spec)
    index = []
    for dim, axis in enumerate(spec):
        if axis is None or mesh.shape[axis] == 1:
            index.append(slice(None))
            continue
        n, size = mesh.shape[axis], global_data.shape[dim]
        if size % n:
            raise ValueError(f"dimension {dim} ({size}) does not divide over mesh "
                             f"axis {axis!r} ({n})")
        part = size // n
        i = mesh.coords[axis]
        index.append(slice(i * part, (i + 1) * part))
    return global_data[tuple(index)]


def replicate_global(mesh, tree):
    """Broadcast every tensor leaf of ``tree`` from rank 0 in place, so
    that every rank holds rank 0's values (a no-op with one process).
    Returns ``tree``."""
    from deeplearning4j_tpu_torch.utils.tree import tree_leaves

    if process_count() == 1:
        return tree
    with torch.no_grad():
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                dist.broadcast(t, src=0)
    return tree
