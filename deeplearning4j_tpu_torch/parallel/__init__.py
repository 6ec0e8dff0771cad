"""Parallelism on torch.distributed (the PyTorch port of the JAX package's
``parallel/``): the process mesh, the active-mesh context, process-group
setup, ring attention over the ``seq`` axis and the sharded trainer over
``data x seq``. One process per card (SPMD): NCCL on CUDA devices, gloo on
the CPU. What is still to port (tensor and pipeline parallelism,
ParallelWrapper, gradient compression, elastic training) is ROADMAP
Queue 1 item 7."""

from deeplearning4j_tpu_torch.parallel.context import current_mesh, use_mesh
from deeplearning4j_tpu_torch.parallel.distributed import (
    global_array,
    init_distributed,
    is_multihost,
    process_count,
    replicate_global,
    shutdown_distributed,
)
from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, data_axis_size, make_mesh
from deeplearning4j_tpu_torch.parallel.ring import local_attention, ring_self_attention
from deeplearning4j_tpu_torch.parallel.tp import ShardedTrainer

__all__ = [
    "MeshSpec", "make_mesh", "data_axis_size", "use_mesh", "current_mesh",
    "ring_self_attention", "local_attention", "ShardedTrainer", "init_distributed",
    "shutdown_distributed", "process_count", "is_multihost", "global_array",
    "replicate_global",
]
