"""Parallelism on torch.distributed (the PyTorch port of the JAX package's
``parallel/``): the process mesh and its sub-groups, the active-mesh
context, process-group setup, the collectives every parallel path goes
through (``comm``), tensor and expert parallelism and the sharded trainer
over ``data x model x seq`` (``tp``), ring attention over ``seq``, the
compressed and sharded gradient exchange (``compress``, ``grads``),
ParallelWrapper, the named-mesh trainer, GPipe and the pipeline runner,
ParallelInference, and the elastic runtime's membership (``elastic``:
leases, views, the FileStore) and its TCP store (``netstore``); the
elastic trainer is ``train/elastic.py``. One process per rank (SPMD):
NCCL on CUDA devices, gloo on the CPU (or, asked for, between ranks that
share a card); elastic workers exchange through the store instead."""

from deeplearning4j_tpu_torch.parallel.compress import (
    decode_gathered,
    encode_packed,
    pack_ternary,
    packed_nbytes,
    threshold_decode,
    threshold_encode,
    unpack_ternary,
)
from deeplearning4j_tpu_torch.parallel.context import current_mesh, use_mesh
from deeplearning4j_tpu_torch.parallel.distributed import (
    global_array,
    init_distributed,
    is_multihost,
    process_count,
    replicate_global,
    shutdown_distributed,
)
from deeplearning4j_tpu_torch.parallel.elastic import (
    ElasticRuntime,
    FileStore,
    Membership,
    MembershipChanged,
    View,
)
from deeplearning4j_tpu_torch.parallel.gpipe import GPipeTrainer
from deeplearning4j_tpu_torch.parallel.grads import DataParallelStep, GradExchange
from deeplearning4j_tpu_torch.parallel.inference import ParallelInference
from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, data_axis_size, make_mesh
from deeplearning4j_tpu_torch.parallel.mesh_step import MeshTrainer, shard_update_spec
from deeplearning4j_tpu_torch.parallel.pipeline import PipelineParallel, stack_stage_params
from deeplearning4j_tpu_torch.parallel.ring import local_attention, ring_self_attention
from deeplearning4j_tpu_torch.parallel.tp import ShardedTrainer, tp_param_shardings
from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper

__all__ = [
    "MeshSpec", "make_mesh", "ParallelWrapper", "ParallelInference",
    "current_mesh", "use_mesh", "local_attention", "ring_self_attention",
    "GPipeTrainer", "PipelineParallel", "stack_stage_params", "ShardedTrainer",
    "tp_param_shardings", "init_distributed", "shutdown_distributed",
    "is_multihost", "global_array", "replicate_global", "process_count",
    "DataParallelStep", "GradExchange", "data_axis_size",
    "MeshTrainer", "shard_update_spec",
    "threshold_encode", "threshold_decode", "pack_ternary", "unpack_ternary",
    "encode_packed", "decode_gathered", "packed_nbytes",
    "ElasticRuntime", "FileStore", "Membership", "MembershipChanged", "View",
]
