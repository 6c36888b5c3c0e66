"""Scale-out over ``torch.distributed``: meshes, data and tensor
parallelism, multi-process initialisation and liveness (the counterpart
of ``arcle_tpu.parallel``).  NCCL on the card, Gloo on the CPU."""

from .mesh import (
    make_mesh, data_model_mesh, shard_leading, replicate, shard_params_tp,
)
from .multihost import (
    init_multihost, assert_all_processes_alive, MultihostInitTimeout,
    shard_global_leading, replicate_global,
)

__all__ = ["make_mesh", "data_model_mesh", "shard_leading", "replicate",
           "shard_params_tp", "init_multihost",
           "assert_all_processes_alive", "MultihostInitTimeout",
           "shard_global_leading", "replicate_global"]
