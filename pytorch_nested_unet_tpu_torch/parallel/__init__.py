"""Data parallelism over processes (counterpart of parallel/).

The JAX package shards the batch over a device mesh and lets GSPMD insert the
collectives; the port runs one process per device and makes them explicit:
the BN moment all-reduce inside K1-K3's sync path and the plain BNs, one
gradient all-reduce per update, and under the 'model' axis one all-gather of
the sharded weights per step. See mesh.py and multihost.py.
"""

from .mesh import (Mesh, TensorParallel, all_reduce_mean_, batch_sharding, full_weights,
                   make_mesh, parse_mesh_spec, replicated_sharding, shard_train_step,
                   state_shardings, sync_batch_norm, tensor_parallel_of, tensor_parallel_spec)
from .multihost import (broadcast_object, global_batch_slice, initialize_distributed,
                        initialize_single_process, local_rank, make_global_array)

__all__ = ["Mesh", "make_mesh", "batch_sharding", "parse_mesh_spec", "replicated_sharding",
           "shard_train_step", "sync_batch_norm", "all_reduce_mean_", "TensorParallel",
           "state_shardings", "tensor_parallel_spec", "tensor_parallel_of", "full_weights",
           "initialize_distributed", "initialize_single_process", "local_rank",
           "global_batch_slice", "make_global_array", "broadcast_object"]
