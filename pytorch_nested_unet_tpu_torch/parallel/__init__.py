"""Data parallelism over processes (counterpart of parallel/).

The JAX package shards the batch over a device mesh and lets GSPMD insert the
collectives; the port runs one process per device and makes them explicit:
the BN moment all-reduce inside K1-K3's sync path and the plain BNs, one
gradient all-reduce per update. See mesh.py and multihost.py.
"""

from .mesh import (Mesh, all_reduce_mean_, batch_sharding, make_mesh, parse_mesh_spec,
                   replicated_sharding, shard_train_step, sync_batch_norm)
from .multihost import (broadcast_object, global_batch_slice, initialize_distributed,
                        initialize_single_process, local_rank, make_global_array)

__all__ = ["Mesh", "make_mesh", "batch_sharding", "parse_mesh_spec", "replicated_sharding",
           "shard_train_step", "sync_batch_norm", "all_reduce_mean_",
           "initialize_distributed", "initialize_single_process", "local_rank",
           "global_batch_slice", "make_global_array", "broadcast_object"]
