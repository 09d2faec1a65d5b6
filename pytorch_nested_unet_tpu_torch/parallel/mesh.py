"""The data axis of the JAX package's mesh (counterpart of parallel/mesh.py).

Data parallel: every process holds the whole model and optimizer state
(replicated from rank 0), takes its rows of each global batch, and ends each
update with the gradients averaged across ranks. BN moments are global over
the sharded batch, as the JAX package's are under GSPMD: every train-mode BN
sums its rows, all-reduces the sums and normalizes with the global mean and
variance (K1 in its sums-only mode and `bn_finish` for `FusedBatchNormReLU`,
plain all-reduces for `BatchNorm` and `FlaxBatchNorm`), so an N-rank step
over a global batch B is the one-process step over B.

A `Mesh` here is a 1-D 'data' mesh over the processes of a
`torch.distributed` group. The JAX package's spatial axes ('x'/'y',
--spatial_partition) and its 'model' axis (tensor-parallel state,
`tensor_parallel_spec`, `state_shardings`) are not ported yet (ROADMAP.md
queue 1, A11b and A11c); `make_mesh` refuses them.
"""

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..ops import fused_bn
from ..ops.layers import BatchNorm, Dropout, FlaxBatchNorm

PORTED_AXES = ("data",)
NOT_PORTED = ("the '{}' mesh axis is not ported (ROADMAP.md queue 1: A11b the 'x'/'y' "
              "axes and --spatial_partition, A11c the 'model' axis)")


class Mesh:
    """A 'data' mesh over the ranks of `group` (None: one process, no
    collectives). `shape` maps axis names to sizes, as a JAX mesh's does."""

    def __init__(self, axis_names: Sequence[str], axis_sizes: Sequence[int], group=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in axis_sizes)))
        self.group = group

    @property
    def size(self) -> int:
        """Ranks on the 'data' axis."""
        return self.shape["data"]

    @property
    def index(self) -> int:
        """This rank's index on the 'data' axis."""
        return dist.get_rank(self.group) if self.group is not None else 0


def make_mesh(axis_sizes: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("data",), group=None) -> Mesh:
    """A 'data' mesh over the ranks of `group` (default: the whole world when
    torch.distributed is initialized, else this one process). Default sizes:
    one axis over every rank. Raises ValueError when the sizes do not cover
    the ranks or name an axis that is not ported."""
    if group is None and dist.is_initialized():
        group = dist.group.WORLD
    world = dist.get_world_size(group) if group is not None else 1
    if axis_sizes is None:
        axis_sizes = (world,)
    if len(axis_sizes) != len(axis_names):
        raise ValueError(f"mesh sizes {tuple(axis_sizes)} do not match axes {tuple(axis_names)}")
    for name in axis_names:
        if name not in PORTED_AXES:
            raise ValueError(NOT_PORTED.format(name))
    total = 1
    for s in axis_sizes:
        total *= int(s)
    if total != world:
        raise ValueError(f"mesh {tuple(axis_sizes)} needs {total} processes, have {world}")
    return Mesh(axis_names, axis_sizes, group)


def parse_mesh_spec(spec: str) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """Parse a CLI mesh spec like ``"data=4,x=2"`` into (names, sizes).

    Axis names are free-form but 'data' shards the batch dim and 'x'/'y' shard
    H/W (see batch_sharding). Sizes must be positive integers.
    """
    names, sizes = [], []
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"bad mesh axis {part!r} (want name=size, e.g. 'data=4,x=2')")
        name, _, size = part.partition("=")
        name = name.strip()
        try:
            size = int(size)
        except ValueError:
            raise ValueError(f"bad mesh axis size in {part!r}") from None
        if size < 1:
            raise ValueError(f"mesh axis {name!r} must have size >= 1, got {size}")
        if name in names:
            raise ValueError(f"duplicate mesh axis {name!r}")
        names.append(name)
        sizes.append(size)
    if not names:
        raise ValueError("empty mesh spec")
    return tuple(names), tuple(sizes)


def batch_sharding(mesh: Mesh, global_batch: int) -> slice:
    """This rank's rows of a global batch (B over 'data')."""
    if global_batch % mesh.size:
        raise ValueError(f"global batch {global_batch} not divisible by the mesh 'data' "
                         f"axis size {mesh.size}")
    per = global_batch // mesh.size
    return slice(mesh.index * per, (mesh.index + 1) * per)


@torch.no_grad()
def replicated_sharding(mesh: Mesh, module: torch.nn.Module):
    """Replicate `module`'s parameters and buffers: rank 0's values broadcast
    to every rank, in place."""
    if mesh.group is None:
        return
    src = dist.get_global_rank(mesh.group, 0)
    for t in module.state_dict().values():
        dist.broadcast(t, src=src, group=mesh.group)


def sync_batch_norm(module: torch.nn.Module, mesh: Mesh):
    """Put every BN (and dropout) of `module` on the mesh's group: train-mode
    moments over every rank's rows, dropout masks drawn for them all."""
    for m in module.modules():
        if isinstance(m, (fused_bn.FusedBatchNormReLU, BatchNorm, FlaxBatchNorm, Dropout)):
            m.process_group = mesh.group


@torch.no_grad()
def all_reduce_mean_(tensors: Sequence[torch.Tensor], mesh: Mesh):
    """Average `tensors` (one dtype and device) across the mesh's ranks in
    place, through one all-reduce of one flat buffer, so every rank adds them
    in the same order."""
    if mesh.group is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    flat.div_(mesh.size)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def shard_train_step(model: torch.nn.Module, optimizer, mesh: Mesh):
    """Put a train step's model and optimizer on the mesh: parameters and
    buffers replicated from rank 0, BN moments and dropout masks over every
    rank's rows, and the optimizer's gradients averaged across ranks once per
    update (`training.optim.Optimizer`). The step itself takes this rank's
    rows (`training.loop.make_train_step(..., mesh=mesh)`)."""
    replicated_sharding(mesh, model)
    sync_batch_norm(model, mesh)
    optimizer.mesh = mesh
