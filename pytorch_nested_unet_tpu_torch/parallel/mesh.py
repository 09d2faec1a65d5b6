"""The 'data', 'x' and 'y' axes of the JAX package's mesh (counterpart of
parallel/mesh.py and the mesh part of train.py:255-304).

Data parallel: every process holds the whole model and optimizer state
(replicated from rank 0), takes its rows of each global batch, and ends each
update with the gradients averaged across ranks. BN moments are global over
the sharded batch, as the JAX package's are under GSPMD: every train-mode BN
sums its rows, all-reduces the sums and normalizes with the global mean and
variance (K1 in its sums-only mode and `bn_finish` for `FusedBatchNormReLU`,
plain all-reduces for `BatchNorm` and `FlaxBatchNorm`), so an N-rank step
over a global batch B is the one-process step over B.

Spatial partitioning ('x' over H, 'y' over W; UNet and NestedUNet): each
rank of a 'data' row holds a band of its images, rows [i*H/X, (i+1)*H/X) and
columns [j*W/Y, (j+1)*W/Y). Every stencil takes its neighbours' edge rows
first (`halo.halo_exchange`, which XLA inserts itself under GSPMD), the BN
moments are taken over every band of every data row (the whole world), and
the heads are gathered (`halo.gather_bands`) so the loss and the metrics are
the whole image's. The gradients are then summed over the bands and averaged
over 'data': one all-reduce over the world divided by the 'data' size.

A `Mesh` lays the ranks of a `torch.distributed` group row-major over its
axis sizes in the order given, as the JAX package lays devices out
(`np.asarray(devices).reshape(axis_sizes)`). The JAX package's 'model' axis
(tensor-parallel state, `tensor_parallel_spec`, `state_shardings`) is not
ported yet (ROADMAP.md queue 1, A11c); `make_mesh` refuses it.
"""

import functools
import weakref
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops import fused_bn
from ..ops.layers import BatchNorm, Dropout, FlaxBatchNorm, TorchConv
from ..ops.resize import Upsample2x
from .halo import halo_exchange

PORTED_AXES = ("data", "x", "y")
SPATIAL_AXES = ("x", "y")  # H over 'x', W over 'y'
NOT_PORTED = ("the '{}' mesh axis is not ported (ROADMAP.md queue 1: A11c the 'model' "
              "axis and --checkpoint_backend)")
# Archs whose every op is right on a band after a one-row halo (3x3 and 1x1
# convs, 2x2 floor pools, 2x align-corners upsamples). Their 4 pools need
# bands of a multiple of 16 rows and columns.
SPATIAL_ARCHS = ("UNet", "NestedUNet")
SPATIAL_MULTIPLE = 16
SPATIAL_QUEUED = ("ROADMAP.md queue 1, A11b: the other archs, uneven bands and --remat under "
                  "the 'x'/'y' axes are queued")


class Mesh:
    """Ranks of `group` (None: one process, no collectives) laid row-major
    over `axis_sizes`. `shape` maps axis names to sizes, as a JAX mesh's
    does. Under 'x'/'y' it also holds two subgroups: `spatial_group`, the
    ranks that share this rank's 'data' index (its image's bands), and
    `data_group`, the ranks that hold the same band of other rows (None
    where that is this rank alone)."""

    def __init__(self, axis_names: Sequence[str], axis_sizes: Sequence[int], group=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in axis_sizes)))
        self.group = group
        self.rank = dist.get_rank(group) if group is not None else 0
        self.coords = self.coords_of(self.rank)
        self.data_group = group
        self.spatial_group = None
        # the ('x', 'y') band of each member of the spatial group, in its rank order
        self.spatial_coords = [self._band(self.coords)]
        if self.spatial and group is not None:
            self._spatial_groups()

    @property
    def size(self) -> int:
        """Ranks on the 'data' axis."""
        return self.shape.get("data", 1)

    @property
    def index(self) -> int:
        """This rank's index on the 'data' axis."""
        return self.coords.get("data", 0)

    @property
    def spatial(self) -> bool:
        """Whether H or W is partitioned ('x' or 'y' in the axes)."""
        return any(a in self.shape for a in SPATIAL_AXES)

    def partitioned(self, axis: str) -> bool:
        return self.shape.get(axis, 1) > 1

    def coords_of(self, rank: int) -> Dict[str, int]:
        sizes = [self.shape[a] for a in self.axis_names]
        return dict(zip(self.axis_names, (int(i) for i in np.unravel_index(rank, sizes))))

    def band_of(self, axis: str) -> Tuple[int, int]:
        """(this rank's band index, band count) on 'x' or 'y'."""
        return self.coords.get(axis, 0), self.shape.get(axis, 1)

    def neighbor(self, axis: str, step: int) -> Optional[int]:
        """The global rank holding the band `step` away on `axis` (same data
        row, same band on the other axis), or None past the image's edge."""
        i, n = self.band_of(axis)
        if not 0 <= i + step < n:
            return None
        coords = dict(self.coords, **{axis: i + step})
        sizes = [self.shape[a] for a in self.axis_names]
        return self._global(int(np.ravel_multi_index([coords[a] for a in self.axis_names],
                                                     sizes)))

    @staticmethod
    def _band(coords) -> Tuple[int, int]:
        return tuple(coords.get(a, 0) for a in SPATIAL_AXES)

    def _global(self, rank: int) -> int:
        return rank if self.group is None else dist.get_global_rank(self.group, rank)

    def _spatial_groups(self):
        """Every rank creates every subgroup in the same order
        (`new_group` is collective over the whole world)."""
        world = dist.get_world_size(self.group)
        spatial, data = {}, {}
        for r in range(world):
            c = self.coords_of(r)
            spatial.setdefault(c.get("data", 0), []).append(r)
            data.setdefault(self._band(c), []).append(r)
        mine_s, mine_d = self.index, self._band(self.coords)
        self.spatial_coords = [self._band(self.coords_of(r)) for r in spatial[mine_s]]
        self.spatial_group = self.data_group = None
        for kind, members, mine in (("spatial", spatial, mine_s), ("data", data, mine_d)):
            for key in sorted(members):
                ranks = members[key]
                if len(ranks) == 1:
                    continue
                g = (self.group if len(ranks) == world
                     else dist.new_group([self._global(r) for r in ranks]))
                if key == mine:
                    setattr(self, f"{kind}_group", g)


def make_mesh(axis_sizes: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("data",), group=None) -> Mesh:
    """A mesh over the ranks of `group` (default: the whole world when
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


@dataclass(frozen=True)
class Band:
    """This rank's share of a global (B, H, W, C) batch under 'x'/'y': its
    data rows, and its band's first row and column in the whole image, its
    height and width, and the whole image's."""
    rows: slice
    h0: int
    h: int
    w0: int
    w: int
    full_h: int
    full_w: int

    def take(self, t: torch.Tensor) -> torch.Tensor:
        """The band of (B, H, W, ...) images (all their rows)."""
        return t[:, self.h0:self.h0 + self.h, self.w0:self.w0 + self.w].contiguous()


def batch_sharding(mesh: Mesh, global_batch: int, spatial: bool = False, hw=None):
    """This rank's rows of a global batch (B over 'data'); with `spatial`,
    the `Band` of images of size `hw` = (H, W) it holds (H over 'x', W over
    'y'), as the JAX package's `batch_sharding(mesh, spatial)` lays it out.
    Raises ValueError when the batch or the image does not divide evenly."""
    if global_batch % mesh.size:
        raise ValueError(f"global batch {global_batch} not divisible by the mesh 'data' "
                         f"axis size {mesh.size}")
    per = global_batch // mesh.size
    rows = slice(mesh.index * per, (mesh.index + 1) * per)
    if not spatial:
        return rows
    full_h, full_w = (int(v) for v in hw)
    (i, nx), (j, ny) = mesh.band_of("x"), mesh.band_of("y")
    if full_h % nx or full_w % ny:
        raise ValueError(f"input {full_h}x{full_w} not divisible by the spatial mesh axes "
                         f"{mesh.shape}")
    h, w = full_h // nx, full_w // ny
    return Band(rows, i * h, h, j * w, w, full_h, full_w)


def check_spatial(arch: str, remat=None, hw=None, mesh_shape: Optional[Dict[str, int]] = None):
    """Raise ValueError unless `arch` can run under the 'x'/'y' axes: UNet or
    NestedUNet without remat, and (given the input size `hw` and the mesh's
    shape) every band whole through the 4 pools: H a multiple of 16 * x, W
    of 16 * y."""
    if arch not in SPATIAL_ARCHS:
        raise ValueError(f"spatial partitioning ('x'/'y') is ported for UNet and NestedUNet, "
                         f"not {arch} ({SPATIAL_QUEUED})")
    if remat not in (None, False, "none"):
        raise ValueError(f"--remat {remat} under the 'x'/'y' axes is not ported "
                         f"({SPATIAL_QUEUED})")
    if hw is None:
        return
    h, w = (int(v) for v in hw)
    mx, my = (SPATIAL_MULTIPLE * mesh_shape.get(a, 1) for a in SPATIAL_AXES)
    if h % mx or w % my:
        raise ValueError(f"input {h}x{w}: every band must stay whole through the 4 pools, so H "
                         f"must be a multiple of {SPATIAL_MULTIPLE} * x = {mx} and W of "
                         f"{SPATIAL_MULTIPLE} * y = {my} ({SPATIAL_QUEUED})")


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
    moments over every rank's rows (under 'x'/'y' every band of every row),
    dropout masks drawn for them all."""
    for m in module.modules():
        if isinstance(m, (fused_bn.FusedBatchNormReLU, BatchNorm, FlaxBatchNorm, Dropout)):
            m.process_group = mesh.group


def conv_halo(conv: TorchConv, mesh) -> Tuple[int, int]:
    """(rows, cols) of halo `conv` takes on `mesh`'s partitioned 'x'/'y'
    axes: padding * dilation, which a stride-1 conv that keeps the size
    has. Raises ValueError for any other conv on a partitioned axis."""
    halo = []
    for axis, k, p, s, d in zip(SPATIAL_AXES, conv.weight.shape[2:], conv.padding,
                                conv.stride, conv.dilation):
        if not mesh.partitioned(axis):
            halo.append(0)
            continue
        if s != 1 or (k - 1) * d != 2 * p:
            raise ValueError(f"TorchConv (kernel {tuple(conv.weight.shape[2:])}, stride "
                             f"{conv.stride}, padding {conv.padding}) changes the size, so it "
                             f"cannot run on bands of the '{axis}' axis")
        halo.append(p)
    return halo[0], halo[1]


def _give_halo(mesh, m, args):
    """Forward pre-hook: the input (a tensor, or a K4 node's parts) with the
    module's halo of the neighbours' rows and columns."""
    x, rows, cols = args[0], *m.halo
    if isinstance(x, torch.Tensor):
        return (halo_exchange(x, mesh, rows, cols),)
    return (tuple(halo_exchange(p, mesh, rows, cols) for p in x),)


_HALO_HOOKS = weakref.WeakKeyDictionary()  # module -> its _give_halo hook's handle


def spatial_partition(module: torch.nn.Module, mesh: Optional[Mesh]):
    """Run `module` (UNet or NestedUNet) on this rank's band of `mesh`:
    every TorchConv, MultipartConv3x3 (K4) and Upsample2x gets a forward
    pre-hook that gives its input its halo (`halo.halo_exchange`), and the
    (rows, cols) of that halo and, for an upsample, the band's place as
    plain ints. With None, on whole images again. Raises ValueError for
    another arch, a remat mode or a conv that changes the size."""
    from ..models.blocks import MultipartConv3x3

    if mesh is not None:
        check_spatial(type(module).__name__, getattr(module, "remat", None))
    one = tuple(int(mesh.partitioned(a)) for a in SPATIAL_AXES) if mesh is not None else None
    for m in module.modules():
        if not isinstance(m, (TorchConv, MultipartConv3x3, Upsample2x)):
            continue
        handle = _HALO_HOOKS.pop(m, None)
        if handle is not None:
            handle.remove()
        m.halo = (0, 0)
        if isinstance(m, Upsample2x):
            m.band = ((0, 1), (0, 1))
        if mesh is None:
            continue
        m.halo = conv_halo(m, mesh) if isinstance(m, TorchConv) else one
        if isinstance(m, Upsample2x):
            m.band = (mesh.band_of("x"), mesh.band_of("y"))
        if m.halo != (0, 0):
            _HALO_HOOKS[m] = m.register_forward_pre_hook(functools.partial(_give_halo, mesh))


@torch.no_grad()
def all_reduce_mean_(tensors: Sequence[torch.Tensor], mesh: Mesh):
    """Average `tensors` (one dtype and device) across the mesh's ranks in
    place, through one all-reduce of one flat buffer, so every rank adds them
    in the same order. The all-reduce runs over the whole group and the sum is
    divided by the 'data' size: under 'x'/'y' each rank of a data row holds
    its band's share of the gradient of the same loss, so the bands' shares
    are summed and the rows' gradients averaged."""
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
    rank's rows, under 'x'/'y' the model on bands (`spatial_partition`), and
    the optimizer's gradients all-reduced once per update
    (`training.optim.Optimizer`). The step itself takes this rank's rows, or
    its band of them (`training.loop.make_train_step(..., mesh=mesh)`)."""
    if mesh.spatial:
        spatial_partition(model, mesh)
    replicated_sharding(mesh, model)
    sync_batch_norm(model, mesh)
    optimizer.mesh = mesh
