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

The 'model' axis (tensor-parallel state, the JAX package's
`tensor_parallel_spec` and `state_shardings`): between steps each rank holds
only its out-channel slice of every weight the JAX rule shards (a conv or
dense kernel of at least `min_shardable` elements whose out-channel count
the 'model' size divides) and of that weight's optimizer state; everything
else is replicated. A train step gathers the weights over the 'model' peers
first (`TensorParallel.gather`), so every op, K1-K4 among them, computes
what it computes without the axis, and frees them after the update; the
optimizer steps the slices (training/optim.py). The 'model' peers hold the
same rows and bands: BN moments, dropout masks, the gradient average and the
metrics run over the batch group (the ranks of this rank's 'model'
coordinate), so a step's numbers are those of the mesh without 'model'. The
peers would compute them alike only where every op rounds alike on every
rank, which a card's backward (the upsample's atomics) does not promise: so
the averaged gradients, the running statistics and the metrics are then
taken from the peer at 'model' coordinate 0 (`agree_over_model_`), and every
peer updates the replicated weights and takes each decision (best model,
early stop, LR plateau) from the same bits.

A `Mesh` lays the ranks of a `torch.distributed` group row-major over its
axis sizes in the order given, as the JAX package lays devices out
(`np.asarray(devices).reshape(axis_sizes)`).
"""

import contextlib
import functools
import weakref
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops import fused_bn
from ..ops.layers import JAX_KERNEL_TO_PORT, BatchNorm, Dropout, FlaxBatchNorm, TorchConv
from ..ops.resize import Upsample2x
from .halo import halo_exchange

PORTED_AXES = ("data", "x", "y", "model")
SPATIAL_AXES = ("x", "y")  # H over 'x', W over 'y'
NOT_PORTED = "the '{}' mesh axis is not ported (the axes are " + ", ".join(
    f"'{a}'" for a in PORTED_AXES) + ")"
MIN_SHARDABLE = 16384  # the JAX package's tensor_parallel_spec default
NOTHING_SHARDED = ("the 'model' axis (size {}) shards nothing in this arch — no kernel has "
                   "out-channels divisible by it (or all are below the shardable size); drop "
                   "the axis or change its size")


class NothingSharded(ValueError):
    """A 'model' axis that shards none of the model's weights."""


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
    does. Under 'model' it holds two subgroups: `model_group`, the ranks
    that differ from this one only in the 'model' coordinate (they hold
    the slices of one weight), and `batch_group`, the ranks of this rank's
    'model' coordinate (BN moments, dropout masks, the gradient average).
    Under 'x'/'y' it holds two more, both within the batch group:
    `spatial_group`, the ranks that share this rank's 'data' index (its
    image's bands), and `data_group`, the ranks that hold the same band of
    other rows (the metrics' sums). A subgroup that is this rank alone is
    None. `min_shardable` is the 'model' axis' smallest sharded weight."""

    def __init__(self, axis_names: Sequence[str], axis_sizes: Sequence[int], group=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in axis_sizes)))
        self.group = group
        self.rank = dist.get_rank(group) if group is not None else 0
        self.coords = self.coords_of(self.rank)
        self.batch_group = self.data_group = group
        self.model_group = self.spatial_group = None
        self.model_root = None  # the global rank of this rank's peer at 'model' coordinate 0
        # the ('x', 'y') band of each member of the spatial group, in its rank order
        self.spatial_coords = [self._band(self.coords)]
        self.min_shardable = MIN_SHARDABLE
        self._device_mesh = None
        if (self.spatial or self.tensor_parallel) and group is not None:
            self._subgroups()

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

    @property
    def tensor_parallel(self) -> bool:
        """Whether the state is sharded over a 'model' axis."""
        return "model" in self.shape

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

    def _subgroups(self):
        """Every rank creates every subgroup in the same order (`new_group`
        is collective over the whole world): the 'model' peers, the batch
        groups, then under 'x'/'y' the bands of a data row and the rows of a
        band, each keyed by the coordinates its members share."""
        model = lambda c: c.get("model", 0)  # noqa: E731
        kinds = []
        if self.tensor_parallel:
            kinds += [("model", lambda c: tuple(v for a, v in c.items() if a != "model")),
                      ("batch", model)]
        if self.spatial:
            kinds += [("spatial", lambda c: (c.get("data", 0), model(c))),
                      ("data", lambda c: (self._band(c), model(c)))]
        world = dist.get_world_size(self.group)
        for kind, key_of in kinds:
            members = {}
            for r in range(world):
                members.setdefault(key_of(self.coords_of(r)), []).append(r)
            mine = key_of(self.coords)
            setattr(self, f"{kind}_group", None)
            for key in sorted(members):
                ranks = members[key]
                if len(ranks) == 1:
                    continue
                g = (self.group if len(ranks) == world
                     else dist.new_group([self._global(r) for r in ranks]))
                if key == mine:
                    setattr(self, f"{kind}_group", g)
            if kind == "model":
                # row-major: the peer with the lowest rank is at 'model' coordinate 0
                self.model_root = self._global(members[mine][0])
            if kind == "spatial":
                self.spatial_coords = [self._band(self.coords_of(r)) for r in members[mine]]
        if not self.spatial:
            self.data_group = self.batch_group

    def device_mesh(self, device_type: str):
        """This mesh as a `torch.distributed` DeviceMesh of the same shape
        and axis names (the DTensor layout of the sharded checkpoints),
        made at the first call on every rank (it creates groups of its
        own). The mesh must span the whole world."""
        if self._device_mesh is None:
            from torch.distributed.device_mesh import init_device_mesh

            self._device_mesh = init_device_mesh(
                device_type, tuple(self.shape[a] for a in self.axis_names),
                mesh_dim_names=self.axis_names)
        return self._device_mesh


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
    """Put every BN (and dropout) of `module` on the mesh's batch group:
    train-mode moments over every rank's rows (under 'x'/'y' every band of
    every row), dropout masks drawn for them all. The 'model' peers hold the
    same rows, so they stay out (each row would count twice, and the
    running variance's n / (n - 1) would change)."""
    for m in module.modules():
        if isinstance(m, (fused_bn.FusedBatchNormReLU, BatchNorm, FlaxBatchNorm, Dropout)):
            m.process_group = mesh.batch_group


def tensor_parallel_spec(param: torch.Tensor, tp: int,
                         min_shardable: int = MIN_SHARDABLE) -> Optional[int]:
    """The dim of the port's tensor `param` that a 'model' axis of size `tp`
    shards, or None (replicated): the JAX package's `tensor_parallel_spec`
    on the JAX leaf that the tensor is. A conv (4-D) or dense (2-D) kernel of
    at least `min_shardable` elements shards its last JAX axis when `tp`
    divides it; that axis is the port weight's dim
    `JAX_KERNEL_TO_PORT[rank].index(rank - 1)`: 0 of an OIHW conv weight,
    of K4's weight and of an [out, in] dense weight, and 0 of a transposed
    conv's [in, out, kh, kw] too, whose JAX kernel is (kh, kw, out, in), so
    that the JAX rule splits its in-channels."""
    perm = JAX_KERNEL_TO_PORT.get(param.dim())
    if perm is None or param.numel() < min_shardable:
        return None
    dim = perm.index(param.dim() - 1)
    return dim if param.shape[dim] % tp == 0 else None


def state_shardings(module: torch.nn.Module, optimizer, tp: int,
                    min_shardable: int = MIN_SHARDABLE) -> Tuple[Dict[str, int], int]:
    """What a 'model' axis of size `tp` shards of `module`'s train state (the
    JAX package's `state_shardings` over a TrainState): ({parameter name:
    dim} of the sharded weights, N), N the sharded leaves the JAX package
    counts and prints: each weight and its optimizer state's leaves of its
    shape (`optimizer.param_shaped_leaves()`: SGD's momentum, Adam's two
    moments, MultiSteps' accumulator, which the port keeps whole)."""
    dims = {}
    for name, p in module.named_parameters():
        d = tensor_parallel_spec(p, tp, min_shardable)
        if d is not None:
            dims[name] = d
    return dims, len(dims) * (1 + optimizer.param_shaped_leaves())


class TensorParallel:
    """A module's weights on the 'model' axis: for each weight `dims` names,
    this rank's slice (`shards`; the block of the sharded dim that the JAX
    package's layout gives this rank's 'model' coordinate), which the
    optimizer steps (training/optim.py), and the weight itself either freed
    (`free`: its storage resized to 0 bytes; a forward then raises) or
    whole (`gather`: one all-gather of every slice over the 'model' peers).
    A gather writes the weights in place, so their version counters move
    (K4's packed weight is made again). `count`: the sharded leaves of the
    train state as the JAX package counts them (`state_shardings`' N)."""

    def __init__(self, module: torch.nn.Module, mesh: Mesh, dims: Dict[str, int],
                 count: Optional[int] = None):
        self.mesh, self.group, self.count = mesh, mesh.model_group, count
        self.size, self.index = mesh.shape["model"], mesh.coords["model"]
        named = dict(module.named_parameters())
        self.dims = {named[n]: d for n, d in dims.items()}
        self.names = {named[n]: n for n in dims}
        with torch.no_grad():
            self.shards = {p: self.rows(p.detach(), d).clone() for p, d in self.dims.items()}
        self.freed = False
        module.register_forward_pre_hook(self._check)

    def rows(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of `t` along `dim` (a view)."""
        n = t.shape[dim] // self.size
        return t.narrow(dim, self.index * n, n)

    def _check(self, module, args):
        if self.freed:
            raise RuntimeError("the 'model' axis' weights are freed between steps: gather them "
                               "first (parallel.mesh.full_weights)")

    @torch.no_grad()
    def take_rows(self):
        """Each slice from its whole weight (every rank holds the same)."""
        for p, shard in self.shards.items():
            shard.copy_(self.rows(p, self.dims[p]))

    @torch.no_grad()
    def free(self):
        """Drop the whole weights and their gradients: between steps a rank
        holds the slices alone, as the JAX layout does."""
        for p, shard in self.shards.items():
            p.grad = shard.grad = None  # a slice's gradient is a view of the whole one
            p.untyped_storage().resize_(0)
        self.freed = True

    @torch.no_grad()
    def materialize(self):
        """The whole weights' storage back, its contents undefined."""
        for p in self.dims:
            p.untyped_storage().resize_(p.numel() * p.element_size())
        self.freed = False

    @torch.no_grad()
    def gather(self):
        """The whole weights from every peer's slices (a no-op when whole)."""
        if not self.freed:
            return
        self.materialize()
        for p, whole in zip(self.dims, self.all_gather(list(self.shards.values()),
                                                       list(self.dims.values()))):
            p.copy_(whole)

    def all_gather(self, shards: Sequence[torch.Tensor], dims: Sequence[int]):
        """The whole tensors of this rank's `shards` (each a block of its dim
        in `dims`) from the 'model' peers' blocks: one all-gather of one
        flat buffer (staged through host memory for CUDA tensors on Gloo),
        each peer's block put back at its place along the dim."""
        if self.group is None or not shards:
            return list(shards)
        flat = torch.cat([s.reshape(-1) for s in shards])
        staged = flat.device.type != "cpu" and dist.get_backend(self.group) == "gloo"
        src = flat.cpu() if staged else flat
        parts = torch.empty((self.size, src.numel()), dtype=src.dtype, device=src.device)
        dist.all_gather(list(parts.unbind(0)), src, group=self.group)
        parts = parts.to(flat.device)
        out, offset = [], 0
        for s, d in zip(shards, dims):
            blocks = parts[:, offset:offset + s.numel()].reshape(self.size, *s.shape)
            out.append(torch.cat(blocks.unbind(0), d))
            offset += s.numel()
        return out


_TENSOR_PARALLEL = weakref.WeakKeyDictionary()  # module -> its TensorParallel


def tensor_parallel_of(module: torch.nn.Module) -> Optional[TensorParallel]:
    """`module`'s TensorParallel, or None off the 'model' axis."""
    return _TENSOR_PARALLEL.get(module)


@contextlib.contextmanager
def full_weights(module: torch.nn.Module):
    """`module` with its weights whole inside the block: on the 'model' axis
    with the weights freed, gathered first and freed after (a collective
    every 'model' peer enters); otherwise nothing to do."""
    tp = tensor_parallel_of(module)
    if tp is None or not tp.freed:
        yield
        return
    tp.gather()
    try:
        yield
    finally:
        tp.free()


def load_full_state(module: torch.nn.Module, state):
    """Load a whole (unsharded) state dict into `module`, strict; on the
    'model' axis each rank then keeps its slices of the sharded weights (no
    collective: every rank holds the whole state)."""
    tp = tensor_parallel_of(module)
    if tp is None:
        module.load_state_dict(state, strict=True)
        return
    freed = tp.freed
    tp.materialize()
    module.load_state_dict(state, strict=True)
    tp.take_rows()
    if freed:
        tp.free()


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
def _through_flat(tensors: Sequence[torch.Tensor], collective):
    """Run `collective` on one flat buffer of `tensors` (one dtype and
    device), then copy the result back into them."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    collective(flat)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def all_reduce_mean_(tensors: Sequence[torch.Tensor], mesh: Mesh):
    """Average `tensors` (one dtype and device) across the mesh's ranks in
    place, through one all-reduce of one flat buffer, so every rank adds them
    in the same order. The all-reduce runs over the batch group (the whole
    group off the 'model' axis) and the sum is divided by the 'data' size:
    under 'x'/'y' each rank of a data row holds its band's share of the
    gradient of the same loss, so the bands' shares are summed and the rows'
    gradients averaged. On a 'model' axis the average is then the one of the
    peer at coordinate 0 (`agree_over_model_`)."""
    if not tensors or (mesh.batch_group is None and mesh.model_group is None):
        return

    def mean(flat):
        if mesh.batch_group is not None:
            dist.all_reduce(flat, group=mesh.batch_group)
            flat.div_(mesh.size)
        _broadcast_from_model_root(flat, mesh)

    _through_flat(tensors, mean)


def _broadcast_from_model_root(flat: torch.Tensor, mesh: Mesh):
    if mesh.model_group is not None:
        dist.broadcast(flat, src=mesh.model_root, group=mesh.model_group)


@torch.no_grad()
def agree_over_model_(tensors: Sequence[torch.Tensor], mesh: Optional[Mesh]):
    """On a 'model' axis, make `tensors` bitwise those of this rank's peer at
    'model' coordinate 0: one broadcast over the 'model' peers per dtype and
    device. The peers hold the same rows, but a card need not round their
    computations alike, and each peer keeps its own copy of the replicated
    state and takes its own decisions from the metrics. A no-op elsewhere."""
    if mesh is None or mesh.model_group is None:
        return
    kinds = {}
    for t in tensors:
        kinds.setdefault((t.dtype, t.device), []).append(t)
    for same in kinds.values():
        _through_flat(same, functools.partial(_broadcast_from_model_root, mesh=mesh))


def shard_train_step(model: torch.nn.Module, optimizer, mesh: Mesh) -> Optional[TensorParallel]:
    """Put a train step's model and optimizer on the mesh: parameters and
    buffers replicated from rank 0, BN moments and dropout masks over the
    batch group's rows, under 'x'/'y' the model on bands
    (`spatial_partition`), the optimizer's gradients all-reduced once per
    update (`training.optim.Optimizer`), and under 'model' the state
    sharded (`state_shardings`; each rank keeps its slices of the rank 0
    weights and of their optimizer state, the weights freed until the step
    gathers them). The step itself takes this rank's rows, or its band of
    them (`training.loop.make_train_step(..., mesh=mesh)`). Returns the
    model's TensorParallel (its `count` the JAX package's N), or None off
    the 'model' axis. Raises NothingSharded (a ValueError) when the 'model'
    axis shards nothing, ValueError when the model is on one already."""
    if tensor_parallel_of(model) is not None:
        raise ValueError("the model's state is sharded over a 'model' axis already")
    dims = count = None
    if mesh.tensor_parallel:
        dims, count = state_shardings(model, optimizer, mesh.shape["model"], mesh.min_shardable)
        if not dims:
            raise NothingSharded(NOTHING_SHARDED.format(mesh.shape["model"]))
    if mesh.spatial:
        spatial_partition(model, mesh)
    replicated_sharding(mesh, model)
    sync_batch_norm(model, mesh)
    optimizer.mesh = mesh
    if not dims:
        return None
    tp = _TENSOR_PARALLEL[model] = TensorParallel(model, mesh, dims, count)
    optimizer.shard(tp)
    tp.free()
    return tp
