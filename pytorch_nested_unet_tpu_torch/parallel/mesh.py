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

Spatial partitioning ('x' over H, 'y' over W; every arch of the registry,
NestedUNet under any --remat mode): each rank of a 'data' row holds a band
of its images, and of every map its layers make: a map of n rows is cut
into rows [floor(i*n/X), floor((i+1)*n/X)) (`halo.cut`; likewise columns
over 'y'), so bands may be unequal or, where n < X, empty, as GSPMD pads
them in the JAX package, whose only rule is that X divides H and Y divides
W (`check_spatial`). Every op that maps a band computes exactly its own
output rows under its output map's cut and reads its input rows through
one primitive, `halo.fetch` (which XLA inserts itself under GSPMD): convs
of any kernel, stride, padding and dilation and the pools take the window
of their output rows (`bands.Bands.window`; a stride-1 conv that keeps the
size takes its band with p rows of each side, as a halo), transposed convs
of kernel = stride theirs (`Bands.deconv_window`), and resizes to any size
the rows they read (`Bands.resize`). The BN moments are taken over every
band of every data row (the whole world), each BN's count the whole map's
pixels over the batch group; what attends or pools over the whole map
takes the band collectives of its data row (bands.py: an all-gather of keys
and values, an all-reduce of sums and maxima, means as sums over the whole
map's count); a dropout draws its data rows' whole masks and keeps its
band's share; and the heads are gathered (`halo.gather_bands`) so the loss
and the metrics are the whole image's. The gradients are then summed over
the bands and averaged over 'data': one all-reduce over the world divided
by the 'data' size.

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
from ..ops.layers import (JAX_KERNEL_TO_PORT, BatchNorm, Dropout, FlaxBatchNorm, TorchConv,
                          TorchConvTranspose)
from .halo import cut

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
    height and width (`halo.cut`: they may differ between bands), and the
    whole image's."""
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
    the `Band` of images of size `hw` = (H, W) it holds (H cut over 'x', W
    over 'y'), as the JAX package's `batch_sharding(mesh, spatial)` lays it
    out. Raises ValueError when the batch does not divide over 'data' or the
    image over the spatial axes (the JAX rule)."""
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
    ch, cw = cut(full_h, nx), cut(full_w, ny)
    return Band(rows, ch[i], ch[i + 1] - ch[i], cw[j], cw[j + 1] - cw[j], full_h, full_w)


def check_spatial(arch: str, hw=None, mesh_shape: Optional[Dict[str, int]] = None):
    """Raise ValueError unless `arch` can run under the 'x'/'y' axes at the
    input size `hw` (when given) on a mesh of `mesh_shape`: the JAX CLI's
    rule (train.py:299-302), an arch of the registry, H a multiple of x and
    W of y. Every arch, any --remat mode and any such size runs on bands
    wherever its one-process step runs at that size."""
    from ..models import arch_names

    if arch not in arch_names():
        raise ValueError(f"unknown arch {arch!r}")
    if hw is None:
        return
    h, w = (int(v) for v in hw)
    nx, ny = (mesh_shape.get(a, 1) for a in SPATIAL_AXES)
    if h % nx or w % ny:
        raise ValueError(f"input {h}x{w} not divisible by the spatial mesh axes {mesh_shape}: "
                         f"H must be a multiple of x = {nx} and W of y = {ny}")


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
    """Put every BN of `module` on the mesh's batch group: train-mode
    moments over every rank's rows (under 'x'/'y' every band of every row);
    and every dropout on its data group: masks drawn for every data row's
    rows, this rank's kept, so the bands of one data row drop alike (off
    'x'/'y' the data group is the batch group). The 'model' peers hold the
    same rows, so they stay out (each row would count twice, and the
    running variance's n / (n - 1) would change). A BN marked `whole_map`
    (ASPP's pooled branch: a map every band holds whole) goes on the data
    group."""
    for m in module.modules():
        if isinstance(m, (fused_bn.FusedBatchNormReLU, BatchNorm, FlaxBatchNorm)):
            # a BN over a map that every band holds whole (a pooled branch)
            # takes the data rows' moments: each band has them all
            m.process_group = mesh.data_group if getattr(m, "whole_map", False) \
                else mesh.batch_group
        elif isinstance(m, Dropout):
            m.process_group = mesh.data_group


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
    """(rows, cols): `conv`'s padding on each of `mesh`'s partitioned 'x'/'y'
    axes, 0 elsewhere. On such an axis the conv reads the window of its
    output rows (`bands.Bands.window`: a stride-1 conv that keeps the size
    its band with p rows of each side) and runs without its padding; the
    window's rows past the map's edge are zeros."""
    return tuple(p if mesh.partitioned(a) else 0 for a, p in zip(SPATIAL_AXES, conv.padding))


def check_transposed_conv(conv: TorchConvTranspose, mesh):
    """Raise ValueError unless `conv` maps bands of `mesh`'s partitioned
    axes: kernel = stride, no padding, no output padding (each input row
    makes its own `stride` output rows; CA-Net's and ResNet50UNet's 2x2
    stride-2 deconvs), whose band reads the window of its output rows."""
    for axis, k, p, op, s in zip(SPATIAL_AXES, conv.weight.shape[2:], conv.padding,
                                 conv.output_padding, conv.stride):
        if mesh.partitioned(axis) and (k != s or p or op):
            raise ValueError(f"TorchConvTranspose (kernel {tuple(conv.weight.shape[2:])}, "
                             f"stride {conv.stride}, padding {conv.padding}) overlaps its "
                             f"windows, so it cannot run on bands of the '{axis}' axis")


def _local(m: TorchConv, mesh) -> bool:
    """Whether a conv maps each band onto its own rows without reading any
    other: kernel 1, stride 1, no padding on every partitioned axis."""
    return all(k == 1 and s == 1 and p == 0 or not mesh.partitioned(a)
               for a, k, s, p in zip(SPATIAL_AXES, m.weight.shape[2:], m.stride, m.padding))


def _give_window(bands, m, args):
    """Forward pre-hook: the input (a tensor, or a K4 node's parts) as the
    window of the module's output rows on each split axis; for a transposed
    conv also the output rows to drop (`crop`)."""
    x = args[0]
    if isinstance(m, TorchConvTranspose):
        x, m.crop = bands.deconv_window(x, m.stride)
        return (x,)
    if isinstance(m, TorchConv):
        return (bands.window(x, m.weight.shape[2:], m.stride, m.padding, m.dilation),)
    return (tuple(bands.window(p, (3, 3), (1, 1), (1, 1), (1, 1)) for p in x),)


_HALO_HOOKS = weakref.WeakKeyDictionary()  # module -> its window hook's handle
_BANDS = weakref.WeakKeyDictionary()  # module put on bands -> its bands.Bands


def bands_of(module: torch.nn.Module):
    """The `bands.Bands` that `put_on_bands` gave `module` last (None off
    bands): a step runs inside its `step`."""
    return _BANDS.get(module)


def spatial_partition(module: torch.nn.Module, mesh: Optional[Mesh]):
    """Run `module` (any arch of the registry; NestedUNet under any --remat
    mode) on this rank's band of `mesh`; see `put_on_bands`. With None, on
    whole images again. Raises ValueError for an arch the registry does not
    hold."""
    if mesh is not None:
        check_spatial(type(module).__name__)
    put_on_bands(module, mesh)


def put_on_bands(module: torch.nn.Module, mesh: Optional[Mesh]):
    """Put `module` (any module: the band ops' tests put single blocks on
    bands) on this rank's band of `mesh`: a `bands.Bands` of the mesh on
    every module that declares `bands` (the BNs, dropouts, resizes, pools,
    attention and the models that pool), a forward pre-hook on every conv
    that reads other rows than its own (all but 1x1 stride-1 convs),
    transposed conv and MultipartConv3x3 (K4) that gives its input the
    window of its output rows (`halo.fetch`), with `halo` = (rows, cols) the
    padding it then leaves out; `bands_of(module)` is that Bands. With
    None, off again. Raises ValueError for a transposed conv whose windows
    overlap."""
    from ..models.blocks import MultipartConv3x3
    from .bands import Bands

    bands = None
    if mesh is not None:
        for m in module.modules():
            if isinstance(m, TorchConvTranspose):
                check_transposed_conv(m, mesh)
        bands = _BANDS[module] = Bands(mesh)
    else:
        _BANDS.pop(module, None)
    one = tuple(int(mesh.partitioned(a)) for a in SPATIAL_AXES) if mesh is not None else None
    for m in module.modules():
        if hasattr(type(m), "bands"):
            m.bands = bands
        handle = _HALO_HOOKS.pop(m, None)
        if handle is not None:
            handle.remove()
        if isinstance(m, TorchConvTranspose):
            m.crop = (0, 0, 0, 0)
        elif isinstance(m, (TorchConv, MultipartConv3x3)):
            m.halo = (0, 0)
        if mesh is None:
            continue
        hook = None
        if any(mesh.partitioned(a) for a in SPATIAL_AXES):
            if isinstance(m, TorchConv):
                m.halo = conv_halo(m, mesh)
                hook = None if _local(m, mesh) else _give_window
            elif isinstance(m, MultipartConv3x3):
                m.halo, hook = one, _give_window
            elif isinstance(m, TorchConvTranspose) and any(
                    s > 1 and mesh.partitioned(a) for a, s in zip(SPATIAL_AXES, m.stride)):
                hook = _give_window
        if hook is not None:
            _HALO_HOOKS[m] = m.register_forward_pre_hook(functools.partial(hook, bands))


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
    buffers replicated from rank 0, BN moments over the batch group's rows
    and dropout masks over the data group's (`sync_batch_norm`), under
    'x'/'y' the model on bands (`spatial_partition`), the optimizer's
    gradients all-reduced once per update (`training.optim.Optimizer`), and
    under 'model' the state
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
