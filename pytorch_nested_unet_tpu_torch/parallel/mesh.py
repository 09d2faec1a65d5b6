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

Spatial partitioning ('x' over H, 'y' over W; the archs of SPATIAL_RULES:
UNet, NestedUNet under any --remat mode, the attention U-Nets, the CRDN
UNets with UNetRNNGhost and the dual-attention UNetRNNs, VGG16RNN, CA-Net,
the ResNet*RNN and ResNet50UNet backbones, DoubleUnet and the PSP hybrids):
each rank of a 'data' row holds a band of its images, rows
[i*H/X, (i+1)*H/X) and columns [j*W/Y, (j+1)*W/Y). Every stencil takes its
neighbours' edge rows first (`halo.halo_exchange`, which XLA inserts itself
under GSPMD), strided convs and the 3x3/2 pool too (`conv_halo`), the BN
moments are taken over every band of every data row
(the whole world), what attends or pools over the whole map takes the band
collectives of its data row (bands.py: an all-gather of keys and values, an
all-reduce of sums and maxima), channel dropout draws per data row, and the
heads are gathered (`halo.gather_bands`) so the loss and the metrics are the
whole image's. The gradients are then summed over the bands and averaged
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
from ..ops.layers import (JAX_KERNEL_TO_PORT, BatchNorm, ChannelDropout, Dropout, FlaxBatchNorm,
                          TorchConv, TorchConvTranspose)
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


# The archs that run on bands, each with (pools, halo): the count of its
# halvings (2x2 floor pools, stride-2 convs and 3x3/2 pools), so that H
# must be a multiple of 2**pools * x (and W of 2**pools * y) for every band
# to stay whole and even through them and every level to halve, and the
# widest halo a conv takes at its coarsest level, so that a band there must
# hold at least that many rows (and columns): `halo.halo_exchange` takes rows
# from the next band only. Every op of these archs is local on a band
# after a halo, or takes a band collective: convs that map a band onto its
# own output rows (`conv_halo`: stride-1 convs that keep the size, grouped
# ones too, the ResNet stems' 7x7/2, their blocks' 3x3/2 and 1x1/2, kernel =
# stride), 2x2 floor pools and the 3x3/2 pool (a halo of 1, -inf past the
# image's edge), BNs over the world (`sync_batch_norm`), 2x align-corners
# upsamples (a halo of 1), nearest 2x upsamples (none), the CRDN cell's carry
# resize, which is a 2x align-corners upsample where every level halves,
# half-pixel resizes by 2, 4 and 8 (a halo of 1: bands.py's `Bands.resize`),
# 2x2 stride-2 deconvs, and what attends or pools over the whole map (PAM,
# CAM, the non-local block, the grid gates' softmax, the SE and channel
# gates, PSP's adaptive pools and the resize of their bins: bands.py). The
# CRDN score blocks and VGG16RNN's are 5x5 convs (a halo of 2); UNetRNNGhost's
# are Ghost bottlenecks (1x1 and depthwise 3x3 convs, a halo of 1). CA-Net's
# non-local block pools its keys once more at its 3rd level, which the rule
# keeps even (H / (8x) of a multiple of 16x). The ResNet trunks halve 4 times
# (the 3x3/2 pool, layer2-4) and DoubleUnet 5 (its 7x7/2 stem too), 3x3
# convs at the coarsest level; the PSP hybrids take UNetRNN's 4 pools with
# its 5x5 score convs, whose 2 rows a band at 1/16 leave 4 at 1/8 for the
# refinement trunk's dilation-4 convs. An RDC's gate convs take
# kernel_size // 2 at the coarsest level, which `band_rule` reads off the
# built model.
_RESNET = {a: (4, 1) for a in ("ResNet18RNN", "ResNet34RNN", "ResNet50RNN", "ResNet101RNN",
                               "ResNet152RNN", "ResNet50UNet")}
SPATIAL_RULES = {"UNet": (4, 1), "NestedUNet": (4, 1), "AttU_Net": (4, 1), "R2U_Net": (4, 1),
                 "R2AttU_Net": (4, 1), "UNetRNN": (4, 2), "UNetRM3": (2, 2), "UNetRM7": (6, 2),
                 "UNetRNNGhost": (4, 1), "UNetRNNPAttention": (4, 2),
                 "UNetRNNCAttention": (4, 2), "UNetRNNAttention": (4, 2), "VGG16RNN": (4, 2),
                 "Comprehensive_Atten_Unet": (4, 1), **_RESNET, "DoubleUnet": (5, 1),
                 "UNetRNNPSP": (4, 2), "UNetRNNCAttention_PSP": (4, 2)}
QUEUED_ARCHS = ("ROADMAP.md queue 1, A11b a: ResNet50FCN (its classifier's valid 3x3 conv "
                "and nearest resizes at non-integer ratios) and DeepLab (ASPP's dilations "
                "wider than a band at 1/16, element-wise dropouts) wait on uneven and thin "
                "bands, A11b b")
QUEUED_DROPOUT = ("ROADMAP.md queue 1, A11b b: an element-wise dropout's mask on bands (the "
                  "whole image's draw cut to the band) is queued")
QUEUED_BANDS = "ROADMAP.md queue 1, A11b b: uneven and thin bands are queued"


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


def check_spatial(arch: str, hw=None, mesh_shape: Optional[Dict[str, int]] = None,
                  rule=None):
    """Raise ValueError unless `arch` can run under the 'x'/'y' axes: one of
    SPATIAL_RULES (any --remat mode of NestedUNet's), and, given the input
    size `hw` and the mesh's shape, by its rule (`rule`: the built model's,
    `band_rule`; default the table's): H a multiple of 2**pools * x and W of
    2**pools * y, and at the coarsest level a band of at least `halo` rows
    on 'x' and columns on 'y' (where split)."""
    if arch not in SPATIAL_RULES:
        raise ValueError(f"spatial partitioning ('x'/'y') is ported for "
                         f"{', '.join(SPATIAL_RULES)}, not {arch} ({QUEUED_ARCHS})")
    if hw is None:
        return
    pools, halo = rule or SPATIAL_RULES[arch]
    h, w = (int(v) for v in hw)
    nx, ny = (mesh_shape.get(a, 1) for a in SPATIAL_AXES)
    mx, my = (2 ** pools) * nx, (2 ** pools) * ny
    if h % mx or w % my:
        raise ValueError(f"input {h}x{w}: every band must stay whole and even through "
                         f"{arch}'s {pools} halvings, so H must be a multiple of {2 ** pools} * "
                         f"x = {mx} and W of {2 ** pools} * y = {my} ({QUEUED_BANDS})")
    rows, cols = h // mx, w // my
    if (nx > 1 and rows < halo) or (ny > 1 and cols < halo):
        raise ValueError(f"input {h}x{w}: {arch}'s coarsest level ({h >> pools}x{w >> pools}) "
                         f"leaves bands of {rows}x{cols} under {mesh_shape}, thinner than the "
                         f"halo of {halo} its convs take there ({QUEUED_BANDS})")


def band_rule(module: torch.nn.Module) -> Tuple[int, int]:
    """The band rule of a built model of SPATIAL_RULES, as `check_spatial`
    takes it: its halvings at the depth it was built with (`_pools`), and the
    table's coarsest halo, widened to its RDC's gate convs' (an option:
    kernel_size // 2)."""
    from ..models.rdc import RDC

    halo = SPATIAL_RULES[type(module).__name__][1]
    for cell in module.modules():
        if isinstance(cell, RDC):
            halo = max([halo] + [max(c.padding) for c in cell.modules()
                                 if isinstance(c, TorchConv)])
    return _pools(module), halo


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
    running variance's n / (n - 1) would change)."""
    for m in module.modules():
        if isinstance(m, (fused_bn.FusedBatchNormReLU, BatchNorm, FlaxBatchNorm)):
            m.process_group = mesh.batch_group
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
    """(rows, cols) of halo `conv` takes on `mesh`'s partitioned 'x'/'y'
    axes. A conv of kernel k, stride s, padding p and dilation d maps a band
    of n rows (n and the band's first row multiples of s) onto exactly its
    own n / s rows of the whole map's output iff d(k-1) + 1 - s <= 2p <=
    d(k-1): a stride-1 conv that keeps the size (2p = d(k-1)), the ResNet
    stems' 7x7/2 p3, their blocks' 3x3/2 p1 and 1x1/2 p0, kernel = stride
    without padding. Its windows reach p rows above the band and d(k-1) - p
    - s + 1 <= p below, so it takes a halo of p (none for kernel = stride)
    and runs without padding on that axis; a strided one also checks that
    its band divides by the stride (a pre-hook). Raises ValueError for any
    other conv on a partitioned axis (a valid conv, whose output rows no
    even cut of the bands holds)."""
    halo = []
    for axis, k, p, s, d in zip(SPATIAL_AXES, conv.weight.shape[2:], conv.padding,
                                conv.stride, conv.dilation):
        if not mesh.partitioned(axis):
            halo.append(0)
        elif d * (k - 1) + 1 - s <= 2 * p <= d * (k - 1):
            halo.append(p)
        else:
            raise ValueError(f"TorchConv (kernel {tuple(conv.weight.shape[2:])}, stride "
                             f"{conv.stride}, padding {conv.padding}) changes the size, so it "
                             f"cannot run on bands of the '{axis}' axis ({QUEUED_ARCHS})")
    return halo[0], halo[1]


def check_transposed_conv(conv: TorchConvTranspose, mesh):
    """Raise ValueError unless `conv` is local on bands of `mesh`'s
    partitioned axes: kernel = stride, no padding, no output padding (each
    input row makes its own `stride` output rows; CA-Net's 2x2 stride-2
    deconvs)."""
    for axis, k, p, op, s in zip(SPATIAL_AXES, conv.weight.shape[2:], conv.padding,
                                 conv.output_padding, conv.stride):
        if mesh.partitioned(axis) and (k != s or p or op):
            raise ValueError(f"TorchConvTranspose (kernel {tuple(conv.weight.shape[2:])}, "
                             f"stride {conv.stride}, padding {conv.padding}) overlaps its "
                             f"windows, so it cannot run on bands of the '{axis}' axis "
                             f"({QUEUED_ARCHS})")


def _check_strides(m, args):
    """Forward pre-hook of a strided conv on bands: the band must divide by
    the stride, so that it holds whole windows (kernel = stride) or its
    first row is an output row's centre."""
    h, w = args[0].shape[1:3]
    if h % m.stride[0] or w % m.stride[1]:
        raise ValueError(f"a {h}x{w} band does not divide by the stride {m.stride} of its "
                         f"conv, so the bands would not hold whole windows ({QUEUED_BANDS})")


def _give_halo(mesh, m, args):
    """Forward pre-hook: the input (a tensor, or a K4 node's parts) with the
    module's halo of the neighbours' rows and columns (a strided conv's
    band checked first)."""
    x, rows, cols = args[0], *m.halo
    if isinstance(m, TorchConv) and max(m.stride) > 1:
        _check_strides(m, args)
    if isinstance(x, torch.Tensor):
        return (halo_exchange(x, mesh, rows, cols),)
    return (tuple(halo_exchange(p, mesh, rows, cols) for p in x),)


def _give_carry_halo(mesh, m, args, kwargs):
    """Forward pre-hook (with kwargs) of the CRDN cell: where the carry (h,
    and c for the LSTM) is resized, i.e. is not the size of the level's
    score map, the carry with the cell's halo and `haloed=True`."""
    x, *carry = args
    if tuple(carry[0].shape[1:3]) == tuple(x.shape[1:3]):
        return None
    rows, cols = m.halo
    return (x, *(halo_exchange(c, mesh, rows, cols) for c in carry)), {**kwargs, "haloed": True}


_HALO_HOOKS = weakref.WeakKeyDictionary()  # module -> its halo hook's handle


def _pools(module: torch.nn.Module) -> int:
    """The halvings of a model of SPATIAL_RULES at the depth it was built
    with: the ResNet trunks' 3x3/2 pool and each of layer2-4 that holds a
    block, DoubleUnet's stem, pool and 3 strided groups; else one fewer than
    its levels: the attention U-Nets' `levels`, the CRDN UNets' (the PSP
    hybrids' too) and CA-Net's `filters` (a width a level), VGG16RNN's
    `STAGES`; UNet and NestedUNet have 5."""
    from ..models.crdn_backbones import _ResNetTrunk
    from ..models.double_unet import DoubleUnet

    if isinstance(module, _ResNetTrunk):
        return 1 + sum(len(getattr(module, f"layer{s}")) > 0 for s in (2, 3, 4))
    if isinstance(module, DoubleUnet):
        return 1 + len(module.layers)
    levels = (getattr(module, "levels", None) or len(getattr(module, "filters", ()))
              or len(getattr(module, "STAGES", ())) or 5)
    return levels - 1


def spatial_partition(module: torch.nn.Module, mesh: Optional[Mesh]):
    """Run `module` (an arch of SPATIAL_RULES; NestedUNet under any --remat
    mode) on this rank's band of `mesh`: every TorchConv, MultipartConv3x3
    (K4), Upsample2x and CRDN cell (`models.rdc.RDC`, for its carry's
    resize) gets a forward pre-hook that gives its input its halo
    (`halo.halo_exchange`), and the (rows, cols) of that halo and, for an
    upsample or a cell, the band's place as plain ints; a strided conv's
    pre-hook checks that its band divides by the stride; every module that
    declares `bands` (attention, global and adaptive pools, the 3x3/2 pool,
    the resizes of CA-Net, the ResNet decoders, DoubleUnet and the
    refinement net) gets a `bands.Bands` of the mesh. With None, on whole
    images again.
    Raises ValueError for another arch, a depth other than its rule's, an
    element-wise dropout that draws masks (channel dropout draws per data
    row, `sync_batch_norm`), or a conv or transposed conv that changes the
    size otherwise than locally."""
    if mesh is not None:
        arch = type(module).__name__
        check_spatial(arch)
        if _pools(module) != SPATIAL_RULES[arch][0]:
            raise ValueError(f"{arch} with {_pools(module)} pools: its band rule holds for "
                             f"{SPATIAL_RULES[arch][0]} ({QUEUED_BANDS})")
    put_on_bands(module, mesh)


def put_on_bands(module: torch.nn.Module, mesh: Optional[Mesh]):
    """`spatial_partition`'s hooks, halos, band places and `bands` on every
    module of `module` (any module: the band ops' tests put single blocks
    on bands), without an arch's band rule; with None, off again. Raises
    ValueError for an element-wise dropout that draws masks or a transposed
    conv whose windows overlap."""
    from ..models.blocks import MultipartConv3x3
    from ..models.rdc import RDC
    from .bands import Bands

    bands = None
    if mesh is not None:
        for m in module.modules():
            if isinstance(m, Dropout) and not isinstance(m, ChannelDropout) and m.p > 0:
                raise ValueError(f"{type(module).__name__} with an element-wise dropout on "
                                 f"({QUEUED_DROPOUT})")
            if isinstance(m, TorchConvTranspose):
                check_transposed_conv(m, mesh)
        bands = Bands(mesh)
    one = tuple(int(mesh.partitioned(a)) for a in SPATIAL_AXES) if mesh is not None else None
    for m in module.modules():
        if hasattr(type(m), "bands"):
            m.bands = bands
        if not isinstance(m, (TorchConv, MultipartConv3x3, Upsample2x, RDC)):
            continue
        handle = _HALO_HOOKS.pop(m, None)
        if handle is not None:
            handle.remove()
        m.halo = (0, 0)
        if isinstance(m, (Upsample2x, RDC)):
            m.band = ((0, 1), (0, 1))
        if mesh is None:
            continue
        m.halo = conv_halo(m, mesh) if isinstance(m, TorchConv) else one
        if isinstance(m, (Upsample2x, RDC)):
            m.band = (mesh.band_of("x"), mesh.band_of("y"))
        if m.halo == (0, 0):
            if isinstance(m, TorchConv) and any(
                    s > 1 and mesh.partitioned(a) for a, s in zip(SPATIAL_AXES, m.stride)):
                _HALO_HOOKS[m] = m.register_forward_pre_hook(_check_strides)
            continue
        if isinstance(m, RDC):
            _HALO_HOOKS[m] = m.register_forward_pre_hook(
                functools.partial(_give_carry_halo, mesh), with_kwargs=True)
        else:
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
