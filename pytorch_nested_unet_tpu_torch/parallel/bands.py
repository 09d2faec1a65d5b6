"""The band collectives of the archs that attend, pool or resize over the
whole map on the 'x'/'y' mesh axes (what GSPMD inserts in the JAX package
for a reduction over a partitioned dimension, or for an operand that every
partition reads whole).

`Bands(mesh)` is what a module that declares a `bands` attribute gets from
`parallel.mesh.spatial_partition` (None: the whole image): this rank's
band's place and the band collectives of its data row (`mesh.spatial_group`,
never the world), their adjoints written out (`torch.autograd.Function`s):

- `sum(t)`: the sum of every band's `t`, on every band. Every band consumes
  the same sum, so the adjoint all-reduces the gradients.
- `amax(x, dims)`: the whole map's max over `dims`. The gradient reaches the
  bands that hold the maximum and is split over every tied element of every
  band, as `amax` splits it in one process.
- `softmax(flat)`: a softmax over the whole map's flattened values from a
  band's: the global max (no gradient: a softmax is shift invariant), then
  the global sum of exponentials through `sum`.
- `gather(t)`: the whole (B, H, W, C) map from the bands, laid out as
  `halo.gather_bands` lays it out (the whole image's row-major order), for
  keys and values that each band reads with its own queries. Their gradient
  is the sum of every band's reading, cut to this band: an all-reduce and a
  slice (Gloo has no reduce-scatter). A band's attention energy is then
  (h*w) x (H*W) per image: 1/X of the one-process energy's memory on X
  bands, not less.
- `resize(x, out_hw, align_corners)`: the band's share of the whole map's
  bilinear upscale by an integer factor, from a one-row halo.

Under Gloo a CUDA tensor is staged through host memory, as `halo` stages
its exchanges; the bytes each rank sends and the host seconds are counted
in `halo.STATS` ("allgather_*", "allreduce_*").
"""

import time

import torch
import torch.distributed as dist

from ..ops.resize import resize_bilinear_band
from .halo import STATS, _gather, _staged, _wait, halo_exchange


def _all_reduce(t: torch.Tensor, mesh, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A new tensor: `t` all-reduced by `op` over the bands of this rank's
    data row."""
    t0 = time.perf_counter()
    group = mesh.spatial_group
    buf = t.detach().to("cpu", copy=True) if _staged(t, group) else t.detach().clone()
    _wait([dist.all_reduce(buf, op=op, group=group, async_op=True)], group)
    STATS["allreduce_bytes"] += buf.numel() * buf.element_size()
    STATS["allreduce_s"] += time.perf_counter() - t0
    return buf.to(t.device)


class _BandSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return _all_reduce(t, mesh)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh), None


class _BandMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dims):
        top = _all_reduce(x.detach().amax(dims, keepdim=True), mesh, dist.ReduceOp.MAX)
        hit = x.detach() == top
        count = _all_reduce(hit.sum(dims, keepdim=True).to(torch.float32), mesh)
        ctx.mesh = mesh
        ctx.save_for_backward(hit, count)
        return top

    @staticmethod
    def backward(ctx, g):
        hit, count = ctx.saved_tensors
        g = _all_reduce(g, ctx.mesh)
        return (g / count.to(g.dtype)) * hit, None, None


class _GatherKeys(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        ctx.band = (mesh.band_of("x")[0] * t.shape[1], t.shape[1],
                    mesh.band_of("y")[0] * t.shape[2], t.shape[2])
        return _gather(t, mesh, "allgather")

    @staticmethod
    def backward(ctx, g):
        h0, h, w0, w = ctx.band
        return _all_reduce(g, ctx.mesh)[:, h0:h0 + h, w0:w0 + w].contiguous(), None


class Bands:
    """This rank's band of every map and the band collectives of its data
    row (see the module docstring). `place` = ((i, nx), (j, ny)): the
    band's index and the band count on H and W; every level of a map keeps
    them (the band rule keeps the bands even). Without a spatial group (one
    band) each collective is the one-process op."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.place = (mesh.band_of("x"), mesh.band_of("y"))
        self.split = mesh.spatial_group is not None

    def full_hw(self, x: torch.Tensor):
        """(H, W) of the whole map of which x (B, h, w, C) is a band."""
        (_, nx), (_, ny) = self.place
        return x.shape[1] * nx, x.shape[2] * ny

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every band's `t`, on every band."""
        return _BandSum.apply(t, self.mesh) if self.split else t

    def amax(self, x: torch.Tensor, dims=(1, 2)) -> torch.Tensor:
        """`x.amax(dims)` of the whole map from this band's x (the reduced
        dims dropped), with `amax`'s gradient over every band's ties."""
        if not self.split:
            return x.amax(dim=dims)
        top = _BandMax.apply(x, self.mesh, tuple(dims))
        for d in sorted(dims, reverse=True):
            top = top.squeeze(d)
        return top

    def softmax(self, flat: torch.Tensor) -> torch.Tensor:
        """This band's (..., n) share of the softmax over the last dim of
        the whole map's flattened (..., N) values."""
        if not self.split:
            return torch.softmax(flat, dim=-1)
        top = _all_reduce(flat.detach().amax(-1, keepdim=True), self.mesh, dist.ReduceOp.MAX)
        e = torch.exp(flat - top)
        return e / self.sum(e.sum(-1, keepdim=True))

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The whole (B, H, W, C) map of keys or values from this band's,
        on every band; this band's gradient sums every band's reading."""
        return _GatherKeys.apply(t, self.mesh) if self.split else t

    def resize(self, x: torch.Tensor, out_hw, align_corners: bool) -> torch.Tensor:
        """This band's share of the whole map's bilinear resize of x's map
        to the size whose band is `out_hw`: an integer upscale per axis,
        with one row (column) of each neighbour's on a split axis that is
        resized (`resize_bilinear_band`)."""
        (i, nx), (j, ny) = self.place
        h, w = x.shape[1:3]
        out_h, out_w = (int(v) for v in out_hw)
        if out_h % h or out_w % w:
            raise ValueError(f"a bilinear resize of a {h}x{w} band to {out_h}x{out_w} is not an "
                             f"integer upscale, so it cannot run on bands")
        sh, sw = out_h // h, out_w // w
        rows, cols = int(nx > 1 and sh > 1), int(ny > 1 and sw > 1)
        return resize_bilinear_band(halo_exchange(x, self.mesh, rows, cols), i * h, nx * h,
                                    j * w, ny * w, sh, sw, rows, cols, align_corners)
