"""The band geometry and the band collectives of a model on the 'x'/'y' mesh
axes (what GSPMD inserts in the JAX package for a partitioned convolution,
pool or resize, for a reduction over a partitioned dimension, or for an
operand that every partition reads whole).

`Bands(mesh)` is what every module that declares a `bands` attribute gets
from `parallel.mesh.spatial_partition` (None: the whole image): this rank's
place and the band ops of its data row (`mesh.spatial_group`, never the
world), their adjoints written out (`torch.autograd.Function`s).

The sizes. Every map is cut by `halo.cut` over its whole height (width on
'y'), so a band holds rows [floor(i*n/X), floor((i+1)*n/X)) of a map of n
rows, which may be unequal or empty. A band's own size does not tell its
map's, so `whole` learns the whole sizes from the bands: one all-gather of
every band's local sizes, the whole size their sum. Every rank asks at the
same calls, since the control flow never depends on a band's own size;
each all-gather carries the call's number, so a rank that strays raises
on every rank of the group at once. The train and eval steps run their
forward (and backward) inside `step(hw, training)`, hw the batch's whole
size: its calls are numbered from 0 and their answers kept under (train
mode, grad mode, hw), so the first step of a kind asks and every later one
reads them back with no collective. Outside a step (a module put on bands
by hand) every call asks.

The ops (each computes exactly its own output rows under the output map's
cut, reading its input rows through `halo.fetch`):

- `window(x, kernel, stride, padding, dilation, edge)`: the input window of
  the band's output rows of a conv or pool of that geometry on each split
  axis, `edge` past the map's edge (0; -inf for a max-pool); the op then
  runs without padding there. Stride-1 convs that keep the size get their
  band with p rows of each side, as a symmetric halo; strided and valid
  convs and the pools the window of their output rows, which may be
  asymmetric.
- `resize(x, out_hw, align_corners, mode)`: the band's share of the whole
  map's bilinear (align corners or half-pixel) or nearest resize to any
  size, from the input rows its output rows read. `out_hw` is this band's
  share of the target's size as the caller knows it (a skip's band, or a
  multiple of x's): summed over the bands it is the whole target's.
- `resize_whole(x, band_hw, align_corners)`: the band's share of the
  bilinear resize of a small map that every band holds whole (PSP's pooled
  bins) to the whole map of which band_hw is a band: local, no fetch.
- `pad_replicate(x, out_hw)`: the band's share of the whole map padded at
  its bottom and right edges to the target, by edge replication.
- `sum(t)`: the sum of every band's `t`, on every band. Every band consumes
  the same sum, so the adjoint all-reduces the gradients.
- `amax(x, dims)`: the whole map's max over `dims`. The gradient reaches the
  bands that hold the maximum and is split over every tied element of every
  band, as `amax` splits it in one process; an empty band holds none.
- `softmax(flat)`: a softmax over the whole map's flattened values from a
  band's: the global max (no gradient: a softmax is shift invariant), then
  the global sum of exponentials through `sum`.
- `gather(t)`: the whole (B, H, W, C) map from the bands, laid out as
  `halo.gather_bands` lays it out, for keys and values that each band reads
  with its own queries. Their gradient is the sum of every band's reading,
  cut to this band: an all-reduce and a slice (Gloo has no reduce-scatter).
- `count(x)`: the pixels of a BN's batch, every data row's whole map.
- `place(x)`: ((h0, H), (w0, W)), this band's first row and column in its
  whole map and the whole map's size.

Under Gloo a CUDA tensor is staged through host memory, as the fetch stages
its exchanges; the bytes each rank sends and the host seconds are counted
in `halo.STATS` ("allgather_*", "allreduce_*").
"""

import contextlib
import time
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops.resize import resize_band, resize_bilinear_to_band, resize_window
from .halo import AXIS_DIM, STATS, _gather, _staged, _wait, cut, fetch

AXES = ("x", "y")
_SIZES = 4  # the most ints a size call all-gathers: two (h, w) pairs


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


def _local_amax(x: torch.Tensor, dims) -> torch.Tensor:
    """x.amax(dims, keepdim=True), -inf where x is empty along them."""
    if any(x.shape[d] == 0 for d in dims):
        shape = [1 if d in dims else s for d, s in enumerate(x.shape)]
        return x.new_full(shape, float("-inf"))
    return x.amax(dims, keepdim=True)


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
        top = _all_reduce(_local_amax(x.detach(), dims), mesh, dist.ReduceOp.MAX)
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
    def forward(ctx, t, mesh, cuts):
        ctx.mesh = mesh
        (cx, cy), i, j = cuts, mesh.band_of("x")[0], mesh.band_of("y")[0]
        ctx.band = (cx[i], cx[i + 1], cy[j], cy[j + 1])
        return _gather(t, mesh, "allgather", cx, cy)

    @staticmethod
    def backward(ctx, g):
        h0, h1, w0, w1 = ctx.band
        return _all_reduce(g, ctx.mesh)[:, h0:h1, w0:w1].contiguous(), None, None


def conv_windows(n: int, parts: int, kernel: int, stride: int, padding: int, dilation: int):
    """(n_out, every band's input window) of a conv or pool of that geometry
    over a map of n rows cut into `parts` bands: output rows [a, b) read
    input rows [a*s - p, (b - 1)*s - p + d(k - 1) + 1); an empty output band
    reads nothing."""
    span = dilation * (kernel - 1) + 1
    n_out = max((n + 2 * padding - span) // stride + 1, 0)
    c = cut(n_out, parts)
    return n_out, tuple((a * stride - padding, (b - 1) * stride - padding + span) if b > a
                        else (a * stride - padding,) * 2 for a, b in zip(c, c[1:]))


class Bands:
    """This rank's band of every map and the band ops of its data row (see
    the module docstring). `place` = ((i, nx), (j, ny)): the band's index
    and the band count on H and W. Without a spatial group (one band) each
    op is the one-process op."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.place = (mesh.band_of("x"), mesh.band_of("y"))
        self.split = mesh.spatial_group is not None
        self._calls, self._key, self._known = 0, None, {}

    # ---------------------------------------------------------------- sizes

    def split_axes(self):
        """(rows, cols): 1 on each axis the mesh splits, else 0."""
        (_, nx), (_, ny) = self.place
        return int(nx > 1), int(ny > 1)

    def _all_sizes(self, index: int, values: Sequence[int]):
        """Every band's `values` (at most _SIZES ints) of its call `index`,
        in the spatial group's rank order: one all-gather of a fixed size,
        whose (index, len(values)) every rank checks, so all raise together
        when one has strayed from the others' calls."""
        group = self.mesh.spatial_group
        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend(group) == "nccl" else torch.device("cpu"))
        head = [index, len(values)]
        t = torch.tensor(head + list(values) + [0] * (_SIZES - len(values)),
                         dtype=torch.int64, device=dev)
        parts = [torch.empty_like(t) for _ in self.mesh.spatial_coords]
        _wait([dist.all_gather(parts, t, group=group, async_op=True)], group)
        every = [p.tolist() for p in parts]
        if any(v[:2] != head for v in every):
            raise RuntimeError(f"band size calls out of step: (call, values) "
                               f"{[tuple(v[:2]) for v in every]} over the bands")
        return [v[2:2 + len(values)] for v in every]

    def _sums(self, index: int, values: Sequence[int]):
        """[(H, W), ...]: each (h, w) pair of `values` summed over the bands
        of this band's column (H) and row (W)."""
        (i, _), (j, _) = self.place
        every = self._all_sizes(index, values)
        out = []
        for k in range(0, len(values), 2):
            out.append((sum(v[k] for (a, b), v in zip(self.mesh.spatial_coords, every)
                            if b == j),
                        sum(v[k + 1] for (a, b), v in zip(self.mesh.spatial_coords, every)
                            if a == i)))
        return out

    @contextlib.contextmanager
    def step(self, hw, training: bool):
        """Inside: one step's forward (and backward: a remat recompute) on a
        batch of whole size hw = (H, W), its size calls numbered from 0
        and kept under (train mode, grad mode, hw)."""
        self._calls = 0
        self._key = (training, torch.is_grad_enabled(), (int(hw[0]), int(hw[1])))
        try:
            yield
        finally:
            self._key = None

    def whole(self, *hws) -> Sequence[Tuple[int, int]]:
        """The whole (H, W) of each (h, w): this band's share of a map (a
        band's own size, or a size the caller scaled from one)."""
        mine = [int(v) for hw in hws for v in hw]
        if not self.split:
            return [tuple(mine[k:k + 2]) for k in range(0, len(mine), 2)]
        index, self._calls = self._calls, self._calls + 1
        if self._key is None:
            return self._sums(index, mine)
        known = self._known.setdefault(self._key, {})
        rec = known.get(index)
        if rec is None:
            rec = known[index] = (mine, self._sums(index, mine))
        elif rec[0] != mine:
            raise RuntimeError(f"band sizes {mine} at call {index} of a forward, where an "
                               f"earlier forward of the same kind had {rec[0]}")
        return rec[1]

    def span(self, n: int, axis: str) -> Tuple[int, int]:
        """This band's rows [lo, hi) of a map of n rows on `axis`."""
        i, parts = self.place[AXES.index(axis)]
        c = cut(n, parts)
        return c[i], c[i + 1]

    def of(self, x: torch.Tensor) -> Tuple[int, int]:
        """The whole (H, W) of band x, checked against the cut."""
        (full,) = self.whole(x.shape[1:3])
        self._check(x, full)
        return full

    def place_of(self, x: torch.Tensor):
        """((h0, H), (w0, W)) of band x."""
        full = self.of(x)
        return tuple((self.span(n, a)[0], n) for a, n in zip(AXES, full))

    def count(self, x: torch.Tensor) -> int:
        """The pixels of a BN's batch whose share x is: x's rows times the
        data rows times x's whole map."""
        h, w = self.of(x)
        return int(x.shape[0]) * self.mesh.size * h * w

    # ---------------------------------------------------------------- windows

    def _fetch_axes(self, x, geometry, edge=0.0):
        """x with the window `geometry(axis, n)` gives on each split axis."""
        full = self.of(x)
        for axis, n in zip(AXES, full):
            parts = self.place[AXES.index(axis)][1]
            if parts > 1:
                x = fetch(x, self.mesh, axis, n, geometry(axis, n, parts), edge)
        return x

    def window(self, x: torch.Tensor, kernel, stride, padding, dilation,
               edge: float = 0.0) -> torch.Tensor:
        """x's window for the band's output rows of a conv or pool of that
        geometry ((rows, cols) pairs) on each split axis (`conv_windows`),
        `edge` past the map's edge."""
        def geometry(axis, n, parts):
            a = AXES.index(axis)
            return conv_windows(n, parts, kernel[a], stride[a], padding[a], dilation[a])[1]

        return self._fetch_axes(x, geometry, edge)

    def deconv_window(self, x: torch.Tensor, stride) -> Tuple[torch.Tensor, tuple]:
        """x's window for the band's output rows of a transposed conv of
        kernel = stride without padding (each input row makes its own s
        output rows), and the (top, bottom, left, right) output rows to drop
        from the window's output."""
        crop = [0, 0, 0, 0]

        def geometry(axis, n, parts):
            a = AXES.index(axis)
            s, c = stride[a], cut(n * stride[a], parts)
            wins = tuple((lo // s, -(-hi // s)) if hi > lo else (lo // s,) * 2
                         for lo, hi in zip(c, c[1:]))
            i = self.place[a][0]
            if c[i + 1] > c[i]:
                crop[2 * a], crop[2 * a + 1] = c[i] - s * wins[i][0], s * wins[i][1] - c[i + 1]
            return wins

        return self._fetch_axes(x, geometry), tuple(crop)

    # ---------------------------------------------------------------- resizes

    def resize(self, x: torch.Tensor, out_hw, align_corners: bool,
               mode: str = "bilinear") -> torch.Tensor:
        """This band's share of the whole map's `mode` resize ("bilinear",
        align corners or half-pixel; "nearest") to the target of which
        out_hw is this band's share (see the module docstring): the input
        rows its output rows read on each split axis (`resize_window`),
        then `resize_band`."""
        full_in, full_out = self.whole(x.shape[1:3], out_hw)
        self._check(x, full_in)
        if full_in == full_out:
            return x
        origin, spans = [], []
        for a, axis in enumerate(AXES):
            n_in, n_out = full_in[a], full_out[a]
            i, parts = self.place[a]
            oc = cut(n_out, parts)
            spans.append((oc[i], oc[i + 1]))
            if n_in == n_out or parts == 1:
                origin.append(self.span(n_in, axis)[0])
                continue
            wins = tuple(resize_window(n_in, n_out, lo, hi, mode, align_corners,
                                       x.dtype == torch.float64) for lo, hi in zip(oc, oc[1:]))
            x = fetch(x, self.mesh, axis, n_in, wins)
            origin.append(wins[i][0])
        return resize_band(x, origin, full_in, full_out, spans, mode, align_corners)

    def _check(self, x, full):
        for axis, n in zip(AXES, full):
            lo, hi = self.span(n, axis)
            if x.shape[AXIS_DIM[axis]] != hi - lo:
                raise ValueError(f"a band of {x.shape[AXIS_DIM[axis]]} on '{axis}' is not this "
                                 f"band's {hi - lo} of a map of {n}")

    def resize_whole(self, x: torch.Tensor, band_hw, align_corners: bool) -> torch.Tensor:
        """This band's share of the bilinear resize of x, a whole map that
        every band holds alike, to the whole map of which band_hw is this
        band's share (`resize_bilinear_to_band`: no fetch). x's gradient is
        this band's share: the sum over the bands comes from the collective
        that made x the same on every band (`sum`)."""
        (h, w), = self.whole(band_hw)
        (h0, h1), (w0, w1) = self.span(h, "x"), self.span(w, "y")
        return resize_bilinear_to_band(x, h0, h1 - h0, h, w0, w1 - w0, w, align_corners)

    def pad_replicate(self, x: torch.Tensor, out_hw) -> torch.Tensor:
        """This band's share of the whole map padded at the bottom and the
        right to the target of which out_hw is this band's share, the pad
        replicating the last row (column): output row r reads row min(r,
        n - 1)."""
        full_in, full_out = self.whole(x.shape[1:3], out_hw)
        self._check(x, full_in)
        for a, axis in enumerate(AXES):
            n_in, n_out = full_in[a], max(full_out[a], full_in[a])
            if n_in == n_out:
                continue
            i, parts = self.place[a]
            oc = cut(n_out, parts)
            src = [np.minimum(np.arange(lo, hi), n_in - 1) for lo, hi in zip(oc, oc[1:])]
            wins = tuple((int(s.min()), int(s.max()) + 1) if len(s) else (0, 0) for s in src)
            lo = 0
            if parts > 1:
                x = fetch(x, self.mesh, axis, n_in, wins)
                lo = wins[i][0]
            x = x.index_select(AXIS_DIM[axis], torch.from_numpy(src[i] - lo).to(x.device))
        return x.contiguous()

    # ---------------------------------------------------------------- reductions

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
        top = _all_reduce(_local_amax(flat.detach(), (flat.dim() - 1,)), self.mesh,
                          dist.ReduceOp.MAX)
        e = torch.exp(flat - top)
        return e / self.sum(e.sum(-1, keepdim=True))

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The whole (B, H, W, C) map of keys or values from this band's,
        on every band; this band's gradient sums every band's reading."""
        if not self.split:
            return t
        h, w = self.of(t)
        return _GatherKeys.apply(t, self.mesh, (cut(h, self.place[0][1]),
                                                cut(w, self.place[1][1])))
