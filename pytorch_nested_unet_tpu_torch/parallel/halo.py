"""The row fetch and band gathering for the 'x'/'y' mesh axes (the
collectives XLA inserts itself when GSPMD partitions a convolution, a pool
or a resize spatially, parallel/mesh.py of the JAX package).

The cut: a map of n rows over X bands gives band i the rows [floor(i*n/X),
floor((i+1)*n/X)) (`cut`), and the same over W for 'y'. It depends on the
map's whole height alone, so every map of one size is cut alike whatever
made it; a band may be unequal, or empty where n < X.

`fetch(x, mesh, axis, n, windows, edge)` gives a rank's band (B, h, w, C) of
a map of n rows (columns on 'y') its window of the whole map: rows [lo, hi)
of `windows[i]` for band i (every rank computes every band's window, so each
knows what to send to whom without asking). Rows outside [0, n) are `edge`
(0 for a conv's zero padding, -inf for a max-pool's); the others come from
every band that holds them: the neighbour, bands further away, or all of
them when a dilation or a resize reaches past a thin band. Its backward is
the adjoint: each fetched row's gradient goes back to the band that owns it
and is added there; past the edge it is dropped. Where the window is the
band with p rows of each neighbour and each neighbour holds p rows (a
stride-1 conv on thick bands), the fetch sends what a symmetric halo
exchange sends: p of each neighbour's edge rows. Rows are fetched before
columns, so a 3x3 stencil gets its corners from the diagonal band.

`gather_bands(t, mesh, hw)` rebuilds the whole (B, H, W, C) image from the
bands of the rank's data row on every rank of it; its backward returns this
rank's band of the gradient (every rank computes the same loss from the
gathered tensor, so nothing is summed). Gloo's all-gather takes equal
sizes, so unequal bands are padded to the largest and trimmed. The band
collectives of the archs that attend or pool over the whole map are in
bands.py.

Under NCCL the fetch is `dist.batch_isend_irecv` on the card; under Gloo,
whose point-to-point calls take CPU tensors only, CUDA tensors are staged
through host memory (as `multihost.make_global_array` stages a gather).
Under Gloo every wait, on CPU tensors or staged ones, takes `TIMEOUT` and
raises past it; NCCL's are enqueued on the stream and bounded by the
process group's own timeout (its watchdog), so the host does not block on
every fetch. `STATS` counts the bytes this rank sends and the host seconds
spent in both functions, and in bands.py's all-gathers and all-reduces;
`chip_smoke.py` reads and resets it.
"""

import time
from datetime import timedelta
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist


TIMEOUT = timedelta(seconds=300)
STATS = {"halo_bytes": 0, "halo_s": 0.0, "gather_bytes": 0, "gather_s": 0.0,
         "allgather_bytes": 0, "allgather_s": 0.0, "allreduce_bytes": 0, "allreduce_s": 0.0}
AXIS_DIM = {"x": 1, "y": 2}


def reset_stats():
    for k in STATS:
        STATS[k] = 0 if k.endswith("bytes") else 0.0


def cut(n: int, parts: int) -> Tuple[int, ...]:
    """The band boundaries of a map of n rows over `parts` bands: band i
    holds [c[i], c[i + 1])."""
    return tuple(i * n // parts for i in range(parts + 1))


def _wait(works, group=None):
    """Wait for `works`: under Gloo for at most TIMEOUT each (it raises past
    it); under NCCL the wait only orders the stream, and the process group's
    own timeout bounds the collective."""
    gloo = dist.get_backend(group) == "gloo"
    for w in works:
        if gloo:
            w.wait(TIMEOUT)
        else:
            w.wait()


def _staged(t: torch.Tensor, group=None) -> bool:
    return t.device.type != "cpu" and dist.get_backend(group) == "gloo"


def _overlap(a: Tuple[int, int], b: Tuple[int, int]) -> Optional[Tuple[int, int]]:
    lo, hi = max(a[0], b[0]), min(a[1], b[1])
    return (lo, hi) if lo < hi else None


def _swap(mesh, axis: str, sends, recvs, like: torch.Tensor):
    """Send each `sends[j]` to band j of `axis` (same data row, same band on
    the other axis) and receive a tensor of shape `recvs[j]` from each band
    j of `recvs`; return {j: received}, on like's device."""
    if not sends and not recvs:
        return {}
    i = mesh.band_of(axis)[0]
    staged = _staged(like)
    ops, got = [], {}
    for j in sorted(set(sends) | set(recvs)):
        peer = mesh.neighbor(axis, j - i)
        if j in sends:
            t = sends[j]
            t = t.cpu() if staged else t.contiguous()
            ops.append(dist.P2POp(dist.isend, t, peer))
            STATS["halo_bytes"] += t.numel() * t.element_size()
        if j in recvs:
            r = torch.empty(recvs[j], dtype=like.dtype, device="cpu" if staged else like.device)
            ops.append(dist.P2POp(dist.irecv, r, peer))
            got[j] = r
    _wait(dist.batch_isend_irecv(ops))
    return {j: r.to(like.device) for j, r in got.items()}


def _plan(cuts, windows, i):
    """(sends, recvs) of band i: {j: global rows of band i that band j's
    window holds}, {j: global rows of band i's window that band j holds}."""
    own = (cuts[i], cuts[i + 1])
    sends, recvs = {}, {}
    for j, win in enumerate(windows):
        if j == i:
            continue
        s = _overlap(own, tuple(win))
        if s:
            sends[j] = s
        r = _overlap(tuple(windows[i]), (cuts[j], cuts[j + 1]))
        if r:
            recvs[j] = r
    return sends, recvs


def _with_rows(t: torch.Tensor, dim: int, n: int) -> Tuple[int, ...]:
    shape = list(t.shape)
    shape[dim] = n
    return tuple(shape)


class _Fetch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, cuts, windows, edge):
        t0 = time.perf_counter()
        dim, i = AXIS_DIM[axis], mesh.band_of(axis)[0]
        n = cuts[-1]
        lo, hi = windows[i]
        sends, recvs = _plan(cuts, windows, i)
        got = _swap(mesh, axis,
                    {j: x.narrow(dim, a - cuts[i], b - a) for j, (a, b) in sends.items()},
                    {j: _with_rows(x, dim, b - a) for j, (a, b) in recvs.items()}, x)
        pieces = []
        if lo < 0:
            pieces.append(x.new_full(_with_rows(x, dim, min(hi, 0) - lo), edge))
        for j in range(len(windows)):
            rows = _overlap((lo, hi), (cuts[j], cuts[j + 1]))
            if rows is None:
                continue
            pieces.append(x.narrow(dim, rows[0] - cuts[i], rows[1] - rows[0]) if j == i
                          else got[j])
        if hi > n:
            pieces.append(x.new_full(_with_rows(x, dim, hi - max(lo, n)), edge))
        y = torch.cat(pieces, dim) if pieces else x.new_empty(_with_rows(x, dim, 0))
        ctx.mesh, ctx.axis, ctx.cuts, ctx.windows = mesh, axis, cuts, windows
        ctx.x_shape = tuple(x.shape)
        STATS["halo_s"] += time.perf_counter() - t0
        return y

    @staticmethod
    def backward(ctx, g):
        t0 = time.perf_counter()
        mesh, axis, cuts, windows = ctx.mesh, ctx.axis, ctx.cuts, ctx.windows
        dim, i = AXIS_DIM[axis], mesh.band_of(axis)[0]
        lo = windows[i][0]
        g = g.contiguous()
        sends, recvs = _plan(cuts, windows, i)
        # the gradient of what each band sent here goes back to it, and that
        # of what this band sent comes back here
        back = _swap(mesh, axis,
                     {j: g.narrow(dim, a - lo, b - a) for j, (a, b) in recvs.items()},
                     {j: _with_rows(g, dim, b - a) for j, (a, b) in sends.items()}, g)
        dx = g.new_zeros(ctx.x_shape)
        own = _overlap(tuple(windows[i]), (cuts[i], cuts[i + 1]))
        if own is not None:
            dx.narrow(dim, own[0] - cuts[i], own[1] - own[0]).add_(
                g.narrow(dim, own[0] - lo, own[1] - own[0]))
        for j, (a, b) in sends.items():
            dx.narrow(dim, a - cuts[i], b - a).add_(back[j])
        STATS["halo_s"] += time.perf_counter() - t0
        return dx, None, None, None, None, None


def fetch(x: torch.Tensor, mesh, axis: str, n: int, windows: Sequence[Tuple[int, int]],
          edge: float = 0.0) -> torch.Tensor:
    """This rank's window of the whole map whose band x (B, h, w, C) is, on
    `axis`: rows (columns on 'y') [lo, hi) of `windows[i]` for band i of a
    map of n rows cut by `cut`, `edge` outside [0, n); see the module
    docstring. Every rank passes every band's window."""
    parts = mesh.shape.get(axis, 1)
    cuts = cut(int(n), parts)
    windows = tuple((int(a), int(b)) for a, b in windows)
    i = mesh.band_of(axis)[0]
    if x.shape[AXIS_DIM[axis]] != cuts[i + 1] - cuts[i]:
        raise ValueError(f"fetch: a band of {x.shape[AXIS_DIM[axis]]} rows on '{axis}' is not "
                         f"band {i} of the cut of {n} over {parts}")
    if parts == 1 or mesh.spatial_group is None:
        lo, hi = windows[i]
        dim = AXIS_DIM[axis]
        inner = x.narrow(dim, max(lo, 0), max(min(hi, n) - max(lo, 0), 0))
        before = x.new_full(_with_rows(x, dim, max(min(hi, 0) - lo, 0)), edge)
        after = x.new_full(_with_rows(x, dim, max(hi - max(lo, n), 0)), edge)
        return torch.cat([before, inner, after], dim)
    return _Fetch.apply(x, mesh, axis, cuts, windows, float(edge))


def _gather(t: torch.Tensor, mesh, stat: str, cuts_x, cuts_y) -> torch.Tensor:
    """The whole (B, H, W, C) image from the bands of this rank's data row
    (one all-gather over the spatial group of the bands padded to the
    largest, each trimmed to its size under `cuts_x` / `cuts_y` and laid out
    at its place), counted in STATS under `stat`."""
    t0 = time.perf_counter()
    group = mesh.spatial_group
    hmax = max(b - a for a, b in zip(cuts_x, cuts_x[1:]))
    wmax = max(b - a for a, b in zip(cuts_y, cuts_y[1:]))
    staged = _staged(t, group)
    src = t.cpu() if staged else t.contiguous()
    if tuple(src.shape[1:3]) != (hmax, wmax):
        pad = src.new_zeros((src.shape[0], hmax, wmax, *src.shape[3:]))
        pad[:, :src.shape[1], :src.shape[2]] = src
        src = pad
    parts = [torch.empty_like(src) for _ in mesh.spatial_coords]
    work = dist.all_gather(parts, src, group=group, async_op=True)
    _wait([work], group)
    STATS[f"{stat}_bytes"] += src.numel() * src.element_size()
    nx, ny = len(cuts_x) - 1, len(cuts_y) - 1
    grid = [[None] * ny for _ in range(nx)]
    for (i, j), part in zip(mesh.spatial_coords, parts):
        grid[i][j] = part[:, :cuts_x[i + 1] - cuts_x[i], :cuts_y[j + 1] - cuts_y[j]]
    out = torch.cat([torch.cat(row, 2) for row in grid], 1).to(t.device)
    STATS[f"{stat}_s"] += time.perf_counter() - t0
    return out


class _GatherBands(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, hw):
        cx, cy = cut(hw[0], mesh.shape.get("x", 1)), cut(hw[1], mesh.shape.get("y", 1))
        i, j = mesh.band_of("x")[0], mesh.band_of("y")[0]
        ctx.band = (cx[i], cx[i + 1], cy[j], cy[j + 1])
        return _gather(t, mesh, "gather", cx, cy)

    @staticmethod
    def backward(ctx, g):
        h0, h1, w0, w1 = ctx.band
        return g[:, h0:h1, w0:w1].contiguous(), None, None


def gather_bands(t: torch.Tensor, mesh, hw) -> torch.Tensor:
    """The whole (B, H, W, C) image of size `hw` = (H, W) from the bands of
    this rank's data row, on every rank of it; see the module docstring.
    Its backward slices this rank's band out of the gradient without
    summing over the ranks: valid
    only where every rank consumes the gathered tensor alike (the heads,
    from which every rank computes the same loss), so that each rank's
    gradient of it is already the whole. Keys and values that each band
    reads with its own queries take `bands.Bands.gather`, whose backward
    sums every band's reading first."""
    if mesh.spatial_group is None:
        return t
    return _GatherBands.apply(t, mesh, (int(hw[0]), int(hw[1])))
