"""Halo exchange and band gathering for the 'x'/'y' mesh axes (the collectives
XLA inserts itself when GSPMD partitions a convolution spatially,
parallel/mesh.py of the JAX package).

`halo_exchange(x, mesh, rows, cols)` gives a rank's band (B, h, w, C) its
neighbours' edge rows and then columns: (B, h + 2*rows, w + 2*cols, C), zeros
past the image's edge (a conv's zero padding). The columns are exchanged
after the rows, so a 3x3 stencil gets its corners from the diagonal band.
Its backward is the adjoint: a halo row's gradient goes back to the rank
that owns the row and is added into its edge rows; past the edge it is
dropped. `gather_bands(t, mesh)` rebuilds the whole (B, H, W, C) image from
the bands of the rank's data row on every rank of it; its backward returns
this rank's band of the gradient (every rank computes the same loss from
the gathered tensor, so nothing is summed). The band collectives of the
archs that attend or pool over the whole map (an all-gather of keys and
values whose adjoint sums, all-reduces over the bands) are in bands.py.

Under NCCL the exchange is `dist.batch_isend_irecv` on the card; under Gloo,
whose point-to-point calls take CPU tensors only, CUDA tensors are staged
through host memory (as `multihost.make_global_array` stages a gather).
Under Gloo every wait, on CPU tensors or staged ones, takes `TIMEOUT` and
raises past it; NCCL's are enqueued on the stream and bounded by the
process group's own timeout (its watchdog), so the host does not block on
every halo. `STATS` counts the bytes this rank sends and the host
seconds spent in both functions, and in bands.py's all-gathers and
all-reduces; `chip_smoke.py` reads and resets it.
"""

import time
from datetime import timedelta

import torch
import torch.distributed as dist


TIMEOUT = timedelta(seconds=300)
STATS = {"halo_bytes": 0, "halo_s": 0.0, "gather_bytes": 0, "gather_s": 0.0,
         "allgather_bytes": 0, "allgather_s": 0.0, "allreduce_bytes": 0, "allreduce_s": 0.0}


def reset_stats():
    for k in STATS:
        STATS[k] = 0 if k.endswith("bytes") else 0.0


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


def _exchange(mesh, axis: str, to_prev: torch.Tensor, to_next: torch.Tensor):
    """Send `to_prev` to the band before this one on `axis` and `to_next` to
    the band after it; return what they sent here (from_prev, from_next),
    None past the image's edge."""
    peers = (mesh.neighbor(axis, -1), mesh.neighbor(axis, 1))
    if peers == (None, None):
        return None, None
    staged = _staged(to_prev)
    ops, recvs = [], []
    for peer, send in zip(peers, (to_prev, to_next)):
        if peer is None:
            recvs.append(None)
            continue
        send = send.cpu() if staged else send.contiguous()
        recv = torch.empty_like(send)
        ops += [dist.P2POp(dist.isend, send, peer), dist.P2POp(dist.irecv, recv, peer)]
        recvs.append(recv)
        STATS["halo_bytes"] += send.numel() * send.element_size()
    _wait(dist.batch_isend_irecv(ops))
    return tuple(None if r is None else r.to(to_prev.device) for r in recvs)


def _pad(t: torch.Tensor, mesh, axis: str, dim: int, k: int) -> torch.Tensor:
    """t with `k` slices of each neighbour's along `dim` before and after."""
    n = t.shape[dim]
    if k > n:
        raise ValueError(f"halo of {k} on '{axis}' wider than the band's {n}")
    got = _exchange(mesh, axis, t.narrow(dim, 0, k), t.narrow(dim, n - k, k))
    edge = t.new_zeros(t.shape[:dim] + (k,) + t.shape[dim + 1:])
    before, after = (edge if g is None else g for g in got)
    return torch.cat([before, t, after], dim)


def _fold(g: torch.Tensor, mesh, axis: str, dim: int, k: int) -> torch.Tensor:
    """The adjoint of `_pad`: the core of `g`, with the neighbours' halo
    gradients of this band's edge slices added in."""
    n = g.shape[dim] - 2 * k
    got = _exchange(mesh, axis, g.narrow(dim, 0, k), g.narrow(dim, n + k, k))
    core = g.narrow(dim, k, n).clone()
    if got[0] is not None:
        core.narrow(dim, 0, k).add_(got[0])
    if got[1] is not None:
        core.narrow(dim, n - k, k).add_(got[1])
    return core


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, rows, cols):
        ctx.mesh, ctx.rows, ctx.cols = mesh, rows, cols
        t0 = time.perf_counter()
        y = x
        if rows:
            y = _pad(y, mesh, "x", 1, rows)
        if cols:
            y = _pad(y, mesh, "y", 2, cols)
        STATS["halo_s"] += time.perf_counter() - t0
        return y

    @staticmethod
    def backward(ctx, g):
        t0 = time.perf_counter()
        g = g.contiguous()
        if ctx.cols:
            g = _fold(g, ctx.mesh, "y", 2, ctx.cols)
        if ctx.rows:
            g = _fold(g, ctx.mesh, "x", 1, ctx.rows)
        STATS["halo_s"] += time.perf_counter() - t0
        return g, None, None, None


def halo_exchange(x: torch.Tensor, mesh, rows: int, cols: int) -> torch.Tensor:
    """This rank's band (B, h, w, C) with `rows` of each 'x' neighbour's edge
    rows above and below, then `cols` of each 'y' neighbour's columns left
    and right (zeros past the image's edge); see the module docstring."""
    if not rows and not cols:
        return x
    return _HaloExchange.apply(x, mesh, int(rows), int(cols))


def _gather(t: torch.Tensor, mesh, stat: str) -> torch.Tensor:
    """The whole (B, H, W, C) image from the bands of this rank's data row
    (one all-gather over the spatial group, the parts laid out at their
    bands' places), counted in STATS under `stat`."""
    t0 = time.perf_counter()
    staged = _staged(t, mesh.spatial_group)
    src = t.cpu() if staged else t.contiguous()
    parts = [torch.empty_like(src) for _ in mesh.spatial_coords]
    work = dist.all_gather(parts, src, group=mesh.spatial_group, async_op=True)
    _wait([work], mesh.spatial_group)
    STATS[f"{stat}_bytes"] += src.numel() * src.element_size()
    nx, ny = mesh.shape.get("x", 1), mesh.shape.get("y", 1)
    grid = [[None] * ny for _ in range(nx)]
    for (i, j), part in zip(mesh.spatial_coords, parts):
        grid[i][j] = part
    out = torch.cat([torch.cat(row, 2) for row in grid], 1).to(t.device)
    STATS[f"{stat}_s"] += time.perf_counter() - t0
    return out


class _GatherBands(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.band = (mesh.band_of("x")[0] * t.shape[1], t.shape[1],
                    mesh.band_of("y")[0] * t.shape[2], t.shape[2])
        return _gather(t, mesh, "gather")

    @staticmethod
    def backward(ctx, g):
        h0, h, w0, w = ctx.band
        return g[:, h0:h0 + h, w0:w0 + w].contiguous(), None


def gather_bands(t: torch.Tensor, mesh) -> torch.Tensor:
    """The whole (B, H, W, C) image from the bands (B, H/X, W/Y, C) of this
    rank's data row, on every rank of it; see the module docstring. Its
    backward slices this rank's band out of the gradient without summing
    over the ranks: valid only where every rank consumes the gathered
    tensor alike (the heads, from which every rank computes the same loss),
    so that each rank's gradient of it is already the whole. Keys and values
    that each band reads with its own queries take `bands.Bands.gather`,
    whose backward sums every band's reading first."""
    if mesh.spatial_group is None:
        return t
    return _GatherBands.apply(t, mesh)
