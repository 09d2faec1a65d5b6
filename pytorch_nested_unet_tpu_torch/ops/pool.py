"""Pooling over NHWC tensors with PyTorch semantics (counterpart of ops/pool.py).

The pools that take `bands` (a `parallel.bands.Bands`, set on the 'x'/'y'
mesh axes) get a band of a whole map and return that band's share of the
whole map's pool (the 2x2 and 3x3/2 pools: the window of its output rows,
`Bands.window`) or the whole map's pool on every band (the global and
adaptive pools). Bands may be unequal or empty (`parallel.halo.cut`)."""

import numpy as np
import torch
import torch.nn.functional as F


def max_pool2x2(x: torch.Tensor, bands=None) -> torch.Tensor:
    """`nn.MaxPool2d(2)` on (B,H,W,C): kernel 2, stride 2, floor mode.

    Floor mode drops an odd edge row or column. The result is NHWC-contiguous.
    `bands`: x is a band of a whole map, and the result is the band's rows of
    the whole map's pool, from the window of its output rows (`Bands.window`:
    2 input rows an output row, which the band's own rows need not align
    with where the map's rows do not divide evenly).
    """
    if bands is not None:
        x = bands.window(x, (2, 2), (2, 2), (0, 0), (1, 1))
    b, h, w, c = x.shape
    x = x[:, : h - h % 2, : w - w % 2, :]
    y = x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))
    return y.contiguous()


def max_pool_3x3_s2_p1(x: torch.Tensor, bands=None) -> torch.Tensor:
    """`nn.MaxPool2d(3, stride=2, padding=1)` on (B,H,W,C), the ResNet stem
    pool: the padding never wins (-inf). The result is NHWC-contiguous.
    `bands`: x is a band of a whole map, and the result is the band's rows
    of the whole map's pool: on a split axis the window of its output rows
    (`Bands.window`: output rows [a, b) read input rows [2a - 1, 2b)), -inf
    past the image's edge as the pool pads, and no padding there; the
    gradient goes back through the fetch's adjoint."""
    rows, cols = (0, 0) if bands is None else bands.split_axes()
    if rows or cols:
        x = bands.window(x, (3, 3), (2, 2), (1, 1), (1, 1), edge=float("-inf"))
    if x.shape[1] == 0 or x.shape[2] == 0:  # an empty band's (empty) window
        out = [0 if n == 0 else (n + 2 * p - 3) // 2 + 1
               for n, p in zip(x.shape[1:3], (1 - rows, 1 - cols))]
        return x[:, :out[0], :out[1]] * 1
    y = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=(1 - rows, 1 - cols))
    return y.permute(0, 2, 3, 1).contiguous()


def avg_pool2d(x: torch.Tensor, window, stride=None) -> torch.Tensor:
    """`nn.AvgPool2d(window, stride)` on (B,H,W,C) over valid windows
    (stride defaults to the window). The result is NHWC-contiguous."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), tuple(window), tuple(stride or window))
    return y.permute(0, 2, 3, 1).contiguous()


def adaptive_avg_pool(x: torch.Tensor, out_hw, bands=None) -> torch.Tensor:
    """`nn.AdaptiveAvgPool2d(out_hw)` on (B,H,W,C): output cell i of an axis
    averages input rows floor(i * in / out) to ceil((i + 1) * in / out), the
    bins of the JAX package (which sums them from an integral image, so the
    two differ in the last bits). The PSP pooling sizes (1, 2, 3, 6)
    (reference pspnet.py:8-26) and the area resize. The result is
    NHWC-contiguous. `bands`: x is a band of a whole map, and the result is
    the whole map's pool on every band: each band sums, in float32 at least,
    the rows and columns it holds of every bin (bins may overlap and cross
    band edges), the sums are all-reduced over the bands (`Bands.sum`, whose
    adjoint gives the gradient) and divided by the whole bins' sizes."""
    out_hw = (int(out_hw[0]), int(out_hw[1]))
    if bands is not None:
        return _band_adaptive_avg_pool(x, out_hw, bands)
    if tuple(x.shape[1:3]) == out_hw:
        return x
    y = F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), out_hw)
    return y.permute(0, 2, 3, 1).contiguous()


def _bin_rows(n: int, n0: int, full: int, out: int, dtype, device):
    """((out, n) 0/1 matrix: whether row n0 + r of a `full`-long axis lies in
    bin i of its adaptive pool to `out`, (out,) the bins' sizes)."""
    i = np.arange(out)
    start, end = i * full // out, -(-(i + 1) * full // out)
    r = n0 + np.arange(n)
    inside = (r[None] >= start[:, None]) & (r[None] < end[:, None])
    return (torch.from_numpy(inside).to(device, dtype),
            torch.from_numpy(end - start).to(device, dtype))


def _band_adaptive_avg_pool(x: torch.Tensor, out_hw, bands) -> torch.Tensor:
    (h0, full_h), (w0, full_w) = bands.place_of(x)
    h, w = x.shape[1:3]
    acc = torch.promote_types(x.dtype, torch.float32)
    a_h, n_h = _bin_rows(h, h0, full_h, out_hw[0], acc, x.device)
    a_w, n_w = _bin_rows(w, w0, full_w, out_hw[1], acc, x.device)
    sums = torch.einsum("jw,biwc->bijc", a_w, torch.einsum("ih,bhwc->biwc", a_h, x.to(acc)))
    total = bands.sum(sums)
    return (total / (n_h[:, None] * n_w[None, :])[None, :, :, None]).to(x.dtype).contiguous()


def adaptive_max_pool(x: torch.Tensor, out_hw) -> torch.Tensor:
    """`nn.AdaptiveMaxPool2d(out_hw)` on (B,H,W,C), the bins of
    `adaptive_avg_pool`. The result is NHWC-contiguous."""
    out_hw = (int(out_hw[0]), int(out_hw[1]))
    if tuple(x.shape[1:3]) == out_hw:
        return x
    y = F.adaptive_max_pool2d(x.permute(0, 3, 1, 2), out_hw)
    return y.permute(0, 2, 3, 1).contiguous()


def global_avg_pool(x: torch.Tensor, keepdims: bool = True, bands=None) -> torch.Tensor:
    """Mean over H and W of (B,H,W,C): (B,1,1,C), or (B,C) without keepdims.
    `bands` (a `parallel.bands.Bands`, set on the 'x'/'y' mesh axes): x is a
    band of a whole map, and the mean is the whole map's: the bands' sums (in
    float32 at least) all-reduced over them, divided by the whole map's H * W
    (an empty band adds zeros)."""
    if bands is None:
        return x.mean(dim=(1, 2), keepdim=keepdims)
    h, w = bands.of(x)
    acc = torch.promote_types(x.dtype, torch.float32)
    total = bands.sum(x.to(acc).sum(dim=(1, 2), keepdim=keepdims))
    return (total / (h * w)).to(x.dtype)


def global_max_pool(x: torch.Tensor, bands=None) -> torch.Tensor:
    """Max over H and W of (B,H,W,C) as (B,C); its gradient is `amax`'s,
    split evenly over tied maxima. `bands`: as `global_avg_pool`'s, the
    whole map's max (`Bands.amax`), ties split over every band's."""
    return x.amax(dim=(1, 2)) if bands is None else bands.amax(x, (1, 2))
