"""Bilinear and nearest resize over NHWC tensors with `F.interpolate`
semantics (counterpart of ops/resize.py).

The reference decoder upsamples with `nn.Upsample(scale_factor=2,
mode='bilinear', align_corners=True)` (reference archs_backup.py:93). The JAX
package writes that as two dense contractions for the TPU's matrix unit; here
it is the operator itself, run on the channels_last view of the NHWC tensor.
"""

import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .pool import adaptive_avg_pool

A_CUBIC = -0.75  # torch's bicubic kernel parameter


def resize_bilinear(x: torch.Tensor, out_hw, align_corners: bool = True,
                    bands=None) -> torch.Tensor:
    """Resize (B,H,W,C) to (B,out_h,out_w,C); the result is NHWC-contiguous.
    Under `torch.use_deterministic_algorithms(True)` the gradient is the
    resize's adjoint as two matmuls (`_DeterministicBilinear`): the
    operator's own backward adds with atomics on a card, so it differs run
    to run, and torch refuses it in that mode. `bands` (a
    `parallel.bands.Bands`, set on the 'x'/'y' mesh axes): x is a band of a
    whole map, out_hw this band's share of the target's size (a band's
    size, or a multiple of x's), and the result is the band's share of the
    whole map's resize (`Bands.resize`, through `resize_band`)."""
    if bands is not None:
        return bands.resize(x, out_hw, align_corners)
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    if tuple(x.shape[1:3]) == (out_h, out_w):
        return x
    if x.requires_grad and torch.is_grad_enabled() and \
            torch.are_deterministic_algorithms_enabled():
        return _DeterministicBilinear.apply(x, out_h, out_w, align_corners)
    return _interpolate(x, out_h, out_w, align_corners)


def _interpolate(x, out_h, out_w, align_corners):
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(out_h, out_w),
                      mode="bilinear", align_corners=align_corners)
    return y.permute(0, 2, 3, 1).contiguous()


@functools.lru_cache(maxsize=64)  # a few sizes a model
def _bilinear_matrix(n_in: int, n_out: int, align_corners: bool, device, dtype):
    """(n_out, n_in): the two weights of each output position of a bilinear
    resize along one axis, at the positions F.interpolate takes: in float32,
    in float64 for a float64 `dtype`."""
    f = np.float64 if dtype == torch.float64 else np.float32
    o = np.arange(n_out, dtype=f)
    if align_corners:
        src = o * (f((n_in - 1) / (n_out - 1)) if n_out > 1 else f(0))
    else:
        src = np.maximum(f(n_in / n_out) * (o + f(0.5)) - f(0.5), f(0))
    i0 = np.floor(src).astype(np.int64)
    lam = (src - i0).astype(f)
    a = np.zeros((n_out, n_in), f)
    np.add.at(a, (np.arange(n_out), i0), 1 - lam)
    np.add.at(a, (np.arange(n_out), np.minimum(i0 + 1, n_in - 1)), lam)
    return torch.from_numpy(a).to(device, dtype)


class _DeterministicBilinear(torch.autograd.Function):
    """`_interpolate` forward; backward the adjoint, W then H, as matmuls
    (the same sums in the same order on every run)."""

    @staticmethod
    def forward(ctx, x, out_h, out_w, align_corners):
        ctx.geometry = (x.shape[1], x.shape[2], align_corners)
        return _interpolate(x, out_h, out_w, align_corners)

    @staticmethod
    def backward(ctx, g):
        h, w, align_corners = ctx.geometry
        a_h = _bilinear_matrix(h, g.shape[1], align_corners, g.device, g.dtype)
        a_w = _bilinear_matrix(w, g.shape[2], align_corners, g.device, g.dtype)
        gx = torch.einsum("oh,bowc->bhwc", a_h, torch.einsum("pw,bopc->bowc", a_w, g))
        return gx.contiguous(), None, None, None


def resize_nearest(x: torch.Tensor, out_hw, bands=None) -> torch.Tensor:
    """Nearest resize of (B,H,W,C) to (B,out_h,out_w,C) as the JAX package
    indexes it: output row i reads input row floor(i * H / out_h), in exact
    integer arithmetic (the JAX package takes the floor in float64, which
    gives the same index at every size; `F.interpolate(mode="nearest")`
    scales in float32). ResNetFCN's score pyramid (reference CRDN.py:855-863).
    The result is NHWC-contiguous. `bands`: as `resize_bilinear`'s."""
    if bands is not None:
        return bands.resize(x, out_hw, False, mode="nearest")
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    h, w = x.shape[1:3]
    if (h, w) == (out_h, out_w):
        return x
    for dim, n_in, n_out in ((1, h, out_h), (2, w, out_w)):
        if n_in != n_out:
            x = x.index_select(dim, torch.arange(n_out, device=x.device) * n_in // n_out)
    return x.contiguous()


def upsample2x(x: torch.Tensor, align_corners: bool = True) -> torch.Tensor:
    """2x bilinear upsample, the decoder's feed (reference archs_backup.py:93)."""
    return resize_bilinear(x, (x.shape[1] * 2, x.shape[2] * 2), align_corners)


@functools.lru_cache(maxsize=256)  # a few band geometries a model
def resize_taps(n_in: int, n_out: int, a: int, b: int, mode: str = "bilinear",
                align_corners: bool = True, double: bool = False):
    """For output positions [a, b) of a resize of an axis from n_in to
    n_out: the two source indices of each (whole-map indices) and the
    weight of the second, as F.interpolate takes them in float32 (float64
    with `double`, as it takes them for float64 maps): align corners, src =
    o * (n_in - 1) / (n_out - 1); half-pixel, src = (o + 0.5) * n_in / n_out
    - 0.5 clamped at 0 (and the second index at n_in - 1). "nearest": the
    index floor(o * n_in / n_out) (`resize_nearest`'s) twice, weight 0."""
    o = np.arange(a, b)
    f = np.float64 if double else np.float32
    if mode == "nearest":
        i0 = o * n_in // n_out
        return i0, i0, np.zeros(len(o), f)
    of = o.astype(f)
    if align_corners:
        src = of * (f((n_in - 1) / (n_out - 1)) if n_out > 1 else f(0))
    else:
        src = np.maximum(f(n_in / n_out) * (of + f(0.5)) - f(0.5), f(0))
    i0 = np.floor(src).astype(np.int64)
    lam = (src - i0).astype(f)
    return i0, np.minimum(i0 + 1, n_in - 1), lam


def resize_window(n_in: int, n_out: int, a: int, b: int, mode: str = "bilinear",
                  align_corners: bool = True, double: bool = False):
    """The input rows [lo, hi) that output rows [a, b) of the resize read
    (an empty range for no output rows)."""
    if b <= a:
        return (0, 0)
    i0, i1, _ = resize_taps(n_in, n_out, a, b, mode, align_corners, double)
    return int(i0.min()), int(i1.max()) + 1


@functools.lru_cache(maxsize=256)  # a few band geometries a model; no copy per call
def _band_taps(n_in: int, n_out: int, a: int, b: int, lo: int, mode: str, align_corners: bool,
               device, dtype):
    """`resize_taps` on `device`: the source indices local to a window of
    the input from row `lo`, and the weights in `dtype`."""
    i0, i1, lam = resize_taps(n_in, n_out, a, b, mode, align_corners, dtype == torch.float64)
    return (torch.from_numpy(i0 - lo).to(device), torch.from_numpy(i1 - lo).to(device),
            torch.from_numpy(lam).to(device, dtype))


def resize_band(x: torch.Tensor, origin, full_in, full_out, out_span, mode: str = "bilinear",
                align_corners: bool = True) -> torch.Tensor:
    """Output rows out_span[0] and columns out_span[1] (each [a, b)) of the
    resize of a whole (B, *full_in, C) map to full_out, from x, the input's
    rows and columns from `origin` = (row, column) on (at least the
    `resize_window` of those rows and columns). Bilinear in float32
    (float64 for float64 x), cast to x's dtype; nearest by indexing. The
    result is NHWC-contiguous."""
    y = x if mode == "nearest" else x.to(torch.promote_types(x.dtype, torch.float32))
    for dim, lo, n_in, n_out, (a, b) in zip((1, 2), origin, full_in, full_out, out_span):
        if n_in == n_out:
            y = y.narrow(dim, a - lo, b - a)
            continue
        i0, i1, lam = _band_taps(n_in, n_out, a, b, lo, mode, align_corners, y.device, y.dtype)
        first = y.index_select(dim, i0)
        if mode == "nearest":
            y = first
            continue
        shape = [1, 1, 1, 1]
        shape[dim] = -1
        y = first + (y.index_select(dim, i1) - first) * lam.reshape(shape)
    return y.to(x.dtype).contiguous()


def resize_bilinear_to_band(x: torch.Tensor, h0: int, h: int, full_h: int, w0: int, w: int,
                            full_w: int, align_corners: bool = False) -> torch.Tensor:
    """Rows [h0, h0 + h) and columns [w0, w0 + w) of the bilinear resize of
    the whole (B, H', W', C) map x to (full_h, full_w): the band's rows of
    each axis' resize matrix (`_bilinear_matrix`) applied to x, so a band of
    the output needs no halo where every band holds x whole (PSP's pooled
    bins, a few rows). Computed in float32 (float64 for float64 x), cast to
    x's dtype; the result is NHWC-contiguous."""
    acc = torch.promote_types(x.dtype, torch.float32)
    a_h = _bilinear_matrix(x.shape[1], full_h, align_corners, x.device, acc)[h0:h0 + h]
    a_w = _bilinear_matrix(x.shape[2], full_w, align_corners, x.device, acc)[w0:w0 + w]
    y = torch.einsum("pw,bowc->bopc", a_w, torch.einsum("oh,bhwc->bowc", a_h, x.to(acc)))
    return y.to(x.dtype).contiguous()


class Upsample2x(nn.Module):
    """`upsample2x` (align corners) as a model's module. `bands` (a
    `parallel.bands.Bands`, set on the 'x'/'y' mesh axes): the output is
    the band's rows and columns of the whole map's upsample
    (`Bands.resize`: output row i reads source position i * (H - 1) / (2H -
    1) of the whole map)."""

    bands = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bands is not None:
            return self.bands.resize(x, (x.shape[1] * 2, x.shape[2] * 2), True)
        return upsample2x(x)


def resize_area(x: torch.Tensor, out_hw) -> torch.Tensor:
    """`F.interpolate(mode='area')`, which torch computes as adaptive average
    pooling: the CascadePSP driver's downscales (reference
    eval_helper.py:9-11)."""
    return adaptive_avg_pool(x, out_hw)


def _cubic_taps(in_size: int, out_size: int, align_corners: bool):
    """For each output index along one axis, the 4 clamped input indices and
    their cubic weights (a = -0.75), positions and weights in float64 on the
    host, the weights then rounded to float32."""
    out_idx = np.arange(out_size, dtype=np.float64)
    if align_corners and out_size > 1:
        pos = out_idx * (in_size - 1) / (out_size - 1)
    else:
        pos = (out_idx + 0.5) * in_size / out_size - 0.5
    i0 = np.floor(pos).astype(np.int64)
    taps = []
    for k in (-1, 0, 1, 2):
        d = np.abs(pos - (i0 + k))
        w = np.where(d <= 1, (A_CUBIC + 2) * d ** 3 - (A_CUBIC + 3) * d ** 2 + 1,
                     np.where(d < 2, A_CUBIC * (d ** 3 - 5 * d ** 2 + 8 * d - 4), 0.0))
        taps.append((np.clip(i0 + k, 0, in_size - 1), w.astype(np.float32)))
    return taps


def resize_bicubic(x: torch.Tensor, out_hw, align_corners: bool = False) -> torch.Tensor:
    """Bicubic resize of (B,H,W,C) to (B,out_h,out_w,C) with
    `F.interpolate(mode='bicubic')` semantics: the 4-tap cubic convolution
    with a = -0.75, taps clamped at the border, half-pixel centres when
    align_corners is False. Written as the JAX package writes it, four
    weighted gathers per axis summed in tap order with float64-derived
    weights, so the two agree to the last bits (F.interpolate derives its
    weights in float32, a few 1e-7 of the values away). The CascadePSP
    driver's upscales (reference eval_helper.py:9-11). The result is
    NHWC-contiguous."""
    for dim, n_out in ((1, int(out_hw[0])), (2, int(out_hw[1]))):
        n_in = x.shape[dim]
        if n_in == n_out:
            continue
        shape = [1, 1, 1, 1]
        shape[dim] = n_out
        acc = None
        for idx, w in _cubic_taps(n_in, n_out, align_corners):
            term = x.index_select(dim, torch.from_numpy(idx).to(x.device)) * \
                torch.from_numpy(w).to(x.device, x.dtype).reshape(shape)
            acc = term if acc is None else acc + term
        x = acc
    return x.contiguous()
