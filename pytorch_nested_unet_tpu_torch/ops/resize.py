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
    whole map, and the result is that band's share of the whole map's
    resize (`Bands.resize`, through `resize_bilinear_band`)."""
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    if tuple(x.shape[1:3]) == (out_h, out_w):
        return x
    if bands is not None:
        return bands.resize(x, (out_h, out_w), align_corners)
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


def resize_nearest(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Nearest resize of (B,H,W,C) to (B,out_h,out_w,C) as the JAX package
    indexes it: output row i reads input row floor(i * H / out_h), in exact
    integer arithmetic (the JAX package takes the floor in float64, which
    gives the same index at every size; `F.interpolate(mode="nearest")`
    scales in float32). ResNetFCN's score pyramid (reference CRDN.py:855-863).
    The result is NHWC-contiguous."""
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


@functools.lru_cache(maxsize=64)  # a few band geometries a model; no copy per call
def _band_taps(n: int, n0: int, full: int, halo: int, device, scale: int = 2,
               align_corners: bool = True):
    """For the scale*n output positions [scale*n0, scale*(n0 + n)) of a
    `scale`x bilinear resize of a `full`-long axis: the two source indices
    of each, local to a band of n positions from n0 with `halo` more on each
    side, and the weight of the second. Positions and weights as
    F.interpolate takes them, in float32: align corners, src = i * (full -
    1) / (scale * full - 1); half-pixel centres, src = (i + 0.5) / scale -
    0.5 clamped at 0 (and the second index at full - 1), so at the map's
    edge a band reads its own edge row."""
    o = np.arange(scale * n0, scale * (n0 + n), dtype=np.float32)
    if align_corners:
        src = o * (np.float32((full - 1) / (scale * full - 1)) if full > 1 else np.float32(0))
    else:
        src = np.maximum(np.float32(1 / scale) * (o + np.float32(0.5)) - np.float32(0.5),
                         np.float32(0))
    i0 = np.floor(src).astype(np.int64)
    lam = (src - i0).astype(np.float32)
    i1 = np.minimum(i0 + 1, full - 1)
    local0, local1 = i0 - n0 + halo, i1 - n0 + halo
    if local0.min() < 0 or local1.max() >= n + 2 * halo:
        raise ValueError(f"resize_bilinear_band: a band of {n} at {n0} of {full} needs a wider "
                         f"halo than {halo}")
    return (torch.from_numpy(local0).to(device), torch.from_numpy(local1).to(device),
            torch.from_numpy(lam).to(device))


def resize_bilinear_band(x: torch.Tensor, h0: int, full_h: int, w0: int, full_w: int,
                         scale_h: int, scale_w: int, halo_rows: int = 0, halo_cols: int = 0,
                         align_corners: bool = True) -> torch.Tensor:
    """The band [scale_h*h0, scale_h*(h0 + h)) x [scale_w*w0, scale_w*(w0 +
    w)) of the bilinear resize by integer factors of a whole (B, full_h,
    full_w, C) map, from its band (B, h, w, C) given with `halo_rows` rows
    of its neighbours above and below and `halo_cols` columns left and right
    (zeros past the map's edge, which no output reads). Source positions are
    the whole map's (`_band_taps`): an output row reads within one row of
    its band's own, so a halo of 1 suffices on a resized split axis, and
    none on an axis of factor 1. Computed in float32 (float64 for float64
    x), cast to x's dtype; the result is NHWC-contiguous."""
    y = x.to(torch.promote_types(x.dtype, torch.float32))
    for dim, n0, full, scale, halo in ((1, h0, full_h, scale_h, halo_rows),
                                       (2, w0, full_w, scale_w, halo_cols)):
        n = y.shape[dim] - 2 * halo
        if scale == 1:
            y = y.narrow(dim, halo, n)
            continue
        i0, i1, lam = _band_taps(n, n0, full, halo, x.device, scale, align_corners)
        shape = [1, 1, 1, 1]
        shape[dim] = -1
        lam = lam.reshape(shape)
        a, b = y.index_select(dim, i0), y.index_select(dim, i1)
        y = a + (b - a) * lam
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
    """`upsample2x` (align corners) as a model's module, so that it can run
    on bands. `band` = ((i, nx), (j, ny)): this band's index and the band
    count on H and on W; `halo` = (rows, cols): how many neighbour rows and
    columns the input carries beyond the band. Both are set on the 'x'/'y'
    mesh axes (`parallel.mesh.spatial_partition`); the output is then the
    band's rows and columns of the whole map's upsample
    (`resize_bilinear_band` at factor 2: output row i reads source position
    i * (H - 1) / (2H - 1) of the whole map, within half a row of i / 2)."""

    band = ((0, 1), (0, 1))
    halo = (0, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.band == ((0, 1), (0, 1)):
            return upsample2x(x)
        (i, nx), (j, ny) = self.band
        rows, cols = self.halo
        h, w = x.shape[1] - 2 * rows, x.shape[2] - 2 * cols
        return resize_bilinear_band(x, i * h, nx * h, j * w, ny * w, 2, 2, rows, cols)


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
