"""Bilinear and nearest resize over NHWC tensors with `F.interpolate`
semantics (counterpart of ops/resize.py).

The reference decoder upsamples with `nn.Upsample(scale_factor=2,
mode='bilinear', align_corners=True)` (reference archs_backup.py:93). The JAX
package writes that as two dense contractions for the TPU's matrix unit; here
it is the operator itself, run on the channels_last view of the NHWC tensor.
"""

import numpy as np
import torch
import torch.nn.functional as F

from .pool import adaptive_avg_pool

A_CUBIC = -0.75  # torch's bicubic kernel parameter


def resize_bilinear(x: torch.Tensor, out_hw, align_corners: bool = True) -> torch.Tensor:
    """Resize (B,H,W,C) to (B,out_h,out_w,C); the result is NHWC-contiguous."""
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    if tuple(x.shape[1:3]) == (out_h, out_w):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(out_h, out_w),
                      mode="bilinear", align_corners=align_corners)
    return y.permute(0, 2, 3, 1).contiguous()


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
