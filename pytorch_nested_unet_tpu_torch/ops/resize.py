"""Bilinear and nearest resize over NHWC tensors with `F.interpolate`
semantics (counterpart of ops/resize.py).

The reference decoder upsamples with `nn.Upsample(scale_factor=2,
mode='bilinear', align_corners=True)` (reference archs_backup.py:93). The JAX
package writes that as two dense contractions for the TPU's matrix unit; here
it is the operator itself, run on the channels_last view of the NHWC tensor.
"""

import torch
import torch.nn.functional as F


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
