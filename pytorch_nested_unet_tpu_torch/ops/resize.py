"""Bilinear resize over NHWC tensors with `F.interpolate` semantics
(counterpart of ops/resize.py).

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


def upsample2x(x: torch.Tensor, align_corners: bool = True) -> torch.Tensor:
    """2x bilinear upsample, the decoder's feed (reference archs_backup.py:93)."""
    return resize_bilinear(x, (x.shape[1] * 2, x.shape[2] * 2), align_corners)
