"""Pooling over NHWC tensors with PyTorch semantics (counterpart of ops/pool.py)."""

import torch
import torch.nn.functional as F


def max_pool2x2(x: torch.Tensor) -> torch.Tensor:
    """`nn.MaxPool2d(2)` on (B,H,W,C): kernel 2, stride 2, floor mode.

    Floor mode drops an odd edge row or column. The result is NHWC-contiguous.
    """
    b, h, w, c = x.shape
    x = x[:, : h - h % 2, : w - w % 2, :]
    y = x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))
    return y.contiguous()


def max_pool_3x3_s2_p1(x: torch.Tensor) -> torch.Tensor:
    """`nn.MaxPool2d(3, stride=2, padding=1)` on (B,H,W,C), the ResNet stem
    pool: the padding never wins (-inf). The result is NHWC-contiguous."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


def avg_pool2d(x: torch.Tensor, window, stride=None) -> torch.Tensor:
    """`nn.AvgPool2d(window, stride)` on (B,H,W,C) over valid windows
    (stride defaults to the window). The result is NHWC-contiguous."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), tuple(window), tuple(stride or window))
    return y.permute(0, 2, 3, 1).contiguous()


def adaptive_avg_pool(x: torch.Tensor, out_hw) -> torch.Tensor:
    """`nn.AdaptiveAvgPool2d(out_hw)` on (B,H,W,C): output cell i of an axis
    averages input rows floor(i * in / out) to ceil((i + 1) * in / out), the
    bins of the JAX package (which sums them from an integral image, so the
    two differ in the last bits). The PSP pooling sizes (1, 2, 3, 6)
    (reference pspnet.py:8-26) and the area resize. The result is
    NHWC-contiguous."""
    out_hw = (int(out_hw[0]), int(out_hw[1]))
    if tuple(x.shape[1:3]) == out_hw:
        return x
    y = F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), out_hw)
    return y.permute(0, 2, 3, 1).contiguous()


def adaptive_max_pool(x: torch.Tensor, out_hw) -> torch.Tensor:
    """`nn.AdaptiveMaxPool2d(out_hw)` on (B,H,W,C), the bins of
    `adaptive_avg_pool`. The result is NHWC-contiguous."""
    out_hw = (int(out_hw[0]), int(out_hw[1]))
    if tuple(x.shape[1:3]) == out_hw:
        return x
    y = F.adaptive_max_pool2d(x.permute(0, 3, 1, 2), out_hw)
    return y.permute(0, 2, 3, 1).contiguous()


def global_avg_pool(x: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    """Mean over H and W of (B,H,W,C): (B,1,1,C), or (B,C) without keepdims."""
    return x.mean(dim=(1, 2), keepdim=keepdims)
