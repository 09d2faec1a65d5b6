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


def global_avg_pool(x: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    """Mean over H and W of (B,H,W,C): (B,1,1,C), or (B,C) without keepdims."""
    return x.mean(dim=(1, 2), keepdim=keepdims)
