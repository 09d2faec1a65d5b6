"""Pooling over NHWC tensors with PyTorch semantics (counterpart of ops/pool.py)."""

import torch


def max_pool2x2(x: torch.Tensor) -> torch.Tensor:
    """`nn.MaxPool2d(2)` on (B,H,W,C): kernel 2, stride 2, floor mode.

    Floor mode drops an odd edge row or column. The result is NHWC-contiguous.
    """
    b, h, w, c = x.shape
    x = x[:, : h - h % 2, : w - w % 2, :]
    y = x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))
    return y.contiguous()
