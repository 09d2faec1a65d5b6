"""GhostNet blocks and UNetRNNGhost (counterpart of models/ghost.py; reference
archs_backup.py:390-616).

UNetRNNGhost is UNetRNN with a GhostBottleneck(in, in/2, num_classes) as each
level's score block and the vanilla decoder by default. Its BNs are the plain
`BatchNorm` (no ReLU fused, no kernel), as the JAX package's are; its
depthwise convs are grouped convs. The encoder's 10 BN layers run K1-K3.

Modules keep the reference's index-style layout: a score block is a
one-element sequence around the bottleneck, and `primary_conv`,
`cheap_operation` and `shortcut` are sequences (`score_block1.0.ghost1.
primary_conv.1.running_mean`, `score_block1.0.shortcut.2.weight`).
"""

import math
from typing import Optional

import torch
import torch.nn as nn

from ..ops.layers import BatchNorm, TorchConv
from ..ops.pool import global_avg_pool
from .rdc import _UNetRNNBase


def _make_divisible(v, divisor, min_value=None):
    """Channel rounding of the TF mobilenet repo (reference archs_backup.py:390-403)."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """relu6(x + 3) / 6 (reference archs_backup.py:405-409)."""
    return torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


class SqueezeExcite(nn.Module):
    """Squeeze-excite with a hard-sigmoid gate (reference archs_backup.py:411-428);
    on the 'x'/'y' mesh axes `bands` (set by `parallel.mesh.spatial_partition`)
    pools over the whole map."""

    bands = None

    def __init__(self, in_chs: int, se_ratio: float = 0.25, divisor: int = 4,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        reduced = _make_divisible(in_chs * se_ratio, divisor)
        self.conv_reduce = TorchConv(in_chs, reduced, 1, dtype=dtype)
        self.conv_expand = TorchConv(reduced, in_chs, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pooled = global_avg_pool(x, bands=self.bands)
        x_se = self.conv_expand(torch.relu(self.conv_reduce(pooled)))
        return x * hard_sigmoid(x_se)


class GhostModule(nn.Module):
    """A primary conv to ceil(oup / ratio) channels, a cheap depthwise conv for
    the rest, concatenated and cut to `oup` (reference archs_backup.py:430-454)."""

    def __init__(self, inp: int, oup: int, kernel_size: int = 1, ratio: int = 2,
                 dw_size: int = 3, stride: int = 1, relu: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.oup = oup
        init_channels = math.ceil(oup / ratio)
        new_channels = init_channels * (ratio - 1)
        act = [nn.ReLU()] if relu else []
        self.primary_conv = nn.Sequential(
            TorchConv(inp, init_channels, kernel_size, kernel_size // 2, dtype,
                      stride=stride, use_bias=False),
            BatchNorm(init_channels, dtype=dtype), *act)
        self.cheap_operation = nn.Sequential(
            TorchConv(init_channels, new_channels, dw_size, dw_size // 2, dtype,
                      groups=init_channels, use_bias=False),
            BatchNorm(new_channels, dtype=dtype), *act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.primary_conv(x)
        x2 = self.cheap_operation(x1)
        return torch.cat([x1, x2], dim=-1)[..., :self.oup]


class GhostBottleneck(nn.Module):
    """ghost1 (expand, ReLU) -> [SE] -> ghost2 (project, linear) + shortcut
    (reference archs_backup.py:456-503); the shortcut is depthwise conv + BN +
    1x1 conv + BN when the channel count or the stride changes, else the
    input."""

    def __init__(self, in_chs: int, mid_chs: int, out_chs: int, dw_kernel_size: int = 3,
                 stride: int = 1, se_ratio: float = 0.0, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.ghost1 = GhostModule(in_chs, mid_chs, relu=True, dtype=dtype)
        self.se = (SqueezeExcite(mid_chs, se_ratio, dtype=dtype)
                   if se_ratio and se_ratio > 0.0 else None)
        self.ghost2 = GhostModule(mid_chs, out_chs, relu=False, dtype=dtype)
        if in_chs == out_chs and stride == 1:
            self.shortcut = nn.Sequential()
        else:
            k = dw_kernel_size
            self.shortcut = nn.Sequential(
                TorchConv(in_chs, in_chs, k, (k - 1) // 2, dtype, stride=stride,
                          groups=in_chs, use_bias=False),
                BatchNorm(in_chs, dtype=dtype),
                TorchConv(in_chs, out_chs, 1, dtype=dtype, use_bias=False),
                BatchNorm(out_chs, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.ghost1(x)
        if self.se is not None:
            y = self.se(y)
        return self.ghost2(y) + self.shortcut(x)


class UNetRNNGhost(_UNetRNNBase):
    """UNetRNN with GhostBottleneck score blocks; decoder 'vanilla' by default
    (reference archs_backup.py:505-616)."""

    DECODER = "vanilla"

    def make_score_block(self, in_channels, num_classes, dtype) -> nn.Module:
        return nn.Sequential(GhostBottleneck(in_channels, in_channels // 2, num_classes,
                                             dtype=dtype))
