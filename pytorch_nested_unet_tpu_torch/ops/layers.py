"""`nn.Conv2d` over NHWC tensors (counterpart of ops/layers.py::TorchConv).

Parameters are float32 in torch's OIHW layout under torch's names (`weight`,
`bias`), so reference checkpoints load as they are. `dtype` is the compute
dtype: input and weight are cast to it, and the bias is added in it after the
convolution, as flax does.
"""

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


class TorchConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 padding: int = 0, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.padding = padding
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt),
                     padding=self.padding)
        return (y.permute(0, 2, 3, 1) + self.bias.to(dt)).contiguous()
