"""`nn.Conv2d` and `nn.BatchNorm2d` over NHWC tensors (counterparts of
ops/layers.py::TorchConv and ::BatchNorm).

Parameters are float32 under torch's names (`weight`, `bias`; a conv weight
in OIHW), so reference checkpoints load as they are. `dtype` is the compute
dtype: a conv casts its input and weight to it and adds the bias in it after
the convolution, as flax does; BatchNorm computes in float32 and casts its
output to it.
"""

from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

IntPair = Union[int, Tuple[int, int]]


def _pair(v: IntPair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


class TorchConv(nn.Module):
    """conv2d with symmetric padding, stride, dilation and groups; the weight
    is [out, in / groups, kh, kw], the bias [out] (absent when `use_bias` is
    False)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: IntPair = 3,
                 padding: IntPair = 0, dtype: Optional[torch.dtype] = None,
                 stride: IntPair = 1, dilation: IntPair = 1, groups: int = 1,
                 use_bias: bool = True):
        super().__init__()
        if in_channels % groups or out_channels % groups:
            raise ValueError(f"groups={groups} must divide in_channels={in_channels} "
                             f"and out_channels={out_channels}")
        self.padding = _pair(padding)
        self.stride = _pair(stride)
        self.dilation = _pair(dilation)
        self.groups = groups
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels // groups, *_pair(kernel_size)))
        self.bias = nn.Parameter(torch.empty(out_channels)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt), stride=self.stride,
                     padding=self.padding, dilation=self.dilation, groups=self.groups)
        y = y.permute(0, 2, 3, 1)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y.contiguous()


class BatchNorm(nn.Module):
    """BatchNorm2d with torch semantics: momentum 0.1, eps 1e-5, float32
    weight/bias/statistics, the running variance updated with the unbiased
    batch variance. No ReLU, no kernel: the JAX package runs this BN in plain
    XLA, so here it is `F.batch_norm` on the NHWC tensor's channels_last view.
    Statistics are taken in float32; the output is cast to `dtype` (or to the
    input's dtype when `dtype` is None)."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out_dtype = self.dtype or x.dtype
        y = F.batch_norm(x.to(torch.float32).permute(0, 3, 1, 2), self.running_mean,
                         self.running_var, self.weight, self.bias, self.training, 0.1,
                         self.eps)
        return y.permute(0, 2, 3, 1).to(out_dtype).contiguous()
