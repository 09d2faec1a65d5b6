"""`nn.Conv2d`, `nn.ConvTranspose2d`, `nn.Linear`, `nn.BatchNorm2d`,
`nn.Dropout2d` and `nn.Dropout` over NHWC tensors (counterparts of
ops/layers.py::TorchConv, ::TorchConvTranspose, ::TorchDense and
::BatchNorm, of flax's `nn.BatchNorm` and of flax's dropout).

Parameters are float32 under torch's names (`weight`, `bias`; a conv weight
in OIHW, a transposed conv's in [in, out, kh, kw]), so reference checkpoints
load as they are. `dtype` is the compute dtype: a conv casts its input and
weight to it and adds the bias in it after the convolution, as flax does;
BatchNorm computes in float32 and casts its output to it.
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


class TorchConvTranspose(nn.Module):
    """conv_transpose2d: the weight is [in, out, kh, kw], the bias [out];
    the output is (in - 1) * stride - 2 * padding + kernel + output_padding
    per axis. `init_convs_` draws both from U(+-1/sqrt(out * kh * kw)), as
    torch and the JAX package's `torch_transpose_kernel_init` do."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: IntPair = 2,
                 stride: IntPair = 2, padding: IntPair = 0, output_padding: IntPair = 0,
                 dtype: Optional[torch.dtype] = None, use_bias: bool = True):
        super().__init__()
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.output_padding = _pair(output_padding)
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels, *_pair(kernel_size)))
        self.bias = nn.Parameter(torch.empty(out_channels)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        y = F.conv_transpose2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt),
                               stride=self.stride, padding=self.padding,
                               output_padding=self.output_padding).permute(0, 2, 3, 1)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y.contiguous()


class TorchDense(nn.Module):
    """linear over the last axis: the weight is [out, in], the bias [out];
    `init_convs_` draws both from U(+-1/sqrt(in)), as torch and the JAX
    package's `torch_dense_kernel_init` do. Input, weight and bias are cast
    to `dtype` (flax's Dense computes in its dtype)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Dropout(nn.Module):
    """`nn.Dropout` over every element: in train mode each is zeroed with
    probability `p` and the rest scaled by 1 / (1 - p); identity in eval. The
    masks come from a generator per device, seeded on first use from
    `generator` (default: seed 0), so a model built from a seed drops the
    same elements on every run."""

    def __init__(self, p: float = 0.5, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.p = p
        self._seeds = generator if generator is not None else torch.Generator().manual_seed(0)
        self._generators = {}

    def mask_shape(self, x: torch.Tensor) -> Tuple[int, ...]:
        return tuple(x.shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0:
            return x
        gen = self._generators.get(x.device)
        if gen is None:
            seed = int(torch.randint(0, 2**62, (1,), generator=self._seeds))
            gen = self._generators[x.device] = torch.Generator(x.device).manual_seed(seed)
        keep = torch.rand(self.mask_shape(x), generator=gen, device=x.device) >= self.p
        return x * (keep.to(x.dtype) / (1.0 - self.p))


class ChannelDropout(Dropout):
    """`nn.Dropout2d` on NHWC: in train mode each (sample, channel) is zeroed
    with probability `p` over all of H and W and the rest scaled by 1 / (1 -
    p) (flax `nn.Dropout(p, broadcast_dims=(1, 2))`); identity in eval.
    Seeded as `Dropout`."""

    def mask_shape(self, x: torch.Tensor) -> Tuple[int, ...]:
        return (x.shape[0], 1, 1, x.shape[3])


class BatchNorm(nn.Module):
    """BatchNorm2d with torch semantics: momentum 0.1, eps 1e-5, float32
    weight/bias/statistics, the running variance updated with the unbiased
    batch variance. No ReLU, no kernel: the JAX package runs this BN in plain
    XLA, so here it is `F.batch_norm` on the NHWC tensor's channels_last view.
    Statistics are taken in float32; the output is cast to `dtype` (or to the
    input's dtype when `dtype` is None).

    A train-mode batch of one value per channel (N*H*W = 1: ASPP's pooled
    branch, a 1x1 map at batch 1), which `F.batch_norm` refuses, is
    normalized as the JAX package's `_TorchBN` does it: the batch mean and a
    variance of 0, so the output is the bias, and the running variance moves
    towards 0 (var * n / max(n - 1, 1) with n = 1)."""

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
        if self.training and x.numel() == x.shape[-1]:
            mean = x.to(torch.float32).reshape(-1)
            with torch.no_grad():
                self.running_mean.mul_(0.9).add_(0.1 * mean)
                self.running_var.mul_(0.9)
            y = (mean - mean) * (self.weight * self.eps ** -0.5) + self.bias
            return y.reshape(x.shape).to(out_dtype)
        y = F.batch_norm(x.to(torch.float32).permute(0, 3, 1, 2), self.running_mean,
                         self.running_var, self.weight, self.bias, self.training, 0.1,
                         self.eps)
        return y.permute(0, 2, 3, 1).to(out_dtype).contiguous()


class FlaxBatchNorm(nn.Module):
    """flax's own `nn.BatchNorm` over NHWC, in float32 (CA-Net's non-local
    W_bn and SpatialAtten's conv1_bn): train mode normalizes with the batch
    mean and the biased variance E[x^2] - E[x]^2 (clipped at 0) and moves the
    running statistics by `momentum` towards them -- the *biased* variance,
    which `F.batch_norm` cannot do (torch updates with the unbiased one).
    `momentum` is torch's convention (new = (1 - momentum) * old + momentum *
    batch; flax's momentum 0.9 is 0.1 here, its 0.99 is 0.01).
    `zero_scale` starts the scale at 0 (a residual branch that starts as
    identity). The output is float32; callers cast it."""

    def __init__(self, num_features: int, momentum: float = 0.1, eps: float = 1e-5,
                 zero_scale: bool = False):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.zeros(num_features) if zero_scale
                                   else torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        if self.training:
            mean = x.mean(dim=(0, 1, 2))
            var = torch.clamp((x * x).mean(dim=(0, 1, 2)) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(m * mean)
                self.running_var.mul_(1.0 - m).add_(m * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
