"""`nn.Conv2d`, `nn.ConvTranspose2d`, `nn.Linear`, `nn.BatchNorm2d`,
`nn.Dropout2d` and `nn.Dropout` over NHWC tensors (counterparts of
ops/layers.py::TorchConv, ::TorchConvTranspose, ::TorchDense and
::BatchNorm, of flax's `nn.BatchNorm` and of flax's dropout).

Parameters are float32 under torch's names (`weight`, `bias`; a conv weight
in OIHW, a transposed conv's in [in, out, kh, kw]), so reference checkpoints
load as they are. `dtype` is the compute dtype: a conv casts its input and
weight to it and adds the bias in it after the convolution, as flax does;
BatchNorm computes in float32 and casts its output to it.

Data-parallel training sets `process_group` on the BNs and dropouts
(`parallel.mesh.sync_batch_norm`): a train-mode BN then takes its moments
over every rank's rows (`_SyncBatchNorm`, the explicit form of the JAX
package's `_TorchBN` under an axis name), and a dropout draws its mask for
every rank's rows and keeps this rank's.
"""

from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

IntPair = Union[int, Tuple[int, int]]

# The transposition that takes a JAX kernel to the port's weight, by rank:
# a conv's HWIO (a transposed conv's (kh, kw, out, in)) to OIHW ([in, out,
# kh, kw]), a dense kernel's (in, out) to (out, in). utils/convert.py
# carries JAX kernels across with it, and parallel/mesh.py finds through it
# the weight dim that is a JAX kernel's last axis.
JAX_KERNEL_TO_PORT = {4: (3, 2, 0, 1), 2: (1, 0)}


def _pair(v: IntPair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


class TorchConv(nn.Module):
    """conv2d with symmetric padding, stride, dilation and groups; the weight
    is [out, in / groups, kh, kw], the bias [out] (absent when `use_bias` is
    False).

    `halo` = (rows, cols): how many rows above and below and columns left
    and right the input carries beyond the output's band. On an axis with a
    halo the conv runs with no padding; the halo's rows are the image's or
    zeros past its edge. (0, 0), the default, is a whole image; the 'x'/'y'
    mesh axes set it (`parallel.mesh.spatial_partition`)."""

    halo = (0, 0)

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
        rows, cols = self.halo
        padding = (0 if rows else self.padding[0], 0 if cols else self.padding[1])
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt), stride=self.stride,
                     padding=padding, dilation=self.dilation, groups=self.groups)
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
    same elements on every run. With `process_group` set, the mask is drawn
    for every rank's rows (equal row counts) and this rank's rows are kept,
    so N ranks drop what one process would over the whole batch."""

    process_group = None

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
        shape = self.mask_shape(x)
        if self.process_group is None:
            keep = torch.rand(shape, generator=gen, device=x.device) >= self.p
        else:
            group, b = self.process_group, shape[0]
            rank = dist.get_rank(group)
            keep = (torch.rand((b * dist.get_world_size(group), *shape[1:]), generator=gen,
                               device=x.device) >= self.p)[rank * b:(rank + 1) * b]
        return x * (keep.to(x.dtype) / (1.0 - self.p))


class ChannelDropout(Dropout):
    """`nn.Dropout2d` on NHWC: in train mode each (sample, channel) is zeroed
    with probability `p` over all of H and W and the rest scaled by 1 / (1 -
    p) (flax `nn.Dropout(p, broadcast_dims=(1, 2))`); identity in eval.
    Seeded as `Dropout`."""

    def mask_shape(self, x: torch.Tensor) -> Tuple[int, ...]:
        return (x.shape[0], 1, 1, x.shape[3])


class _SyncBatchNorm(torch.autograd.Function):
    """Train-mode batch norm of float32 (n, C) rows over every rank of
    `group` (equal row counts): y = (x - mean) * (inv * weight) + bias with
    the global moments. Forward: the global mean by an all-reduce of the
    sums, then the biased variance either as the global mean of (x - mean)^2
    (`two_pass`, the JAX package's `_TorchBN`) or as E[x^2] - mean^2 clipped
    at 0 (flax's `nn.BatchNorm`), one more all-reduce. Backward: [sum dy,
    sum dy*xhat] all-reduced for dx = weight*inv * (dy - sum dy/n - xhat *
    sum dy*xhat/n) over the global n; dweight and dbias stay this rank's own
    (the optimizer averages them). Returns (y, mean, var)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group, two_pass):
        n = x.shape[0] * dist.get_world_size(group)
        if two_pass:
            s = x.sum(0)
            dist.all_reduce(s, group=group)
            mean = s / n
            sq = ((x - mean) ** 2).sum(0)
            dist.all_reduce(sq, group=group)
            var = sq / n
        else:
            s = torch.stack([x.sum(0), (x * x).sum(0)])
            dist.all_reduce(s, group=group)
            mean = s[0] / n
            var = torch.clamp(s[1] / n - mean * mean, min=0.0)
        inv = torch.rsqrt(var + eps)
        xhat = (x - mean) * inv
        ctx.save_for_backward(xhat, inv, weight)
        ctx.group, ctx.n = group, n
        ctx.mark_non_differentiable(mean, var)
        return xhat * weight + bias, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        xhat, inv, weight = ctx.saved_tensors
        local = torch.stack([dy.sum(0), (dy * xhat).sum(0)])
        total = local.clone()
        dist.all_reduce(total, group=ctx.group)
        dx = (weight * inv) * (dy - total[0] / ctx.n - xhat * (total[1] / ctx.n))
        return dx, local[1], local[0], None, None, None


def sync_batch_norm_train(x, weight, bias, eps, group, two_pass=True):
    """`_SyncBatchNorm` on an NHWC tensor's float32 (N*H*W, C) rows: (y in
    x's shape, mean, biased var, the global row count)."""
    c = x.shape[-1]
    y, mean, var = _SyncBatchNorm.apply(x.to(torch.float32).reshape(-1, c), weight, bias,
                                        eps, group, two_pass)
    return y.reshape(x.shape), mean, var, x.numel() // c * dist.get_world_size(group)


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
    towards 0 (var * n / max(n - 1, 1) with n = 1). With `process_group` set
    the batch is every rank's rows (`_SyncBatchNorm`, two passes, as
    `_TorchBN` under an axis name), and n counts them all: a rank holding
    one value per channel is normalized with the others' values too."""

    process_group = None

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
        if self.training and self.process_group is not None:
            y, mean, var, n = sync_batch_norm_train(x, self.weight, self.bias, self.eps,
                                                    self.process_group)
            with torch.no_grad():
                self.running_mean.mul_(0.9).add_(0.1 * mean)
                self.running_var.mul_(0.9).add_(0.1 * (var * (n / max(n - 1, 1))))
            return y.to(out_dtype)
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
    identity). The output is float32; callers cast it. With `process_group`
    set the train-mode moments are over every rank's rows (`_SyncBatchNorm`,
    one pass)."""

    process_group = None

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
        if self.training and self.process_group is not None:
            y, mean, var, _ = sync_batch_norm_train(x, self.weight, self.bias, self.eps,
                                                    self.process_group, two_pass=False)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(m * mean)
                self.running_var.mul_(1.0 - m).add_(m * var)
            return y
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
