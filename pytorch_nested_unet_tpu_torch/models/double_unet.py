"""DoubleUnet: an iterative bottom-up / top-down net with dense laterals
(counterpart of models/double_unet.py; reference archs.py:1080-1239).

The reference is dead code (it needs fastai and calls `torch.ones()` with no
arguments); this follows the JAX package's rebuild of the intended net:

- bottom-up (BU): a ResNet-18-shaped body, a 7x7/2 stem + BN + ReLU + 3x3/2
  max-pool, then 4 groups of `layers[g]` basic blocks at widths (64, 128,
  256, 512); the first block of a group (`_DoubledBasicBlock`) takes the
  concat of its input and the previous iteration's top-down output of the
  same shape (zeros on iteration 0), with a 1x1 projection on the residual;
- a middle of two conv3x3 + BN + ReLU layers (512 -> 1024 -> 512);
- top-down (TD): one `UnetBlock` per BU block, groups mirrored; the first
  block of a group takes the concat of its input and that group's BU output,
  the last block of groups 1-3 upsamples by 2 (bilinear, align_corners=False);
- a head (conv3x3 + BN + ReLU, then a bias-free 1x1 to `num_classes`)
  upsampled to the input size (align_corners=False).

The same modules run every one of `iterations` rounds. The output is the
last round's head; `deep_supervision` returns every round's. `weighted_sum`
adds the 1-D parameter `iteration_weights` (init ones): the rounds' heads
are combined by its softmax, and `deep_supervision` then returns the rounds
plus the combination.

On the 'x'/'y' mesh axes (`parallel.mesh.spatial_partition`) the strided
convs read the window of their output rows like any conv, and `bands` (a `parallel.bands.Bands`)
on the net and on each `UnetBlock` puts the 3x3/2 pool and the half-pixel
resizes (x2 in the TD groups, x4 in the head) on the band's rows of the
whole map's (`Bands.resize`).

Input height and width must be multiples of 32: the deepest BU group works
at 1/32 of the input, and at 16x16 TD group 3 would upsample to 2x2 against
a 1x1 BU output. Every BN is the plain `BatchNorm` (no kernel, as in the JAX
package). Heads are float32 whatever the compute dtype. Module names follow
the JAX package's scopes (`bu0_block0.downsample_bn`, `td3_block1.conv2`,
`middle0.conv`, `td_head1`), which are also the state dict's keys.
"""

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..ops.init import init_convs_
from ..ops.layers import BatchNorm, TorchConv
from ..ops.pool import max_pool_3x3_s2_p1
from ..ops.resize import resize_bilinear

WIDTHS = (64, 128, 256, 512)


class UnetBlock(nn.Module):
    """conv3x3 (ni -> ni) + BN + ReLU, [bilinear x2, align_corners=False],
    conv3x3 (ni -> out) + BN + ReLU (reference archs.py:1089-1104)."""

    bands = None

    def __init__(self, in_channels: int, out_channels: int, upsample: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.upsample = upsample
        self.conv1 = TorchConv(in_channels, in_channels, 3, 1, dtype)
        self.bn1 = BatchNorm(in_channels, dtype=dtype)
        self.conv2 = TorchConv(in_channels, out_channels, 3, 1, dtype)
        self.bn2 = BatchNorm(out_channels, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(x)))
        if self.upsample:
            x = resize_bilinear(x, (x.shape[1] * 2, x.shape[2] * 2), align_corners=False,
                                bands=self.bands)
        return torch.relu(self.bn2(self.conv2(x)))


class _DoubledBasicBlock(nn.Module):
    """A basic block over concat(x, lateral): both convs bias-free, the
    residual a 1x1 projection of the concat (reference `double_res_block`,
    archs.py:1124-1141)."""

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        cin = 2 * in_channels
        self.conv1 = TorchConv(cin, planes, 3, 1, dtype, stride=stride, use_bias=False)
        self.bn1 = BatchNorm(planes, dtype=dtype)
        self.conv2 = TorchConv(planes, planes, 3, 1, dtype, use_bias=False)
        self.bn2 = BatchNorm(planes, dtype=dtype)
        self.downsample_conv = TorchConv(cin, planes, 1, 0, dtype, stride=stride,
                                         use_bias=False)
        self.downsample_bn = BatchNorm(planes, dtype=dtype)

    def forward(self, x: torch.Tensor, lateral: torch.Tensor) -> torch.Tensor:
        inp = torch.cat([x, lateral], dim=-1)
        out = torch.relu(self.bn1(self.conv1(inp)))
        out = self.bn2(self.conv2(out))
        return torch.relu(out + self.downsample_bn(self.downsample_conv(inp)))


class _PlainBasicBlock(nn.Module):
    """A standard basic block (stride 1, identity residual): the non-first
    blocks of a BU group."""

    def __init__(self, planes: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = TorchConv(planes, planes, 3, 1, dtype, use_bias=False)
        self.bn1 = BatchNorm(planes, dtype=dtype)
        self.conv2 = TorchConv(planes, planes, 3, 1, dtype, use_bias=False)
        self.bn2 = BatchNorm(planes, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(self.bn2(self.conv2(out)) + x)


class _ConvLayer(nn.Module):
    """conv3x3 (bias-free) + BN + ReLU (reference `conv_layer`,
    archs.py:1143-1148)."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = TorchConv(in_channels, out_channels, 3, 1, dtype, use_bias=False)
        self.bn = BatchNorm(out_channels, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


class DoubleUnet(nn.Module):
    bands = None

    def __init__(self, num_classes: int = 1, input_channels: int = 3,
                 deep_supervision: bool = False, iterations: int = 2,
                 layers: Sequence[int] = (2, 2, 2, 2), weighted_sum: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        layers = tuple(int(n) for n in layers)
        if len(layers) != len(WIDTHS) or min(layers) < 1:
            raise ValueError(f"layers must be 4 block counts >= 1, got {layers}")
        self.deep_supervision, self.iterations = deep_supervision, int(iterations)
        self.layers, self.weighted_sum = layers, weighted_sum
        self.fe_conv1 = TorchConv(input_channels, 64, 7, 3, dtype, stride=2, use_bias=False)
        self.fe_bn1 = BatchNorm(64, dtype=dtype)
        cin = 64
        for g, width in enumerate(WIDTHS):
            setattr(self, f"bu{g}_block0",
                    _DoubledBasicBlock(cin, width, 1 if g == 0 else 2, dtype))
            for b in range(1, layers[g]):
                setattr(self, f"bu{g}_block{b}", _PlainBasicBlock(width, dtype))
            cin = width
        self.middle0 = _ConvLayer(WIDTHS[-1], WIDTHS[-1] * 2, dtype)
        self.middle1 = _ConvLayer(WIDTHS[-1] * 2, WIDTHS[-1], dtype)
        for g, width in enumerate(WIDTHS):
            cin = 2 * width  # the group's input and its BU lateral
            for b in range(layers[g] - 1):
                setattr(self, f"td{g}_block{b}", UnetBlock(cin, width, dtype=dtype))
                cin = width
            setattr(self, f"td{g}_block{layers[g] - 1}",
                    UnetBlock(cin, WIDTHS[g - 1] if g > 0 else 64, upsample=g > 0,
                              dtype=dtype))
        self.td_head0 = _ConvLayer(64, 64, dtype)
        self.td_head1 = TorchConv(64, num_classes, 1, 0, dtype, use_bias=False)
        if weighted_sum:
            self.iteration_weights = nn.Parameter(torch.ones(self.iterations))
        init_convs_(self, generator)

    def forward(self, x: torch.Tensor):
        n_groups = len(WIDTHS)
        h = torch.relu(self.fe_bn1(self.fe_conv1(x)))
        img_features = max_pool_3x3_s2_p1(h, self.bands)
        td_lats = [None] * n_groups
        outs = []
        for _ in range(self.iterations):
            h, bu_outs = img_features, []
            for g in range(n_groups):
                lat = td_lats[g] if td_lats[g] is not None else torch.zeros_like(h)
                h = getattr(self, f"bu{g}_block0")(h, lat)
                for b in range(1, self.layers[g]):
                    h = getattr(self, f"bu{g}_block{b}")(h)
                bu_outs.append(h)
            h = self.middle1(self.middle0(h))
            for g in reversed(range(n_groups)):
                h = torch.cat([h, bu_outs[g]], dim=-1)
                for b in range(self.layers[g]):
                    h = getattr(self, f"td{g}_block{b}")(h)
                td_lats[g] = h
            y = self.td_head1(self.td_head0(h))
            y = resize_bilinear(y, (x.shape[1], x.shape[2]), align_corners=False,
                                bands=self.bands)
            outs.append(y.to(torch.float32))
        if self.weighted_sum:
            w = torch.softmax(self.iteration_weights, dim=0)
            combined = sum(w[i] * outs[i] for i in range(self.iterations))
            return outs + [combined] if self.deep_supervision else combined
        return outs if self.deep_supervision else outs[-1]
