"""The CRDN backbone family: VGG16RNN, ResNet{18,34,50,101,152}RNN,
ResNet50UNet and ResNet50FCN (counterpart of models/crdn_backbones.py;
reference CRDN.py:250-908).

- `VGG16RNN`: the VGG-16 (BN) encoder, 13 conv -> BN -> ReLU units in five
  stages with 2x2 max-pools between them, a 5x5 score block per stage and
  the `RDC` chain (LSTM by default). All 18 of its BN layers are
  `FusedBatchNormReLU`: K1-K3 run 18 times per train step.
- `ResNetRNN` and its presets `ResNet{18,34,50,101,152}RNN`: a ResNet trunk
  with a stride-1 7x7 stem (CRDN.py:430, unlike torchvision's stride 2),
  whose five features (the stem before its 3x3 pool, then layer1-4) each get
  a 3x3 score block; the `RDC` chain decodes them (LSTM by default). The
  trunk's BN layers are plain `BatchNorm`, as the JAX package runs plain
  XLA there; the 5 score blocks run K1-K3.
- `ResNetUNet` / `ResNet50UNet`: the trunk and a UNet decoder of `UnetUp`
  nodes (a 2x2 transposed conv, or a bilinear x2, an align-corners resize
  to the skip, a concat and a BN-free `UnetConv2`). No kernel.
- `ResNetFCN` / `ResNet50FCN`: the trunk, a classifier of a valid 3x3 conv
  to 4096 channels, two plain BN + ReLU + channel dropout layers and a 1x1
  conv, then FCN score-map sums resized by nearest indexing. No kernel.

On the 'x'/'y' mesh axes (`parallel.mesh.spatial_partition`) every conv
reads the window of its output rows (the strided convs and ResNetFCN's
valid 3x3 too), and `bands` (a `parallel.bands.Bands`) is set on the
trunk's model, VGG16RNN's stages and each `UnetUp`: the pools then take the
band's rows of the whole map's pool, the resizes (bilinear, and
ResNetFCN's nearest ones at any ratio) the band's rows of the whole map's
resize.

The presets are subclasses that set `BLOCK` and `LAYERS`, so the registry
and `arch_options` treat them as classes; `block` and `layers` remain
constructor options, as in the JAX package's factories. Module names give
the reference's state-dict keys: `conv1`, `bn1`, `layer3.2.conv2`,
`layer1.0.downsample.{0,1}`, `conv_block2.4` (VGG's indexed Sequentials,
MaxPool and ReLU taking indices but no keys), `score_block1.{0,1}`,
`conv5_score_block.{0,1}`, `up_concat4.up`, `up_concat4.conv.conv1.0`,
`classifier.{0,1,4,5,8}`, `score_pool4`, `final`. The reference's unused
`fc` head and VGG16RNN's unused `score` conv are not built
(`utils.convert.load_reference_pth` drops them).
"""

from collections import OrderedDict
from typing import List, Optional, Sequence

import torch
import torch.nn as nn

from ..ops.fused_bn import FusedBatchNormReLU
from ..ops.init import init_convs_
from ..ops.layers import BatchNorm, ChannelDropout, TorchConv, TorchConvTranspose
from ..ops.pool import max_pool2x2, max_pool_3x3_s2_p1
from ..ops.resize import resize_bilinear, resize_nearest
from .blocks import ConvBNReLU, UnetConv2
from .rdc import RDC, rdc_decode


class BasicBlock(nn.Module):
    """ResNet basic block, expansion 1 (reference CRDN.py:639-664)."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = TorchConv(inplanes, planes, 3, 1, dtype, stride=stride, use_bias=False)
        self.bn1 = BatchNorm(planes, dtype=dtype)
        self.conv2 = TorchConv(planes, planes, 3, 1, dtype, use_bias=False)
        self.bn2 = BatchNorm(planes, dtype=dtype)
        self.downsample = _downsample(inplanes, planes, stride, dtype) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


class Bottleneck(nn.Module):
    """ResNet bottleneck, expansion 4, the stride on the 3x3 conv (reference
    CRDN.py:589-633); `dilation` dilates (and pads) that conv as CascadePSP's
    trunk does (reference extractors.py:14-50)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False,
                 dtype: Optional[torch.dtype] = None, dilation: int = 1):
        super().__init__()
        self.conv1 = TorchConv(inplanes, planes, 1, 0, dtype, use_bias=False)
        self.bn1 = BatchNorm(planes, dtype=dtype)
        self.conv2 = TorchConv(planes, planes, 3, dilation, dtype, stride=stride,
                               dilation=dilation, use_bias=False)
        self.bn2 = BatchNorm(planes, dtype=dtype)
        self.conv3 = TorchConv(planes, planes * 4, 1, 0, dtype, use_bias=False)
        self.bn3 = BatchNorm(planes * 4, dtype=dtype)
        self.downsample = (_downsample(inplanes, planes * 4, stride, dtype) if downsample
                           else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


def _downsample(cin: int, cout: int, stride: int, dtype) -> nn.Sequential:
    """The residual's 1x1 strided conv and its BN (torchvision's
    `downsample.0` / `.1`)."""
    return nn.Sequential(TorchConv(cin, cout, 1, 0, dtype, stride=stride, use_bias=False),
                         BatchNorm(cout, dtype=dtype))


BLOCKS = {"basic": BasicBlock, "bottleneck": Bottleneck}


class _ResNetTrunk(nn.Module):
    """A model whose ResNet trunk sits at the root of its state dict, as in
    the reference (CRDN.py:430-437, `_make_layer` :516-530): `conv1` (7x7,
    stride 1), `bn1`, `layer1`-`layer4` of `BLOCK`s. Subclasses set the
    presets and call `build_trunk` before their own layers. `bands`: see
    the module docstring."""

    BLOCK = "bottleneck"
    LAYERS = (3, 4, 6, 3)
    bands = None

    def build_trunk(self, input_channels: int, block: Optional[str],
                    layers: Optional[Sequence[int]], dtype) -> List[int]:
        """Add the trunk's modules; return the channels of its 5 features."""
        blk = BLOCKS[block or self.BLOCK]
        layers = tuple(self.LAYERS if layers is None else layers)
        self.conv1 = TorchConv(input_channels, 64, 7, 3, dtype, use_bias=False)
        self.bn1 = BatchNorm(64, dtype=dtype)
        inplanes, channels = 64, [64]
        for stage, (planes, n) in enumerate(zip((64, 128, 256, 512), layers)):
            blocks = []
            for i in range(n):
                stride = 2 if stage > 0 and i == 0 else 1
                ds = i == 0 and (stride != 1 or inplanes != planes * blk.expansion)
                blocks.append(blk(inplanes, planes, stride, ds, dtype))
                inplanes = planes * blk.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
            channels.append(inplanes)
        return channels

    def encode(self, x: torch.Tensor) -> List[torch.Tensor]:
        """[down1 (the stem before its pool, full size), down2 (1/2), ...,
        down5 (1/16)] (CRDN.py:533-543)."""
        down1 = torch.relu(self.bn1(self.conv1(x)))
        feats, x = [down1], max_pool_3x3_s2_p1(down1, self.bands)
        for stage in range(1, 5):
            x = getattr(self, f"layer{stage}")(x)
            feats.append(x)
        return feats


class ResNetRNN(_ResNetTrunk):
    """ResNet trunk + a 3x3 score block per feature + the RDC chain
    (reference CRDN.py:418-584). The score blocks take their in-channels
    from the features (the reference hardcodes Bottleneck widths, which
    crashes ResNet18/34RNN)."""

    DECODER = "LSTM"

    def __init__(self, num_classes: int = 1, input_channels: int = 3,
                 deep_supervision: bool = False, block: Optional[str] = None,
                 layers: Optional[Sequence[int]] = None, kernel_size: int = 3,
                 decoder: Optional[str] = None, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.decoder = decoder or self.DECODER
        channels = self.build_trunk(input_channels, block, layers, dtype)
        for i, c in enumerate(channels):
            setattr(self, f"conv{i + 1}_score_block",
                    ConvBNReLU(c, num_classes, kernel_size=3, padding=1, dtype=dtype))
        self.RDC = RDC(num_classes, kernel_size, use_bias, self.decoder, dtype=dtype)
        init_convs_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        feats = self.encode(x)
        scores = [getattr(self, f"conv{i + 1}_score_block")(feats[i])
                  for i in reversed(range(len(feats)))]  # coarsest first
        return rdc_decode(self.RDC, scores).to(torch.float32)


class _VGGStage(nn.Sequential):
    """`n` conv3x3 -> BN+ReLU units, after a 2x2 max-pool unless it is the
    first stage, keyed at the reference Sequential's indices (CRDN.py:260-316):
    [MaxPool,] then (Conv, BN, ReLU) per unit, so the convs sit at 0, 3 (or
    1, 4, 7 after the pool) and their BNs one after; the pool and the ReLUs
    (here inside the BN) hold no parameters."""

    def __init__(self, cin: int, cout: int, n: int, pool: bool, dtype):
        first = int(pool)
        units = OrderedDict()
        for i in range(n):
            units[str(first + 3 * i)] = TorchConv(cin if i == 0 else cout, cout, 3, 1, dtype)
            units[str(first + 3 * i + 1)] = FusedBatchNormReLU(cout, dtype=dtype)
        super().__init__(units)
        self.pool = pool

    bands = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(max_pool2x2(x, self.bands) if self.pool else x)


class VGG16RNN(nn.Module):
    """VGG-16 (BN) encoder + a 5x5 score block per stage + the RDC chain
    (reference CRDN.py:250-407)."""

    STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
    DECODER = "LSTM"

    def __init__(self, num_classes: int = 1, input_channels: int = 3,
                 deep_supervision: bool = False, kernel_size: int = 3,
                 decoder: Optional[str] = None, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.decoder = decoder or self.DECODER
        cin = input_channels
        for b, (ch, n) in enumerate(self.STAGES):
            setattr(self, f"conv_block{b + 1}", _VGGStage(cin, ch, n, b > 0, dtype))
            cin = ch
        for b, (ch, _) in enumerate(self.STAGES):
            setattr(self, f"score_block{b + 1}",
                    ConvBNReLU(ch, num_classes, kernel_size=5, padding=2, dtype=dtype))
        self.RDC = RDC(num_classes, kernel_size, use_bias, self.decoder, dtype=dtype)
        init_convs_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        feats = []
        for b in range(len(self.STAGES)):
            x = getattr(self, f"conv_block{b + 1}")(x)
            feats.append(x)
        scores = [getattr(self, f"score_block{b + 1}")(feats[b])
                  for b in reversed(range(len(feats)))]
        return rdc_decode(self.RDC, scores).to(torch.float32)


class UnetUp(nn.Module):
    """A 2x2 stride-2 transposed conv to `out_size` channels (or a bilinear
    x2 that keeps the channels), an align-corners resize to the skip's size,
    [skip ++ up], and a BN-free `UnetConv2` (reference CRDN.py:753-772).
    With `bands` both resizes are the band's rows of the whole map's
    (`Bands.resize`)."""

    bands = None

    def __init__(self, skip_channels: int, below_channels: int, out_size: int,
                 is_deconv: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.up = (TorchConvTranspose(below_channels, out_size, 2, 2, dtype=dtype)
                   if is_deconv else None)
        up_channels = out_size if is_deconv else below_channels
        self.conv = UnetConv2(skip_channels + up_channels, out_size, is_batchnorm=False,
                              dtype=dtype)

    def forward(self, skip: torch.Tensor, below: torch.Tensor) -> torch.Tensor:
        if self.up is not None:
            up = self.up(below)
        else:
            up = resize_bilinear(below, (below.shape[1] * 2, below.shape[2] * 2),
                                 bands=self.bands)
        up = resize_bilinear(up, skip.shape[1:3], bands=self.bands)
        return self.conv(torch.cat([skip, up], dim=-1))


class ResNetUNet(_ResNetTrunk):
    """ResNet trunk + UNet decoder + a 1x1 head (reference CRDN.py:674-750)."""

    def __init__(self, num_classes: int = 1, input_channels: int = 3,
                 deep_supervision: bool = False, block: Optional[str] = None,
                 layers: Optional[Sequence[int]] = None, is_deconv: bool = True,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        ch = self.build_trunk(input_channels, block, layers, dtype)
        below = ch[4]
        for i in (4, 3, 2, 1):  # up_concat4 joins down4 to down5, ..., up_concat1 down1
            setattr(self, f"up_concat{i}",
                    UnetUp(ch[i - 1], below, ch[i - 1], is_deconv, dtype))
            below = ch[i - 1]
        self.final = TorchConv(ch[0], num_classes, 1, dtype=dtype)
        init_convs_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        feats = self.encode(x)
        y = feats[4]
        for i in (4, 3, 2, 1):
            y = getattr(self, f"up_concat{i}")(feats[i - 1], y)
        return self.final(y).to(torch.float32)


class ResNetFCN(_ResNetTrunk):
    """ResNet trunk + FCN decoder (reference CRDN.py:781-872): the classifier
    on down5, then, from down4 to down1 (the stem's output after the 3x3
    stride-2 pool, CRDN.py:836-839), score = nearest-resize(score, featK's
    size) + score_poolK(featK), and a last nearest resize to the input size.
    The classifier's channel dropout (`nn.Dropout2d`, CRDN.py:808) is seeded
    from `generator`."""

    def __init__(self, num_classes: int = 1, input_channels: int = 3,
                 deep_supervision: bool = False, block: Optional[str] = None,
                 layers: Optional[Sequence[int]] = None,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        ch = self.build_trunk(input_channels, block, layers, dtype)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.classifier = nn.Sequential(
            TorchConv(ch[4], 4096, 3, 0, dtype), BatchNorm(4096, dtype=dtype), nn.ReLU(),
            ChannelDropout(0.5, generator),
            TorchConv(4096, 4096, 1, 0, dtype), BatchNorm(4096, dtype=dtype), nn.ReLU(),
            ChannelDropout(0.5, generator),
            TorchConv(4096, num_classes, 1, 0, dtype))
        for i in (4, 3, 2, 1):
            setattr(self, f"score_pool{i}", TorchConv(ch[i - 1], num_classes, 1, 0, dtype))
        init_convs_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        stem_hw = x.shape[1:3]
        full, *down = self.encode(x)  # down2 .. down5
        feats = [max_pool_3x3_s2_p1(full, self.bands)] + down[:3]  # down1 .. down4
        score = self.classifier(down[3])
        for i in (4, 3, 2, 1):
            feat = feats[i - 1]
            score = (resize_nearest(score, feat.shape[1:3], self.bands)
                     + getattr(self, f"score_pool{i}")(feat))
        return resize_nearest(score, stem_hw, self.bands).to(torch.float32)


class ResNet18RNN(ResNetRNN):
    BLOCK, LAYERS = "basic", (2, 2, 2, 2)


class ResNet34RNN(ResNetRNN):
    BLOCK, LAYERS = "basic", (3, 4, 6, 3)


class ResNet50RNN(ResNetRNN):
    BLOCK, LAYERS = "bottleneck", (3, 4, 6, 3)


class ResNet101RNN(ResNetRNN):
    BLOCK, LAYERS = "bottleneck", (3, 4, 23, 3)


class ResNet152RNN(ResNetRNN):
    BLOCK, LAYERS = "bottleneck", (3, 8, 36, 3)


class ResNet50UNet(ResNetUNet):
    BLOCK, LAYERS = "bottleneck", (3, 4, 6, 3)


class ResNet50FCN(ResNetFCN):
    BLOCK, LAYERS = "bottleneck", (3, 4, 6, 3)
