"""CascadePSP's RefinementModule: a 6-channel dilated ResNet-50, pyramid
pooling and a 3-pass cascade (counterpart of refinement/pspnet.py; reference
segmentation-refinement/segmentation_refinement/models/psp/pspnet.py:1-171
and extractors.py:14-107).

NHWC. Module names give the released checkpoint's keys, so a CascadePSP
`.pth` loads with no rename (`refiner.convert_torch_state_dict` only strips
DataParallel prefixes): `feats.conv1`, `feats.bn1`,
`feats.layer3.2.{conv,bn}2`, `feats.layer1.0.downsample.{0,1}`,
`psp.stages.3.1` (index 0 is the parameter-free pool), `psp.bottleneck`,
`up_1.conv.{0,2,3,5}`, `up_1.conv2.{0,2,3,5}`, `up_1.shortcut`,
`final_28.{0,2}`, `final_56.{0,2}`, `final_11`, `final_21`.

On the 'x'/'y' mesh axes (`parallel.mesh.spatial_partition`, the PSP
hybrids) the stem's 7x7/2, the strided and the dilated convs take their
halo like any conv, and `bands` (a `parallel.bands.Bands`) on the trunk,
the pyramid's pools, PSPModule, PSPUpsample and RefinementModule puts the
3x3/2 pool, the adaptive pools (each band's share of every bin summed over
the bands), the resize of the pooled bins (`Bands.resize_whole`) and the
half-pixel x2 / x4 / x8 resizes (`Bands.resize`) on the band's rows of the
whole map's.

The BNs are the plain `BatchNorm` and the convs `TorchConv`: the JAX package
runs this network in plain XLA, with no Pallas kernel, so here it is cuDNN
and PyTorch's own ops. The passes share `feats`, `psp` and `up_1`; in train
mode each BN in them moves its running statistics once per pass that runs
it, in order, as flax does.
"""

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from ..models.crdn_backbones import Bottleneck
from ..ops.init import init_convs_
from ..ops.layers import BatchNorm, TorchConv
from ..ops.pool import adaptive_avg_pool, max_pool_3x3_s2_p1
from ..ops.resize import resize_bilinear

# (planes, stride, dilation) of layer1-4: layers 3 and 4 dilate instead of
# striding, so the trunk's output stride stays 8
STAGES = ((64, 1, 1), (128, 2, 1), (256, 1, 2), (512, 1, 4))


class DilatedResNet50(nn.Module):
    """The dilated ResNet trunk (reference extractors.py:53-107): a stride-2
    7x7 stem on `in_channels` (image ++ 3 segmentation channels), a 3x3
    stride-2 pool, then `layers` bottlenecks per stage, the first block of
    each stage undilated. Returns (f, f_1, f_2) = (layer4's output at 1/8,
    the stem conv's output before its BN at 1/2, layer1's output at 1/4)."""

    bands = None

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), in_channels: int = 6,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = TorchConv(in_channels, 64, 7, 3, dtype, stride=2, use_bias=False)
        self.bn1 = BatchNorm(64, dtype=dtype)
        inplanes = 64
        for stage, ((planes, stride, dilation), n) in enumerate(zip(STAGES, layers)):
            blocks = []
            for i in range(n):
                s = stride if i == 0 else 1
                ds = i == 0 and (s != 1 or inplanes != planes * 4)
                blocks.append(Bottleneck(inplanes, planes, s, ds, dtype,
                                         dilation=1 if i == 0 else dilation))
                inplanes = planes * 4
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor):
        x_1 = self.conv1(x)
        h = max_pool_3x3_s2_p1(torch.relu(self.bn1(x_1)), self.bands)
        f_2 = self.layer1(h)
        f = self.layer4(self.layer3(self.layer2(f_2)))
        return f, x_1, f_2


class AdaptiveAvgPool(nn.Module):
    """`nn.AdaptiveAvgPool2d(size)` on NHWC: the parameter-free index 0 of a
    PSP stage; with `bands`, the whole map's pool on every band."""

    bands = None

    def __init__(self, size: int):
        super().__init__()
        self.size = size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return adaptive_avg_pool(x, (self.size, self.size), self.bands)


class PSPModule(nn.Module):
    """Pyramid pooling at `sizes`, each a bias-free 1x1 conv resized back
    (half-pixel bilinear), concatenated with the input, a 1x1 bottleneck and
    a ReLU (reference pspnet.py:8-26). With `bands` each pooled map is whole
    on every band and is resized onto the band's rows."""

    bands = None

    def __init__(self, features: int = 2048, out_features: int = 1024,
                 sizes: Sequence[int] = (1, 2, 3, 6), dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.stages = nn.ModuleList(
            nn.Sequential(AdaptiveAvgPool(size),
                          TorchConv(features, features, 1, 0, dtype, use_bias=False))
            for size in sizes)
        self.bottleneck = TorchConv(features * (len(sizes) + 1), out_features, 1, 0, dtype)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        hw = feats.shape[1:3]
        if self.bands is None:
            priors = [resize_bilinear(stage(feats), hw, align_corners=False)
                      for stage in self.stages]
        else:
            priors = [self.bands.resize_whole(stage(feats), hw, align_corners=False)
                      for stage in self.stages]
        return torch.relu(self.bottleneck(torch.cat(priors + [feats], dim=-1)))


def _bn_relu_conv_twice(cin: int, cout: int, dtype) -> nn.Sequential:
    """BN, ReLU, 3x3 conv, BN, ReLU, 3x3 conv (keys .0, .2, .3, .5)."""
    return nn.Sequential(BatchNorm(cin, dtype=dtype), nn.ReLU(),
                         TorchConv(cin, cout, 3, 1, dtype), BatchNorm(cout, dtype=dtype),
                         nn.ReLU(), TorchConv(cout, cout, 3, 1, dtype))


class PSPUpsample(nn.Module):
    """2x half-pixel bilinear upsample of x, concatenated with the skip `up`,
    and two residual conv stacks (reference pspnet.py:29-62). The first BN
    runs over the concatenation: x_channels + up_channels channels."""

    bands = None

    def __init__(self, x_channels: int, up_channels: int, out_channels: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = _bn_relu_conv_twice(x_channels + up_channels, out_channels, dtype)
        self.conv2 = _bn_relu_conv_twice(out_channels, out_channels, dtype)
        self.shortcut = TorchConv(x_channels, out_channels, 1, 0, dtype)

    def forward(self, x: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
        x = resize_bilinear(x, (x.shape[1] * 2, x.shape[2] * 2), align_corners=False,
                            bands=self.bands)
        p = self.conv(torch.cat([x, up], dim=-1)) + self.shortcut(x)
        return p + self.conv2(p)


def _head(cin: int, dtype) -> nn.Sequential:
    """1x1 conv to 32, ReLU, 1x1 conv to 1 (keys .0, .2)."""
    return nn.Sequential(TorchConv(cin, 32, 1, 0, dtype), nn.ReLU(),
                         TorchConv(32, 1, 1, 0, dtype))


class RefinementModule(nn.Module):
    """The 3-pass cascade (reference pspnet.py:65-171): each pass feeds tanh
    of the previous pass's upsampled logits back as two of the six input
    channels.

    forward(x, seg, inter_s8=None, inter_s4=None) takes the (B,H,W,3) image
    (`in_channels` channels) and the (B,H,W,1) segmentation in [-1, 1], H and W multiples of 8, and
    returns a dict of (B,H,W,1) float32 maps: `pred_*` (sigmoid) and `out_*`
    (logits). Giving inter_s8 / inter_s4 skips the earlier passes, as the
    tiled local step does (reference eval_helper.py:130): inter_s8 alone
    skips pass 1, both skip passes 1 and 2.

    dtype is the compute dtype of the convs and the BNs' outputs. Without
    weights the convs are drawn from `generator` (default seed 0) as torch
    draws them: the port's own init, not the JAX package's flax init at
    PRNGKey(0).
    """

    bands = None

    def __init__(self, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None, in_channels: int = 3):
        super().__init__()
        self.dtype = dtype
        self.feats = DilatedResNet50(in_channels=in_channels + 3, dtype=dtype)
        self.psp = PSPModule(2048, 1024, (1, 2, 3, 6), dtype)
        self.up_1 = PSPUpsample(1024, 256, 512, dtype)
        self.up_2 = PSPUpsample(512, 64, 256, dtype)
        self.up_3 = PSPUpsample(256, in_channels, 32, dtype)
        self.final_28 = _head(1024, dtype)
        self.final_56 = _head(512, dtype)
        self.final_11 = TorchConv(32 + in_channels, 32, 1, 0, dtype)
        self.final_21 = TorchConv(32, 1, 1, 0, dtype)
        init_convs_(self, generator)

    def _up(self, y: torch.Tensor, k: int) -> torch.Tensor:
        return resize_bilinear(y, (y.shape[1] * k, y.shape[2] * k), align_corners=False,
                               bands=self.bands)

    def forward(self, x: torch.Tensor, seg: torch.Tensor,
                inter_s8: Optional[torch.Tensor] = None,
                inter_s4: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        if self.dtype is not None:
            x, seg = x.to(self.dtype), seg.to(self.dtype)
        images: Dict[str, torch.Tensor] = {}

        def logits(name, y):
            y = y.float()
            images[f"pred_{name}"] = torch.sigmoid(y)
            images[f"out_{name}"] = y

        if inter_s8 is None:  # pass 1, at 1/8
            f, _, _ = self.feats(torch.cat([x, seg, seg, seg], dim=-1))
            r_s8 = self._up(self.final_28(self.psp(f)), 8)
            logits("28", r_s8)
            tanh_s8 = torch.tanh(r_s8)
        else:
            tanh_s8 = inter_s8.to(x.dtype)

        if inter_s4 is None:  # pass 2, at 1/8 and 1/4
            f, _, f_2 = self.feats(torch.cat([x, seg, tanh_s8, tanh_s8], dim=-1))
            p = self.psp(f)
            r_s8_2 = self._up(self.final_28(p), 8)
            r_s4 = self._up(self.final_56(self.up_1(p, f_2)), 4)
            logits("28_2", r_s8_2)
            logits("56", r_s4)
            tanh_s8_2, tanh_s4 = torch.tanh(r_s8_2), torch.tanh(r_s4)
        else:
            tanh_s8_2, tanh_s4 = inter_s8.to(x.dtype), inter_s4.to(x.dtype)

        # pass 3, to full resolution
        f, f_1, f_2 = self.feats(torch.cat([x, seg, tanh_s8_2, tanh_s4], dim=-1))
        p = self.psp(f)
        r_s8_3 = self._up(self.final_28(p), 8)
        p = self.up_1(p, f_2)
        r_s4_2 = self._up(self.final_56(p), 4)
        p = self.up_3(self.up_2(p, f_1), x)
        logits("224", self.final_21(torch.relu(self.final_11(torch.cat([p, x], dim=-1)))))
        logits("28_3", r_s8_3)
        logits("56_2", r_s4_2)
        return images


# The reference vendors the network a second time on synchronized BN
# (cascadePSP_model/psp/pspnet.py:66-172): the same architecture.
PSPNet = RefinementModule
