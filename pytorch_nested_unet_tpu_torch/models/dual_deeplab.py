"""DeepLab: DeepLabV3+ over a dual-path (RGB, HHA) ResNet-101 with SAGate
fusion (counterpart of models/dual_deeplab.py; reference archs.py:1483-1864).

The reference is dead code (it names `SAGate`, `DualBottleneck`, `config`
and `logger` without defining them); this follows the JAX package's rebuild:

- `FSP` / `SAGate`: each path recalibrated by SE-style channel weights of
  the concatenated pair, then a 2-way softmax spatial gate blends the two
  into `merge`, and both paths go on as relu((x + merge) / 2);
- `DualBottleneck`: a ResNet bottleneck on each path with its own weights
  (`conv1` ... and `hha_conv1` ...);
- `DualResNet`: two deep 3-conv stems, 4 dual stages, an SAGate after each;
  `layer4_dilated` keeps layer4 at stride 1 and dilates block i by 2 * 2**i;
- `ASPP` (1x1 + three dilated 3x3 branches, BN, LeakyReLU 0.01, 1x1, plus
  a global-pool branch added by broadcast, BN, LeakyReLU) and `Head`
  (ASPP on the last merge, the first merge reduced to 48 channels, an
  align-corners upsample and concat, two conv3x3 + BN + ReLU, dropout 0.1,
  a 1x1 classifier; the auxiliary `FCNHead` on the last merge);
- `DeepLab.forward(x, hha=None)`: `hha` defaults to `x`; train mode (or
  `deep_supervision`) returns [aux, pred], eval `pred`, both resized to the
  input (align_corners=True) and float32.

FSP's `fc1` / `fc2` are flax Dense layers in the JAX package: their weights
start LeCun-normal and their biases at 0. The two dropouts are element-wise
and train-only (`ops.layers.Dropout`, seeded from the model's generator).
Every BN is the plain `BatchNorm` (no kernel, as in the JAX package).

On the 'x'/'y' mesh axes (`parallel.mesh.spatial_partition`) every conv
reads the window of its output rows: layer4's and ASPP's dilated convs
(dilations up to 18 at 1/16, wider than a thin band) take rows from every
band that holds them. `bands` (a `parallel.bands.Bands`) is set on FSP,
ASPP, the stems, `Head` and `DeepLab`: the global means are the whole
map's sums over its pixel count, the 3x3/2 pools and the align-corners
resizes (1/16 -> 1/4, the heads back to the input) the band's rows of the
whole map's; ASPP's pooled branch BN (`whole_map`) takes the data rows'
moments, and both element-wise dropouts draw the whole map's mask and keep
the band's share. Module names follow the JAX package's scopes (`backbone.layer4_2.hha_conv2`,
`backbone.sagate0.fsp_rgb.fc1`, `head.aspp.map_conv3`), which are also the
state dict's keys.
"""

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..ops.init import init_convs_, lecun_normal_
from ..ops.layers import BatchNorm, Dropout, TorchConv, TorchDense
from ..ops.pool import global_avg_pool, max_pool_3x3_s2_p1
from ..ops.resize import resize_bilinear


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.leaky_relu(x, 0.01)


class FSP(nn.Module):
    """Feature Separation Part: out = main + sigmoid(fc2(relu(fc1(gap(concat(
    guide, main)))))) * guide, `fc1` to max(1, 2C // 16) units."""

    bands = None

    def __init__(self, channels: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        hidden = max(1, 2 * channels // 16)
        self.fc1 = TorchDense(2 * channels, hidden, dtype)
        self.fc2 = TorchDense(hidden, channels, dtype)

    def init_(self, generator: torch.Generator):
        """flax Dense's init: LeCun-normal weights, zero biases."""
        for fc in (self.fc1, self.fc2):
            lecun_normal_(fc.weight, generator)
            with torch.no_grad():
                fc.bias.zero_()

    def forward(self, guide: torch.Tensor, main: torch.Tensor) -> torch.Tensor:
        pooled = global_avg_pool(torch.cat([guide, main], dim=-1), keepdims=False,
                                 bands=self.bands)
        w = torch.sigmoid(self.fc2(torch.relu(self.fc1(pooled))))[:, None, None, :]
        return main + w * guide


class SAGate(nn.Module):
    """Separation-and-Aggregation gate over [rgb, hha]: returns ([rgb', hha'],
    merge)."""

    def __init__(self, channels: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.fsp_rgb = FSP(channels, dtype)
        self.fsp_hha = FSP(channels, dtype)
        self.gate_rgb = TorchConv(2 * channels, 1, 1, 0, dtype)
        self.gate_hha = TorchConv(2 * channels, 1, 1, 0, dtype)

    def forward(self, pair):
        rgb, hha = pair
        rec_rgb, rec_hha = self.fsp_rgb(hha, rgb), self.fsp_hha(rgb, hha)
        cat = torch.cat([rec_rgb, rec_hha], dim=-1)
        att = torch.softmax(torch.cat([self.gate_rgb(cat), self.gate_hha(cat)], dim=-1), dim=-1)
        merge = rec_rgb * att[..., 0:1] + rec_hha * att[..., 1:2]
        return [torch.relu((rgb + merge) / 2.0), torch.relu((hha + merge) / 2.0)], merge


class DualBottleneck(nn.Module):
    """A ResNet bottleneck (expansion 4) on each of [rgb, hha], separate
    weights per path; the 3x3 conv takes the stride and the dilation."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False, bn_eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.downsample = downsample
        for p in ("", "hha_"):
            setattr(self, f"{p}conv1", TorchConv(inplanes, planes, 1, 0, dtype, use_bias=False))
            setattr(self, f"{p}bn1", BatchNorm(planes, bn_eps, dtype))
            setattr(self, f"{p}conv2", TorchConv(planes, planes, 3, dilation, dtype,
                                                 stride=stride, dilation=dilation,
                                                 use_bias=False))
            setattr(self, f"{p}bn2", BatchNorm(planes, bn_eps, dtype))
            setattr(self, f"{p}conv3", TorchConv(planes, planes * 4, 1, 0, dtype,
                                                 use_bias=False))
            setattr(self, f"{p}bn3", BatchNorm(planes * 4, bn_eps, dtype))
            if downsample:
                setattr(self, f"{p}downsample_conv", TorchConv(
                    inplanes, planes * 4, 1, 0, dtype, stride=stride, use_bias=False))
                setattr(self, f"{p}downsample_bn", BatchNorm(planes * 4, bn_eps, dtype))

    def _path(self, p: str, x: torch.Tensor) -> torch.Tensor:
        """The bottleneck of one path, its modules' names prefixed by `p`."""
        def layer(name, t):
            return getattr(self, p + name)(t)

        out = torch.relu(layer("bn1", layer("conv1", x)))
        out = torch.relu(layer("bn2", layer("conv2", out)))
        out = layer("bn3", layer("conv3", out))
        if self.downsample:
            x = layer("downsample_bn", layer("downsample_conv", x))
        return torch.relu(out + x)

    def forward(self, pair):
        return [self._path(p, x) for p, x in zip(("", "hha_"), pair)]


class _DualStem(nn.Module):
    """One path's stem: the deep stem (conv3x3/2, conv3x3, conv3x3 to 2 *
    stem_width, with BN + ReLU after each) or a 7x7/2 conv, then BN, ReLU and
    the 3x3/2 max-pool."""

    bands = None

    def __init__(self, in_channels: int, deep_stem: bool, stem_width: int, bn_eps: float,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.deep_stem = deep_stem
        if deep_stem:
            self.conv1_0 = TorchConv(in_channels, stem_width, 3, 1, dtype, stride=2,
                                     use_bias=False)
            self.bn1_0 = BatchNorm(stem_width, bn_eps, dtype)
            self.conv1_1 = TorchConv(stem_width, stem_width, 3, 1, dtype, use_bias=False)
            self.bn1_1 = BatchNorm(stem_width, bn_eps, dtype)
            self.conv1_2 = TorchConv(stem_width, stem_width * 2, 3, 1, dtype, use_bias=False)
            self.bn1 = BatchNorm(stem_width * 2, bn_eps, dtype)
        else:
            self.conv1 = TorchConv(in_channels, 64, 7, 3, dtype, stride=2, use_bias=False)
            self.bn1 = BatchNorm(64, bn_eps, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.deep_stem:
            x = torch.relu(self.bn1_0(self.conv1_0(x)))
            x = torch.relu(self.bn1_1(self.conv1_1(x)))
            x = self.conv1_2(x)
        else:
            x = self.conv1(x)
        return max_pool_3x3_s2_p1(torch.relu(self.bn1(x)), self.bands)


class DualResNet(nn.Module):
    """Dual-path ResNet with an SAGate after every stage; forward(rgb, hha)
    returns (per-stage gated pairs, per-stage merges)."""

    def __init__(self, in_channels: int = 3, layers: Sequence[int] = (3, 4, 23, 3),
                 deep_stem: bool = False, stem_width: int = 32, bn_eps: float = 1e-5,
                 layer4_dilated: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.layers = tuple(int(n) for n in layers)
        self.stem = _DualStem(in_channels, deep_stem, stem_width, bn_eps, dtype)
        self.hha_stem = _DualStem(in_channels, deep_stem, stem_width, bn_eps, dtype)
        inplanes = stem_width * 2 if deep_stem else 64
        for stage, (planes, n) in enumerate(zip((64, 128, 256, 512), self.layers)):
            dilated = stage == 3 and layer4_dilated
            stride = 1 if stage == 0 or dilated else 2
            for i in range(n):
                s = stride if i == 0 else 1
                setattr(self, f"layer{stage + 1}_{i}", DualBottleneck(
                    inplanes, planes, s, 2 * 2 ** i if dilated else 1,
                    i == 0 and (s != 1 or inplanes != planes * 4), bn_eps, dtype))
                inplanes = planes * 4
            setattr(self, f"sagate{stage}", SAGate(planes * 4, dtype))

    def forward(self, rgb: torch.Tensor, hha: torch.Tensor):
        pair = [self.stem(rgb), self.hha_stem(hha)]
        blocks_out, merges = [], []
        for stage, n in enumerate(self.layers):
            for i in range(n):
                pair = getattr(self, f"layer{stage + 1}_{i}")(pair)
            pair, merge = getattr(self, f"sagate{stage}")(pair)
            blocks_out.append(pair)
            merges.append(merge)
        return blocks_out, merges


class FCNHead(nn.Module):
    """Auxiliary head: conv3x3 to C / 4 (bias-free) + BN + ReLU, dropout 0.1
    in train mode, 1x1 conv to `num_classes` (reference `_FCNHead`,
    archs.py:1702-1714)."""

    def __init__(self, in_channels: int, num_classes: int, bn_eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        inter = in_channels // 4
        self.conv1 = TorchConv(in_channels, inter, 3, 1, dtype, use_bias=False)
        self.bn1 = BatchNorm(inter, bn_eps, dtype)
        self.dropout = Dropout(0.1, generator)
        self.conv2 = TorchConv(inter, num_classes, 1, 0, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.dropout(torch.relu(self.bn1(self.conv1(x)))))


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling (reference archs.py:1760-1824)."""

    bands = None

    def __init__(self, in_channels: int, out_channels: int,
                 dilation_rates: Tuple[int, int, int] = (12, 24, 36),
                 hidden_channels: int = 256, bn_eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.map_conv0 = TorchConv(in_channels, hidden_channels, 1, 0, dtype, use_bias=False)
        for i, r in enumerate(dilation_rates):
            setattr(self, f"map_conv{i + 1}", TorchConv(
                in_channels, hidden_channels, 3, r, dtype, dilation=r, use_bias=False))
        self.n_maps = 1 + len(dilation_rates)
        self.map_bn = BatchNorm(hidden_channels * self.n_maps, bn_eps, dtype)
        self.red_conv = TorchConv(hidden_channels * self.n_maps, out_channels, 1, 0, dtype,
                                  use_bias=False)
        self.global_pooling_conv = TorchConv(in_channels, hidden_channels, 1, 0, dtype,
                                             use_bias=False)
        self.global_pooling_bn = BatchNorm(hidden_channels, bn_eps, dtype)
        self.global_pooling_bn.whole_map = True  # (B, 1, 1, C): whole on every band
        self.pool_red_conv = TorchConv(hidden_channels, out_channels, 1, 0, dtype,
                                       use_bias=False)
        self.red_bn = BatchNorm(out_channels, bn_eps, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.cat([getattr(self, f"map_conv{i}")(x) for i in range(self.n_maps)], dim=-1)
        out = self.red_conv(_leaky(self.map_bn(out)))
        pool = self.global_pooling_conv(global_avg_pool(x, bands=self.bands))
        pool = self.pool_red_conv(_leaky(self.global_pooling_bn(pool)))
        return _leaky(self.red_bn(out + pool))


class Head(nn.Module):
    """DeepLabV3+ decoder (reference archs.py:1826-1864): returns (pred, aux)
    at the stride-4 and stride-16 resolutions."""

    bands = None

    def __init__(self, num_classes: int, low_channels: int = 256, high_channels: int = 2048,
                 bn_eps: float = 1e-5, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.aspp = ASPP(high_channels, 256, (6, 12, 18), bn_eps=bn_eps, dtype=dtype)
        self.reduce_conv = TorchConv(low_channels, 48, 1, 0, dtype, use_bias=False)
        self.reduce_bn = BatchNorm(48, bn_eps, dtype)
        self.last_conv0 = TorchConv(256 + 48, 256, 3, 1, dtype, use_bias=False)
        self.last_bn0 = BatchNorm(256, bn_eps, dtype)
        self.last_conv1 = TorchConv(256, 256, 3, 1, dtype, use_bias=False)
        self.last_bn1 = BatchNorm(256, bn_eps, dtype)
        self.dropout = Dropout(0.1, generator)
        self.classify = TorchConv(256, num_classes, 1, 0, dtype)
        self.auxlayer = FCNHead(high_channels, num_classes, bn_eps, dtype, generator)

    def forward(self, merges):
        encoder_out = merges[-1]
        f = self.aspp(encoder_out)
        low = torch.relu(self.reduce_bn(self.reduce_conv(merges[0])))
        f = resize_bilinear(f, low.shape[1:3], align_corners=True, bands=self.bands)
        f = torch.cat([f, low], dim=-1)
        f = torch.relu(self.last_bn0(self.last_conv0(f)))
        f = torch.relu(self.last_bn1(self.last_conv1(f)))
        pred = self.classify(self.dropout(f))
        return pred, self.auxlayer(encoder_out)


class DeepLab(nn.Module):
    bands = None

    def __init__(self, num_classes: int = 1, input_channels: int = 3,
                 deep_supervision: bool = False, layers: Sequence[int] = (3, 4, 23, 3),
                 bn_eps: float = 1e-5, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.deep_supervision = deep_supervision
        self.backbone = DualResNet(input_channels, layers, deep_stem=True, stem_width=64,
                                   bn_eps=bn_eps, layer4_dilated=True, dtype=dtype)
        self.head = Head(num_classes, bn_eps=bn_eps, dtype=dtype, generator=generator)
        init_convs_(self, generator)
        for m in self.modules():
            if isinstance(m, FSP):
                m.init_(generator)

    def forward(self, x: torch.Tensor, hha: Optional[torch.Tensor] = None):
        h, w = x.shape[1:3]
        _, merges = self.backbone(x, x if hha is None else hha)
        pred, aux = self.head(merges)
        pred = resize_bilinear(pred, (h, w), align_corners=True,
                               bands=self.bands).to(torch.float32)
        if self.training or self.deep_supervision:
            return [resize_bilinear(aux, (h, w), align_corners=True,
                                    bands=self.bands).to(torch.float32), pred]
        return pred


def resnet101(**kwargs) -> DualResNet:
    """The reference's `resnet101` factory (archs.py:1691-1696)."""
    return DualResNet(layers=(3, 4, 23, 3), **kwargs)


def duplicate_dualpath_params(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The reference's `load_dualpath_model` rgb -> hha copy on a state dict:
    every key with an `hha_` module (`backbone.layer1_0.hha_conv1.weight`,
    `backbone.hha_stem.bn1.running_var`) whose rgb sibling (the same key
    without that `hha_`) exists gets a copy of the rgb tensor; every other
    key is kept as it is."""
    out = dict(state_dict)
    for key in state_dict:
        parts = key.split(".")
        for i, p in enumerate(parts):
            if p.startswith("hha_"):
                rgb = ".".join(parts[:i] + [p[4:]] + parts[i + 1:])
                if rgb in state_dict:
                    out[key] = state_dict[rgb].clone()
                break
    return out
