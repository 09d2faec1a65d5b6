"""CA-Net, the Comprehensive Attention U-Net (counterpart of models/canet.py;
reference archs.py:29-959).

Encoder conv blocks x5; decoder: UpCat (deconv + concat) and SE conv blocks,
grid-attention gates on the skips, a non-local block at the bottleneck;
deep-supervision heads concatenated and fused by the scale-attention block;
a 1x1 head. The port keeps the JAX package's documented divergences from the
reference: global pooling in the SE blocks (any input size), edge
replication where a deconv comes out smaller than its skip, train-only
dropout, the registry's constructor contract, and with 1 class the raw
logit (the reference's Softmax2d over one channel is the constant 1); with
more it returns the float32 softmax over the classes.

BNs: the plain `BatchNorm` everywhere, except where the JAX package uses
flax's own `nn.BatchNorm` -- the non-local block's W BN (momentum 0.9 in
flax's convention, scale starting at 0) and SpatialAtten's conv1 BN (0.99):
those are `FlaxBatchNorm` (biased running variance, float32). No kernel.

On the 'x'/'y' mesh axes `parallel.mesh.spatial_partition` sets the
`bands` of the modules that reduce, attend or resize over the whole map (a
`parallel.bands.Bands`): the non-local block attends from its band's
queries to the whole map's pooled keys and values, the grid gates resize
and (concatenation_residual) take their softmax over the whole map, the SE
and channel gates pool over it, the deep-supervision heads and the
bilinear UpCat resize the band's share of the whole map, UpCat's
replicate pad and the pools take the window of their output rows. The 2x2
stride-2 deconv and a theta of kernel = stride read the window of their
output rows like any conv; the channel dropout draws per data row
(`parallel.mesh.sync_batch_norm`). With `bands` None each runs on the whole
image.

Modules keep the reference's layout, so the state dict's keys are its
checkpoints' own: `conv1.conv.{0,1,3,4}`, `nonlocal4_2.{g.0,theta,phi.0,W.0,
W.1}`, `attentionblock3.gate_block_1.{theta,phi,psi,W.0,W.1}`,
`attentionblock3.combine_gates.{0,1}`, `up4.{conv1,bn1,...,downchannel.0,
fc1,fc2}`, `up_concat4.up`, `dsv4.dsv.0`, `dsv1`,
`scale_att.cbam.ChannelGate.mlp.{1,3}`,
`scale_att.cbam.SpatialGate.conv{1,2}.{conv,bn}`, `scale_att.{conv3,bn3}`,
`final.0`.
"""

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.init import init_convs_
from ..ops.layers import (BatchNorm, ChannelDropout, FlaxBatchNorm, TorchConv,
                          TorchConvTranspose, TorchDense, _pair)
from ..ops.pool import global_avg_pool, global_max_pool, max_pool2x2
from ..ops.resize import resize_bilinear
from .attention_unet import ConvBlock

GRID_MODES = ("concatenation", "concatenation_debug", "concatenation_residual")
NONLOCAL_MODES = ("embedded_gaussian", "dot_product")
# the scale attention's channel reduction: 16 deep-supervision maps, 4 scales
REDUCTION = 4


class GridAttentionBlock2D(nn.Module):
    """Gated grid attention (reference archs.py:101-253): theta(x) plus
    phi(g) resized to theta's size, relu (softplus in concatenation_debug),
    psi to one channel, a sigmoid gate (concatenation_residual: a softmax
    over the flattened map, in float32) resized to x's size, applied to x,
    then a 1x1 conv + BN. Returns (W(att * x), att)."""

    bands = None

    def __init__(self, in_channels: int, gating_channels: int, inter_channels: int,
                 mode: str = "concatenation", sub_sample_factor=(1, 1),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if mode not in GRID_MODES:
            raise NotImplementedError(mode)
        self.mode = mode
        sf = _pair(sub_sample_factor)
        self.theta = TorchConv(in_channels, inter_channels, sf, 0, dtype, stride=sf)
        self.phi = TorchConv(gating_channels, inter_channels, 1, 0, dtype)
        self.psi = TorchConv(inter_channels, 1, 1, 0, dtype)
        self.W = nn.Sequential(TorchConv(in_channels, in_channels, 1, 0, dtype),
                               BatchNorm(in_channels, dtype=dtype))

    def forward(self, x: torch.Tensor, g: torch.Tensor):
        theta_x = self.theta(x)
        phi_g = resize_bilinear(self.phi(g), theta_x.shape[1:3], align_corners=False,
                                bands=self.bands)
        f = theta_x + phi_g
        f = F.softplus(f) if self.mode == "concatenation_debug" else torch.relu(f)
        psi_f = self.psi(f)
        if self.mode == "concatenation_residual":
            flat = psi_f.reshape(psi_f.shape[0], -1).to(torch.float32)
            att = (torch.softmax(flat, dim=-1) if self.bands is None
                   else self.bands.softmax(flat)).reshape(psi_f.shape).to(x.dtype)
        else:
            att = torch.sigmoid(psi_f)
        att = resize_bilinear(att, x.shape[1:3], align_corners=False, bands=self.bands)
        return self.W(att * x), att


class MultiAttentionBlock(nn.Module):
    """Two grid-attention gates in parallel, combined by 1x1 conv + BN +
    ReLU (reference archs.py:263-285). Returns (combined, both gates' maps)."""

    def __init__(self, in_channels: int, gating_channels: int, inter_channels: int,
                 nonlocal_mode: str = "concatenation", sub_sample_factor=(1, 1),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        for i in (1, 2):
            setattr(self, f"gate_block_{i}", GridAttentionBlock2D(
                in_channels, gating_channels, inter_channels, nonlocal_mode,
                sub_sample_factor, dtype))
        self.combine_gates = nn.Sequential(
            TorchConv(2 * in_channels, in_channels, 1, 0, dtype),
            BatchNorm(in_channels, dtype=dtype), nn.ReLU())

    def forward(self, x: torch.Tensor, g: torch.Tensor):
        gate1, att1 = self.gate_block_1(x, g)
        gate2, att2 = self.gate_block_2(x, g)
        return (self.combine_gates(torch.cat([gate1, gate2], dim=-1)),
                torch.cat([att1, att2], dim=-1))


class NonLocalBlock2D(nn.Module):
    """Non-local block, embedded_gaussian (softmax over the keys, in float32)
    or dot_product (divided by the key count) (reference archs.py:286-570):
    g and phi 2x2 max-pooled (CA-Net's sub-sampling), W a 1x1 conv and a
    flax-semantics BN whose scale starts at 0, so the block starts as the
    identity; a residual around it."""

    bands = None

    def __init__(self, in_channels: int, inter_channels: int,
                 mode: str = "embedded_gaussian", dtype: Optional[torch.dtype] = None):
        super().__init__()
        if mode not in NONLOCAL_MODES:
            raise NotImplementedError(mode)
        self.mode = mode
        self.g = nn.Sequential(TorchConv(in_channels, inter_channels, 1, 0, dtype))
        self.theta = TorchConv(in_channels, inter_channels, 1, 0, dtype)
        self.phi = nn.Sequential(TorchConv(in_channels, inter_channels, 1, 0, dtype))
        self.W = nn.Sequential(TorchConv(inter_channels, in_channels, 1, 0, dtype),
                               FlaxBatchNorm(in_channels, momentum=0.1, zero_scale=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        g_x, theta_x = max_pool2x2(self.g(x), self.bands), self.theta(x)
        phi_x = max_pool2x2(self.phi(x), self.bands)
        ic = theta_x.shape[-1]
        if self.bands is not None:  # the whole map's keys and values
            whole = self.bands.gather(torch.cat([phi_x, g_x], dim=-1))
            phi_x, g_x = whole[..., :ic], whole[..., ic:]
        q = theta_x.reshape(b, h * w, ic)
        k = phi_x.reshape(b, -1, ic)
        v = g_x.reshape(b, -1, ic)
        f = torch.bmm(q, k.transpose(1, 2))
        if self.mode == "embedded_gaussian":
            attn = torch.softmax(f.to(torch.float32), dim=-1).to(v.dtype)
        else:
            attn = f / f.shape[-1]
        y = torch.bmm(attn, v).reshape(b, h, w, ic)
        return self.W(y).to(x.dtype) + x


class UpCat(nn.Module):
    """2x upsample of `down` (a 2x2 stride-2 deconv, or bilinear without
    `is_deconv`), padded by edge replication to the skip's size where it
    comes out smaller, concatenated after the skip (reference
    archs.py:571-593; the reference pads with torch.rand)."""

    bands = None

    def __init__(self, in_channels: int, out_channels: int, is_deconv: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.up = (TorchConvTranspose(in_channels, out_channels, 2, 2, dtype=dtype)
                   if is_deconv else None)

    def forward(self, skip: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
        if self.up is not None:
            up = self.up(down)
        else:
            up = resize_bilinear(down, (down.shape[1] * 2, down.shape[2] * 2),
                                 align_corners=False, bands=self.bands)
        if self.bands is not None:
            return torch.cat([skip, self.bands.pad_replicate(up, skip.shape[1:3])], dim=-1)
        dh, dw = skip.shape[1] - up.shape[1], skip.shape[2] - up.shape[2]
        if dh > 0 or dw > 0:
            up = F.pad(up.permute(0, 3, 1, 2), (0, max(dw, 0), 0, max(dh, 0)),
                       mode="replicate").permute(0, 2, 3, 1).contiguous()
        return torch.cat([skip, up], dim=-1)


class SEConvBlock(nn.Module):
    """conv3x3 -> BN -> ReLU -> conv3x3 (2 * planes) -> BN, gated per channel
    by a shared MLP (fc1, fc2) on the global average and on the global max,
    plus a residual (a 1x1 conv + BN when the input is not `planes` wide),
    then ReLU -> conv3x3 -> BN -> ReLU and channel dropout in train mode when
    `drop_out` (reference archs.py:598-712). The max is `amax`, which on ties
    spreads the gradient evenly, as JAX's does. Returns (out, avg + max gate)."""

    bands = None

    def __init__(self, inplanes: int, planes: int, drop_out: bool = False,
                 drop_rate: float = 0.5, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        p = planes
        self.conv1 = TorchConv(inplanes, p, 3, 1, dtype, use_bias=False)
        self.bn1 = BatchNorm(p, dtype=dtype)
        self.conv2 = TorchConv(p, 2 * p, 3, 1, dtype, use_bias=False)
        self.bn2 = BatchNorm(2 * p, dtype=dtype)
        self.downchannel = (nn.Sequential(TorchConv(inplanes, 2 * p, 1, 0, dtype, use_bias=False),
                                          BatchNorm(2 * p, dtype=dtype))
                            if inplanes != p else None)
        self.fc1 = TorchDense(2 * p, round(p / 2), dtype=dtype)
        self.fc2 = TorchDense(round(p / 2), 2 * p, dtype=dtype)
        self.conv3 = TorchConv(2 * p, p, 3, 1, dtype, use_bias=False)
        self.bn3 = BatchNorm(p, dtype=dtype)
        self.dropout = (ChannelDropout(drop_rate, generator) if drop_out and drop_rate > 0
                        else None)

    def _gate(self, pooled: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.fc2(torch.relu(self.fc1(pooled))))[:, None, None, :]

    def forward(self, x: torch.Tensor):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downchannel is None else self.downchannel(x)
        avg_att = self._gate(global_avg_pool(out, keepdims=False, bands=self.bands))
        max_att = self._gate(global_max_pool(out, self.bands))
        out = torch.relu(avg_att * out + max_att * out + residual)
        out = torch.relu(self.bn3(self.conv3(out)))
        if self.dropout is not None:
            out = self.dropout(out)
        return out, avg_att + max_att


class UnetDsv3(nn.Module):
    """Deep-supervision head: 1x1 conv to 4 maps, bilinear resize to
    `out_size` (reference archs.py:687-694)."""

    bands = None

    def __init__(self, in_channels: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dsv = nn.Sequential(TorchConv(in_channels, 4, 1, 0, dtype))

    def forward(self, x: torch.Tensor, out_size) -> torch.Tensor:
        return resize_bilinear(self.dsv(x), out_size, align_corners=False, bands=self.bands)


class ChannelGate(nn.Module):
    """A shared MLP on the global average and max pools, summed; the channels
    taken as 4 scales of C / 4 maps, each scale gated by the sigmoid of its
    mean (reference archs.py:734-768). Returns (x * gate, gate)."""

    bands = None

    def __init__(self, channels: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.mlp = nn.Sequential(nn.Flatten(),
                                 TorchDense(channels, channels // REDUCTION, dtype=dtype),
                                 nn.ReLU(),
                                 TorchDense(channels // REDUCTION, channels, dtype=dtype))

    def forward(self, x: torch.Tensor):
        b, c = x.shape[0], x.shape[-1]
        att = (self.mlp(global_avg_pool(x, keepdims=False, bands=self.bands))
               + self.mlp(global_max_pool(x, self.bands)))
        att = att.reshape(b, 4, c // 4)
        avg_weight = att.mean(dim=2, keepdim=True).expand(b, 4, c // 4).reshape(b, c)
        scale = torch.sigmoid(avg_weight)[:, None, None, :]
        return x * scale, scale


class BasicConv(nn.Module):
    """conv (no bias) [-> flax-semantics BN, momentum 0.99 in flax's
    convention] -> ReLU (the reference's BasicConv as SpatialAtten uses it)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 bn: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = TorchConv(in_channels, out_channels, kernel_size, (kernel_size - 1) // 2,
                              dtype, use_bias=False)
        self.bn = FlaxBatchNorm(out_channels, momentum=0.01) if bn else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        if self.bn is not None:
            y = self.bn(y).to(x.dtype)
        return torch.relu(y)


class SpatialAtten(nn.Module):
    """A per-scale spatial gate (conv3x3 + BN + ReLU, conv1x1 + ReLU, sigmoid
    to `out_size` maps), each map repeated over its scale's channels, and a
    residual: x * att + x (reference archs.py:713-733). Returns (out, att)."""

    def __init__(self, in_channels: int, out_size: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = BasicConv(in_channels, out_size, 3, dtype=dtype)
        self.conv2 = BasicConv(out_size, out_size, 1, bn=False, dtype=dtype)

    def forward(self, x: torch.Tensor):
        att = torch.sigmoid(self.conv2(self.conv1(x)))
        att = att.repeat_interleave(x.shape[-1] // att.shape[-1], dim=-1)
        return x * att + x, att


class _CBAM(nn.Module):
    """The reference's scope of the two gates (`cbam.ChannelGate`,
    `cbam.SpatialGate`)."""

    def __init__(self, channels: int, dtype: Optional[torch.dtype]):
        super().__init__()
        self.ChannelGate = ChannelGate(channels, dtype)
        self.SpatialGate = SpatialAtten(channels, channels // REDUCTION, dtype)


class ScaleAttenConvBlock(nn.Module):
    """Scale attention (the channel gate, then the spatial gate), a residual,
    ReLU, conv3x3 (no bias) -> BN -> ReLU to `out_size` channels (reference
    archs.py:769-842)."""

    def __init__(self, in_channels: int, out_size: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cbam = _CBAM(in_channels, dtype)
        self.conv3 = TorchConv(in_channels, out_size, 3, 1, dtype, use_bias=False)
        self.bn3 = BatchNorm(out_size, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out, _ = self.cbam.ChannelGate(x)
        out, _ = self.cbam.SpatialGate(out)
        out = torch.relu(out + x)
        return torch.relu(self.bn3(self.conv3(out)))


class Comprehensive_Atten_Unet(nn.Module):
    """CA-Net (reference archs.py:844-959) at widths (64, ..., 1024) /
    `feature_scale`. `nonlocal_mode` is the grid gates' mode,
    `attention_dsample` their theta stride; `out_size` is accepted for the
    JAX package's contract (the heads resize to the input's size);
    `drop_rate` 0 turns the dropout of conv4, center and up4 off. Returns
    the float32 logit with 1 class, the float32 softmax over the classes
    with more. `bands`: the pools' windows on the 'x'/'y' mesh axes."""

    bands = None

    def __init__(self, num_classes: int = 2, input_channels: int = 3,
                 deep_supervision: bool = False, feature_scale: int = 4,
                 is_deconv: bool = True, nonlocal_mode: str = "concatenation",
                 attention_dsample: Tuple[int, int] = (1, 1),
                 out_size: Tuple[int, int] = (224, 300), drop_rate: float = 0.5,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        f = [int(c / feature_scale) for c in (64, 128, 256, 512, 1024)]
        self.filters = f  # a width a level: parallel/mesh.py counts the pools from it
        self.dtype, self.num_classes, self.out_size = dtype, num_classes, out_size
        dt = dtype
        self.conv1 = ConvBlock(input_channels, f[0], dtype=dt)
        self.conv2 = ConvBlock(f[0], f[1], dtype=dt)
        self.conv3 = ConvBlock(f[1], f[2], dtype=dt)
        self.conv4 = ConvBlock(f[2], f[3], True, drop_rate, dt, generator)
        self.center = ConvBlock(f[3], f[4], True, drop_rate, dt, generator)

        def upcat(skip_c, down_c, out_c):
            return UpCat(down_c, out_c, is_deconv, dt), skip_c + (out_c if is_deconv else down_c)

        self.up_concat4, c4 = upcat(f[3], f[4], f[3])
        self.nonlocal4_2 = NonLocalBlock2D(c4, f[4] // 4, dtype=dt)
        self.up4 = SEConvBlock(c4, f[3], True, drop_rate, dt, generator)
        self.attentionblock3 = MultiAttentionBlock(f[2], f[3], f[2], nonlocal_mode,
                                                   attention_dsample, dt)
        self.up_concat3, c3 = upcat(f[2], f[3], f[2])
        self.up3 = SEConvBlock(c3, f[2], dtype=dt)
        self.attentionblock2 = MultiAttentionBlock(f[1], f[2], f[1], nonlocal_mode,
                                                   attention_dsample, dt)
        self.up_concat2, c2 = upcat(f[1], f[2], f[1])
        self.up2 = SEConvBlock(c2, f[1], dtype=dt)
        self.up_concat1, c1 = upcat(f[0], f[1], f[0])
        self.up1 = SEConvBlock(c1, f[0], dtype=dt)
        self.dsv4 = UnetDsv3(f[3], dt)
        self.dsv3 = UnetDsv3(f[2], dt)
        self.dsv2 = UnetDsv3(f[1], dt)
        self.dsv1 = TorchConv(f[0], 4, 1, 0, dt)
        self.scale_att = ScaleAttenConvBlock(16, 4, dtype=dt)
        self.final = nn.Sequential(TorchConv(4, num_classes, 1, 0, dt))
        init_convs_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        conv1 = self.conv1(x)
        conv2 = self.conv2(max_pool2x2(conv1, self.bands))
        conv3 = self.conv3(max_pool2x2(conv2, self.bands))
        conv4 = self.conv4(max_pool2x2(conv3, self.bands))
        center = self.center(max_pool2x2(conv4, self.bands))

        up4 = self.up_concat4(conv4, center)
        up4, _ = self.up4(self.nonlocal4_2(up4))
        g_conv3, _ = self.attentionblock3(conv3, up4)
        up3, _ = self.up3(self.up_concat3(g_conv3, up4))
        g_conv2, _ = self.attentionblock2(conv2, up3)
        up2, _ = self.up2(self.up_concat2(g_conv2, up3))
        up1, _ = self.up1(self.up_concat1(conv1, up2))

        size = x.shape[1:3]
        dsv = torch.cat([self.dsv1(up1), self.dsv2(up2, size), self.dsv3(up3, size),
                         self.dsv4(up4, size)], dim=-1)
        out = self.final(self.scale_att(dsv)).to(torch.float32)
        return out if self.num_classes == 1 else torch.softmax(out, dim=-1)
