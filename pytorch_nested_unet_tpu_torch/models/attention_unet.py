"""Attention U-Net family: AttU_Net, R2U_Net, R2AttU_Net (counterpart of
models/attention_unet.py; reference archs.py:1240-1480, conv_block
archs.py:29-46).

R2U_Net is the model the JAX package rebuilds from the reference's
commented-out body (R2AttU_Net without the gates). Every BN is the plain
`BatchNorm` (no kernel, as in the JAX package). The constructor follows the
registry's (num_classes, input_channels, deep_supervision) contract, as the
JAX package's does.

Modules keep the reference's index-style layout, so the state dict's keys
are its checkpoints' own: `Conv1.conv.{0,1,3,4}` (conv, BN, conv, BN),
`Up5.up.{1,2}`, `Att5.{W_g,W_x,psi}.{0,1}`, `RRCNN1.Conv_1x1`,
`RRCNN1.RCNN.{0,1}.conv.{0,1}`, `Conv_1x1`.
"""

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..ops.init import init_convs_
from ..ops.layers import BatchNorm, ChannelDropout, TorchConv
from ..ops.pool import max_pool2x2
from ..ops.resize import resize_nearest


class ConvBlock(nn.Module):
    """(conv3x3 -> BN -> ReLU) x2, then channel dropout in train mode when
    `drop_out` and `drop_rate` > 0 (reference archs.py:29-46; the JAX
    package's dropout is train-only, the reference's is not). The dropout's
    masks are seeded from `generator`."""

    def __init__(self, in_channels: int, out_channels: int, drop_out: bool = False,
                 drop_rate: float = 0.5, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = nn.Sequential(
            TorchConv(in_channels, out_channels, 3, 1, dtype), BatchNorm(out_channels, dtype=dtype),
            nn.ReLU(),
            TorchConv(out_channels, out_channels, 3, 1, dtype),
            BatchNorm(out_channels, dtype=dtype), nn.ReLU())
        self.dropout = (ChannelDropout(drop_rate, generator) if drop_out and drop_rate > 0
                        else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        return x if self.dropout is None else self.dropout(x)


class Upsample2xNearest(nn.Module):
    """`nn.Upsample(scale_factor=2)` (nearest) on NHWC; with `bands` (the
    'x'/'y' mesh axes) the band's rows of the whole map's upsample."""

    bands = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return resize_nearest(x, (x.shape[1] * 2, x.shape[2] * 2), self.bands)


class UpConv(nn.Module):
    """Nearest 2x upsample -> conv3x3 -> BN -> ReLU (reference archs.py:1244-1256)."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.up = nn.Sequential(Upsample2xNearest(),
                                TorchConv(in_channels, out_channels, 3, 1, dtype),
                                BatchNorm(out_channels, dtype=dtype), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.up(x)


class RecurrentBlock(nn.Module):
    """x1 = conv(x), then t times x1 = conv(x + x1), one conv -> BN -> ReLU
    shared by all t + 1 steps (reference archs.py:1257-1275): in train mode
    its BN's running statistics move t + 1 times per forward."""

    def __init__(self, channels: int, t: int = 2, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.t = t
        self.conv = nn.Sequential(TorchConv(channels, channels, 3, 1, dtype),
                                  BatchNorm(channels, dtype=dtype), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.conv(x)
        for _ in range(self.t):
            x1 = self.conv(x + x1)
        return x1


class RRCNNBlock(nn.Module):
    """1x1 conv, then two recurrent blocks with a residual (reference
    archs.py:1276-1292)."""

    def __init__(self, in_channels: int, out_channels: int, t: int = 2,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.Conv_1x1 = TorchConv(in_channels, out_channels, 1, 0, dtype)
        self.RCNN = nn.Sequential(RecurrentBlock(out_channels, t, dtype),
                                  RecurrentBlock(out_channels, t, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv_1x1(x)
        return x + self.RCNN(x)


class AttentionGate(nn.Module):
    """Additive gate: x * sigmoid(BN(conv(relu(BN(W_g g) + BN(W_x x))))), the
    last BN at C = 1 (reference archs.py:1293-1321)."""

    def __init__(self, g_channels: int, x_channels: int, inter_channels: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.W_g = nn.Sequential(TorchConv(g_channels, inter_channels, 1, 0, dtype),
                                 BatchNorm(inter_channels, dtype=dtype))
        self.W_x = nn.Sequential(TorchConv(x_channels, inter_channels, 1, 0, dtype),
                                 BatchNorm(inter_channels, dtype=dtype))
        self.psi = nn.Sequential(TorchConv(inter_channels, 1, 1, 0, dtype),
                                 BatchNorm(1, dtype=dtype), nn.Sigmoid())

    def forward(self, g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return x * self.psi(torch.relu(self.W_g(g) + self.W_x(x)))


class _EncDecUNet(nn.Module):
    """The LeeJunHyun family's 5-level encoder/decoder: blocks at each level
    (ConvBlock, or RRCNNBlock when RECURRENT), 2x2 max-pools down, UpConv up,
    an attention gate on the skip when ATTENTION, concat [skip, up] and a
    decoder block, a 1x1 head, float32 whatever the compute dtype.
    `deep_supervision` is accepted for the registry's contract and unused.
    `bands`: the pools' windows on the 'x'/'y' mesh axes."""

    bands = None

    RECURRENT = False
    ATTENTION = False

    def __init__(self, num_classes: int = 1, input_channels: int = 3,
                 deep_supervision: bool = False, t: int = 2,
                 filters: Sequence[int] = (64, 128, 256, 512, 1024),
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        fs = tuple(int(f) for f in filters)
        self.dtype = dtype
        self.levels = len(fs)
        enc, dec = ("RRCNN", "Up_RRCNN") if self.RECURRENT else ("Conv", "Up_conv")
        for i, f in enumerate(fs):
            setattr(self, f"{enc}{i + 1}", self._block(fs[i - 1] if i else input_channels, f,
                                                        t, dtype))
        for level in range(len(fs) - 1, 0, -1):
            f = fs[level - 1]
            setattr(self, f"Up{level + 1}", UpConv(fs[level], f, dtype))
            if self.ATTENTION:
                setattr(self, f"Att{level + 1}", AttentionGate(f, f, max(f // 2, 1), dtype))
            setattr(self, f"{dec}{level + 1}", self._block(2 * f, f, t, dtype))
        self.Conv_1x1 = TorchConv(fs[0], num_classes, 1, 0, dtype)
        self._enc, self._dec = enc, dec
        init_convs_(self, generator)

    def _block(self, cin, cout, t, dtype):
        return RRCNNBlock(cin, cout, t, dtype) if self.RECURRENT else ConvBlock(
            cin, cout, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        enc = []
        for i in range(self.levels):
            if i > 0:
                x = max_pool2x2(x, self.bands)
            x = getattr(self, f"{self._enc}{i + 1}")(x)
            enc.append(x)
        d = enc[-1]
        for level in range(self.levels - 1, 0, -1):
            skip = enc[level - 1]
            d = getattr(self, f"Up{level + 1}")(d)
            if self.ATTENTION:
                skip = getattr(self, f"Att{level + 1}")(d, skip)
            d = getattr(self, f"{self._dec}{level + 1}")(torch.cat([skip, d], dim=-1))
        return self.Conv_1x1(d).to(torch.float32)


class AttU_Net(_EncDecUNet):
    """Attention U-Net (reference archs.py:1402-1474)."""

    ATTENTION = True


class R2U_Net(_EncDecUNet):
    """Recurrent-residual U-Net (the model behind the reference's dead code,
    archs_backup.py:1856-1974)."""

    RECURRENT = True


class R2AttU_Net(_EncDecUNet):
    """Recurrent-residual attention U-Net (reference archs.py:1322-1396)."""

    RECURRENT = True
    ATTENTION = True
