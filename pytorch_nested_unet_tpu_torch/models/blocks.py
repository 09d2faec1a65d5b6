"""Conv blocks of NestedUNet over NHWC tensors (counterpart of models/blocks.py)."""

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..ops.decoder_fusion import multipart_conv3x3, pack_weight
from ..ops.fused_bn import FusedBatchNormReLU
from ..ops.layers import TorchConv


class MultipartConv3x3(nn.Module):
    """conv3x3(concat(parts), padding=1) with TorchConv's parameters.

    `weight` [co, cin, 3, 3] and `bias` [co] are float32 under torch's names, so
    a reference checkpoint's `<node>.conv1.{weight,bias}` load into it. The
    forward runs `ops.decoder_fusion.multipart_conv3x3` on the parts tuple; its
    HWIO copy of the weights in the compute dtype is made once and made again
    only when the weights change (a load, a move to another device).
    """

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 3, 3))
        self.bias = nn.Parameter(torch.empty(out_channels))
        self._packed = None
        self._packed_key = None

    def packed_weight(self, dtype: torch.dtype) -> torch.Tensor:
        w = self.weight
        # a tensor made under inference_mode keeps no version counter
        version = -1 if w.is_inference() else w._version
        key = (w.data_ptr(), version, w.device, dtype)
        if key != self._packed_key:
            self._packed, self._packed_key = pack_weight(w, dtype), key
        return self._packed

    def forward(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        dt = self.dtype or parts[0].dtype
        parts = tuple(p.to(dt) for p in parts)
        return multipart_conv3x3(parts, self.packed_weight(dt), self.bias)


class VGGBlock(nn.Module):
    """(conv3x3 -> BN -> ReLU) x2 (reference archs_backup.py:24-42).

    Given a tuple of NHWC parts (a decoder node's skips and its upsampled feed),
    the first conv is a MultipartConv3x3 over them; given one tensor, it is a
    TorchConv. `in_channels` is the parts' total.
    """

    def __init__(self, in_channels: int, middle_channels: int, out_channels: int,
                 multipart: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if multipart:
            self.conv1 = MultipartConv3x3(in_channels, middle_channels, dtype=dtype)
        else:
            self.conv1 = TorchConv(in_channels, middle_channels, 3, padding=1, dtype=dtype)
        self.bn1 = FusedBatchNormReLU(middle_channels, dtype=dtype)
        self.conv2 = TorchConv(middle_channels, out_channels, 3, padding=1, dtype=dtype)
        self.bn2 = FusedBatchNormReLU(out_channels, dtype=dtype)

    def forward(self, x) -> torch.Tensor:
        x = self.bn1(self.conv1(x))
        return self.bn2(self.conv2(x))
