"""Plain U-Net (counterpart of models/unet.py; reference archs_backup.py:46-81).

Five VGGBlock levels down with 2x2 max-pools, four up: each decoder node hands
its first conv the parts tuple (skip, up(x)), so on the card the decoder-fusion
kernel runs at all 4 nodes and the concat is never written. One 1x1 head,
float32 whatever the compute dtype. `deep_supervision` is accepted for the
registry's constructor contract and unused. Under the 'x'/'y' mesh axes
(`parallel.mesh.spatial_partition`) it runs on this rank's band: its convs
and upsamples read the rows around their output rows, its pools the window
of theirs (`bands`), at any size whose bands may be unequal or empty.
"""

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..ops.init import init_convs_
from ..ops.layers import TorchConv
from ..ops.pool import max_pool2x2
from ..ops.resize import Upsample2x
from .blocks import VGGBlock


class UNet(nn.Module):
    bands = None  # a parallel.bands.Bands on the 'x'/'y' mesh axes: the pools' windows

    def __init__(self, num_classes: int = 1, input_channels: int = 3,
                 deep_supervision: bool = False,
                 nb_filter: Sequence[int] = (32, 64, 128, 256, 512),
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        nb = tuple(int(c) for c in nb_filter)
        self.dtype = dtype
        self.up = Upsample2x()
        self.conv0_0 = VGGBlock(input_channels, nb[0], nb[0], dtype=dtype)
        for i in range(1, 5):
            setattr(self, f"conv{i}_0", VGGBlock(nb[i - 1], nb[i], nb[i], dtype=dtype))
        for i in range(3, -1, -1):  # conv3_1, conv2_2, conv1_3, conv0_4
            setattr(self, f"conv{i}_{4 - i}",
                    VGGBlock(nb[i] + nb[i + 1], nb[i], nb[i], multipart=True, dtype=dtype))
        self.final = TorchConv(nb[0], num_classes, 1, dtype=dtype)
        init_convs_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        feats = [self.conv0_0(x)]
        for i in range(1, 5):
            feats.append(getattr(self, f"conv{i}_0")(max_pool2x2(feats[-1], self.bands)))
        y = feats[4]
        for i in range(3, -1, -1):
            y = getattr(self, f"conv{i}_{4 - i}")((feats[i], self.up(y)))
        return self.final(y).to(torch.float32)
