"""NestedUNet (UNet++), the flagship model (counterpart of models/nested_unet.py;
reference archs_backup.py:84-152).

Node x_{i,j} = VGGBlock(x_{i,0..j-1}, up(x_{i+1,j-1})): each decoder node hands
its first conv the parts tuple, so on the card the concat is never written.
Deep supervision: four 1x1 heads on x0_1..x0_4 returning a list; else one head
on x0_4. NHWC in and out; heads are float32 whatever the compute dtype.

`remat` rematerializes every VGGBlock in backward, as the JAX module's
option: False / None / "none" keeps every residual, True / "full" recomputes
each block from its inputs, "policy" keeps only the conv outputs and
recomputes the BN + ReLU elementwise math (see blocks.VGGBlock). Per train
step K1 launches 30 times under "none" and "policy" and 60 under "full"
(its recompute runs K1 again, without the running statistics), K2 and K3
30 times under each, and K4 10 times, 20 under "full".

Under the 'x'/'y' mesh axes (`parallel.mesh.spatial_partition`; remat
"none" only) it runs on this rank's band: its convs, K4 and upsamples take
halos, its pools stay local.
"""

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..ops.init import init_convs_
from ..ops.layers import TorchConv
from ..ops.pool import max_pool2x2
from ..ops.resize import Upsample2x
from .blocks import VGGBlock


def remat_mode(remat) -> str:
    """The JAX module's remat values -> one of blocks.REMAT_MODES."""
    if remat in (False, None, "none"):
        return "none"
    if remat in (True, "full"):
        return "full"
    if remat == "policy":
        return "policy"
    raise ValueError(f"remat must be False/True/'full'/'policy'/'none', got {remat!r}")


class NestedUNet(nn.Module):
    def __init__(self, num_classes: int = 1, input_channels: int = 3,
                 deep_supervision: bool = False,
                 nb_filter: Sequence[int] = (32, 64, 128, 256, 512), remat=False,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        nb = tuple(int(c) for c in nb_filter)
        self.deep_supervision = deep_supervision
        self.dtype = dtype
        self.up = Upsample2x()
        self.remat = remat_mode(remat)
        kw = {"dtype": dtype, "remat": self.remat}
        # Registration order follows the reference module's __init__.
        self.conv0_0 = VGGBlock(input_channels, nb[0], nb[0], **kw)
        for i in range(1, 5):
            setattr(self, f"conv{i}_0", VGGBlock(nb[i - 1], nb[i], nb[i], **kw))
        for j in range(1, 5):
            for i in range(0, 5 - j):
                cin = nb[i] * j + nb[i + 1]
                setattr(self, f"conv{i}_{j}", VGGBlock(cin, nb[i], nb[i], multipart=True, **kw))
        heads = ("final1", "final2", "final3", "final4") if deep_supervision else ("final",)
        for name in heads:
            setattr(self, name, TorchConv(nb[0], num_classes, 1, dtype=dtype))
        init_convs_(self, generator)

    def forward(self, x: torch.Tensor):
        if self.dtype is not None:
            x = x.to(self.dtype)
        up = self.up
        x0_0 = self.conv0_0(x)
        x1_0 = self.conv1_0(max_pool2x2(x0_0))
        x0_1 = self.conv0_1((x0_0, up(x1_0)))

        x2_0 = self.conv2_0(max_pool2x2(x1_0))
        x1_1 = self.conv1_1((x1_0, up(x2_0)))
        x0_2 = self.conv0_2((x0_0, x0_1, up(x1_1)))

        x3_0 = self.conv3_0(max_pool2x2(x2_0))
        x2_1 = self.conv2_1((x2_0, up(x3_0)))
        x1_2 = self.conv1_2((x1_0, x1_1, up(x2_1)))
        x0_3 = self.conv0_3((x0_0, x0_1, x0_2, up(x1_2)))

        x4_0 = self.conv4_0(max_pool2x2(x3_0))
        x3_1 = self.conv3_1((x3_0, up(x4_0)))
        x2_2 = self.conv2_2((x2_0, x2_1, up(x3_1)))
        x1_3 = self.conv1_3((x1_0, x1_1, x1_2, up(x2_2)))
        x0_4 = self.conv0_4((x0_0, x0_1, x0_2, x0_3, up(x1_3)))

        if self.deep_supervision:
            return [getattr(self, f"final{k}")(feat).to(torch.float32)
                    for k, feat in zip((1, 2, 3, 4), (x0_1, x0_2, x0_3, x0_4))]
        return self.final(x0_4).to(torch.float32)
