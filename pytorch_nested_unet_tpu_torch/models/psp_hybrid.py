"""UNetRNN with in-model CascadePSP refinement: UNetRNNPSP and
UNetRNNCAttention_PSP (counterpart of models/psp_hybrid.py; reference
archs_backup.py:1397-1544 and :1719-1849).

The flow: UNetRNN's encoder and score blocks (CAM on each score map in the
CAttention variant), the RDC decode to h5, then the refinement network
`psp` (refinement.RefinementModule) on the input image and h5; the output
is its pred_224, a probability map in [0, 1] in float32.

Documented divergences, kept from the JAX package:
- The reference builds a fresh random refinement network inside every
  forward (archs_backup.py:1533-1537, :1842-1844), untrained, and
  UNetRNNPSP even returns a numpy uint8 array, so neither trains. Here the
  refinement network is a real submodule, trained end to end and
  differentiable, or loaded from the released CascadePSP weights.
- It runs the full-resolution 3-pass cascade (the driver's global pass);
  at the reference's 96-256 px sizes, below L = 900, the tiled local step
  does not run anyway (eval_helper.py:56-66).
- It gets the raw RDC output as its segmentation channel.
- num_classes must be 1 (the refinement stem takes the image and three
  single-channel segmentations); the reference fails otherwise too.

The 15 train-mode BN layers of the UNetRNN trunk run K1-K3 on the card;
the refinement network's BNs are plain (`ops/layers.py::BatchNorm`).

On the 'x'/'y' mesh axes (`parallel.mesh.spatial_partition`) the trunk and
the refinement network both run on the band (refinement/pspnet.py says
how), and the step gathers pred_224 as it gathers any head.
"""

import torch

from .dual_attention import UNetRNNCAttention
from .rdc import UNetRNN, rdc_decode


class _PSPTail:
    """RDC decode -> RefinementModule(x, h5) -> pred_224."""

    def __init__(self, *args, num_classes: int = 1, **kwargs):
        if num_classes != 1:
            raise ValueError("the PSP hybrids need num_classes=1 (the refinement stem "
                             "takes the image and 3 single-channel segmentations, "
                             "reference extractors.py:57)")
        super().__init__(*args, num_classes=num_classes, **kwargs)
        # imported here: refinement.pspnet builds on models.crdn_backbones
        from ..refinement.pspnet import RefinementModule

        self.psp = RefinementModule(self.dtype, kwargs.get("generator"),
                                    kwargs.get("input_channels", 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        h5 = rdc_decode(self.RDC, self.attend(self.score(self.encode(x))))
        return self.psp(x, h5)["pred_224"].to(torch.float32)


class UNetRNNPSP(_PSPTail, UNetRNN):
    """UNetRNN + cascade refinement (reference archs_backup.py:1719-1849)."""


class UNetRNNCAttention_PSP(_PSPTail, UNetRNNCAttention):
    """CAM-attended UNetRNN + cascade refinement (reference
    archs_backup.py:1397-1544)."""
