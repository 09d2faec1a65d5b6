"""ISIC trainer with the CascadePSP refinement hook (counterpart of
train_isic_ca.py at the repo root; reference train_ISIC_ca.py):

    python -m pytorch_nested_unet_tpu_torch.train_isic_ca [any train flag]

The reference imports CascadePSP and stubs a Refiner call in its validation
(train_ISIC_ca.py:33-36, :183-189, commented out). Here training is the ISIC
preset's (train_isic.py), and refinement is live at evaluation (`val
--refine [--refine_weights PTH]`) or in the model (--arch UNetRNNPSP /
UNetRNNCAttention_PSP). Any flag given overrides the preset.
"""

import sys

from . import train
from .train_isic import PRESET, _with_defaults


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    return train.main(_with_defaults(argv, PRESET))


if __name__ == "__main__":
    main()
