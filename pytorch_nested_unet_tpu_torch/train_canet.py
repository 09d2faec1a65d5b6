"""CA-Net trainer preset of the port (counterpart of train_canet.py at the
repo root; reference train_Canet.py):

    python -m pytorch_nested_unet_tpu_torch.train_canet [any train flag]

The ISIC preset (train_isic.py) with the reference script's model and
sizes: Comprehensive_Atten_Unet, batch 2, 256x256 inputs. Any flag given
overrides the preset (-b and -a count as --batch_size and --arch), e.g.
`--img_ext .png` for a folder of PNG images.
"""

import sys

from . import train
from .train_isic import PRESET as ISIC_PRESET
from .train_isic import _with_defaults

PRESET = {
    **ISIC_PRESET,
    "--arch": "Comprehensive_Atten_Unet",
    "--batch_size": "2",
    "--input_w": "256",
    "--input_h": "256",
}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    return train.main(_with_defaults(argv, PRESET))


if __name__ == "__main__":
    main()
