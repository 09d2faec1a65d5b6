"""ISIC-2018 trainer with pixel-accuracy columns in log.csv (counterpart of
train_isic_wacc.py at the repo root; reference trainISIC_wAcc.py):

    python -m pytorch_nested_unet_tpu_torch.train_isic_wacc [any train flag]

The ISIC preset (train_isic.py) plus --log_acc true.
"""

import sys

from . import train
from .train_isic import PRESET, _with_defaults


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    return train.main(_with_defaults(argv, {**PRESET, "--log_acc": "true"}))


if __name__ == "__main__":
    main()
