"""ISIC-2018 trainer preset of the port (counterpart of train_isic.py at the
repo root; reference train_ISIC.py):

    python -m pytorch_nested_unet_tpu_torch.train_isic [any train flag]

Delegates to the port's train.main with the reference script's defaults: the
ISIC layout (inputs/ISIC/{train,test}/{image,mask}, `<id>_segmentation`
masks), .jpg images and .png masks, and augmentation reduced to resize +
normalize. Any flag given overrides the preset.
"""

import argparse
import sys

from . import train


def _with_defaults(argv, defaults):
    """argv plus each of `defaults`' flags (and its value) whose destination
    argv does not set itself. What argv sets is read by the trainer's own
    parser with every default suppressed, so each spelling counts: `-b4`,
    `-b 4`, `--batch 4` (an abbreviation), `--batch_size=4`, `-aUNet`."""
    parser = train.build_parser()
    for action in parser._actions:
        action.default = argparse.SUPPRESS
    given = vars(parser.parse_args(argv))
    out = list(argv)
    for flag, value in defaults.items():
        if parser._option_string_actions[flag].dest not in given:
            out += [flag, value]
    return out


PRESET = {
    "--dataset": "ISIC",
    "--dataset_layout": "isic",
    "--img_ext": ".jpg",
    "--mask_ext": ".png",
    "--augment": "none",
}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    return train.main(_with_defaults(argv, PRESET))


if __name__ == "__main__":
    main()
