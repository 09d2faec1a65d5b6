"""ISIC-2018 trainer preset of the port (counterpart of train_isic.py at the
repo root; reference train_ISIC.py):

    python -m pytorch_nested_unet_tpu_torch.train_isic [any train flag]

Delegates to the port's train.main with the reference script's defaults: the
ISIC layout (inputs/ISIC/{train,test}/{image,mask}, `<id>_segmentation`
masks), .jpg images and .png masks, and augmentation reduced to resize +
normalize. Any flag given overrides the preset.
"""

import sys

from . import train


# train's short flags, so a preset's long flag does not override them
_SHORT = {"-b": "--batch_size", "-a": "--arch"}


def _with_defaults(argv, defaults):
    """argv plus each of `defaults`' flags (and its value) that argv does not
    give itself."""
    given = {_SHORT.get(f, f) for f in (a.split("=")[0] for a in argv if a.startswith("-"))}
    out = list(argv)
    for flag, value in defaults.items():
        if flag not in given:
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
