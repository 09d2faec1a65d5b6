"""Offline DSB2018 preprocessing CLI of the port (counterpart of
preprocess_dsb2018.py at the repo root):

    python -m pytorch_nested_unet_tpu_torch.preprocess_dsb2018 \
        [--src inputs/data-science-bowl-2018/stage1_train] [--out inputs] [--img_size 96]
"""

import argparse

from .data.preprocess import preprocess_dsb2018


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--src", default="inputs/data-science-bowl-2018/stage1_train",
                   help="stage1_train directory with per-sample subdirs")
    p.add_argument("--out", default="inputs", help="output root")
    p.add_argument("--img_size", default=96, type=int)
    args = p.parse_args(argv)
    return preprocess_dsb2018(args.src, args.out, args.img_size)


if __name__ == "__main__":
    main()
