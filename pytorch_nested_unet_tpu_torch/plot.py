"""Plot training curves from a run's log.csv (counterpart of plot.py at the
repo root; reference Ploting.py CLI surface).

    python -m pytorch_nested_unet_tpu_torch.plot models/<name>/log.csv \
        [--every 10] [--out_dir DIR]

writes loss.png, iou.png (and acc.png for a log with accuracy) and prints
their paths. Needs matplotlib.
"""

import argparse

from .utils.plotting import plot_data


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("path", help="path to a run's log.csv")
    p.add_argument("--every", default=10, type=int,
                   help="sample every N epochs (the reference samples every 10th)")
    p.add_argument("--out_dir", default=None)
    args = p.parse_args(argv)
    written = plot_data(args.path, every=args.every, out_dir=args.out_dir)
    for f in written:
        print(f)
    return written


if __name__ == "__main__":
    main()
