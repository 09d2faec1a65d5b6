"""Evaluation entry point of the port (counterpart of val.py at the repo root;
reference val.py:31-113).

    python -m pytorch_nested_unet_tpu_torch.val --name dsb2018_96_NestedUNet_wDS \
        [--data_dir inputs] [--output_dir models] [--save_dir outputs] [-b 16] \
        [--out_ext .jpg|.png] [--device cuda] [--refine true [--refine_weights PTH] \
        [--refine_L 900] [--refine_fast false] [--refine_tile_batch K]]

Loads the models/<name>/ capsule (config.yml + model.pth, in the capsule's
precision), re-derives the seed-41 validation split of the capsule's dataset
(or takes its test/ dir when there is one), predicts in padded batches of -b,
scores the hard IoU at 0.5 over the valid images of each batch, weighted by
their count, writes outputs/<name>/<c>/<id>.jpg = uint8(prob * 255) and
prints `IoU: x`. `--out_ext .png` writes the masks as PNGs instead, for a
host whose image library was built without a JPEG codec. `--refine true`
refines class 0 of each image with CascadePSP before scoring (the
capability the reference stubs at train_ISIC_ca.py:183-189): the loader's
image and uint8(prob x 255) through `Refiner.refine`, in float32 on the
model's device, the full pipeline (global and tiled local pass) unless
--refine_fast true; without --refine_weights the refinement net is a
random init, and a warning says so.
"""

import argparse
import os

import numpy as np

from .data import image_io
from .data.datasets import DATASET_CLASSES, dirs_for, list_image_ids, split_ids
from .data.pipeline import epoch_batches
from .infer import Predictor, add_refine_flags, make_refiner, refine_masks
from .utils.meters import AverageMeter


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--name", required=True, help="capsule name (models/<name>)")
    p.add_argument("--data_dir", default="inputs")
    p.add_argument("--output_dir", default="models")
    p.add_argument("--save_dir", default="outputs")
    p.add_argument("-b", "--batch_size", default=16, type=int)
    p.add_argument("--out_ext", default=".jpg", choices=[".jpg", ".png"],
                   help="mask format: .jpg as the reference writes them, or lossless .png")
    p.add_argument("--device", default="cuda")
    add_refine_flags(p, fast_default=False)
    return vars(p.parse_args(argv))


def val_set(config: dict, data_dir: str):
    """The capsule's validation dataset: its test/ dir when there is one
    (reference train_ISIC.py:273-280), else the seed-41 split's val part."""
    base = os.path.join(data_dir, config["dataset"])
    layout = config.get("dataset_layout", "generic")
    if os.path.isdir(os.path.join(base, "test")):
        img_dir, mask_dir = dirs_for(os.path.join(base, "test"), layout)
        val_ids = list_image_ids(img_dir, config["img_ext"])
    else:
        img_dir, mask_dir = dirs_for(base, layout)
        _, val_ids = split_ids(list_image_ids(img_dir, config["img_ext"]), 0.2, 41)
    return DATASET_CLASSES[layout](val_ids, img_dir, mask_dir, config["img_ext"],
                                   config["mask_ext"], config["num_classes"])


def main(argv=None) -> float:
    args = parse_args(argv)
    predictor, config = Predictor.from_capsule(
        os.path.join(args["output_dir"], args["name"]), batch_size=args["batch_size"],
        device=args["device"])
    print("-" * 20)
    for k in sorted(config):
        print(f"{k}: {config[k]}")
    print("-" * 20)

    images, masks, ids = val_set(config, args["data_dir"]).load_all(
        (config["input_h"], config["input_w"]))
    out_dirs = [os.path.join(args["save_dir"], args["name"], str(c))
                for c in range(config["num_classes"])]
    for d in out_dirs:
        os.makedirs(d, exist_ok=True)
    refiner = make_refiner(args, predictor.device)
    if refiner is not None and args["refine_weights"] is None:
        print("warning: --refine without --refine_weights uses a random-initialized "
              "refinement net")

    meter = AverageMeter()
    for idx, valid in epoch_batches(len(ids), args["batch_size"], np.random.default_rng(0),
                                    shuffle=False, drop_last=False):
        idx = idx[:valid]  # Predictor pads the short batch itself
        probs = predictor.predict_u8(images[idx])
        if refiner is not None:  # class 0 of each image, before scoring
            refine_masks(refiner, images[idx], probs, [0], args["refine_fast"],
                         args["refine_L"])
        # hard IoU at 0.5 (reference metrics.py:6-18) over the batch's valid images
        pred = probs > 0.5
        tgt = (masks[idx].astype(np.float32) / 255.0) > 0.5
        meter.update(((pred & tgt).sum() + 1e-5) / ((pred | tgt).sum() + 1e-5), valid)
        for j, i in enumerate(idx):
            for c, d in enumerate(out_dirs):
                image_io.write_image(os.path.join(d, ids[i] + args["out_ext"]),
                                     (probs[j, :, :, c] * 255).astype(np.uint8))

    print(f"IoU: {meter.avg:.4f}")
    return meter.avg


if __name__ == "__main__":
    main()
