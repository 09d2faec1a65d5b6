"""Offline DSB2018 preprocessing (counterpart of data/preprocess.py; reference
preprocess_dsb2018.py:9-50).

Per stage1_train sample directory <id>/{images/<id>.png, masks/*.png}:
  - the mask is the union of the instance masks thresholded at >127;
  - the image decodes to 3-channel BGR (gray tiled, RGBA composited onto
    black, which leaves DSB2018's opaque pixels as they are);
  - the image is resized bilinearly as uint8, and the float64 0/1 mask
    bilinearly as float64, then x255 and truncated to uint8 (so mask edges get
    intermediate values, as in the reference);
  - both are written as PNG to <out>/dsb2018_<size>/{images, masks/0}/<id>.png.
"""

import os
from glob import glob

import numpy as np

from . import image_io


def preprocess_dsb2018(src_dir: str, out_root: str = "inputs", img_size: int = 96,
                       verbose: bool = True) -> int:
    """Preprocess every sample under src_dir; returns the number written."""
    paths = sorted(glob(os.path.join(src_dir, "*")))
    out_img = os.path.join(out_root, f"dsb2018_{img_size}", "images")
    out_mask = os.path.join(out_root, f"dsb2018_{img_size}", "masks", "0")
    os.makedirs(out_img, exist_ok=True)
    os.makedirs(out_mask, exist_ok=True)

    n = 0
    for path in paths:
        if not os.path.isdir(path):
            continue
        sample = os.path.basename(path)
        try:
            img = image_io.load_image(os.path.join(path, "images", sample + ".png"), 3)
        except image_io.ImageError:
            if verbose:
                print(f"skip {sample}: unreadable image")
            continue
        instances = []
        for mask_path in sorted(glob(os.path.join(path, "masks", "*"))):
            try:
                instances.append(image_io.load_image(mask_path, 1))
            except image_io.ImageError:
                continue  # an unreadable instance mask adds nothing, as in the reference
        mask = np.zeros(img.shape[:2], np.float64)
        if instances:
            mask[image_io.union_masks(np.stack(instances)) > 0] = 1
        size = (img_size, img_size)
        image_io.write_png(os.path.join(out_img, sample + ".png"), image_io.resize(img, size))
        mask = image_io.resize_bilinear_plain(mask, size, round_u8=False)
        image_io.write_png(os.path.join(out_mask, sample + ".png"), (mask * 255).astype(np.uint8))
        n += 1
    if verbose:
        print(f"preprocessed {n} samples -> {os.path.dirname(out_img)}")
    return n
