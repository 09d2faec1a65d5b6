"""Folder datasets in the reference layouts (counterpart of data/datasets.py;
reference dataset.py:9-148).

Two layouts:
  - generic, per class: images/<id><img_ext> + masks/<c>/<id><mask_ext>
  - ISIC: image(s)/<id><img_ext> + mask/<id>_segmentation<mask_ext>

Images decode as BGR uint8 and masks as gray uint8, through the port's image
library (data/image_io.py). `load_all` resizes everything to the training size
once, images bilinearly and masks by nearest neighbour, so the device never
sees variable shapes.
"""

import math
import os
from glob import glob
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import image_io


def list_image_ids(img_dir: str, img_ext: str) -> List[str]:
    """Image ids under img_dir, sorted (the reference relies on raw glob
    order, which depends on the filesystem)."""
    paths = glob(os.path.join(img_dir, "*" + img_ext))
    return sorted(os.path.splitext(os.path.basename(p))[0] for p in paths)


def split_ids(img_ids: Sequence[str], test_size: float = 0.2, seed: int = 41):
    """The reference's seed-41 80/20 split (reference trains.py:255,
    val.py:56): sklearn's `train_test_split(ids, test_size, random_state=seed)`,
    which draws one permutation from a legacy RandomState and takes its first
    ceil(test_size * n) indices as the test set. Returns (train, test) lists."""
    ids = list(img_ids)
    perm = np.random.RandomState(seed).permutation(len(ids))
    n_test = math.ceil(test_size * len(ids))
    return [ids[i] for i in perm[n_test:]], [ids[i] for i in perm[:n_test]]


def dirs_for(base: str, layout: str) -> Tuple[str, str]:
    """(img_dir, mask_dir) under `base` for a layout: ISIC's flat image/ (or
    images/) and mask/ dirs (reference train_ISIC.py:268-308), or the generic
    images/ and masks/<c> (reference trains.py:274-289)."""
    if layout == "isic":
        for img_name in ("image", "images"):
            if os.path.isdir(os.path.join(base, img_name)):
                return os.path.join(base, img_name), os.path.join(base, "mask")
        return os.path.join(base, "image"), os.path.join(base, "mask")
    return os.path.join(base, "images"), os.path.join(base, "masks")


class SegmentationFolderDataset:
    """Generic per-class-mask dataset (reference dataset.py:9-76)."""

    def __init__(self, img_ids, img_dir, mask_dir, img_ext, mask_ext, num_classes):
        self.img_ids = list(img_ids)
        self.img_dir = img_dir
        self.mask_dir = mask_dir
        self.img_ext = img_ext
        self.mask_ext = mask_ext
        self.num_classes = num_classes

    def __len__(self):
        return len(self.img_ids)

    def image_path(self, img_id: str) -> str:
        return os.path.join(self.img_dir, img_id + self.img_ext)

    def _mask_path(self, img_id: str, cls: int) -> str:
        return os.path.join(self.mask_dir, str(cls), img_id + self.mask_ext)

    def load_raw(self, idx: int) -> Tuple[np.ndarray, np.ndarray, str]:
        """(image HWC uint8 BGR, mask HW<num_classes> uint8, img_id) at the
        files' own size."""
        img_id = self.img_ids[idx]
        img = image_io.load_image(self.image_path(img_id), 3)
        mask = [image_io.load_image(self._mask_path(img_id, c), 1)[..., None]
                for c in range(self.num_classes)]
        return img, np.concatenate(mask, axis=-1), img_id

    def load_items(self, idxs: Sequence[int], size_hw: Tuple[int, int]):
        """(images (N,H,W,3), masks (N,H,W,num_classes)) uint8 of the given
        indices, resized to size_hw on the image library's threads."""
        ids = [self.img_ids[int(i)] for i in idxs]
        images = image_io.load_batch([self.image_path(i) for i in ids], size_hw, 3)
        masks = [image_io.load_batch([self._mask_path(i, c) for i in ids], size_hw, 1,
                                     nearest=True) for c in range(self.num_classes)]
        return images, np.concatenate(masks, axis=-1)

    def load_all(self, size_hw: Optional[Tuple[int, int]] = None):
        """The whole dataset -> (images, masks, ids) uint8 arrays, resized to
        size_hw (None: every file must already have one size)."""
        if size_hw is None:
            raws = [self.load_raw(i) for i in range(len(self))]
            return (np.stack([r[0] for r in raws]), np.stack([r[1] for r in raws]),
                    list(self.img_ids))
        images, masks = self.load_items(range(len(self)), size_hw)
        return images, masks, list(self.img_ids)


class ISICDataset(SegmentationFolderDataset):
    """ISIC-2018 layout: flat mask dir, `<id>_segmentation` naming
    (reference dataset.py:131-133)."""

    def _mask_path(self, img_id: str, cls: int) -> str:
        return os.path.join(self.mask_dir, img_id + "_segmentation" + self.mask_ext)


DATASET_CLASSES = {
    "generic": SegmentationFolderDataset,
    "isic": ISICDataset,
}
