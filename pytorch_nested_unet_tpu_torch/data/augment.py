"""Eval-time transform of the reference pipeline (counterpart of data/augment.py).

Resize happens at load; here the image is scaled to [0, 1], normalized with
albumentations' ImageNet defaults, and divided by 255 once more, a quirk of the
reference Dataset (dataset.py:71-74) that the JAX package reproduces too.
Channels are used as loaded (cv2 BGR), as in the reference.
"""

import torch

# albumentations Normalize defaults (applied to channels as loaded).
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize(img: torch.Tensor) -> torch.Tensor:
    """img float32 in [0,1], (..., 3) -> ((img - mean) / std) / 255."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=img.dtype, device=img.device)
    std = torch.tensor(IMAGENET_STD, dtype=img.dtype, device=img.device)
    return ((img - mean) / std) / 255.0


def eval_transform(images_u8: torch.Tensor, masks_u8=None):
    """(B,H,W,3) uint8 images [+ uint8 masks] -> (float32 images, float32 masks).

    The mask, when given, is scaled to [0, 1]; it is None otherwise.
    """
    img = normalize(images_u8.to(torch.float32) / 255.0)
    mask = None if masks_u8 is None else masks_u8.to(torch.float32) / 255.0
    return img, mask
