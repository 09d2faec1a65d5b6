"""Batched augmentation on the device (counterpart of data/augment.py).

The reference pipeline (reference trains.py:257-272):

    RandomRotate90(p=.5) -> Flip(p=.5) -> OneOf{HSV, brightness, contrast}(p=1)
    -> Resize -> Normalize(ImageNet)  ... then the Dataset divides by 255 again
    (reference dataset.py:71-74), a quirk the JAX package reproduces too.

Resize happens at load. Here every transform runs on the whole batch at once:
per-sample parameters are drawn as tensors from an explicit `torch.Generator`
on the batch's device (`draw_params`) and applied with `where` and flips, so a
step has no per-sample Python loop and no host sync. The draws cannot match
`jax.random`'s; `apply_augment` takes them as an argument, so the tests hold
every transform at fixed parameters against the JAX package. Channels are used
as loaded (cv2 BGR), as in the reference.
"""

from typing import Dict, Sequence, Tuple

import torch

from ..ops.resize import resize_bilinear

# albumentations Normalize defaults (applied to channels as loaded).
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# The reference's transforms, each selectable; geometric ops apply at p=0.5
# each, the selected color ops form the OneOf(p=1) pool.
AUGMENT_OPS = ("rot90", "flip", "hsv", "brightness", "contrast")
COLOR_OPS = ("hsv", "brightness", "contrast")


def parse_augment_spec(spec) -> Tuple[str, ...]:
    """'full' | 'none' | comma list of AUGMENT_OPS | bool | tuple -> the ops in
    canonical order, deduplicated. Raises ValueError on an unknown op."""
    if spec is True:
        return AUGMENT_OPS
    if spec in (False, None):
        return ()
    if isinstance(spec, (tuple, list)):
        ops = tuple(spec)
    else:
        s = str(spec).strip().lower()
        if s == "full":
            return AUGMENT_OPS
        if s in ("none", ""):
            return ()
        ops = tuple(p.strip() for p in s.split(",") if p.strip())
    unknown = sorted(set(ops) - set(AUGMENT_OPS))
    if unknown:
        raise ValueError(f"unknown augment op(s) {unknown}; available: {list(AUGMENT_OPS)}")
    return tuple(op for op in AUGMENT_OPS if op in ops)


def rgb_to_hsv(img):
    """img float [0,1] (..., 3) -> h [0,1), s [0,1], v [0,1]."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    c = v - mn
    safe_c = torch.where(c == 0, 1.0, c)
    h = torch.where(v == r, (g - b) / safe_c,
                    torch.where(v == g, 2.0 + (b - r) / safe_c, 4.0 + (r - g) / safe_c))
    h = torch.where(c == 0, 0.0, h / 6.0)
    h = torch.where(h < 0, h + 1.0, h)
    s = torch.where(v == 0, 0.0, c / torch.where(v == 0, 1.0, v))
    return h, s, v


def _select(i, choices):
    """choices[i] elementwise, the first matching i winning (jnp.select)."""
    out = torch.zeros_like(choices[0])
    for k in range(len(choices) - 1, -1, -1):
        out = torch.where(i == k, choices[k], out)
    return out


def hsv_to_rgb(h, s, v):
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = torch.remainder(i.to(torch.int32), 6)
    r = _select(i, [v, q, p, p, t, v])
    g = _select(i, [t, v, v, q, p, p])
    b = _select(i, [p, p, t, v, v, q])
    return torch.stack([r, g, b], dim=-1)


def _per_sample(flag, x):
    """Broadcast a (B,) tensor over the trailing dims of a (B, ...) tensor."""
    return flag.reshape((-1,) + (1,) * (x.dim() - 1))


def rot90(x, k):
    """Counter-clockwise rot90 of each (B,H,W,C) sample by its k in {0..3}.

    Square images rotate exactly. For H != W an odd k transposes, and the
    result is resized back to (H, W) with align_corners=False, as the JAX
    package's `_rot90_rect` does for the reference's rotate-then-resize.
    """
    h, w = x.shape[1], x.shape[2]
    k = _per_sample(k, x)
    if h == w:
        out = x
        for kk in (1, 2, 3):
            out = torch.where(k == kk, torch.rot90(x, kk, dims=(1, 2)), out)
        return out
    even = torch.where(k == 2, torch.rot90(x, 2, dims=(1, 2)), x)
    transposed = x.transpose(1, 2)
    odd = torch.where(k == 1, transposed.flip(1), transposed.flip(2))
    odd = resize_bilinear(odd.contiguous(), (h, w), align_corners=False)
    return torch.where(k % 2 == 1, odd, even)


def flip(x, do_ud, do_lr):
    """Vertical flip where do_ud, then horizontal where do_lr, per sample."""
    x = torch.where(_per_sample(do_ud, x), x.flip(1), x)
    return torch.where(_per_sample(do_lr, x), x.flip(2), x)


def hsv_shift(img, hue, sat, val):
    """HueSaturationValue with per-sample shifts (hue in turns, sat/val in
    [0,1] units): hue wraps, saturation and value clip to [0, 1]."""
    h, s, v = rgb_to_hsv(img)
    h = torch.remainder(h + hue[:, None, None], 1.0)
    s = torch.clamp(s + sat[:, None, None], 0.0, 1.0)
    v = torch.clamp(v + val[:, None, None], 0.0, 1.0)
    return hsv_to_rgb(h, s, v)


def brightness(img, beta):
    return torch.clamp(img + _per_sample(beta, img), 0.0, 1.0)


def contrast(img, alpha):
    return torch.clamp(img * _per_sample(alpha, img), 0.0, 1.0)


def normalize(img: torch.Tensor) -> torch.Tensor:
    """img float32 in [0,1], (..., 3) -> ((img - mean) / std) / 255."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=img.dtype, device=img.device)
    std = torch.tensor(IMAGENET_STD, dtype=img.dtype, device=img.device)
    return ((img - mean) / std) / 255.0


def draw_params(batch: int, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Every per-sample parameter of the pipeline, drawn in one fixed order
    whatever ops are selected, so a (seed, batch) pair gives each op the same
    draws whichever others are on. Limits mirror albumentations' defaults:
    hue +-20 (cv2 units of 2 degrees), saturation +-30/255, value +-20/255,
    brightness +-0.2, contrast alpha in [0.8, 1.2]."""
    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(batch, generator=generator, device=device)

    def ints(lo, hi):
        return torch.randint(lo, hi, (batch,), generator=generator, device=device)

    return {"rot_apply": u(0.0, 1.0) < 0.5, "rot_k": ints(0, 4),
            "flip_apply": u(0.0, 1.0) < 0.5, "flip_d": ints(-1, 2),
            "color_u": u(0.0, 1.0),
            "hue": u(-20.0, 20.0) / 180.0, "sat": u(-30.0, 30.0) / 255.0,
            "val": u(-20.0, 20.0) / 255.0, "brightness": u(-0.2, 0.2),
            "contrast": u(0.8, 1.2)}


def apply_augment(img, mask, ops: Sequence[str], params: Dict[str, torch.Tensor]):
    """The selected ops on float [0,1] (B,H,W,C) images and masks, with the
    given per-sample parameters (from `draw_params`)."""
    if "rot90" in ops:
        k = torch.where(params["rot_apply"], params["rot_k"], 0)
        img, mask = rot90(img, k), rot90(mask, k)
    if "flip" in ops:
        d = params["flip_d"]  # -1: both, 0: vertical (ud), 1: horizontal (lr)
        do_ud = params["flip_apply"] & (d <= 0)
        do_lr = params["flip_apply"] & (d != 0)
        img, mask = flip(img, do_ud, do_lr), flip(mask, do_ud, do_lr)
    pool = [op for op in ops if op in COLOR_OPS]
    if pool:
        jittered = {
            "hsv": lambda: hsv_shift(img, params["hue"], params["sat"], params["val"]),
            "brightness": lambda: brightness(img, params["brightness"]),
            "contrast": lambda: contrast(img, params["contrast"]),
        }
        choice = torch.clamp((params["color_u"] * len(pool)).to(torch.int64),
                             max=len(pool) - 1)
        out = jittered[pool[0]]()
        for j, op in enumerate(pool[1:], start=1):
            out = torch.where(_per_sample(choice == j, img), jittered[op](), out)
        img = out
    return img, mask


def augment_batch(images_u8, masks_u8, ops, generator: torch.Generator):
    """(B,H,W,3) uint8 images + (B,H,W,C) uint8 masks -> float32 (normalized
    images, masks in [0,1]), augmented with `ops` (see parse_augment_spec) on
    per-sample draws from `generator`, which lives on the batch's device."""
    ops = parse_augment_spec(ops)
    img = images_u8.to(torch.float32) / 255.0
    mask = masks_u8.to(torch.float32) / 255.0
    if ops:
        params = draw_params(img.shape[0], generator, img.device)
        img, mask = apply_augment(img, mask, ops, params)
    return normalize(img), mask


def eval_transform(images_u8: torch.Tensor, masks_u8=None):
    """(B,H,W,3) uint8 images [+ uint8 masks] -> (float32 images, float32 masks).

    The mask, when given, is scaled to [0, 1]; it is None otherwise.
    """
    img = normalize(images_u8.to(torch.float32) / 255.0)
    mask = None if masks_u8 is None else masks_u8.to(torch.float32) / 255.0
    return img, mask
