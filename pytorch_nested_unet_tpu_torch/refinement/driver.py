"""CascadePSP's inference driver: a global pass, then a sliding-window local
pass (counterpart of refinement/driver.py; reference
segmentation-refinement/segmentation_refinement/eval_helper.py:1-192).

`apply_fn(im, seg, inter_s8, inter_s4)` is the RefinementModule's forward on
the device (NHWC tensors). The global pass and its resizes run on the
device; the tile loop stays on the host, because which tiles run depends on
the data (trivial tiles are skipped, eval_helper.py:124-127), and the tiles'
overlap accumulation and averaging run in numpy on the host, as in the JAX
package. Every tile has the same L x L shape.
"""

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.resize import resize_area, resize_bicubic, resize_bilinear

ApplyFn = Callable[..., Dict[str, torch.Tensor]]


def resize_max_side(im: torch.Tensor, size: int, method: str) -> torch.Tensor:
    """Scale (B,H,W,C) so its longer side is `size`: the output is
    (int(H * r), int(W * r)) with r = size / max(H, W) in Python floats
    (reference eval_helper.py:4-11). method: bilinear (half-pixel), bicubic
    or area."""
    h, w = im.shape[1:3]
    ratio = size / max(h, w)
    out_hw = (int(h * ratio), int(w * ratio))
    if method == "bilinear":
        return resize_bilinear(im, out_hw, align_corners=False)
    if method == "bicubic":
        return resize_bicubic(im, out_hw, align_corners=False)
    if method == "area":
        return resize_area(im, out_hw)
    raise ValueError(method)


def safe_forward(apply_fn: ApplyFn, im, seg, inter_s8=None, inter_s4=None):
    """Pad the image with 0 and the segmentations with -1 to multiples of 8
    (when either side is off a multiple, both grow to the next multiple
    above, as the reference does), run, and crop pred_224, pred_28_3 and
    pred_56_2 back (reference eval_helper.py:13-45)."""
    ph, pw = seg.shape[1:3]
    if ph % 8 or pw % 8:
        pad = (0, 0, 0, (pw // 8 + 1) * 8 - pw, 0, (ph // 8 + 1) * 8 - ph)
        im = F.pad(im, pad)
        seg = F.pad(seg, pad, value=-1.0)
        if inter_s8 is not None:
            inter_s8 = F.pad(inter_s8, pad, value=-1.0)
        if inter_s4 is not None:
            inter_s4 = F.pad(inter_s4, pad, value=-1.0)
    images = apply_fn(im, seg, inter_s8, inter_s4)
    return {k: images[k][:, :ph, :pw, :] for k in ("pred_224", "pred_28_3", "pred_56_2")}


def process_im_single_pass(apply_fn: ApplyFn, im, seg, L: int = 900) -> torch.Tensor:
    """The global pass alone, the fast path (reference eval_helper.py:171-192):
    bicubic up (segmentation bilinear) or area down to a longer side of L,
    one forward, then area down or align-corners bilinear up to (H, W)."""
    h, w = im.shape[1:3]
    if max(h, w) < L:
        im, seg = resize_max_side(im, L, "bicubic"), resize_max_side(seg, L, "bilinear")
    elif max(h, w) > L:
        im, seg = resize_max_side(im, L, "area"), resize_max_side(seg, L, "area")
    pred = safe_forward(apply_fn, im, seg)["pred_224"]
    if max(h, w) < L:
        return resize_area(pred, (h, w))
    if max(h, w) > L:
        return resize_bilinear(pred, (h, w), align_corners=True)
    return pred


def tile_grid(h: int, w: int, L: int):
    """The L x L windows of the local step over an (h, w) map, stride L/2
    less 32 pixels, clamped at the far edges, without repeats (reference
    eval_helper.py:100-123): a list of (start_x, start_y, end_x, end_y)."""
    step = L // 2 - 32
    seen, tiles = set(), []
    for x_idx in range(w // step + 1):
        for y_idx in range(h // step + 1):
            sx, sy = x_idx * step, y_idx * step
            ex, ey = sx + L, sy + L
            if ey > h:
                ey, sy = h, h - L
            if ex > w:
                ex, sx = w, w - L
            sx, sy, ex, ey = max(0, sx), max(0, sy), min(w, ex), min(h, ey)
            if (sy, sx) in seen:
                continue
            seen.add((sy, sx))
            tiles.append((sx, sy, ex, ey))
    return tiles


def process_high_res_im(apply_fn: ApplyFn, im, seg, L: int = 900,
                        tile_batch: Optional[int] = None,
                        tiles_run: Optional[list] = None) -> torch.Tensor:
    """The global pass, then the local pass at the input's own resolution
    (reference eval_helper.py:47-168): the global prediction thresholded at
    0.5 picks the tiles (a tile whose foreground share is above 0.9 or
    below 0.1 is skipped), each tile runs pass 3 alone on the global
    pred_224 (as +-1) and pred_56_2, its prediction is trimmed by 16 pixels
    on every inner edge and averaged over the overlaps, and pixels that no
    tile covers keep the thresholded global prediction. Returns (B,H,W,1)
    on im's device.

    tile_batch=k runs the tiles k at a time along the batch axis, the last
    chunk padded with copies of its last tile (the tiles are independent,
    so the result is the sequential one). The tiles run are appended to
    `tiles_run` when a list is given."""
    h, w = seg.shape[1:3]
    if max(h, w) > L:
        im_small, seg_small = resize_max_side(im, L, "area"), resize_max_side(seg, L, "area")
    elif max(h, w) < L:
        im_small = resize_max_side(im, L, "bicubic")
        seg_small = resize_max_side(seg, L, "bilinear")
    else:
        im_small, seg_small = im, seg
    images = safe_forward(apply_fn, im_small, seg_small)

    # the local step at the original resolution (a max-side resize to the
    # longer side itself: the identity)
    im_np = resize_max_side(im, max(h, w), "area").cpu().numpy()
    seg_np = resize_max_side(seg, max(h, w), "area").cpu().numpy()
    h2, w2 = seg_np.shape[1:3]
    combined = np.zeros_like(seg_np)
    weight = np.zeros_like(seg_np)
    r_pred_224 = (resize_bilinear(images["pred_224"], (h2, w2), align_corners=False)
                  .cpu().numpy() > 0.5).astype(np.float32) * 2 - 1
    r_pred_56 = resize_bilinear(images["pred_56_2"], (h2, w2),
                                align_corners=False).cpu().numpy() * 2 - 1

    tiles = []
    for tile in tile_grid(h2, w2, L):
        sx, sy, ex, ey = tile
        share = (r_pred_224[:, sy:ey, sx:ex, :] > 0).astype(np.float32).mean()
        if not (share > 0.9 or share < 0.1):  # the reference's float32 mean
            tiles.append(tile)
    if tiles_run is not None:
        tiles_run.extend(tiles)

    pad = 16

    def accumulate(tile, pred):
        sx, sy, ex, ey = tile
        psx = psy = 0
        pex = pey = L
        if sx != 0:
            sx, psx = sx + pad, psx + pad
        if sy != 0:
            sy, psy = sy + pad, psy + pad
        if ex != w2:
            ex, pex = ex - pad, pex - pad
        if ey != h2:
            ey, pey = ey - pad, pey - pad
        combined[:, sy:ey, sx:ex, :] += pred[:, psy:pey, psx:pex, :]
        weight[:, sy:ey, sx:ex, :] += 1

    def parts(tile):
        sx, sy, ex, ey = tile
        return tuple(a[:, sy:ey, sx:ex, :] for a in (im_np, r_pred_224, r_pred_56))

    dev = im.device
    group = tile_batch or 1
    for s in range(0, len(tiles), group):
        chunk = tiles[s:s + group]
        fill = group - len(chunk)  # one shape for every chunk
        batch = [torch.from_numpy(np.concatenate(list(col) + [col[-1]] * fill)).to(dev)
                 for col in zip(*(parts(t) for t in chunk))]
        preds = safe_forward(apply_fn, *batch)["pred_224"].float().cpu().numpy()
        for j, tile in enumerate(chunk):
            accumulate(tile, preds[j:j + 1])

    with np.errstate(invalid="ignore", divide="ignore"):
        averaged = combined / weight
    pred = np.where(weight == 0, r_pred_224 / 2 + 0.5, averaged)
    return resize_bilinear(torch.from_numpy(pred).to(dev), (h, w), align_corners=True)
