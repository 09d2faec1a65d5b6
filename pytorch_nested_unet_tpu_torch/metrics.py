"""Segmentation metrics on the device (counterpart of metrics.py).

Each returns a 0-d tensor on the logits' device; nothing is read back to the
host here (the reference syncs every step, reference metrics.py:10-12).
Formulas follow the reference:
  - iou_score: sigmoid, threshold 0.5 on both, (|and| + 1e-5)/(|or| + 1e-5);
  - dice_coef: soft dice on the sigmoid probabilities, no threshold;
  - pixel_accuracy: share of pixels where the thresholded prediction equals the
    binarized target.
"""

import torch

__all__ = ["iou_score", "iou_score_weighted", "dice_coef", "numeric_score",
           "pixel_accuracy"]


def _binary(logits, targets):
    return (torch.sigmoid(logits.to(torch.float32)) > 0.5,
            targets.to(torch.float32) > 0.5)


def iou_score(logits, targets, smooth: float = 1e-5):
    pred, tgt = _binary(logits, targets)
    intersection = (pred & tgt).sum().to(torch.float32)
    union = (pred | tgt).sum().to(torch.float32)
    return (intersection + smooth) / (union + smooth)


def iou_score_weighted(logits, targets, weights, smooth: float = 1e-5):
    """IoU over the valid samples (weights 0/1 per sample), for padded batches."""
    pred, tgt = _binary(logits, targets)
    w = weights.to(torch.float32).reshape((-1,) + (1,) * (logits.dim() - 1))
    intersection = ((pred & tgt) * w).sum()
    union = ((pred | tgt) * w).sum()
    return (intersection + smooth) / (union + smooth)


def dice_coef(logits, targets, smooth: float = 1e-5):
    probs = torch.sigmoid(logits.to(torch.float32)).reshape(-1)
    tgt = targets.to(torch.float32).reshape(-1)
    intersection = (probs * tgt).sum()
    return (2.0 * intersection + smooth) / (probs.sum() + tgt.sum() + smooth)


def numeric_score(pred_binary, target_binary):
    """FP, FN, TP, TN pixel counts (reference metrics.py:31-45)."""
    pred, tgt = pred_binary.to(torch.bool), target_binary.to(torch.bool)
    fp = (pred & ~tgt).sum()
    fn = (~pred & tgt).sum()
    tp = (pred & tgt).sum()
    tn = (~pred & ~tgt).sum()
    return fp, fn, tp, tn


def pixel_accuracy(logits, targets):
    """`Acc` (reference metrics.py:47-105): threshold the probabilities at 0.5."""
    fp, fn, tp, tn = numeric_score(*_binary(logits, targets))
    total = fp + fn + tp + tn
    return (tp + tn).to(torch.float32) / torch.clamp(total, min=1).to(torch.float32)
