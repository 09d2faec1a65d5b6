"""Segmentation losses on the device (counterpart of losses.py).

Semantics follow the JAX package, which follows the reference:
  - BCEDiceLoss: 0.5*BCEWithLogits + (1 - mean per-sample soft Dice), smooth
    1e-5 (reference losses.py:103-117);
  - LovaszHingeLoss: per-image binary Lovasz hinge (reference losses.py:49-96),
    the errors sorted per image with a stable descending `torch.sort`;
  - BCEWithLogitsLoss: the mean binary cross-entropy with logits.
The `_weighted` variants weight each sample (1 valid, 0 padding), so the padded
last validation batch scores like the reference's batch-weighted meter.

Every loss takes (logits, targets) shaped (B, ...) (NHWC for the models),
computes in float32 and returns a 0-d tensor.
"""

import torch

__all__ = ["LOSS_NAMES", "get_loss", "get_weighted_loss", "bce_with_logits",
           "bce_dice_loss", "lovasz_hinge", "lovasz_hinge_loss",
           "bce_with_logits_weighted", "bce_dice_loss_weighted",
           "lovasz_hinge_loss_weighted"]


def _f32(*tensors):
    return tuple(t.to(torch.float32) for t in tensors)


def _bce_elementwise(logits, targets):
    # max(x, 0) - x*t + log(1 + exp(-|x|)), the numerically stable form
    return torch.clamp(logits, min=0.0) - logits * targets + torch.log1p(
        torch.exp(-logits.abs()))


def bce_with_logits(logits, targets):
    """Mean binary cross-entropy with logits."""
    logits, targets = _f32(logits, targets)
    return _bce_elementwise(logits, targets).mean()


def _soft_dice(logits, targets, smooth):
    num = logits.shape[0]
    probs = torch.sigmoid(logits).reshape(num, -1)
    tgt = targets.reshape(num, -1)
    intersection = (probs * tgt).sum(1)
    return (2.0 * intersection + smooth) / (probs.sum(1) + tgt.sum(1) + smooth)


def bce_dice_loss(logits, targets, smooth: float = 1e-5):
    """Reference losses.py:107-117."""
    logits, targets = _f32(logits, targets)
    bce = bce_with_logits(logits, targets)
    return 0.5 * bce + (1.0 - _soft_dice(logits, targets, smooth).mean())


def _lovasz_grad(gt_sorted):
    """Gradient of the Lovasz extension w.r.t. sorted errors, per row
    (reference losses.py:49-61)."""
    gts = gt_sorted.sum(-1, keepdim=True)
    intersection = gts - gt_sorted.cumsum(-1)
    union = gts + (1.0 - gt_sorted).cumsum(-1)
    jaccard = 1.0 - intersection / union
    return torch.cat([jaccard[..., :1], jaccard[..., 1:] - jaccard[..., :-1]], -1)


def _lovasz_hinge_rows(logits, labels):
    """Per-row hinge of (B, P) logits/labels: sort the errors descending
    (stable), dot(relu(errors_sorted), lovasz_grad) (reference losses.py:79-96)."""
    signs = 2.0 * labels - 1.0
    errors = 1.0 - logits * signs
    errors_sorted, order = torch.sort(errors, dim=-1, descending=True, stable=True)
    gt_sorted = torch.gather(labels, -1, order)
    return (torch.relu(errors_sorted) * _lovasz_grad(gt_sorted)).sum(-1)


def lovasz_hinge(logits, labels, per_image: bool = True):
    """Binary Lovasz hinge on (B, ...) logits/labels (reference losses.py:63-76)."""
    logits, labels = _f32(logits, labels)
    b = logits.shape[0]
    if per_image:
        return _lovasz_hinge_rows(logits.reshape(b, -1), labels.reshape(b, -1)).mean()
    return _lovasz_hinge_rows(logits.reshape(1, -1), labels.reshape(1, -1))[0]


def lovasz_hinge_loss(logits, targets):
    """Reference losses.py:120-129: drop the one-channel axis, per-image hinge."""
    if logits.dim() == 4 and logits.shape[-1] == 1:
        logits, targets = logits[..., 0], targets[..., 0]
    return lovasz_hinge(logits, targets, per_image=True)


def _weighted_mean(per_sample, weights):
    weights = weights.to(torch.float32)
    return (per_sample * weights).sum() / torch.clamp(weights.sum(), min=1.0)


def bce_with_logits_weighted(logits, targets, weights):
    """BCE where sample i counts with weight w_i (all ones: the plain mean)."""
    logits, targets = _f32(logits, targets)
    per = _bce_elementwise(logits, targets)
    return _weighted_mean(per.reshape(per.shape[0], -1).mean(1), weights)


def bce_dice_loss_weighted(logits, targets, weights, smooth: float = 1e-5):
    logits, targets = _f32(logits, targets)
    bce = bce_with_logits_weighted(logits, targets, weights)
    return 0.5 * bce + (1.0 - _weighted_mean(_soft_dice(logits, targets, smooth), weights))


def lovasz_hinge_loss_weighted(logits, targets, weights):
    logits, targets = _f32(logits, targets)
    b = logits.shape[0]
    per_image = _lovasz_hinge_rows(logits.reshape(b, -1), targets.reshape(b, -1))
    return _weighted_mean(per_image, weights)


_LOSSES = {
    "BCEDiceLoss": bce_dice_loss,
    "LovaszHingeLoss": lovasz_hinge_loss,
    "BCEWithLogitsLoss": bce_with_logits,
}
_WEIGHTED = {
    "BCEDiceLoss": bce_dice_loss_weighted,
    "LovaszHingeLoss": lovasz_hinge_loss_weighted,
    "BCEWithLogitsLoss": bce_with_logits_weighted,
}
LOSS_NAMES = sorted(_LOSSES)


def get_loss(name: str):
    try:
        return _LOSSES[name]
    except KeyError:
        raise KeyError(f"unknown loss {name!r}; available: {LOSS_NAMES}") from None


def get_weighted_loss(name: str):
    try:
        return _WEIGHTED[name]
    except KeyError:
        raise KeyError(f"unknown loss {name!r}; available: {LOSS_NAMES}") from None
