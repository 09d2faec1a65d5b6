"""Train, eval and predict steps and the epoch runners (counterpart of
training/loop.py).

A train step gathers nothing itself: it takes a uint8 batch already on the
device, augments it there, runs the train-mode forward, the loss averaged over
the heads (deep supervision: the four heads, IoU and accuracy on the last;
reference trains.py:118-124), backward and the optimizer update. Its metrics
stay on the device. The epoch runners gather each batch with `index_select`
from the device-resident uint8 store and stack the per-step metrics there;
the host reads them once per epoch. The JAX package's lax.scan over the epoch
has no counterpart yet (CUDA graphs of the epoch are queued in ROADMAP.md).
"""

from typing import Callable, Dict

import torch

from ..data.augment import augment_batch, eval_transform, parse_augment_spec
from ..losses import get_loss, get_weighted_loss
from ..metrics import iou_score, iou_score_weighted, pixel_accuracy


def _as_heads(outputs):
    return outputs if isinstance(outputs, (list, tuple)) else [outputs]


def make_train_step(model: torch.nn.Module, optimizer, loss_name: str,
                    deep_supervision: bool, augment="full") -> Callable:
    """Return step(images_u8, masks_u8, generator) -> {'loss', 'iou', 'acc'}.

    images_u8 (B,H,W,3) and masks_u8 (B,H,W,C) are uint8 on the model's device;
    `generator` (on that device) draws the augmentation; `augment` is an
    augment spec (see data.augment.parse_augment_spec). `optimizer` is a
    training.optim.Optimizer (or any object with zero_grad/step). Puts `model`
    in train mode.
    """
    loss_fn = get_loss(loss_name)
    ops = parse_augment_spec(augment)

    def step(images_u8, masks_u8, generator) -> Dict[str, torch.Tensor]:
        model.train()
        images, masks = augment_batch(images_u8, masks_u8, ops, generator)
        optimizer.zero_grad()
        heads = _as_heads(model(images))
        loss = sum(loss_fn(o, masks) for o in heads) / len(heads)
        loss.backward()
        optimizer.step()
        final = heads[-1].detach()
        return {"loss": loss.detach(), "iou": iou_score(final, masks),
                "acc": pixel_accuracy(final, masks)}

    return step


def make_eval_step(model: torch.nn.Module, loss_name: str, deep_supervision: bool):
    """Return eval_step(images_u8, masks_u8, weights) -> {'loss', 'iou', 'acc'}.

    weights is a (B,) 0/1 float tensor marking the valid (non-padding) samples,
    so a padded last batch scores like the reference's batch-weighted meter.
    Runs the eval forward without gradients and restores the model's mode.
    """
    wloss_fn = get_weighted_loss(loss_name)

    @torch.no_grad()
    def eval_step(images_u8, masks_u8, weights) -> Dict[str, torch.Tensor]:
        was_training = model.training
        model.eval()
        try:
            images, masks = eval_transform(images_u8, masks_u8)
            heads = _as_heads(model(images))
            loss = sum(wloss_fn(o, masks, weights) for o in heads) / len(heads)
            return {"loss": loss, "iou": iou_score_weighted(heads[-1], masks, weights),
                    "acc": pixel_accuracy(heads[-1], masks)}
        finally:
            model.train(was_training)

    return eval_step


def make_predict_fn(model: torch.nn.Module):
    """Return predict(images_u8) -> sigmoid of the last head of the eval
    forward (val.py semantics, reference val.py:92-100).

    images_u8: (B,H,W,C) uint8 on the model's device; the result is
    (B,H,W,num_classes) float32 probabilities. Puts `model` in eval mode.
    """
    model.eval()

    @torch.inference_mode()
    def predict(images_u8: torch.Tensor) -> torch.Tensor:
        images, _ = eval_transform(images_u8)
        return torch.sigmoid(_as_heads(model(images))[-1])

    return predict


def stack_metrics(per_step):
    """[{name: scalar tensor}] of an epoch's steps -> {name: (steps,) tensor}."""
    return {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}


def make_epoch_runner(model, optimizer, loss_name: str, deep_supervision: bool,
                      augment="full"):
    """Return run_epoch(images_u8, masks_u8, batch_idx, generator) -> metrics.

    images_u8/masks_u8 are the whole uint8 training set on the device;
    batch_idx is a (steps, batch) int64 tensor on the same device. Each metric
    comes back as a (steps,) device tensor.
    """
    step = make_train_step(model, optimizer, loss_name, deep_supervision, augment)

    def run_epoch(images_u8, masks_u8, batch_idx, generator):
        per_step = [step(images_u8.index_select(0, idx), masks_u8.index_select(0, idx),
                         generator) for idx in batch_idx]
        return stack_metrics(per_step)

    return run_epoch


def make_epoch_evaluator(model, loss_name: str, deep_supervision: bool):
    """Return eval_epoch(images_u8, masks_u8, batch_idx, weights) -> metrics,
    each a (steps,) device tensor; weights is (steps, batch) 0/1."""
    eval_step = make_eval_step(model, loss_name, deep_supervision)

    def eval_epoch(images_u8, masks_u8, batch_idx, weights):
        per_step = [eval_step(images_u8.index_select(0, idx), masks_u8.index_select(0, idx), w)
                    for idx, w in zip(batch_idx, weights)]
        return stack_metrics(per_step)

    return eval_epoch
