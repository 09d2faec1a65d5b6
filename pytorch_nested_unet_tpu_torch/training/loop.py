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

Under a data mesh (`mesh`, parallel/mesh.py) each rank takes its rows of every
global batch: the train step draws the augmentation for the global batch and
applies this rank's draws, its BNs take global moments and its optimizer
averages the gradients across ranks; the metrics are the global batch's (the
loss the mean of the ranks' losses, IoU and accuracy from the ranks' pixel
counts added, the eval loss from the ranks' weighted sums added), the same on
every rank.

Under the 'x'/'y' axes as well (`mesh.spatial`; UNet and NestedUNet) a rank
augments its data rows at full size (rot90, flip and contrast's per-image
mean see the whole image), then takes its band (`batch_sharding(...,
spatial=True)`); the model runs on the band (parallel/mesh.py), its heads
are gathered (`parallel.halo.gather_bands`) so the loss and the metrics are
the whole images', and the metrics are reduced over the data group only:
every rank of a data row holds the same counts.

Under the 'model' axis (`mesh.tensor_parallel`) the state is sharded
(parallel/mesh.py): a train step gathers the weights over the 'model' peers
before its forward and frees them after the update (under `--remat full`
the recompute in backward reads them whole, before the update); an eval
step gathers them and frees them again at its end. The 'model' peers take
the same rows and bands, and the metrics are reduced over the batch group;
the running statistics and the metrics are then those of the peer at 'model'
coordinate 0 (`parallel.mesh.agree_over_model_`), as the averaged gradients
are, so the peers' replicated state and their decisions stay bitwise alike.
"""

from typing import Callable, Dict

import torch
import torch.distributed as dist

from ..data.augment import augment_batch, eval_transform, parse_augment_spec
from ..losses import get_loss, get_weighted_loss, get_weighted_loss_sums
from ..metrics import (accuracy_counts, accuracy_from_counts, iou_counts, iou_from_counts,
                       iou_score, iou_score_weighted, pixel_accuracy)
from ..parallel.halo import gather_bands
from ..parallel.mesh import (SPATIAL_AXES, agree_over_model_, band_rule, batch_sharding,
                             check_spatial, full_weights, shard_train_step, spatial_partition)


def _as_heads(outputs):
    return outputs if isinstance(outputs, (list, tuple)) else [outputs]


def _all_reduce_sum(values, mesh):
    """Float64 sums of a small vector over the mesh's data rows (on a 'model'
    axis, the sums of the peer at coordinate 0)."""
    v = torch.stack([t.to(torch.float64).reshape(()) for t in values])
    if mesh.data_group is not None:
        dist.all_reduce(v, group=mesh.data_group)
    agree_over_model_([v], mesh)
    return v


def _assert_equal_bands(images, mesh):
    """Raise unless every rank holds a batch of this shape: the BNs count
    rows * world size pixels (ops/fused_bn.py). One small all-reduce."""
    if mesh.group is None:
        return
    n = torch.tensor([images.numel(), -images.numel()], dtype=torch.int64,
                     device=images.device)
    dist.all_reduce(n, op=dist.ReduceOp.MAX, group=mesh.group)
    if int(n[0]) != -int(n[1]):
        raise ValueError(f"spatial step: ranks hold bands of {-int(n[1])} to {int(n[0])} "
                         "values; every band must be equal")


class _Bands:
    """The band a spatial step takes of its full-size batch. At the first
    call the image size is held to the built model's band rule (its options
    may widen a halo: `parallel.mesh.band_rule`) and the bands are checked
    equal on every rank."""

    def __init__(self, mesh, model):
        self.mesh, self.checked = mesh, False
        self.arch, self.rule = type(model).__name__, band_rule(model)

    def __call__(self, global_batch, images):
        if not self.checked and any(self.mesh.partitioned(a) for a in SPATIAL_AXES):
            check_spatial(self.arch, images.shape[1:3], self.mesh.shape, self.rule)
        band = batch_sharding(self.mesh, global_batch, spatial=True, hw=images.shape[1:3])
        images = band.take(images)
        if not self.checked:
            _assert_equal_bands(images, self.mesh)
            self.checked = True
        return images


def _heads(model, images, mesh):
    """The model's heads; under 'x'/'y' each gathered to the whole image."""
    heads = _as_heads(model(images))
    if mesh is not None and mesh.spatial:
        heads = [gather_bands(o, mesh) for o in heads]
    return heads


def make_train_step(model: torch.nn.Module, optimizer, loss_name: str,
                    deep_supervision: bool, augment="full", mesh=None) -> Callable:
    """Return step(images_u8, masks_u8, generator) -> {'loss', 'iou', 'acc'}.

    images_u8 (B,H,W,3) and masks_u8 (B,H,W,C) are uint8 on the model's device;
    `generator` (on that device) draws the augmentation; `augment` is an
    augment spec (see data.augment.parse_augment_spec). `optimizer` is a
    training.optim.Optimizer (or any object with zero_grad/step). Puts `model`
    in train mode. With `mesh` (a parallel.mesh.Mesh), `model` and
    `optimizer` go on it (`shard_train_step`) and the batch is this rank's
    rows of a global batch of B * 'data' ranks, at full size (see the module
    docstring).
    """
    loss_fn = get_loss(loss_name)
    ops = parse_augment_spec(augment)
    bands = tp = None
    if mesh is not None:
        tp = shard_train_step(model, optimizer, mesh)
        bands = _Bands(mesh, model) if mesh.spatial else None

    def step(images_u8, masks_u8, generator) -> Dict[str, torch.Tensor]:
        model.train()
        shard = None
        if mesh is not None:
            global_batch = images_u8.shape[0] * mesh.size
            shard = (global_batch, batch_sharding(mesh, global_batch))
        images, masks = augment_batch(images_u8, masks_u8, ops, generator, shard)
        if bands is not None:
            images = bands(global_batch, images)
        if tp is not None:
            tp.gather()
        optimizer.zero_grad()
        heads = _heads(model, images, mesh)
        loss = sum(loss_fn(o, masks) for o in heads) / len(heads)
        loss.backward()
        optimizer.step()
        if tp is not None:
            agree_over_model_(list(model.buffers()), mesh)
            tp.free()
        final = heads[-1].detach()
        if mesh is None:
            return {"loss": loss.detach(), "iou": iou_score(final, masks),
                    "acc": pixel_accuracy(final, masks)}
        v = _all_reduce_sum([loss.detach(), *iou_counts(final, masks),
                             *accuracy_counts(final, masks)], mesh)
        return {"loss": (v[0] / mesh.size).to(torch.float32),
                "iou": iou_from_counts(v[1].to(torch.float32), v[2].to(torch.float32)),
                "acc": accuracy_from_counts(v[3], v[4])}

    return step


def make_eval_step(model: torch.nn.Module, loss_name: str, deep_supervision: bool,
                   mesh=None):
    """Return eval_step(images_u8, masks_u8, weights) -> {'loss', 'iou', 'acc'}.

    weights is a (B,) 0/1 float tensor marking the valid (non-padding) samples,
    so a padded last batch scores like the reference's batch-weighted meter.
    Runs the eval forward without gradients and restores the model's mode.
    With `mesh`, the batch and its weights are this rank's rows of a global
    batch, and the metrics are the global batch's; under 'x'/'y' the model
    runs on this rank's band of them (put on the mesh here too); under
    'model' on its weights gathered for the step.
    """
    wloss_fn = get_weighted_loss(loss_name)
    wloss_sums, wloss_finish = get_weighted_loss_sums(loss_name)
    bands = None
    if mesh is not None and mesh.spatial:
        spatial_partition(model, mesh)
        bands = _Bands(mesh, model)

    @torch.no_grad()
    def eval_step(images_u8, masks_u8, weights) -> Dict[str, torch.Tensor]:
        was_training = model.training
        model.eval()
        try:
            images, masks = eval_transform(images_u8, masks_u8)
            if bands is not None:
                images = bands(images.shape[0] * mesh.size, images)
            with full_weights(model):
                heads = _heads(model, images, mesh)
            if mesh is None:
                loss = sum(wloss_fn(o, masks, weights) for o in heads) / len(heads)
                return {"loss": loss, "iou": iou_score_weighted(heads[-1], masks, weights),
                        "acc": pixel_accuracy(heads[-1], masks)}
            sums = [wloss_sums(o, masks, weights) for o in heads]
            v = _all_reduce_sum([*torch.cat(sums), *iou_counts(heads[-1], masks, weights),
                                 *accuracy_counts(heads[-1], masks)], mesh)
            k = sums[0].numel()
            loss = sum(wloss_finish(v[i * k:(i + 1) * k].to(torch.float32))
                       for i in range(len(heads))) / len(heads)
            c = len(heads) * k
            return {"loss": loss,
                    "iou": iou_from_counts(v[c].to(torch.float32), v[c + 1].to(torch.float32)),
                    "acc": accuracy_from_counts(v[c + 2], v[c + 3])}
        finally:
            model.train(was_training)

    return eval_step


class PredictModule(torch.nn.Module):
    """uint8 NHWC images -> sigmoid of the last head of `model`'s forward
    (val.py semantics, reference val.py:92-100): the eval transform, the
    model, the sigmoid. The module serving.py exports."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, images_u8: torch.Tensor) -> torch.Tensor:
        images, _ = eval_transform(images_u8)
        return torch.sigmoid(_as_heads(self.model(images))[-1])


def make_predict_fn(model: torch.nn.Module):
    """Return predict(images_u8) -> `PredictModule(model)`'s probabilities,
    without autograd.

    images_u8: (B,H,W,C) uint8 on the model's device; the result is
    (B,H,W,num_classes) float32 probabilities. Puts `model` in eval mode.
    """
    module = PredictModule(model.eval())

    @torch.inference_mode()
    def predict(images_u8: torch.Tensor) -> torch.Tensor:
        return module(images_u8)

    return predict


def stack_metrics(per_step):
    """[{name: scalar tensor}] of an epoch's steps -> {name: (steps,) tensor}."""
    return {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}


def make_epoch_runner(model, optimizer, loss_name: str, deep_supervision: bool,
                      augment="full", mesh=None):
    """Return run_epoch(images_u8, masks_u8, batch_idx, generator) -> metrics.

    images_u8/masks_u8 are the whole uint8 training set on the device;
    batch_idx is a (steps, batch) int64 tensor on the same device (with
    `mesh`, the global batches: each rank gathers its rows). Each metric
    comes back as a (steps,) device tensor.
    """
    step = make_train_step(model, optimizer, loss_name, deep_supervision, augment, mesh)

    def run_epoch(images_u8, masks_u8, batch_idx, generator):
        rows = slice(None) if mesh is None else batch_sharding(mesh, batch_idx.shape[1])
        per_step = [step(images_u8.index_select(0, idx[rows]),
                         masks_u8.index_select(0, idx[rows]), generator) for idx in batch_idx]
        return stack_metrics(per_step)

    return run_epoch


def make_epoch_evaluator(model, loss_name: str, deep_supervision: bool, mesh=None):
    """Return eval_epoch(images_u8, masks_u8, batch_idx, weights) -> metrics,
    each a (steps,) device tensor; weights is (steps, batch) 0/1 (with
    `mesh`, of the global batches)."""
    eval_step = make_eval_step(model, loss_name, deep_supervision, mesh)

    def eval_epoch(images_u8, masks_u8, batch_idx, weights):
        rows = slice(None) if mesh is None else batch_sharding(mesh, batch_idx.shape[1])
        per_step = [eval_step(images_u8.index_select(0, idx[rows]),
                              masks_u8.index_select(0, idx[rows]), w[rows])
                    for idx, w in zip(batch_idx, weights)]
        return stack_metrics(per_step)

    return eval_epoch
