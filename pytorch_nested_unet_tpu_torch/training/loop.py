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

Under the 'x'/'y' axes as well (`mesh.spatial`; any arch) a rank augments
its data rows at full size (rot90, flip and contrast's per-image mean see
the whole image), then takes its band (`batch_sharding(..., spatial=True)`:
the cut of the image, whose bands may be unequal); the model runs on the
band (parallel/mesh.py), its heads are gathered (`parallel.halo.
gather_bands`) so the loss and the metrics are the whole images', and the
metrics are reduced over the data group only: every rank of a data row
holds the same counts.

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

import contextlib
from typing import Callable, Dict

import torch
import torch.distributed as dist

from ..data.augment import augment_batch, eval_transform, parse_augment_spec
from ..losses import get_loss, get_weighted_loss, get_weighted_loss_sums
from ..metrics import (accuracy_counts, accuracy_from_counts, iou_counts, iou_from_counts,
                       iou_score, iou_score_weighted, pixel_accuracy)
from ..parallel.halo import gather_bands
from ..parallel.mesh import (SPATIAL_AXES, agree_over_model_, bands_of, batch_sharding,
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


def _assert_bands_tile(band, mesh):
    """Raise unless the bands of the ranks' data row tile their whole image:
    every rank's (h0, h, w0, w) against the rows and columns before it. One
    small all-gather over the spatial group."""
    if mesh.spatial_group is None:
        return
    mine = torch.tensor([band.h0, band.h, band.w0, band.w, band.full_h, band.full_w])
    if dist.get_backend(mesh.spatial_group) == "nccl":
        mine = mine.to(torch.device("cuda", torch.cuda.current_device()))
    every = [torch.empty_like(mine) for _ in mesh.spatial_coords]
    dist.all_gather(every, mine, group=mesh.spatial_group)
    got = {c: [int(v) for v in t.tolist()] for c, t in zip(mesh.spatial_coords, every)}
    for (i, j), (h0, h, w0, w, full_h, full_w) in got.items():
        above = sum(got[(a, j)][1] for a in range(i))
        left = sum(got[(i, b)][3] for b in range(j))
        if (h0, w0) != (above, left) or (full_h, full_w) != (band.full_h, band.full_w):
            raise ValueError(f"spatial step: band ({i}, {j}) holds rows {h0}+{h} and columns "
                             f"{w0}+{w} of {full_h}x{full_w}; the bands do not tile the image")
    if (sum(got[(a, 0)][1] for a in range(mesh.shape.get("x", 1))) != band.full_h
            or sum(got[(0, b)][3] for b in range(mesh.shape.get("y", 1))) != band.full_w):
        raise ValueError("spatial step: the bands do not cover the whole image")


class _Bands:
    """The band a spatial step takes of its full-size batch, and the
    context its forward and backward run in (`sizes`). At the first call
    the image size is held to the JAX rule (`check_spatial`) and the ranks'
    bands are checked to tile the image."""

    def __init__(self, mesh, model):
        self.mesh, self.model, self.checked = mesh, model, False

    def __call__(self, global_batch, images):
        hw = images.shape[1:3]
        if not self.checked and any(self.mesh.partitioned(a) for a in SPATIAL_AXES):
            check_spatial(type(self.model).__name__, hw, self.mesh.shape)
        band = batch_sharding(self.mesh, global_batch, spatial=True, hw=hw)
        if not self.checked:
            _assert_bands_tile(band, self.mesh)
            self.checked = True
        return band.take(images)

    def sizes(self, hw):
        """The model's `Bands.step` at the batch's whole size hw: its size
        calls answered from the first step of the kind. The model's Bands
        is looked up here, since an eval step puts the model on bands anew."""
        return bands_of(self.model).step(hw, self.model.training)


def _heads(model, images, mesh, hw):
    """The model's heads; under 'x'/'y' each gathered to the whole image of
    size `hw`."""
    heads = _as_heads(model(images))
    if mesh is not None and mesh.spatial:
        heads = [gather_bands(o, mesh, hw) for o in heads]
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
        hw = images.shape[1:3]
        if bands is not None:
            images = bands(global_batch, images)
        if tp is not None:
            tp.gather()
        optimizer.zero_grad()
        with bands.sizes(hw) if bands is not None else contextlib.nullcontext():
            heads = _heads(model, images, mesh, hw)
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
            hw = images.shape[1:3]
            if bands is not None:
                images = bands(images.shape[0] * mesh.size, images)
            with full_weights(model), (bands.sizes(hw) if bands is not None
                                       else contextlib.nullcontext()):
                heads = _heads(model, images, mesh, hw)
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
