"""Training entry point of the port (counterpart of train.py at the repo root).

From an image folder, as the reference protocol runs it:

    python -m pytorch_nested_unet_tpu_torch.train --dataset dsb2018_96 \
        --arch NestedUNet --deep_supervision true [--data_dir inputs] \
        [--output_dir models] [--epochs 100] [-b 16] [--input_w 96 --input_h 96] \
        [--precision bf16] [--pipeline device|host|auto] [--resume true] \
        [--init_from CAPSULE] [--pretrained_backbone PTH] [--device cuda]

reads <data_dir>/<dataset>/ in the generic (images/, masks/<c>/) or ISIC
(--dataset_layout isic) layout, trains on the seed-41 80/20 split (or on
train/ and validates on test/ when train/ exists), and writes the capsule
models/<dataset>_<arch>_{w,wo}DS/: config.yml before training, then per epoch
a row of log.csv, model.pth whenever the validation IoU improves, and
last.pth. `--resume true` continues from last.pth (epoch + 1, the earlier
log rows kept; the shuffle and augmentation generators are re-seeded from
--seed, as the JAX package does, so a resumed run is not bit-identical to an
uninterrupted one). `--init_from` starts from another capsule's model.pth
with a fresh optimizer; `--pretrained_backbone` then pours a
torchvision-format ResNet state dict into the model's ResNet trunk (the
ResNet backbones; utils/pretrained.py). SIGTERM or SIGINT finishes the
epoch, writes last.pth and exits 0.

From arrays already at the training size (`fit`):

    python -m pytorch_nested_unet_tpu_torch.train \
        --train_images tr_x.npy --train_masks tr_y.npy \
        --val_images va_x.npy --val_masks va_y.npy [--arch ...] ...

Images are (N,H,W,3) uint8 and masks (N,H,W,num_classes) uint8.

`--arch` takes any of the 25 registered archs (`models.arch_names()`, the
JAX package's registry); `--arch_kwargs` is a JSON object of
its constructor options, checked against them. `--pipeline device` (default)
keeps the uint8 set on the device and gathers each batch there; `host`
decodes each batch from the files on a background thread. Each epoch sets the learning rate from the
schedule, trains on shuffled drop_last batches, validates on every image (the
short last batch padded and weighted) and steps ReduceLROnPlateau with the
validation loss. model.pth loads into `infer.Predictor(weights=...)` and into
the JAX package (`convert.py --pth`; not for DoubleUnet and DeepLab, which
have no reference key layout). `--remat false|true|full|policy`
rematerializes NestedUNet's blocks in backward (models/nested_unet.py); the
other archs have no such option and ignore it, as the JAX CLI does.

Data-parallel training runs one process per device, each with this same
command, started by torchrun (which sets RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR and MASTER_PORT):

    torchrun --nproc_per_node 2 -m pytorch_nested_unet_tpu_torch.train \
        --mesh data=2 ... [--device cpu]

Each rank takes its rows of every global batch of `-b`, the BN moments and
the metrics are the global batch's, the gradients are averaged, and only rank
0 writes config.yml, log.csv, model.pth and last.pth; `--resume` adopts rank
0's last.pth on every rank (parallel/mesh.py). The device is
cuda:LOCAL_RANK (a bare `--device cuda`), the backend NCCL (Gloo for the
CPU). Without --mesh a multi-process run gets a 'data' mesh over all ranks;
`--mesh data=1` in one process runs the same collective path over a world of
one.

Spatial partitioning (every arch, NestedUNet under every --remat mode,
Comprehensive_Atten_Unet also through train_canet): `--mesh
data=D,x=X[,y=Y]` (D*X*Y processes) or `--spatial_partition true`
(('data', 'x') = (world / 2, 2)) gives each rank a band of its data rows'
images and of every map its layers make, a map of n rows cut into rows
[floor(i*n/X), floor((i+1)*n/X)) (bands may be unequal, or empty where a
map has fewer rows than bands) and columns likewise over Y; convs, pools
and resizes read the rows of their output rows from the bands that hold
them, attention gathers its keys and values from the bands and global
pools reduce over them, dropout draws per data row, BN moments, loss and
metrics are the whole global batch's, as the JAX CLI's (train.py:255-304).
The rule is the JAX CLI's: X must divide H and Y divide W (any size the
one-process step runs at); another size exits with a message
(parallel/mesh.py::check_spatial).

Tensor parallelism: `--mesh data=D,model=M` (with 'x'/'y' too: D*X*Y*M
processes) shards each conv and dense kernel of at least 16,384 elements
whose out-channels M divides, and its optimizer state, over the M 'model'
peers, as the JAX CLI does (train.py:457-472): between steps each rank
holds its slices, a step gathers the weights first, and the numbers are
those of the mesh without 'model'. The run prints `tensor parallel: N
kernels sharded over 'model'=M` (N counts the weights and their optimizer
state's leaves, as the JAX package counts them) and exits when the axis
shards nothing. `--checkpoint_backend msgpack` (default) keeps last.pth,
whole in every layout (every rank joins the gather, rank 0 writes);
`orbax` writes the state as every rank's slices into
models/<name>/orbax_last/ (torch.distributed.checkpoint, DTensors), one
machine only, as the JAX CLI's orbax backend. Either restores under another
mesh. The JAX CLI's --fused_bn(_mode) (the port's BN always runs its CUDA
kernels) and --platform have no counterpart; argparse rejects them.

`--profile DIR` traces the training part of the run's first epoch with
torch.profiler (host, and the device on a card) on rank 0 only, into
DIR/epoch<N>.pt.trace.json, a chrome trace (chrome://tracing, Perfetto or
TensorBoard's profiler plugin read it).
Refinement is `val --refine` / `infer --refine`, or in the model with
--arch UNetRNNPSP / UNetRNNCAttention_PSP (`--pretrained_backbone` then
fills their refinement trunk, `psp.feats`).
"""

import argparse
import csv
import functools
import inspect
import os
import signal
import sys
import time
from typing import Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from .data.augment import parse_augment_spec
from .data.datasets import DATASET_CLASSES, dirs_for, list_image_ids, split_ids
from .data.pipeline import DeviceDataStore, HostPrefetchLoader, epoch_batches, resolve_pipeline
from .losses import LOSS_NAMES
from .models import PRECISIONS, arch_names, create_model, parse_arch_kwargs, remat_kwargs
from .parallel import mesh as pmesh
from .parallel import multihost
from .training import checkpoint
from .training.loop import (make_epoch_evaluator, make_epoch_runner, make_eval_step,
                            make_train_step, stack_metrics)
from .training.optim import (LRSchedule, build_optimizer, nonfinite_count,
                             params_all_finite, set_learning_rate)
from .utils.config import save_config, str2bool
from .utils.convert import load_reference_pth
from .utils.device import resolve_device
from .utils.meters import AverageMeter
from .utils.pretrained import find_trunk_scopes, graft_trunk, load_pretrained_backbone

SCHEDULERS = ("CosineAnnealingLR", "ReduceLROnPlateau", "MultiStepLR", "ConstantLR")
NPY_FLAGS = ("train_images", "train_masks", "val_images", "val_masks")


def _check_set(images, masks, what):
    images, masks = np.asarray(images), np.asarray(masks)
    if images.dtype != np.uint8 or masks.dtype != np.uint8 or images.ndim != 4 \
            or masks.ndim != 4 or len(images) != len(masks) \
            or images.shape[1:3] != masks.shape[1:3]:
        raise ValueError(f"{what}: expected uint8 (N,H,W,C) images and masks of one "
                         f"N,H,W, got {images.dtype} {images.shape} and "
                         f"{masks.dtype} {masks.shape}")
    return images, masks


def _log_cols(log_acc: bool):
    if log_acc:  # column layout of trainISIC_wAcc.py:331-368
        return ["epoch", "lr", "loss", "iou", "acc", "val_loss", "val_iou", "val_acc"]
    return ["epoch", "lr", "loss", "iou", "val_loss", "val_iou"]


def _write_log(log_path, log, cols):
    """log.csv with floats at 10 significant digits: pandas' default parser
    (the JAX package's --resume reads the log with it) reads longer decimal
    strings up to an ulp away from Python's float(), which csv readers
    (its plot.py, the port's --resume) use; at 10 digits both read the same
    value."""
    with open(log_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(cols)
        for row in zip(*(log[k] for k in cols)):
            w.writerow([v if isinstance(v, int) else f"{v:.10g}" for v in row])


def _valid_weights(valid_list, batch_size):
    return np.stack([(np.arange(batch_size) < v).astype(np.float32) for v in valid_list])


class _DeviceFeed:
    """Epochs over uint8 sets on the device: each batch is gathered there
    (under a mesh, each rank's rows of it)."""

    def __init__(self, model, opt, loss, deep_supervision, augment, train_store, val_store,
                 batch_size, dev, mesh=None):
        self.run_epoch = make_epoch_runner(model, opt, loss, deep_supervision, augment=augment,
                                           mesh=mesh)
        self.eval_epoch = make_epoch_evaluator(model, loss, deep_supervision, mesh)
        self.train_store, self.val_store = train_store, val_store
        self.batch_size, self.dev = batch_size, dev

    def train(self, data_rng, generator):
        batches = np.stack([idx for idx, _ in epoch_batches(
            len(self.train_store), self.batch_size, data_rng, shuffle=True, drop_last=True)])
        return self.run_epoch(self.train_store.images, self.train_store.masks,
                              torch.from_numpy(batches).to(self.dev), generator)

    def val(self, data_rng):
        idx_list, valid_list = zip(*epoch_batches(len(self.val_store), self.batch_size,
                                                  data_rng, shuffle=False, drop_last=False))
        metrics = self.eval_epoch(
            self.val_store.images, self.val_store.masks,
            torch.from_numpy(np.stack(idx_list)).to(self.dev),
            torch.from_numpy(_valid_weights(valid_list, self.batch_size)).to(self.dev))
        return metrics, valid_list


class _HostFeed:
    """Epochs over batches decoded from the files by HostPrefetchLoaders
    (under a mesh, each rank decodes its rows)."""

    def __init__(self, model, opt, loss, deep_supervision, augment, train_loader,
                 val_loader, batch_size, dev, mesh=None):
        self.step = make_train_step(model, opt, loss, deep_supervision, augment, mesh)
        self.eval_step = make_eval_step(model, loss, deep_supervision, mesh)
        self.train_loader, self.val_loader = train_loader, val_loader
        self.batch_size, self.dev = batch_size, dev
        self.rows = val_loader.rows

    def train(self, data_rng, generator):
        # the loader draws the epoch's order from the same data_rng
        return stack_metrics([self.step(torch.from_numpy(imgs).to(self.dev),
                                      torch.from_numpy(msks).to(self.dev), generator)
                            for imgs, msks, _ in self.train_loader])

    def val(self, data_rng):
        per_step, valid_list = [], []
        for imgs, msks, valid in self.val_loader:
            w = _valid_weights([valid], self.batch_size)[0][self.rows]
            per_step.append(self.eval_step(torch.from_numpy(imgs).to(self.dev),
                                           torch.from_numpy(msks).to(self.dev),
                                           torch.from_numpy(w).to(self.dev)))
            valid_list.append(valid)
        return stack_metrics(per_step), valid_list


def _start_profiler(model):
    """A running torch.profiler over the host and, for a model on a card,
    the device."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if next(model.parameters()).device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _write_profile(prof, profile_dir, epoch):
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, f"epoch{epoch}.pt.trace.json"))
    print(f"profiler trace written to {profile_dir}")


def _epochs(model, opt, sched, feed, *, model_dir, epochs, batch_size, log, cols,
            data_rng, generator, early_stopping=-1, skip_nonfinite=0, start_epoch=0,
            best_iou=0.0, trigger=0, stop_requested=lambda: False, is_main=True,
            profile=None, save_state) -> dict:
    """The epoch loop shared by `fit` and the folder CLI: train, validate,
    step the plateau schedule, append to log.csv, write model.pth on a better
    validation IoU and the resume state after every epoch (`save_state`,
    from `_state_backend`; the files only where `is_main`: rank 0 of a
    data-parallel run, though every rank joins the saves, which gather the
    slices of a 'model' axis). With `profile` (a directory),
    the training part of the first epoch run is traced by torch.profiler on
    the main process into <profile>/epoch<N>.pt.trace.json (chrome trace
    format; the writing is not in the epoch's train_s). On a 'model' axis the
    weights are whole again at the end."""
    log_path = os.path.join(model_dir, "log.csv")
    train_s, val_s = [], []
    guard = bool(skip_nonfinite)
    for epoch in range(start_epoch, epochs):
        lr_now = sched.epoch_lr(epoch)
        set_learning_rate(opt, lr_now)

        # ---- train ----
        t0 = time.perf_counter()
        prof = _start_profiler(model) if profile and epoch == start_epoch and is_main else None
        metrics = {k: v.cpu().numpy() for k, v in feed.train(data_rng, generator).items()}
        train_s.append(time.perf_counter() - t0)
        if prof is not None:
            _write_profile(prof, profile, epoch)
        tr = {k: AverageMeter() for k in ("loss", "iou", "acc")}
        bad_steps = 0
        for s in range(len(metrics["loss"])):
            if guard and not np.isfinite(metrics["loss"][s]):
                bad_steps += 1  # update skipped on the device; keep it out of the meters
                continue
            for k in tr:
                tr[k].update(metrics[k][s], batch_size)
        if tr["loss"].count == 0 or not np.isfinite(tr["loss"].avg):
            skipped = nonfinite_count(opt)
            detail = f" after {skipped} skipped update(s)" if skipped else ""
            raise RuntimeError(f"non-finite training loss at epoch {epoch}{detail}; "
                               "aborting without saving")
        if bad_steps:
            print(f"failure detection: {bad_steps} step(s) with non-finite loss this "
                  f"epoch; {nonfinite_count(opt)} update(s) skipped since start")
        if guard:
            with pmesh.full_weights(model):
                finite = params_all_finite(model.parameters())
            if not finite:
                raise RuntimeError(f"non-finite parameters at epoch {epoch}: the "
                                   f"--skip_nonfinite tolerance was exhausted "
                                   f"({nonfinite_count(opt)} update(s) skipped); aborting "
                                   "without saving")

        # ---- validate ----
        t1 = time.perf_counter()
        vm, valid_list = feed.val(data_rng)
        vm = {k: v.cpu().numpy() for k, v in vm.items()}
        val_s.append(time.perf_counter() - t1)
        va = {k: AverageMeter() for k in ("loss", "iou", "acc")}
        for s, valid in enumerate(valid_list):
            for k in va:
                va[k].update(vm[k][s], valid)
        sched.plateau_step(va["loss"].avg)

        print(f"epoch [{epoch}/{epochs}] loss {tr['loss'].avg:.4f} - iou {tr['iou'].avg:.4f} "
              f"- val_loss {va['loss'].avg:.4f} - val_iou {va['iou'].avg:.4f} "
              f"({train_s[-1] + val_s[-1]:.1f}s, "
              f"{tr['loss'].count / max(train_s[-1], 1e-9):.1f} img/s train)", flush=True)
        row = {"epoch": epoch, "lr": lr_now, "loss": tr["loss"].avg, "iou": tr["iou"].avg,
               "acc": tr["acc"].avg, "val_loss": va["loss"].avg, "val_iou": va["iou"].avg,
               "val_acc": va["acc"].avg}
        for k in cols:
            log[k].append(row[k])
        if is_main:
            _write_log(log_path, log, cols)

        trigger += 1
        if va["iou"].avg > best_iou:  # the global metric: every rank takes the branch
            checkpoint.save_model(model_dir, model, write=is_main)
            if is_main:
                print("=> saved best model")
            best_iou = va["iou"].avg
            trigger = 0
        save_state(model_dir, model, opt, epoch, best_iou, trigger)
        if 0 <= early_stopping <= trigger:
            print("=> early stopping")
            break
        if stop_requested():
            print(f"=> stopped by a signal at epoch {epoch}; continue with --resume true")
            break

    tp = pmesh.tensor_parallel_of(model)
    if tp is not None:
        tp.gather()
    print(f"best val iou: {best_iou:.4f}")
    return {"best_iou": best_iou, "log": log, "model_dir": model_dir, "model": model,
            "train_s": train_s, "val_s": val_s}


def fit(train_images, train_masks, val_images, val_masks, *, name: str = "run",
        output_dir: str = "models", epochs: int = 100, batch_size: int = 16,
        arch: str = "NestedUNet", deep_supervision: bool = False, input_channels: int = 3,
        num_classes: int = 1, loss: str = "BCEDiceLoss", optimizer: str = "SGD",
        lr: float = 1e-3, momentum: float = 0.9, weight_decay: float = 1e-4,
        nesterov: bool = False, scheduler: str = "CosineAnnealingLR",
        min_lr: float = 1e-5, factor: float = 0.1, patience: int = 2,
        milestones="1,2", gamma: float = 2 / 3, early_stopping: int = -1,
        precision: str = "bf16", seed: int = 41, augment="full", log_acc: bool = False,
        skip_nonfinite: int = 0, accum_steps: int = 1, device="cuda",
        arch_kwargs: Optional[Mapping] = None,
        pretrained_backbone: Optional[str] = None, remat=False, mesh=None,
        profile: Optional[str] = None) -> dict:
    """Train `arch` from a random init drawn from `seed` on the uint8 arrays
    and return a summary: `best_iou`, `log` (the log.csv columns),
    `model_dir`, `model`, and per epoch the host seconds of its training and
    validation parts (`train_s`, `val_s`), each ending in the read of that
    part's metrics. arch_kwargs (a mapping or a JSON object string) go to the
    model constructor (e.g. nb_filter, decoder); an option the arch does not
    have raises ValueError. pretrained_backbone: a torchvision-format ResNet
    `.pth` poured into the model's ResNet trunk after the init. remat: the
    --remat mode, given to the archs that have the option (an arch_kwargs
    `remat` wins). mesh: a parallel.mesh.Mesh to train data-parallel on
    (`batch_size` is then the global batch; only rank 0 writes; a 'model'
    axis that shards nothing raises ValueError). profile: a directory for a
    torch.profiler trace of the first epoch's training.
    """
    arch_kwargs = {**remat_kwargs(arch, remat), **parse_arch_kwargs(arch, arch_kwargs)}
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {sorted(PRECISIONS)}, got {precision!r}")
    dev = resolve_device(device)
    tr_x, tr_y = _check_set(train_images, train_masks, "train set")
    va_x, va_y = _check_set(val_images, val_masks, "val set")
    if len(tr_x) < batch_size:
        raise ValueError(f"batch_size {batch_size} exceeds the {len(tr_x)}-image "
                         "training set (drop_last)")
    if len(va_x) == 0:
        raise ValueError("the validation set is empty")
    ops = parse_augment_spec(augment)
    if isinstance(milestones, str):
        milestones = [int(e) for e in milestones.split(",")]

    model_dir = os.path.join(output_dir, name)
    os.makedirs(model_dir, exist_ok=True)
    model = create_model(arch, num_classes, input_channels, deep_supervision,
                         dtype=PRECISIONS[precision],
                         generator=torch.Generator().manual_seed(seed), **arch_kwargs)
    if pretrained_backbone:
        _pretrained_backbone(model, pretrained_backbone, arch)
    model = model.to(dev).train()
    opt = build_optimizer(model.parameters(), optimizer, lr, momentum, weight_decay, nesterov,
                          skip_nonfinite, accum_steps)
    sched = LRSchedule(scheduler, lr, epochs, min_lr, factor, patience, milestones, gamma)
    feed = _DeviceFeed(model, opt, loss, deep_supervision, ops,
                       DeviceDataStore(tr_x, tr_y, dev), DeviceDataStore(va_x, va_y, dev),
                       batch_size, dev, mesh)
    cols = _log_cols(log_acc)
    is_main = mesh is None or mesh.rank == 0
    return _epochs(model, opt, sched, feed, model_dir=model_dir, epochs=epochs,
                   batch_size=batch_size, log={k: [] for k in cols}, cols=cols,
                   data_rng=np.random.default_rng(seed),
                   generator=torch.Generator(device=dev).manual_seed(seed + 1),
                   early_stopping=early_stopping, skip_nonfinite=skip_nonfinite,
                   is_main=is_main, profile=profile,
                   save_state=_state_backend("msgpack", mesh, is_main)[0])


def build_datasets(config):
    """(train, val) datasets: the physical train/ + test/ dirs when train/
    exists (reference train_ISIC.py:268-280), else the seed-41 80/20 split of
    one pool (reference trains.py:252-255)."""
    base = os.path.join(config["data_dir"], config["dataset"])
    ds_cls = DATASET_CLASSES[config["dataset_layout"]]

    def mk(ids, img_dir, mask_dir):
        return ds_cls(ids, img_dir, mask_dir, config["img_ext"], config["mask_ext"],
                      config["num_classes"])

    if os.path.isdir(os.path.join(base, "train")):
        tr_img, tr_mask = dirs_for(os.path.join(base, "train"), config["dataset_layout"])
        va_img, va_mask = dirs_for(os.path.join(base, "test"), config["dataset_layout"])
        train_ids = list_image_ids(tr_img, config["img_ext"])
        if not train_ids:
            sys.exit(f"no images found under {tr_img} (*{config['img_ext']})")
        return (mk(train_ids, tr_img, tr_mask),
                mk(list_image_ids(va_img, config["img_ext"]), va_img, va_mask))
    img_dir, mask_dir = dirs_for(base, config["dataset_layout"])
    img_ids = list_image_ids(img_dir, config["img_ext"])
    if not img_ids:
        sys.exit(f"no images found under {img_dir} (*{config['img_ext']})")
    train_ids, val_ids = split_ids(img_ids, 0.2, 41)
    return mk(train_ids, img_dir, mask_dir), mk(val_ids, img_dir, mask_dir)


def _init_from(model, config):
    """--init_from: load another capsule's model.pth, exiting on a mismatch."""
    src = config["init_from"]
    if not os.path.isdir(src):
        src = os.path.join(config["output_dir"], src)
    pth = os.path.join(src, "model.pth")
    if not os.path.isfile(pth):
        sys.exit(f"--init_from: no model.pth under {src}")
    sd = load_reference_pth(pth, config["arch"], getattr(model, "decoder", None),
                            init=model.state_dict())
    own = model.state_dict()
    missing, unexpected = sorted(set(own) - set(sd)), sorted(set(sd) - set(own))
    if missing or unexpected:
        sys.exit(f"--init_from: {src} does not match arch {config['arch']} (missing "
                 f"{missing[:3]}, unexpected {unexpected[:3]})")
    wrong = [f"{k}: capsule {tuple(sd[k].shape)} vs model {tuple(own[k].shape)}"
             for k in own if tuple(sd[k].shape) != tuple(own[k].shape)]
    if wrong:
        sys.exit(f"--init_from: {src} does not match arch {config['arch']} "
                 f"(num_classes/input_channels/arch_kwargs differ): " + "; ".join(wrong[:3]))
    model.load_state_dict(sd, strict=True)
    print(f"initialized weights from {src} (fresh optimizer state)")


def _pretrained_backbone(model, path, arch):
    """--pretrained_backbone: pour a torchvision ResNet state dict into every
    ResNet trunk of `model` (JAX train.py:435-449), exiting when the arch has
    none or the trunk does not fit."""
    scopes = find_trunk_scopes(model)
    if not scopes:
        sys.exit(f"--pretrained_backbone: arch {arch} has no ResNet trunk (encoder/feats "
                 "scope) to initialize")
    trunk = load_pretrained_backbone(path)
    for scope in scopes:
        try:
            sd, n = graft_trunk(model, trunk, scope)
        except (KeyError, ValueError) as e:
            sys.exit(f"--pretrained_backbone: {e}")
        model.load_state_dict(sd, strict=True)
        print(f"pretrained backbone: {n} tensors -> {scope or 'the model root'}")


def _read_log(log_path, cols, rows):
    """The first `rows` rows of a log.csv, as the epoch loop keeps them."""
    log = {k: [] for k in cols}
    with open(log_path, newline="") as f:
        for i, rec in enumerate(csv.DictReader(f)):
            if i >= rows:
                break
            for k in cols:
                log[k].append(int(rec[k]) if k == "epoch" else float(rec[k]))
    return log


def _state_backend(backend, mesh, is_main):
    """(save, load) of the resume state: `msgpack` last.pth (whole; rank 0
    writes), `orbax` the sharded directory orbax_last/ (every rank writes
    its slices)."""
    if backend == "orbax":
        return (lambda d, model, opt, *rest: checkpoint.save_training_state_sharded(
            d, model, opt, mesh, *rest), checkpoint.load_training_state_sharded)
    return (functools.partial(checkpoint.save_training_state, write=is_main),
            checkpoint.load_training_state)


def _feed(config, model, opt, ops, train_ds, val_ds, data_rng, dev, mesh):
    """The folder CLI's epochs over the host loaders or the device store,
    the train step put on `mesh`."""
    bs, size_hw = config["batch_size"], (config["input_h"], config["input_w"])
    if resolve_pipeline(config, len(train_ds) + len(val_ds), dev) == "host":
        rows = slice(None) if mesh is None else pmesh.batch_sharding(mesh, bs)
        return _HostFeed(model, opt, config["loss"], config["deep_supervision"], ops,
                         HostPrefetchLoader(train_ds, bs, size_hw, True, True, rng=data_rng,
                                            rows=rows),
                         HostPrefetchLoader(val_ds, bs, size_hw, False, False, rng=data_rng,
                                            rows=rows),
                         bs, dev, mesh)
    t0 = time.perf_counter()
    stores = [DeviceDataStore(*ds.load_all(size_hw)[:2], dev) for ds in (train_ds, val_ds)]
    n = len(train_ds) + len(val_ds)
    print(f"decoded {n} images at {size_hw[0]}x{size_hw[1]} in "
          f"{time.perf_counter() - t0:.2f} s")
    return _DeviceFeed(model, opt, config["loss"], config["deep_supervision"], ops,
                       stores[0], stores[1], bs, dev, mesh)


def train_folder(config: dict, mesh=None) -> dict:
    """The folder CLI's run (train.py:328-765 of the JAX package): see the
    module docstring. `config` is parse_args' dict; `mesh` a
    parallel.mesh.Mesh for a data-parallel run (`main` builds it)."""
    is_main = mesh is None or mesh.rank == 0
    if config["name"] is None:
        tag = "wDS" if config["deep_supervision"] else "woDS"
        config["name"] = f"{config['dataset']}_{config['arch']}_{tag}"
    model_dir = os.path.join(config["output_dir"], config["name"])
    os.makedirs(model_dir, exist_ok=True)
    print("-" * 20)
    for k in sorted(config):
        print(f"{k}: {config[k]}")
    print("-" * 20)
    if is_main:
        save_config(config, model_dir)

    dev = resolve_device(config["device"])
    bs = config["batch_size"]
    model = checkpoint.build_from_config(
        config, generator=torch.Generator().manual_seed(config["seed"]))
    train_ds, val_ds = build_datasets(config)
    print(f"train {len(train_ds)} / val {len(val_ds)} images")
    if len(train_ds) < bs:
        sys.exit(f"batch_size {bs} exceeds the {len(train_ds)}-image training set (drop_last)")
    if len(val_ds) == 0:
        sys.exit("the validation set is empty")
    print(f"arch {config['arch']}: {sum(p.numel() for p in model.parameters()):,} params")
    if config["init_from"]:
        _init_from(model, config)
    if config["pretrained_backbone"]:
        _pretrained_backbone(model, config["pretrained_backbone"], config["arch"])
    model = model.to(dev).train()

    opt = build_optimizer(model.parameters(), config["optimizer"], config["lr"],
                          config["momentum"], config["weight_decay"], config["nesterov"],
                          config["skip_nonfinite"], config["accum_steps"])
    sched = LRSchedule(config["scheduler"], config["lr"], config["epochs"], config["min_lr"],
                       config["factor"], config["patience"],
                       [int(e) for e in str(config["milestones"]).split(",")], config["gamma"])

    # re-seeded from --seed on resume as well (the JAX CLI does the same)
    data_rng = np.random.default_rng(config["seed"])
    generator = torch.Generator(device=dev).manual_seed(config["seed"] + 1)
    ops = parse_augment_spec(config["augment"])
    try:
        feed = _feed(config, model, opt, ops, train_ds, val_ds, data_rng, dev, mesh)
    except pmesh.NothingSharded as e:
        sys.exit(f"--mesh: {e}")
    tp = pmesh.tensor_parallel_of(model)
    if tp is not None:  # N: the weights' and their optimizer state's leaves, as JAX counts
        print(f"tensor parallel: {tp.count} kernels sharded over 'model'={tp.size}")

    # resumed once the state is laid out on the mesh: each rank reads its slices
    save_state, load_state = _state_backend(config["checkpoint_backend"], mesh, is_main)
    start_epoch, best_iou, trigger = 0, 0.0, 0
    if config["resume"]:
        try:
            restored = load_state(model_dir, model, opt, mesh)
        except ValueError as e:
            sys.exit(f"--resume: {e}")
        if restored:
            start_epoch, best_iou, trigger = restored
            start_epoch += 1
            print(f"resumed from epoch {start_epoch - 1} (best iou {best_iou:.4f})")
    cols = _log_cols(config["log_acc"])
    log_path = os.path.join(model_dir, "log.csv")
    log = {k: [] for k in cols}
    if config["resume"] and os.path.exists(log_path):
        log = _read_log(log_path, cols, start_epoch)

    # finish the epoch, write last.pth and exit 0 on SIGTERM / SIGINT
    stop = {"flag": False}

    def _on_signal(signum, frame):
        print(f"signal {signum}: finishing the epoch, writing last.pth, then exiting")
        stop["flag"] = True

    previous = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            previous[sig] = signal.signal(sig, _on_signal)
        except ValueError:  # not the main thread
            pass
    try:
        return _epochs(model, opt, sched, feed, model_dir=model_dir, epochs=config["epochs"],
                       batch_size=bs, log=log, cols=cols, data_rng=data_rng,
                       generator=generator, early_stopping=config["early_stopping"],
                       skip_nonfinite=config["skip_nonfinite"], start_epoch=start_epoch,
                       best_iou=best_iou, trigger=trigger,
                       stop_requested=lambda: stop["flag"], is_main=is_main,
                       profile=config["profile"], save_state=save_state)
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)


def _augment_spec(v):
    parse_augment_spec(v)  # raises ValueError on an unknown op
    return v


def _remat_mode(v):
    """--remat values: booleans plus the 'full' / 'policy' mode strings."""
    if isinstance(v, bool):
        return v
    s = str(v).lower()
    return s if s in ("policy", "full") else str2bool(v)


def build_parser() -> argparse.ArgumentParser:
    """The trainer's flags (the presets' `train_isic._with_defaults` reads
    which of them an argv gives through this parser)."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--name", default=None,
                   help="run name (default: <dataset>_<arch>_{w,wo}DS; from arrays "
                        "<arch>_{w,wo}DS)")
    p.add_argument("--epochs", default=100, type=int)
    p.add_argument("-b", "--batch_size", default=16, type=int)
    p.add_argument("--arch", "-a", default="NestedUNet", choices=arch_names())
    p.add_argument("--arch_kwargs", default=None,
                   help="JSON object of the arch's constructor options, e.g. "
                        "'{\"decoder\": \"LSTM\", \"feature_scale\": 8}'")
    p.add_argument("--deep_supervision", default=False, type=str2bool)
    p.add_argument("--input_channels", default=3, type=int)
    p.add_argument("--num_classes", default=1, type=int)
    p.add_argument("--input_w", default=96, type=int)
    p.add_argument("--input_h", default=96, type=int)
    p.add_argument("--loss", default="BCEDiceLoss", choices=LOSS_NAMES)
    p.add_argument("--dataset", default="dsb2018_96")
    p.add_argument("--img_ext", default=".png")
    p.add_argument("--mask_ext", default=".png")
    p.add_argument("--optimizer", default="SGD", choices=["Adam", "SGD"])
    p.add_argument("--lr", "--learning_rate", default=1e-3, type=float)
    p.add_argument("--momentum", default=0.9, type=float)
    p.add_argument("--weight_decay", default=1e-4, type=float)
    p.add_argument("--nesterov", default=False, type=str2bool)
    p.add_argument("--scheduler", default="CosineAnnealingLR", choices=SCHEDULERS)
    p.add_argument("--min_lr", default=1e-5, type=float)
    p.add_argument("--factor", default=0.1, type=float)
    p.add_argument("--patience", default=2, type=int)
    p.add_argument("--milestones", default="1,2", type=str)
    p.add_argument("--gamma", default=2 / 3, type=float)
    p.add_argument("--early_stopping", default=-1, type=int)
    p.add_argument("--num_workers", default=4, type=int,
                   help="kept for flag parity; the pipelines have no worker processes")
    p.add_argument("--data_dir", default="inputs")
    p.add_argument("--output_dir", default="models")
    p.add_argument("--precision", default="bf16", choices=sorted(PRECISIONS),
                   help="conv compute dtype (parameters always float32)")
    p.add_argument("--seed", default=41, type=int)
    p.add_argument("--resume", default=False, type=str2bool,
                   help="continue from models/<name>/last.pth")
    p.add_argument("--dataset_layout", default="generic", choices=sorted(DATASET_CLASSES))
    p.add_argument("--augment", default="full", type=_augment_spec,
                   help="'full', 'none' or a comma list of rot90,flip,hsv,brightness,contrast")
    p.add_argument("--log_acc", default=False, type=str2bool)
    p.add_argument("--pipeline", default="device", choices=["device", "host", "auto"],
                   help="'device' keeps the uint8 set on the device, 'host' decodes each "
                        "batch on a background thread, 'auto' picks by the set's size "
                        "against device memory")
    p.add_argument("--mesh", default=None, metavar="SPEC",
                   help="mesh over the processes (torchrun starts them), e.g. 'data=4,x=2': "
                        "'data' shards the batch, 'x'/'y' shard H/W (UNet, NestedUNet; "
                        "implies --spatial_partition), 'model' shards the large kernels' "
                        "out-channels and their optimizer state; without it a multi-process "
                        "run gets 'data' over all")
    p.add_argument("--spatial_partition", default=False, type=str2bool,
                   help="also shard H over the mesh (halo exchange around the convs). "
                        "Without --mesh the processes are laid out as ('data', 'x') with "
                        "2-way H partitioning; exits if their count is odd")
    p.add_argument("--checkpoint_backend", default="msgpack", choices=["msgpack", "orbax"],
                   help="resume state: 'msgpack' last.pth (whole in every layout, rank 0 "
                        "writes) or 'orbax' the sharded directory orbax_last/ (every rank "
                        "writes its slices; one machine); either restores under another mesh")
    p.add_argument("--skip_nonfinite", default=0, type=int)
    p.add_argument("--accum_steps", default=1, type=int)
    p.add_argument("--remat", default=False, type=_remat_mode,
                   help="rematerialize NestedUNet's blocks in backward: false | true/full "
                        "(recompute whole blocks, keep their inputs) | policy (keep the conv "
                        "outputs, recompute BN+ReLU); other archs ignore it")
    p.add_argument("--init_from", default=None, metavar="CAPSULE",
                   help="start from models/<CAPSULE>/model.pth (a name under --output_dir "
                        "or a directory), with a fresh optimizer")
    p.add_argument("--pretrained_backbone", default=None, metavar="PTH",
                   help="torchvision-format ResNet .pth poured into the model's ResNet "
                        "trunk (the ResNet backbone archs, the PSP hybrids' refinement trunk) "
                        "after --init_from")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="trace the training part of the first epoch this run trains with "
                        "torch.profiler (host and device) into DIR/epoch<N>.pt.trace.json, on "
                        "the main process only")
    p.add_argument("--device", default="cuda")
    for flag in NPY_FLAGS:
        p.add_argument(f"--{flag}", default=None,
                       help="train from .npy arrays instead of a folder (all four flags)")
    return p


def parse_args(argv=None) -> dict:
    return vars(build_parser().parse_args(argv))


def _mesh_axes(config):
    """(names, sizes) of --mesh, or None; exits on a refused flag: a bad spec,
    an unknown axis, --spatial_partition without an 'x'/'y' axis in --mesh,
    under x/y an input size that the axes do not divide (check_spatial),
    and --checkpoint_backend orbax across machines (checked here, before any
    process group is formed)."""
    if config["checkpoint_backend"] == "orbax" and multihost.spans_machines():
        # every rank writes its slices into one directory: one filesystem
        sys.exit("--checkpoint_backend orbax is single-host only; use msgpack under multi-host")
    spatial = config["spatial_partition"]
    axes = None
    if config.get("mesh"):
        try:
            names, sizes = pmesh.parse_mesh_spec(config["mesh"])
        except ValueError as e:
            sys.exit(f"--mesh: {e}")
        for name in names:
            if name not in pmesh.PORTED_AXES:
                sys.exit("--mesh: " + pmesh.NOT_PORTED.format(name))
        has_spatial_axes = bool(set(pmesh.SPATIAL_AXES) & set(names))
        if spatial and not has_spatial_axes:
            sys.exit("--spatial_partition with --mesh requires an 'x' or 'y' axis in the spec")
        spatial = has_spatial_axes
        axes = names, sizes
    if spatial:
        shape = dict(zip(*axes)) if axes else {"x": 2}
        try:
            pmesh.check_spatial(config["arch"], (config["input_h"], config["input_w"]), shape)
        except ValueError as e:
            sys.exit(f"--mesh / --spatial_partition: {e}")
    return axes


def _build_mesh(config, axes, world: int):
    """The mesh (JAX train.py:255-304): --mesh's axes must cover the
    processes and the batch divide over 'data'; --spatial_partition without
    --mesh lays an even world out as ('data', 'x') = (world / 2, 2); without
    either a multi-process run gets 'data' over all ranks and one process
    none. Exits with a message otherwise."""
    if axes is not None:
        names, sizes = axes
        total = int(np.prod(sizes))
        if total != world:
            sys.exit(f"--mesh '{config['mesh']}' needs {total} processes, have {world}")
    elif config["spatial_partition"]:
        if world < 2 or world % 2:
            sys.exit(f"--spatial_partition needs an even process count >= 2 to factor into "
                     f"('data', 'x'); have {world} process(es) -- use --mesh to lay the axes "
                     f"out explicitly")
        names, sizes = ("data", "x"), (world // 2, 2)
    elif world > 1:
        names, sizes = ("data",), (world,)
    else:
        return None
    mesh = pmesh.make_mesh(sizes, names)
    if config["batch_size"] % mesh.size:
        sys.exit(f"batch_size {config['batch_size']} not divisible by the mesh 'data' axis "
                 f"size {mesh.size}")
    print(f"mesh: {mesh.shape}" + (" (spatial H/W partitioning on)" if mesh.spatial else ""))
    return mesh


def _rank_device(device: str, multiprocess: bool) -> str:
    """A bare 'cuda' in a multi-process run is this rank's card,
    cuda:LOCAL_RANK."""
    if multiprocess and device == "cuda":
        return f"cuda:{multihost.local_rank()}"
    return device


def main(argv=None) -> dict:
    config = parse_args(argv)
    axes = _mesh_axes(config)
    multiprocess = int(os.environ.get("WORLD_SIZE", "1")) > 1
    config["device"] = _rank_device(config["device"], multiprocess)
    dev = resolve_device(config["device"])
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)  # NCCL's collectives run on the current device
    owned = multihost.initialize_distributed(device=dev)
    if owned:
        print(f"multi-host: process {dist.get_rank()}/{dist.get_world_size()}, device {dev}, "
              f"backend {dist.get_backend()}")
    elif axes is not None and not dist.is_initialized():
        # --mesh in one process: the collective path over a world of one
        multihost.initialize_single_process("nccl" if dev.type == "cuda" else "gloo")
        owned = True
    try:
        return _run(config, _build_mesh(config, axes, multihost.process_count()))
    finally:
        if owned:
            dist.destroy_process_group()


def _run(config, mesh):
    npy = [config.pop(k) for k in NPY_FLAGS]
    if not any(npy):
        return train_folder(config, mesh)
    if not all(npy):
        sys.exit(f"training from arrays needs all of --{', --'.join(NPY_FLAGS)}")
    if config["name"] is None:
        config["name"] = f"{config['arch']}_{'wDS' if config['deep_supervision'] else 'woDS'}"
    print("-" * 20)
    for k in sorted(config):
        print(f"{k}: {config[k]}")
    print("-" * 20)
    fit_args = {k: v for k, v in config.items()
                if k in inspect.signature(fit).parameters and k != "mesh"}
    return fit(*(np.load(path) for path in npy), **fit_args, mesh=mesh)


if __name__ == "__main__":
    main()
