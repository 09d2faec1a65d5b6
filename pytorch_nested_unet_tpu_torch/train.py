"""Training entry point of the port (counterpart of the epoch loop of train.py
at the repo root, :474-765).

    python -m pytorch_nested_unet_tpu_torch.train \
        --train_images tr_x.npy --train_masks tr_y.npy \
        --val_images va_x.npy --val_masks va_y.npy \
        --arch NestedUNet --deep_supervision true [--epochs 100] [-b 16] \
        [--precision bf16] [--augment full] [--device cuda]
    ... --arch UNetRNN --arch_kwargs '{"decoder": "LSTM"}'

`--arch` takes any registered arch (the UNet and CRDN families, see
`models.arch_names()`); `--arch_kwargs` is a JSON object of its constructor
options (feature_scale, decoder, nb_filter, ...), checked against them.

Images are (N,H,W,3) uint8 and masks (N,H,W,num_classes) uint8 `.npy` files,
already at the training size; both sets live on the device for the whole run.
Each epoch sets the learning rate from the schedule, trains on shuffled
drop_last batches, validates on every image (the short last batch padded and
weighted), steps ReduceLROnPlateau with the validation loss, appends a row to
`<output_dir>/<name>/log.csv` with the JAX trainer's columns, and writes
`model.pth` in the reference key layout whenever the validation IoU improves.
That file loads into `infer.Predictor(weights=...)` and into the JAX package's
`converters_for_arch(arch)[0]`, for every registered arch. The seed-41 split
of an image folder, image decoding, `config.yml`, resume, meshes, remat and
profiling wait for later slices (ROADMAP.md queue 1).
"""

import argparse
import csv
import os
import time
from typing import Mapping, Optional

import numpy as np
import torch

from .data.augment import parse_augment_spec
from .infer import _str2bool
from .data.pipeline import epoch_batches
from .losses import LOSS_NAMES
from .models import arch_names, create_model, parse_arch_kwargs
from .training.loop import make_epoch_evaluator, make_epoch_runner
from .training.optim import (LRSchedule, build_optimizer, nonfinite_count,
                             params_all_finite, set_learning_rate)
from .utils.device import resolve_device
from .utils.meters import AverageMeter

PRECISIONS = {"fp32": None, "bf16": torch.bfloat16}
SCHEDULERS = ("CosineAnnealingLR", "ReduceLROnPlateau", "MultiStepLR", "ConstantLR")


def _check_set(images, masks, what):
    images, masks = np.asarray(images), np.asarray(masks)
    if images.dtype != np.uint8 or masks.dtype != np.uint8 or images.ndim != 4 \
            or masks.ndim != 4 or len(images) != len(masks) \
            or images.shape[1:3] != masks.shape[1:3]:
        raise ValueError(f"{what}: expected uint8 (N,H,W,C) images and masks of one "
                         f"N,H,W, got {images.dtype} {images.shape} and "
                         f"{masks.dtype} {masks.shape}")
    return images, masks


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
        arch_kwargs: Optional[Mapping] = None) -> dict:
    """Train `arch` from a random init drawn from `seed` on the uint8 arrays
    and return a summary: `best_iou`, `log` (the log.csv columns),
    `model_dir`, `model`, and per epoch the host seconds of its training and
    validation parts (`train_s`, `val_s`), each ending in the read of that
    part's metrics. arch_kwargs (a mapping or a JSON object string) go to the
    model constructor (e.g. nb_filter, decoder); an option the arch does not
    have raises ValueError.
    """
    arch_kwargs = parse_arch_kwargs(arch, arch_kwargs)
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
                         generator=torch.Generator().manual_seed(seed),
                         **arch_kwargs)
    model = model.to(dev).train()
    opt = build_optimizer(model.parameters(), optimizer, lr, momentum, weight_decay, nesterov,
                          skip_nonfinite, accum_steps)
    sched = LRSchedule(scheduler, lr, epochs, min_lr, factor, patience, milestones, gamma)
    run_epoch = make_epoch_runner(model, opt, loss, deep_supervision, augment=ops)
    eval_epoch = make_epoch_evaluator(model, loss, deep_supervision)

    tr_x, tr_y = torch.from_numpy(tr_x).to(dev), torch.from_numpy(tr_y).to(dev)
    va_x, va_y = torch.from_numpy(va_x).to(dev), torch.from_numpy(va_y).to(dev)
    data_rng = np.random.default_rng(seed)
    generator = torch.Generator(device=dev).manual_seed(seed + 1)

    cols = ["epoch", "lr", "loss", "iou", "val_loss", "val_iou"]
    if log_acc:  # column layout of trainISIC_wAcc.py:331-368
        cols = ["epoch", "lr", "loss", "iou", "acc", "val_loss", "val_iou", "val_acc"]
    log = {k: [] for k in cols}
    log_path = os.path.join(model_dir, "log.csv")
    best_iou, trigger = 0.0, 0
    train_s, val_s = [], []
    guard = bool(skip_nonfinite)

    for epoch in range(epochs):
        lr_now = sched.epoch_lr(epoch)
        set_learning_rate(opt, lr_now)

        # ---- train ----
        t0 = time.perf_counter()
        batches = np.stack([idx for idx, _ in epoch_batches(
            len(tr_x), batch_size, data_rng, shuffle=True, drop_last=True)])
        metrics = run_epoch(tr_x, tr_y, torch.from_numpy(batches).to(dev), generator)
        metrics = {k: v.cpu().numpy() for k, v in metrics.items()}
        train_s.append(time.perf_counter() - t0)
        tr = {k: AverageMeter() for k in ("loss", "iou", "acc")}
        bad_steps = 0
        for s in range(len(batches)):
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
        if guard and not params_all_finite(model.parameters()):
            raise RuntimeError(f"non-finite parameters at epoch {epoch}: the "
                               f"--skip_nonfinite tolerance was exhausted "
                               f"({nonfinite_count(opt)} update(s) skipped); aborting "
                               "without saving")

        # ---- validate ----
        t1 = time.perf_counter()
        idx_list, valid_list = zip(*epoch_batches(len(va_x), batch_size, data_rng,
                                                  shuffle=False, drop_last=False))
        valid_w = np.stack([(np.arange(batch_size) < v).astype(np.float32)
                            for v in valid_list])
        vm = eval_epoch(va_x, va_y, torch.from_numpy(np.stack(idx_list)).to(dev),
                        torch.from_numpy(valid_w).to(dev))
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
        with open(log_path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(cols)
            w.writerows(zip(*(log[k] for k in cols)))

        trigger += 1
        if va["iou"].avg > best_iou:
            # the reference key layout, float32, on the CPU
            torch.save({k: v.detach().to("cpu", torch.float32)
                        for k, v in model.state_dict().items()},
                       os.path.join(model_dir, "model.pth"))
            print("=> saved best model")
            best_iou = va["iou"].avg
            trigger = 0
        if 0 <= early_stopping <= trigger:
            print("=> early stopping")
            break

    print(f"best val iou: {best_iou:.4f}")
    return {"best_iou": best_iou, "log": log, "model_dir": model_dir, "model": model,
            "train_s": train_s, "val_s": val_s}


def _augment_spec(v):
    parse_augment_spec(v)  # raises ValueError on an unknown op
    return v


def parse_args(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--train_images", required=True, help="(N,H,W,3) uint8 .npy")
    p.add_argument("--train_masks", required=True, help="(N,H,W,num_classes) uint8 .npy")
    p.add_argument("--val_images", required=True)
    p.add_argument("--val_masks", required=True)
    p.add_argument("--name", default=None, help="run name (default: <arch>_{w,wo}DS)")
    p.add_argument("--output_dir", default="models")
    p.add_argument("--epochs", default=100, type=int)
    p.add_argument("-b", "--batch_size", default=16, type=int)
    p.add_argument("--arch", "-a", default="NestedUNet", choices=arch_names())
    p.add_argument("--arch_kwargs", default=None,
                   help="JSON object of the arch's constructor options, e.g. "
                        "'{\"decoder\": \"LSTM\", \"feature_scale\": 8}'")
    p.add_argument("--deep_supervision", default=False, type=_str2bool)
    p.add_argument("--input_channels", default=3, type=int)
    p.add_argument("--num_classes", default=1, type=int)
    p.add_argument("--loss", default="BCEDiceLoss", choices=LOSS_NAMES)
    p.add_argument("--optimizer", default="SGD", choices=["Adam", "SGD"])
    p.add_argument("--lr", "--learning_rate", default=1e-3, type=float)
    p.add_argument("--momentum", default=0.9, type=float)
    p.add_argument("--weight_decay", default=1e-4, type=float)
    p.add_argument("--nesterov", default=False, type=_str2bool)
    p.add_argument("--scheduler", default="CosineAnnealingLR", choices=SCHEDULERS)
    p.add_argument("--min_lr", default=1e-5, type=float)
    p.add_argument("--factor", default=0.1, type=float)
    p.add_argument("--patience", default=2, type=int)
    p.add_argument("--milestones", default="1,2", type=str)
    p.add_argument("--gamma", default=2 / 3, type=float)
    p.add_argument("--early_stopping", default=-1, type=int)
    p.add_argument("--precision", default="bf16", choices=sorted(PRECISIONS),
                   help="conv compute dtype (parameters always float32)")
    p.add_argument("--seed", default=41, type=int)
    p.add_argument("--augment", default="full", type=_augment_spec,
                   help="'full', 'none' or a comma list of rot90,flip,hsv,brightness,contrast")
    p.add_argument("--log_acc", default=False, type=_str2bool)
    p.add_argument("--skip_nonfinite", default=0, type=int)
    p.add_argument("--accum_steps", default=1, type=int)
    p.add_argument("--device", default="cuda")
    return vars(p.parse_args(argv))


def main(argv=None) -> dict:
    config = parse_args(argv)
    if config["name"] is None:
        config["name"] = f"{config['arch']}_{'wDS' if config['deep_supervision'] else 'woDS'}"
    print("-" * 20)
    for k in sorted(config):
        print(f"{k}: {config[k]}")
    print("-" * 20)
    data = {k: np.load(config.pop(k)) for k in
            ("train_images", "train_masks", "val_images", "val_masks")}
    return fit(data["train_images"], data["train_masks"], data["val_images"],
               data["val_masks"], **config)


if __name__ == "__main__":
    main()
