"""Checkpoints and the capsule (counterpart of training/checkpoint.py).

  models/<name>/config.yml  the config capsule (utils/config.py)
  models/<name>/model.pth   best-IoU weights: the float32 CPU state dict in
                            the reference key layout (reference
                            trains.py:344-349); the JAX package imports it
                            with `convert.py --pth`
  models/<name>/last.pth    the resume state: model, optimizer (its buffers
                            and non-finite counters), epoch, best_iou, trigger
"""

import os

import torch

from ..models import PRECISIONS, create_model, parse_arch_kwargs, remat_kwargs
from ..utils.config import load_config
from ..utils.convert import load_reference_pth


def save_model(model_dir: str, model: torch.nn.Module):
    """Write `model`'s weights as model.pth (reference layout, float32, CPU)."""
    torch.save({k: v.detach().to("cpu", torch.float32) for k, v in model.state_dict().items()},
               os.path.join(model_dir, "model.pth"))


def build_from_config(config: dict, precision=None, generator=None) -> torch.nn.Module:
    """The model a capsule's config describes, on the CPU; precision None
    takes the config's. The config's `remat` reaches the archs that have the
    option."""
    precision = precision or config.get("precision") or "fp32"
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {sorted(PRECISIONS)}, got {precision!r}")
    return create_model(config["arch"], config["num_classes"], config["input_channels"],
                        config["deep_supervision"], dtype=PRECISIONS[precision],
                        generator=generator,
                        **{**remat_kwargs(config["arch"], config.get("remat")),
                           **parse_arch_kwargs(config["arch"], config.get("arch_kwargs"))})


def load_capsule(model_dir: str, precision=None):
    """Rebuild a trained model from models/<name>/: read config.yml, build
    the arch (in `precision`, default the capsule's), load model.pth strict.
    Returns (model on the CPU in eval mode, config) — the loading path of
    val.py and infer.py (reference val.py:34-59)."""
    config = load_config(model_dir)
    model = build_from_config(config, precision)
    model.load_state_dict(load_reference_pth(os.path.join(model_dir, "model.pth"),
                                             config["arch"], getattr(model, "decoder", None),
                                             init=model.state_dict()), strict=True)
    return model.eval(), config


def save_training_state(model_dir: str, model, optimizer, epoch: int, best_iou: float,
                        trigger: int):
    """Write last.pth through a temporary file, so a run cut while writing
    leaves the previous state whole."""
    state = {"model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
             "optimizer": optimizer.state_dict(), "epoch": int(epoch),
             "best_iou": float(best_iou), "trigger": int(trigger)}
    path = os.path.join(model_dir, "last.pth")
    torch.save(state, path + ".tmp")
    os.replace(path + ".tmp", path)


def load_training_state(model_dir: str, model, optimizer):
    """Restore last.pth into `model` and `optimizer`; returns (epoch,
    best_iou, trigger), or None when there is no last.pth. Raises ValueError
    when the optimizer's layout (--optimizer, --skip_nonfinite,
    --accum_steps) differs from the saved one's."""
    path = os.path.join(model_dir, "last.pth")
    if not os.path.exists(path):
        return None
    state = torch.load(path, map_location="cpu", weights_only=True)
    try:
        optimizer.load_state_dict(state["optimizer"])
    except (KeyError, ValueError) as e:
        raise ValueError(f"{path} does not match the current optimizer state layout: "
                         f"--optimizer/--skip_nonfinite/--accum_steps must match the "
                         f"original run ({e})") from e
    model.load_state_dict(state["model"], strict=True)
    return int(state["epoch"]), float(state["best_iou"]), int(state["trigger"])
