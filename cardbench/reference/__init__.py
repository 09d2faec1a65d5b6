"""Frozen plain references, one module per architecture (`<arch>.py`), and
the steps every reference shares: SGD training steps, the eval forward that
serving answers, BN calibration. Plain PyTorch; nothing of the program under
test or of JAX is imported here.
"""

import importlib

import torch

from .common import DTYPE, BatchNorms, Numerics, heads_loss, preprocess


def module(arch: str):
    """The reference module of `arch` (`cardbench/reference/<arch>.py`)."""
    return importlib.import_module(f"{__name__}.{arch}")


def is_param(key: str) -> bool:
    return not key.endswith(("running_mean", "running_var"))


def sgd_steps(cfg, sd0, batches, optim, num: Numerics):
    """Train from the state dict `sd0` over `batches` ([(images_u8, masks_u8)],
    NHWC uint8 on the device) with SGD (torch's rule: d = g + wd * p, the
    momentum buffer starting at d, p -= lr * buf).

    Returns (losses [float], first gradients {key: tensor} before weight
    decay, the state dict after the last step)."""
    ref = module(cfg["arch"])
    sd = {k: v.detach().to(DTYPE) for k, v in sd0.items()}
    keys = [k for k in sd if is_param(k)]
    lr, mom, wd = optim["lr"], optim["momentum"], optim["weight_decay"]
    losses, first, bufs = [], None, {}
    for t, (images, masks) in enumerate(batches):
        x, y = preprocess(images, masks)
        params = {k: sd[k].requires_grad_(True) for k in keys}
        bn = BatchNorms(sd, train=True)
        loss = heads_loss(ref.forward(sd, x, cfg, bn, num), y)
        grads = torch.autograd.grad(loss, [params[k] for k in keys])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            if first is None:
                first = {k: g.detach().clone() for k, g in zip(keys, grads)}
            for k, g in zip(keys, grads):
                p = params[k].detach()
                d = g + wd * p
                bufs[k] = d if t == 0 else bufs[k].mul_(mom).add_(d)
                sd[k] = p - lr * bufs[k]
            sd.update(bn.updates)
        del loss, grads, params
    return losses, first, sd


@torch.no_grad()
def predict(cfg, sd, images_u8, num: Numerics):
    """Eval-mode probabilities of the last head, (B, H, W, classes) float32."""
    sd = {k: v.to(DTYPE) for k, v in sd.items()}
    x, _ = preprocess(images_u8)
    heads = module(cfg["arch"]).forward(sd, x, cfg, BatchNorms(sd, train=False), num)
    return torch.sigmoid(heads[-1]).permute(0, 2, 3, 1).float().contiguous()


@torch.no_grad()
def calibrate(cfg, sd, images_u8):
    """sd with every BN's running statistics set to its batch moments over
    `images_u8` (a served model's statistics, not the init's 0 and 1), in
    sd's dtype."""
    x, _ = preprocess(images_u8)
    bn = BatchNorms({k: v.to(DTYPE) for k, v in sd.items()}, train=True, calibrate=True)
    module(cfg["arch"]).forward(bn.sd, x, cfg, bn, Numerics())
    return {**sd, **{k: v.to(sd[k].dtype) for k, v in bn.updates.items()}}
