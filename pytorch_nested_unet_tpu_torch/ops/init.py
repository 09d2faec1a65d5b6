"""Initializers matching PyTorch layer defaults (counterpart of ops/init.py).

`nn.Conv2d` and `nn.Linear` draw weight and bias from U(-1/sqrt(fan_in),
1/sqrt(fan_in)); here
the draw comes from an explicit `torch.Generator`, so a model built from a seed
is the same on every device.
"""

import math
from typing import Optional

import torch


def uniform_(t: torch.Tensor, bound: float, generator: torch.Generator):
    """Fill `t` in place from U(-bound, bound) drawn on the CPU generator."""
    with torch.no_grad():
        draw = torch.empty(t.shape, dtype=torch.float32).uniform_(
            -bound, bound, generator=generator)
        t.copy_(draw)
    return t


def torch_conv_init_(weight: torch.Tensor, bias, generator: torch.Generator):
    """OIHW `weight` (or a linear's [out, in]) and its `bias`: both
    U(±1/sqrt(I*kh*kw)) (U(±1/sqrt(in)))."""
    fan_in = int(weight[0].numel())
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    uniform_(weight, bound, generator)
    if bias is not None:
        uniform_(bias, bound, generator)


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator):
    """A linear's [out, in] `weight` as flax's default Dense kernel init draws
    it: a normal truncated at 2 standard deviations, scaled to variance
    1 / in (lecun_normal)."""
    std = 1.0 / math.sqrt(weight.shape[1]) / 0.87962566103423978  # truncation's std
    with torch.no_grad():
        draw = torch.empty(weight.shape, dtype=torch.float32).normal_(generator=generator)
        out = draw.abs() > 2.0
        while bool(out.any()):
            draw[out] = torch.empty(int(out.sum()), dtype=torch.float32).normal_(
                generator=generator)
            out = draw.abs() > 2.0
        weight.copy_(draw * std)
    return weight


def init_convs_(module: torch.nn.Module, generator: Optional[torch.Generator] = None):
    """`torch_conv_init_` on every conv and linear of `module` (each submodule
    with a 4-D or 2-D `weight`), in module order, from `generator` (default:
    seed 0)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    for m in module.modules():
        w = getattr(m, "weight", None)
        if isinstance(w, torch.Tensor) and w.dim() in (2, 4):
            torch_conv_init_(w, m.bias, generator)
