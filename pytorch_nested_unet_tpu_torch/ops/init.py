"""Initializers matching PyTorch layer defaults (counterpart of ops/init.py).

`nn.Conv2d` draws weight and bias from U(-1/sqrt(fan_in), 1/sqrt(fan_in)); here
the draw comes from an explicit `torch.Generator`, so a model built from a seed
is the same on every device.
"""

import math

import torch


def uniform_(t: torch.Tensor, bound: float, generator: torch.Generator):
    """Fill `t` in place from U(-bound, bound) drawn on the CPU generator."""
    with torch.no_grad():
        draw = torch.empty(t.shape, dtype=torch.float32).uniform_(
            -bound, bound, generator=generator)
        t.copy_(draw)
    return t


def torch_conv_init_(weight: torch.Tensor, bias, generator: torch.Generator):
    """OIHW `weight` and its `bias`: both U(±1/sqrt(I*kh*kw))."""
    fan_in = int(weight.shape[1] * weight.shape[2] * weight.shape[3])
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    uniform_(weight, bound, generator)
    if bias is not None:
        uniform_(bias, bound, generator)
