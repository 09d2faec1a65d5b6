"""BatchNorm2d + ReLU over NHWC tensors, eval mode (counterpart of
ops/fused_bn.py::FusedBatchNormReLU, running-stat branch :341-344).

The JAX module's three Pallas kernels (statistics, backward reduction,
backward dx) run only in training; they are queued for the training slice
(ROADMAP K1-K3), so train mode raises here.
"""

from typing import Optional

import torch
import torch.nn as nn


class FusedBatchNormReLU(nn.Module):
    """relu((x - running_mean) * rsqrt(running_var + eps) * weight + bias).

    The math runs in float32 whatever the compute dtype, and the result is cast
    back to `dtype` (or to the input's dtype when `dtype` is None).
    """

    def __init__(self, num_features: int, eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "FusedBatchNormReLU train mode (batch statistics, the backward "
                "kernels) is not ported yet: see ROADMAP.md queue 2, K1-K3; "
                "call model.eval() to use the running statistics")
        out_dtype = self.dtype or x.dtype
        scale = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.to(torch.float32) - self.running_mean) * scale + self.bias
        return torch.relu(y).to(out_dtype)
