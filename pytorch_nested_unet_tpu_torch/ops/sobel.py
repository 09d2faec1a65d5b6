"""Fixed-kernel Sobel edge maps over NHWC tensors (counterpart of
ops/sobel.py; reference cascadePSP_model/sobel_op.py:7-45).

CascadePSP's boundary losses read them. Each map is a depthwise 3x3
convolution with a fixed kernel, zero-padded: a 3x3 mean (count_include_pad)
first, then the x and y Sobel kernels. The reference hard-codes `.cuda()`
for the kernels (sobel_op.py:14,19); here they follow the input's device.
"""

from typing import Dict

import torch
import torch.nn.functional as F

_MEAN = [[1 / 9.0] * 3] * 3
_KX = [[0.25, 0.0, -0.25], [0.5, 0.0, -0.5], [0.25, 0.0, -0.25]]
_KY = [[0.25, 0.5, 0.25], [0.0, 0.0, 0.0], [-0.25, -0.5, -0.25]]


def _depthwise3x3(x: torch.Tensor, kernel) -> torch.Tensor:
    """x (B,C,H,W) convolved channel by channel with the 3x3 `kernel`."""
    c = x.shape[1]
    k = torch.tensor(kernel, dtype=x.dtype, device=x.device).expand(c, 1, 3, 3)
    return F.conv2d(x, k, padding=1, groups=c)


def sobel(x: torch.Tensor, epsilon: float = 1e-4) -> torch.Tensor:
    """sqrt(gx^2 + gy^2 + eps) of (B,H,W,C) after a 3x3 mean (reference
    sobel_op.py:22-36). The result is NHWC-contiguous."""
    x = _depthwise3x3(x.permute(0, 3, 1, 2), _MEAN)
    gx, gy = _depthwise3x3(x, _KX), _depthwise3x3(x, _KY)
    return torch.sqrt(gx * gx + gy * gy + epsilon).permute(0, 2, 3, 1).contiguous()


class SobelComputer:
    """compute_edges(images) adds 'gt_sobel' and 'pred_sobel' (reference
    sobel_op.py:38-45)."""

    def __init__(self, epsilon: float = 1e-4):
        self.epsilon = epsilon

    def compute_edges(self, images: Dict) -> Dict:
        images["gt_sobel"] = sobel(images["gt"], self.epsilon)
        images["pred_sobel"] = sobel(images["pred_224"], self.epsilon)
        return images
