"""The Non-local U-Nets 2D multi-head attention block (counterpart of
models/nonlocal_attention.py; reference archs.py:964-1077).

Scaled dot-product attention of every query position over every input
position, per head, with a 1x1 (SAME), 3x3 stride-2 (DOWN) or 3x3 stride-2
transposed (UP, output_padding 1: twice the input's size) query transform;
the softmax in float32, dropout on the attention weights in train mode. A
block, not an arch: it is not registered (the reference lists it in
archs.__all__ but cannot build it as a model), as in the JAX package.
"""

from typing import Optional

import torch
import torch.nn as nn

from ..ops.init import init_convs_
from ..ops.layers import Dropout, TorchConv, TorchConvTranspose

LAYER_TYPES = ("SAME", "DOWN", "UP")


class MultiHeadAttention2D(nn.Module):
    """Multi-head attention over NHWC maps with input transforms
    (QueryTransform, KeyTransform, ValueTransform) and a 1x1 outputConv.
    Weights and the dropout's masks come from `generator`."""

    def __init__(self, in_channels: int, key_filters: int = 16, value_filters: int = 16,
                 output_filters: int = 40, num_heads: int = 2, dropout_prob: float = 0.5,
                 layer_type: str = "SAME", dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if key_filters % num_heads:
            raise ValueError("Key depth must be divisible by the number of heads.")
        if value_filters % num_heads:
            raise ValueError("Value depth must be divisible by the number of heads.")
        if layer_type not in LAYER_TYPES:
            raise ValueError(f"Layer type ({layer_type}) must be SAME, DOWN or UP.")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.num_heads = num_heads
        if layer_type == "SAME":
            self.QueryTransform = TorchConv(in_channels, key_filters, 1, 0, dtype)
        elif layer_type == "DOWN":
            self.QueryTransform = TorchConv(in_channels, key_filters, 3, 1, dtype, stride=2)
        else:
            self.QueryTransform = TorchConvTranspose(in_channels, key_filters, 3, 2, 1, 1,
                                                     dtype=dtype)
        self.KeyTransform = TorchConv(in_channels, key_filters, 1, 0, dtype)
        self.ValueTransform = TorchConv(in_channels, value_filters, 1, 0, dtype)
        self.attention_dropout = Dropout(dropout_prob, generator)
        self.outputConv = TorchConv(value_filters, output_filters, 1, 0, dtype)
        init_convs_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = self.QueryTransform(x)
        k, v = self.KeyTransform(x), self.ValueTransform(x)
        b, hq, wq = q.shape[:3]
        n = self.num_heads
        ck, cv = q.shape[-1] // n, v.shape[-1] // n
        q = q.reshape(b, hq * wq, n, ck) / torch.tensor(ck ** 0.5, dtype=q.dtype)
        k = k.reshape(b, -1, n, ck)
        v = v.reshape(b, -1, n, cv)
        logits = torch.einsum("bqnc,bknc->bnqk", q, k).to(torch.float32)
        attn = self.attention_dropout(torch.softmax(logits, dim=-1).to(v.dtype))
        out = torch.einsum("bnqk,bknc->bqnc", attn, v).reshape(b, hq, wq, n * cv)
        return self.outputConv(out)


# the reference's name (archs.py exports it in __all__)
multi_head_attention_2d = MultiHeadAttention2D
