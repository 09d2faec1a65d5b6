"""The CRDN family: the Recurrent Decoding Cell and the RNN-decoder UNets
(counterpart of models/rdc.py; reference archs_backup.py:155-361, :621-871,
CRDN.py:8-199).

An encoder column of `UnetConv2` blocks, a 5x5 conv -> BN -> ReLU score block
per level down to `num_classes` channels, and one shared cell (`RDC`) that
decodes the score maps coarse to fine: the carry is resized with
align-corners bilinear interpolation to each level's size (2x between the
levels, 1 -> 3 and 3 -> 6 at RM7's deepest ones) and merged with the level's
map by a ConvLSTM, ConvGRU or vanilla-RNN cell. The 15 (RM3: 9, RM7: 21)
train-mode BN layers run K1-K3 on the card; there is no multipart conv.
The CRDN backbones (models/crdn_backbones.py: VGG16RNN and
ResNet{18,34,50,101,152}RNN) decode their score maps with the same `RDC`
and `rdc_decode`.

State-dict keys are the reference's: `conv1.conv1.0.weight` (the conv) and
`conv1.conv1.1.running_var` (its BN), `score_block1.0` / `.1`, the 5th
encoder block named `center` in UNetRNN and its variants (not in RM3 / RM7),
and only the chosen decoder's gate convs under `RDC.` (the reference builds
all four; `utils.convert.load_reference_pth` drops the dead ones).
"""

from typing import List, Optional, Sequence

import torch
import torch.nn as nn

from ..ops.init import init_convs_
from ..ops.layers import TorchConv
from ..ops.pool import max_pool2x2
from ..ops.resize import resize_bilinear
from .blocks import ConvBNReLU, UnetConv2

DECODERS = ("LSTM", "GRU", "vanilla")
# The JAX package's conv_impl values: how it lowers a gate conv on the TPU
# (its ShiftConv is plain XLA, no Pallas kernel). Each is the same conv here.
CONV_IMPLS = ("auto", "mxu", "shift")
# each decoder's gate convs: name -> output channels in units of hidden_dim
GATES = {"LSTM": {"lstm_catconv": 4}, "GRU": {"gru_catconv": 2, "gru_conv": 1},
         "vanilla": {"vanilla_conv": 1}}


class RDC(nn.Module):
    """Recurrent Decoding Cell over class-score maps (hidden_dim = num_classes).

    Every gate conv sees 2*hidden_dim channels ([h_up ++ x], or [x ++ r*h_up]
    for the GRU's candidate). Each is a TorchConv whatever conv_impl says
    (validated, so configs carry over).
    """

    def __init__(self, hidden_dim: int, kernel_size: int = 3, use_bias: bool = True,
                 decoder: str = "GRU", conv_impl: str = "auto",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if decoder not in DECODERS:
            raise NotImplementedError(decoder)
        if conv_impl not in CONV_IMPLS:
            raise NotImplementedError(conv_impl)
        self.decoder = decoder
        cin, pad = 2 * hidden_dim, kernel_size // 2
        for name, mult in GATES[decoder].items():
            setattr(self, name, TorchConv(cin, mult * hidden_dim, kernel_size, pad, dtype,
                                          use_bias=use_bias))

    def forward(self, x_cur, h_pre, c_pre=None):
        hw = x_cur.shape[1:3]
        h_up = resize_bilinear(h_pre, hw, align_corners=True)
        if self.decoder == "LSTM":
            c_up = resize_bilinear(c_pre, hw, align_corners=True)
            gates = self.lstm_catconv(torch.cat([h_up, x_cur], dim=-1))
            i, f, o, g = torch.chunk(gates, 4, dim=-1)
            c_cur = torch.sigmoid(f) * c_up + torch.sigmoid(i) * torch.tanh(g)
            return torch.sigmoid(o) * torch.tanh(c_cur), c_cur
        if self.decoder == "GRU":
            r, z = torch.chunk(self.gru_catconv(torch.cat([h_up, x_cur], dim=-1)), 2, dim=-1)
            r, z = torch.sigmoid(r), torch.sigmoid(z)
            h_hat = torch.tanh(self.gru_conv(torch.cat([x_cur, r * h_up], dim=-1)))
            return z * h_up + (1.0 - z) * h_hat
        return torch.relu(self.vanilla_conv(torch.cat([h_up, x_cur], dim=-1)))


def rdc_decode(rdc: RDC, scores: Sequence[torch.Tensor]) -> torch.Tensor:
    """Run the shared cell over the score maps, coarsest first, from a zero
    carry the size of the coarsest map; return the last carry. The decoder
    of UNetRNN and its variants, UNetRM3 / RM7, VGG16RNN and the
    ResNet*RNN backbones."""
    h = torch.zeros_like(scores[0])
    if rdc.decoder == "LSTM":
        c = torch.zeros_like(h)
        for x in scores:
            h, c = rdc(x, h, c)
        return h
    for x in scores:
        h = rdc(x, h)
    return h


class _UNetRNNBase(nn.Module):
    """Encoder column of UnetConv2 blocks, a score block per level, the RDC
    chain. Subclasses set the filters (BASE_FILTERS / feature_scale), whether
    the 5th block is called `center`, and may override `make_score_block` and
    `attend` (identity here)."""

    BASE_FILTERS = (64, 128, 256, 512, 1024)
    CENTER = True
    DECODER = "GRU"

    def __init__(self, num_classes: int = 1, input_channels: int = 3,
                 deep_supervision: bool = False, kernel_size: int = 3,
                 feature_scale: int = 4, decoder: Optional[str] = None,
                 conv_impl: str = "auto", use_bias: bool = True,
                 base_filters: Optional[Sequence[int]] = None,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.decoder = decoder or self.DECODER
        base = self.BASE_FILTERS if base_filters is None else tuple(base_filters)
        self.filters = [int(f / feature_scale) for f in base]
        cin = input_channels
        for i, f in enumerate(self.filters):
            setattr(self, self._block_name(i), UnetConv2(cin, f, dtype=dtype))
            cin = f
        for i, f in enumerate(self.filters):
            setattr(self, f"score_block{i + 1}",
                    self.make_score_block(f, num_classes, dtype))
        self.build_attention(num_classes, dtype)
        self.RDC = RDC(num_classes, kernel_size, use_bias, self.decoder, conv_impl, dtype)
        init_convs_(self, generator)

    def _block_name(self, i: int) -> str:
        return "center" if self.CENTER and i == 4 else f"conv{i + 1}"

    def make_score_block(self, in_channels, num_classes, dtype) -> nn.Module:
        """conv5x5 -> BN -> ReLU to num_classes (reference archs_backup.py:313-321)."""
        return ConvBNReLU(in_channels, num_classes, kernel_size=5, padding=2, dtype=dtype)

    def build_attention(self, num_classes, dtype):
        """Hook for the attention variants' modules (none here)."""

    def attend(self, scores: List[torch.Tensor]) -> List[torch.Tensor]:
        return scores

    def encode(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The encoder column's features, finest first: a UnetConv2 block,
        then [2x2 max-pool, UnetConv2] per level (reference
        archs_backup.py:299-311)."""
        feats = []
        for i in range(len(self.filters)):
            if i > 0:
                x = max_pool2x2(x)
            x = getattr(self, self._block_name(i))(x)
            feats.append(x)
        return feats

    def score(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each level's score block, coarsest first (reference
        archs_backup.py:313-321)."""
        return [getattr(self, f"score_block{i + 1}")(feats[i])
                for i in reversed(range(len(feats)))]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        scores = self.attend(self.score(self.encode(x)))
        return rdc_decode(self.RDC, scores).to(torch.float32)


class UNetRNN(_UNetRNNBase):
    """CRDN on a UNet encoder, filters (16, 32, 64, 128, 256) at feature_scale
    4, GRU decoder by default (reference archs_backup.py:234-361)."""


class UNetRM3(_UNetRNNBase):
    """3-level depth ablation, filters (64, 288, 512) / feature_scale
    (reference archs_backup.py:621-715)."""

    BASE_FILTERS = (64, 288, 512)
    CENTER = False


class UNetRM7(_UNetRNNBase):
    """7-level depth ablation, filters (32 .. 2048) / feature_scale
    (reference archs_backup.py:717-871)."""

    BASE_FILTERS = (32, 64, 128, 256, 512, 1024, 2048)
    CENTER = False
