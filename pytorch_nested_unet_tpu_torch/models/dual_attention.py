"""DANet dual attention (PAM / CAM) and the UNetRNN attention variants
(counterpart of models/dual_attention.py; reference archs_backup.py:876-1394).

The variants apply attention to each level's class-score map before the RDC
chain. The port follows the JAX package's documented divergences from the
reference: PAM's query/key width is max(C // 8, 1) of the map's own C (the
reference builds it from the encoder's width and crashes), and the dual
block's PAM and CAM are registered submodules (the reference builds them
inside forward). Dtypes are the JAX package's: energies in the compute dtype,
softmax in float32, cast back. These are plain matmuls there and here.

On the 'x'/'y' mesh axes `parallel.mesh.spatial_partition` sets each
module's `bands` (a `parallel.bands.Bands`): PAM attends from its band's
queries to the whole map's keys and values (`Bands.gather`, whose adjoint
sums every band's reading), so a band's energy is (h*w) x (H*W) per image;
CAM sums its C x C gram over the bands (`Bands.sum`) before the softmax.
With `bands` None each runs on the whole image.

Keys: `PAM_Module1.{query_conv,key_conv,value_conv}.*` and `.gamma`,
`CAM_Module1.gamma`, `attention_block1.{pam,cam}.*`.
"""

from typing import List, Optional

import torch
import torch.nn as nn

from ..ops.layers import TorchConv
from .rdc import _UNetRNNBase


def _rank1_attention_interp(t: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            grid_size: int, t_all: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(t_i * k_j) @ v for scalar queries and keys through one shared
    function of t: evaluated on a per-batch uniform grid over [min t, max t]
    and interpolated linearly at each row's t_i (an approximation).

    t: (B, n); k: (B, N); v: (B, N, C); `t_all`: every query of the map when
    t is a band's share of them (the grid spans all), else t. Returns (B,
    n, C) in v's dtype; the softmax math runs in float32."""
    tf, kf, vf = t.float(), k.float(), v.float()
    ta = tf if t_all is None else t_all.float()
    lo = ta.amin(dim=1, keepdim=True)
    hi = ta.amax(dim=1, keepdim=True)
    span = torch.clamp(hi - lo, min=1e-12)
    g = lo + span * torch.linspace(0.0, 1.0, grid_size, device=t.device)[None, :]  # (B, G)
    s = g[:, :, None] * kf[:, None, :]                                           # (B, G, N)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    f_grid = torch.einsum("bgn,bnc->bgc", e, vf) / e.sum(dim=-1)[:, :, None]     # (B, G, C)
    pos = (tf - lo) / span * (grid_size - 1)
    i0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, grid_size - 2)
    frac = (pos - i0.to(torch.float32))[..., None]
    idx0 = i0[:, :, None].expand(-1, -1, f_grid.shape[-1])
    f0 = torch.gather(f_grid, 1, idx0)
    f1 = torch.gather(f_grid, 1, idx0 + 1)
    return ((1.0 - frac) * f0 + frac * f1).to(v.dtype)


class PAMModule(nn.Module):
    """Position attention: softmax(Q K^T) over the H*W positions, a
    gamma-gated residual (reference archs_backup.py:876-910). fast_rank1 (off
    by default) takes the grid-interpolated path where the query/key width is
    1; it approximates the exact path."""

    bands = None

    def __init__(self, in_channels: int, dtype: Optional[torch.dtype] = None,
                 fast_rank1: bool = False, grid_size: int = 256):
        super().__init__()
        qk = max(in_channels // 8, 1)
        self.fast_rank1, self.grid_size = fast_rank1, grid_size
        self.query_conv = TorchConv(in_channels, qk, 1, dtype=dtype)
        self.key_conv = TorchConv(in_channels, qk, 1, dtype=dtype)
        self.value_conv = TorchConv(in_channels, in_channels, 1, dtype=dtype)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        qx, kx, vx = self.query_conv(x), self.key_conv(x), self.value_conv(x)
        fast = self.fast_rank1 and qx.shape[-1] == 1
        t_all = None
        if self.bands is not None:  # the whole map's keys and values (and queries: fast's grid)
            parts = [kx, vx, qx] if fast else [kx, vx]
            whole = self.bands.gather(torch.cat(parts, dim=-1))
            kx, vx = whole[..., :kx.shape[-1]], whole[..., kx.shape[-1]:kx.shape[-1] + c]
            if fast:
                t_all = whole[..., -1].reshape(b, -1)
        q = qx.reshape(b, h * w, -1)
        k = kx.reshape(b, -1, kx.shape[-1])
        v = vx.reshape(b, -1, c)
        if fast:
            out = _rank1_attention_interp(q[..., 0], k[..., 0], v, self.grid_size, t_all)
        else:
            energy = torch.bmm(q, k.transpose(1, 2))
            attention = torch.softmax(energy.float(), dim=-1).to(v.dtype)
            out = torch.bmm(attention, v)
        return self.gamma.to(x.dtype) * out.reshape(b, h, w, c) + x


class CAMModule(nn.Module):
    """Channel attention: a C x C gram with the max-subtraction of the
    reference, a gamma-gated residual (reference archs_backup.py:913-947)."""

    bands = None

    def __init__(self):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        flat = x.reshape(b, h * w, c)
        energy = torch.bmm(flat.transpose(1, 2), flat).float()
        if self.bands is not None:  # the gram sums over every band's pixels
            energy = self.bands.sum(energy)
        energy_new = energy.amax(dim=-1, keepdim=True) - energy
        attention = torch.softmax(energy_new, dim=-1).to(x.dtype)
        out = torch.bmm(flat, attention.transpose(1, 2)).reshape(b, h, w, c)
        return self.gamma.to(x.dtype) * out + x


class DualAttentionBlock(nn.Module):
    """PAM(x) + CAM(x) (reference archs_backup.py:950-962)."""

    def __init__(self, in_channels: int, dtype: Optional[torch.dtype] = None,
                 fast_pam: bool = False, pam_grid: int = 256):
        super().__init__()
        self.pam = PAMModule(in_channels, dtype, fast_pam, pam_grid)
        self.cam = CAMModule()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pam(x) + self.cam(x)


class _AttentionBase(_UNetRNNBase):
    """An attention module per level, named PREFIX1..N, applied to the score
    maps coarsest first (PREFIX1 on the coarsest)."""

    PREFIX = ""

    def make_attention(self, num_classes, dtype) -> nn.Module:
        raise NotImplementedError

    def build_attention(self, num_classes, dtype):
        for i in range(len(self.filters)):
            setattr(self, f"{self.PREFIX}{i + 1}", self.make_attention(num_classes, dtype))

    def attend(self, scores: List[torch.Tensor]) -> List[torch.Tensor]:
        return [getattr(self, f"{self.PREFIX}{i + 1}")(s) for i, s in enumerate(scores)]


class _PAMOptions:
    """fast_pam / pam_grid, set before the base constructor builds the
    attention modules."""

    def __init__(self, *args, fast_pam: bool = False, pam_grid: int = 256, **kwargs):
        self.fast_pam, self.pam_grid = fast_pam, pam_grid
        super().__init__(*args, **kwargs)


class UNetRNNPAttention(_PAMOptions, _AttentionBase):
    """UNetRNN with position attention on each score map (reference
    archs_backup.py:968-1106); fast_pam opts into the approximate rank-1 PAM."""

    PREFIX = "PAM_Module"

    def make_attention(self, num_classes, dtype):
        return PAMModule(num_classes, dtype, self.fast_pam, self.pam_grid)


class UNetRNNCAttention(_AttentionBase):
    """UNetRNN with channel attention on each score map (reference
    archs_backup.py:1109-1250)."""

    PREFIX = "CAM_Module"

    def make_attention(self, num_classes, dtype):
        return CAMModule()


class UNetRNNAttention(_PAMOptions, _AttentionBase):
    """UNetRNN with PAM + CAM on each score map (reference
    archs_backup.py:1256-1394); fast_pam opts into the approximate rank-1 PAM."""

    PREFIX = "attention_block"

    def make_attention(self, num_classes, dtype):
        return DualAttentionBlock(num_classes, dtype, self.fast_pam, self.pam_grid)
