"""Plain PyTorch pieces the frozen references share, written from the upstream
layer equations (4uiiurz1/pytorch-nested-unet and its CRDN fork): NCHW
tensors in float64 (DTYPE), functional over a reference-layout state dict
(the upstream checkpoints' keys), no kernels of the program under test.

Float64, not float32: a conv bias that feeds a BN has a gradient that is
nought but for rounding, and in float32 the first layer's rounding (its
input is normalized, then divided by 255 again) leaves it above a
thousandth of the median leaf's, where the check could not tell it from a
live leaf. The blocks are checkpointed (`torch.utils.checkpoint`), so a
training step at a cell's batch fits on one card.

`Numerics` is how a reference computes: "exact" (float64, under
`plain_math`) is the yardstick; "fp8" is the control, the step below the bf16
that the configurations state: each convolution's operands, and every
tensor the program keeps in bf16 (conv and BN outputs, upsamples, the RDC's
gates and carries), rounded to float8 e4m3 under a per-tensor scale, and the
gradient reaching each of them rounded to e5m2.
"""

import contextlib

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
DTYPE = torch.float64
BN_EPS = 1e-5
BN_MOMENTUM = 0.1
DICE_SMOOTH = 1e-5


@contextlib.contextmanager
def plain_math():
    """Inside: TF32 off for matmuls and cuDNN, and cuDNN off, so a float64
    conv is PyTorch's own (im2col and a float64 GEMM, 2-3x faster on the
    card than cuDNN's float64 kernels); the switches restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _fake_fp8(x, dtype):
    """x rounded to the float8 `dtype` under a per-tensor scale (amax to the
    format's largest finite value), returned in x's dtype."""
    top = torch.finfo(dtype).max
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = top / amax
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _RoundE4M3(torch.autograd.Function):
    """Forward: e4m3 rounding. Backward: the gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x):
        return _fake_fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundOut(torch.autograd.Function):
    """Forward: e4m3 rounding. Backward: the gradient rounded to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return _fake_fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _fake_fp8(g, torch.float8_e5m2)


class Numerics:
    """How a reference computes: "exact" or "fp8" (the control, see the
    module docstring); `recompute`: whether blocks are checkpointed (off for
    counting FLOPs, which count no recomputed work)."""

    def __init__(self, kind: str = "exact", recompute: bool = True):
        if kind not in ("exact", "fp8"):
            raise ValueError(f"numerics must be exact or fp8, got {kind!r}")
        self.kind, self.recompute = kind, recompute

    def checkpointed(self, fn, *args):
        """fn(*args), its activations made again in backward when a gradient
        is taken (a step at a cell's batch then fits on one card)."""
        if not (self.recompute and torch.is_grad_enabled()):
            return fn(*args)
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)

    def keep(self, x):
        """x as the program keeps it between ops (fp8: rounded to e4m3, its
        gradient to e5m2)."""
        return x if self.kind == "exact" else _RoundOut.apply(x)

    def conv(self, x, weight, bias, padding):
        if self.kind == "exact":
            return F.conv2d(x, weight, bias, padding=padding)
        y = F.conv2d(_RoundE4M3.apply(x), _RoundE4M3.apply(weight), None, padding=padding)
        if bias is not None:
            y = y + bias.view(1, -1, 1, 1)
        return self.keep(y)


def preprocess(images_u8, masks_u8=None):
    """(B,H,W,3) uint8 -> NCHW DTYPE: /255, ImageNet mean and std, then /255
    once more (upstream's Dataset divides the normalized image again); masks
    (B,H,W,C) uint8 -> NCHW in [0, 1]."""
    x = images_u8.to(DTYPE) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, dtype=DTYPE, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=DTYPE, device=x.device)
    x = ((x - mean) / std / 255.0).permute(0, 3, 1, 2).contiguous()
    if masks_u8 is None:
        return x, None
    return x, (masks_u8.to(DTYPE) / 255.0).permute(0, 3, 1, 2).contiguous()



class BatchNorms:
    """The state dict's BatchNorm2d layers: train mode normalizes with the
    batch's moments and records the running statistics' update (momentum 0.1,
    unbiased variance) in `updates`; eval mode uses the running statistics.
    `calibrate` records the batch moments themselves as the new statistics."""

    def __init__(self, sd, train: bool, calibrate: bool = False):
        self.sd, self.train, self.calibrate = sd, train, calibrate
        self.updates = {}

    def __call__(self, x, prefix):
        w, b = self.sd[prefix + "weight"], self.sd[prefix + "bias"]
        if not self.train:
            mean, var = self.sd[prefix + "running_mean"], self.sd[prefix + "running_var"]
        else:
            mean = x.mean(dim=(0, 2, 3))
            var = x.var(dim=(0, 2, 3), unbiased=False)
            with torch.no_grad():
                if self.calibrate:
                    new_mean, new_var = mean.detach(), var.detach()
                else:
                    n = x.numel() // x.shape[1]
                    new_mean = ((1 - BN_MOMENTUM) * self.sd[prefix + "running_mean"]
                                + BN_MOMENTUM * mean.detach())
                    new_var = ((1 - BN_MOMENTUM) * self.sd[prefix + "running_var"]
                               + BN_MOMENTUM * var.detach() * n / (n - 1))
                self.updates[prefix + "running_mean"] = new_mean
                self.updates[prefix + "running_var"] = new_var
        scale = w / torch.sqrt(var + BN_EPS)
        return (x - mean.view(1, -1, 1, 1)) * scale.view(1, -1, 1, 1) + b.view(1, -1, 1, 1)


def max_pool(x):
    return F.max_pool2d(x, 2)


def upsample(x, size):
    return F.interpolate(x, size=size, mode="bilinear", align_corners=True)


def bce_dice(logits, target):
    """0.5 * mean BCE-with-logits + (1 - mean per-image soft Dice of the
    sigmoid), smooth 1e-5 (upstream losses.py BCEDiceLoss)."""
    bce = F.binary_cross_entropy_with_logits(logits, target)
    n = logits.shape[0]
    p = torch.sigmoid(logits).reshape(n, -1)
    t = target.reshape(n, -1)
    dice = (2.0 * (p * t).sum(1) + DICE_SMOOTH) / (p.sum(1) + t.sum(1) + DICE_SMOOTH)
    return 0.5 * bce + (1.0 - dice.mean())


def heads_loss(heads, target):
    """Deep supervision: the mean of the heads' losses (upstream train.py)."""
    return sum(bce_dice(h, target) for h in heads) / len(heads)
