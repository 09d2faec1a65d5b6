#!/usr/bin/env python
"""How far the narrow NestedUNet train step of
tests/test_torch_cuda.py::test_train_step_cuda_matches_cpu moves when only
the summation order of its BN sums changes.

    python3 bn_conditioning.py                 # CPU only
    python3 bn_conditioning.py --device cuda   # and the card's step

For the model's conv biases that feed a BN at their init and at 0, it
prints the first BN layer's largest mean^2 / var and, as each gradient's
share of that test's bound (1e-4 of the larger of its own and its module's
weight gradient norm), the worst gradient of:
- the CPU step with every BN layer's sum x and sum x^2 taken in float64 and
  rounded once to f32, against the CPU step with the plain version's f32
  sums: what the summation order alone moves;
- with --device cuda, the card's step (the port's kernels) against the
  CPU's.
TF32 is off on the card, as in the test.
"""

import argparse

import numpy as np
import torch

from pytorch_nested_unet_tpu_torch.models import create_model
from pytorch_nested_unet_tpu_torch.ops import fused_bn as bn
from pytorch_nested_unet_tpu_torch.training.loop import make_train_step
from pytorch_nested_unet_tpu_torch.training.optim import build_optimizer

NARROW = (4, 8, 16, 32, 64)


def exact_sum_stats(x2d, eps=1e-5, running_mean=None, running_var=None,
                    momentum=bn.MOMENTUM):
    """`reference_bn_stats` with sum x and sum x^2 taken in float64 and
    rounded once to f32; the rest is its f32 arithmetic."""
    n = x2d.shape[0]
    xd = x2d.double()
    s, ss = xd.sum(0).float(), (xd * xd).sum(0).float()
    mean = s / n
    var = torch.clamp(ss / n - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    if running_mean is not None:
        running_mean.copy_(momentum * running_mean + (1 - momentum) * mean)
        running_var.copy_(momentum * running_var
                          + (1 - momentum) * (var * (n / max(n - 1, 1))))
    return s, ss, mean, var, inv


def train_step_grads(dev, zero_bn_biases, stats=None):
    """Gradients of one train step of the test's model and batch on `dev`;
    `stats` replaces the plain K1 on the CPU."""
    rng = np.random.default_rng(1)
    imgs = torch.from_numpy(rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8))
    masks = torch.from_numpy((rng.random((2, 32, 32, 1)) > 0.6).astype(np.uint8) * 255)
    m = create_model("NestedUNet", 1, 3, True, nb_filter=NARROW)
    if zero_bn_biases:
        with torch.no_grad():
            for name, p in m.named_parameters():
                if name.endswith(("conv1.bias", "conv2.bias")):
                    p.zero_()
    m = m.to(dev)
    step = make_train_step(m, build_optimizer(m.parameters(), "SGD", 1e-2), "BCEDiceLoss",
                           True, augment="none")
    plain = bn.reference_bn_stats
    bn.reference_bn_stats = stats or plain
    try:
        step(imgs.to(dev), masks.to(dev), torch.Generator(device=dev))
    finally:
        bn.reference_bn_stats = plain
    return {n: p.grad.cpu() for n, p in m.named_parameters()}


def worst_share(got, want):
    """(name, share of the test's bound) of the gradient furthest from want."""
    share = {n: ((got[n] - w).norm() / (1e-4 * max(w.norm(), want[n.rsplit(".", 1)[0]
                                                               + ".weight"].norm()))).item()
             for n, w in want.items()}
    name = max(share, key=share.get)
    return name, share[name]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="a CUDA device to compare as well")
    args = ap.parse_args()
    if args.device:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    plain = bn.reference_bn_stats
    for zero in (False, True):
        first = []

        def recording(x2d, *a, **k):
            if not first:
                xd = x2d.double()
                mean = xd.mean(0)
                first.append(((mean * mean) / ((xd * xd).mean(0) - mean * mean)).max().item())
            return plain(x2d, *a, **k)

        cpu = train_step_grads("cpu", zero, recording)
        exact = train_step_grads("cpu", zero, exact_sum_stats)
        name, share = worst_share(exact, cpu)
        line = (f"conv biases feeding a BN {'at 0' if zero else 'at init'}: first BN layer "
                f"mean^2/var up to {first[0]:.3g}; CPU exact BN sums vs f32 sums: worst "
                f"gradient {name} at {share:.3g}x the test's bound")
        if args.device:
            name, share = worst_share(train_step_grads(args.device, zero), cpu)
            line += f"; card ({torch.cuda.get_device_name(0)}) vs CPU: {name} at {share:.3g}x"
        print(line, flush=True)


if __name__ == "__main__":
    main()
