"""What a run is fed, all made on the device from `--seed`: the weights (a
state dict in the upstream layout) and the synthetic segmentation set.
"""

import math

import torch

from cardbench import reference


def bn_fed_biases(specs):
    """The keys of the conv biases that feed a BN: the bias right before a
    BN's weight in the upstream order (a BN's prefix has a running_mean)."""
    keys = [k for k, _ in specs]
    out = []
    for k, nxt in zip(keys, keys[1:]):
        bn = nxt[:-len("weight")]
        if k.endswith(".bias") and nxt.endswith(".weight") and bn + "running_mean" in keys:
            out.append(k)
    return out


def state_dict(cfg, generator: torch.Generator):
    """Seeded float32 weights in the upstream layout: every conv weight and
    bias from torch's default U(+-1/sqrt(fan_in)) in one uniform draw, but
    the biases that feed a BN at 0; BN weight 1, bias 0, running mean 0,
    running variance 1.

    A BN cancels the bias before it. At its default draw that bias is ~60x
    the first conv's signal (the input is normalized and then divided by
    255 again), so the conv's output holds the signal in its last bits: a
    bf16 output keeps ~3 of them, and even two float32 sums in another
    order move the first layer's gradient by percents. At 0 the step is
    well conditioned, and the check sees the program's arithmetic."""
    specs = reference.module(cfg["arch"]).param_specs(cfg)
    shapes = dict(specs)
    dev = generator.device

    def conv_fan_in(key):
        w = key[:-len("bias")] + "weight" if key.endswith("bias") else key
        shape = shapes.get(w)
        return math.prod(shape[1:]) if shape is not None and len(shape) == 4 else None

    drawn = [(k, s, conv_fan_in(k)) for k, s in specs if conv_fan_in(k) is not None]
    total = sum(math.prod(s) for _, s, _ in drawn)
    flat = torch.empty(total, device=dev).uniform_(-1.0, 1.0, generator=generator)
    bounds = torch.tensor([1.0 / math.sqrt(f) for _, _, f in drawn], device=dev)
    sizes = torch.tensor([math.prod(s) for _, s, _ in drawn], device=dev)
    flat.mul_(bounds.repeat_interleave(sizes, output_size=total))
    sd, at = {}, 0
    for k, s, _ in drawn:
        n = math.prod(s)
        sd[k] = flat[at:at + n].view(s)
        at += n
    for k in bn_fed_biases(specs):
        sd[k].zero_()
    fill = {"weight": 1.0, "bias": 0.0, "running_mean": 0.0, "running_var": 1.0}
    for k, s in specs:
        if k not in sd:
            sd[k] = torch.full(s, fill[k.rsplit(".", 1)[1]], device=dev)
    return {k: sd[k] for k, _ in specs}


def synthetic_set(n: int, hw, generator: torch.Generator):
    """n seeded images (uint8 (n, H, W, 3)) and masks (uint8 (n, H, W, 1), 0
    or 255): 1-3 rotated ellipses (the mask, brighter in green) over a
    textured background, a red rectangle as a distractor in 70% of images,
    pixel noise. The generator of parity.py's synthetic set, vectorized over
    the images."""
    h, w = hw
    dev = generator.device
    s = min(h, w)

    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    def integers(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=generator, device=dev)

    img = integers(40, 120, n, h, w, 3).float()
    yy = torch.arange(h, device=dev).view(1, h, 1).float()
    xx = torch.arange(w, device=dev).view(1, 1, w).float()
    count = integers(1, 4, n)
    mask = torch.zeros(n, h, w, dtype=torch.bool, device=dev)
    for k in range(3):
        cy = integers(s // 6, h - s // 6, n).float().view(n, 1, 1)
        cx = integers(s // 6, w - s // 6, n).float().view(n, 1, 1)
        ry = integers(max(2, s // 12), max(3, s // 5), n).float().view(n, 1, 1)
        rx = integers(max(2, s // 12), max(3, s // 5), n).float().view(n, 1, 1)
        ang = (uniform(n) * math.pi).view(n, 1, 1)
        ca, sa = torch.cos(ang), torch.sin(ang)
        u = (yy - cy) * ca + (xx - cx) * sa
        v = -(yy - cy) * sa + (xx - cx) * ca
        inside = (u / ry) ** 2 + (v / rx) ** 2 < 1.0
        mask |= inside & (k < count).view(n, 1, 1)
    img += mask.unsqueeze(-1) * torch.tensor([25.0, 60.0, 25.0], device=dev)
    y0 = integers(0, max(1, h - h // 4), n).view(n, 1, 1)
    x0 = integers(0, max(1, w - w // 4), n).view(n, 1, 1)
    has = (uniform(n) < 0.7).view(n, 1, 1)
    rect = (has & (yy >= y0) & (yy < y0 + h // 6) & (xx >= x0) & (xx < x0 + w // 6))
    img += rect.unsqueeze(-1) * torch.tensor([70.0, 20.0, 20.0], device=dev)
    img += torch.randn(img.shape, generator=generator, device=dev) * 12.0
    images = img.clamp_(0, 255).to(torch.uint8)
    masks = (mask.to(torch.uint8) * 255).unsqueeze(-1)
    return images, masks


def epoch_orders(n: int, steps: int, batch: int, generator: torch.Generator):
    """Endless seeded batch orders: each epoch a permutation of the n images,
    cut into `steps` batches of `batch` (drop_last), a (steps, batch) int64
    tensor on the generator's device."""
    while True:
        yield torch.randperm(n, generator=generator, device=generator.device)[
            :steps * batch].view(steps, batch)
