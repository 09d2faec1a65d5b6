"""Frozen plain reference of NestedUNet (UNet++), upstream
4uiiurz1/pytorch-nested-unet archs.py: VGGBlock = (conv3x3 -> BN -> ReLU) x2;
node x_{i,j} = VGGBlock(cat(x_{i,0..j-1}, up(x_{i+1,j-1}))), 2x2 max-pools
down, 2x bilinear align-corners upsamples; four 1x1 heads on x0_1..x0_4 with
deep supervision, else one on x0_4. NCHW (float64), functional over the
upstream state dict's keys.
"""

import torch

from .common import max_pool, upsample


def blocks(cfg):
    """(name, in channels, out channels, the parts' channels or None) of the
    15 VGGBlocks in upstream registration order."""
    nb, cin = cfg["nb_filter"], cfg["input_channels"]
    out = [("conv0_0", cin, nb[0], None)]
    for i in range(1, 5):
        out.append((f"conv{i}_0", nb[i - 1], nb[i], None))
    for j in range(1, 5):
        for i in range(0, 5 - j):
            parts = (nb[i],) * j + (nb[i + 1],)
            out.append((f"conv{i}_{j}", sum(parts), nb[i], parts))
    return out


def heads(cfg):
    return ["final1", "final2", "final3", "final4"] if cfg["deep_supervision"] else ["final"]


def param_specs(cfg):
    """[(key, shape)] of the state dict, in upstream order."""
    specs = []
    for name, cin, cout, _ in blocks(cfg):
        for k, (a, b) in (("1", (cin, cout)), ("2", (cout, cout))):
            specs += [(f"{name}.conv{k}.weight", (b, a, 3, 3)), (f"{name}.conv{k}.bias", (b,)),
                      (f"{name}.bn{k}.weight", (b,)), (f"{name}.bn{k}.bias", (b,)),
                      (f"{name}.bn{k}.running_mean", (b,)), (f"{name}.bn{k}.running_var", (b,))]
    for h in heads(cfg):
        specs += [(f"{h}.weight", (cfg["num_classes"], cfg["nb_filter"][0], 1, 1)),
                  (f"{h}.bias", (cfg["num_classes"],))]
    return specs


def _block(sd, name, x, bn, num):
    return num.checkpointed(lambda t: _vgg_block(sd, name, t, bn, num), x)


def _vgg_block(sd, name, x, bn, num):
    x = num.conv(x, sd[f"{name}.conv1.weight"], sd[f"{name}.conv1.bias"], 1)
    x = num.keep(bn(x, f"{name}.bn1.").relu())
    x = num.conv(x, sd[f"{name}.conv2.weight"], sd[f"{name}.conv2.bias"], 1)
    return num.keep(bn(x, f"{name}.bn2.").relu())


def forward(sd, x, cfg, bn, num):
    """NCHW images -> the list of head logits (one without deep
    supervision)."""
    f = {}
    f["0_0"] = _block(sd, "conv0_0", x, bn, num)
    for i in range(1, 5):
        f[f"{i}_0"] = _block(sd, f"conv{i}_0", max_pool(f[f"{i - 1}_0"]), bn, num)
    # upstream's order: the nodes of each new encoder level after it
    order = [(0, 1), (1, 1), (0, 2), (2, 1), (1, 2), (0, 3), (3, 1), (2, 2), (1, 3), (0, 4)]
    for i, j in order:
        below = f[f"{i + 1}_{j - 1}"]
        up = num.keep(upsample(below, (below.shape[2] * 2, below.shape[3] * 2)))
        cat = torch.cat([f[f"{i}_{k}"] for k in range(j)] + [up], dim=1)
        f[f"{i}_{j}"] = _block(sd, f"conv{i}_{j}", cat, bn, num)
    feats = [f["0_1"], f["0_2"], f["0_3"], f["0_4"]] if cfg["deep_supervision"] else [f["0_4"]]
    return [num.conv(t, sd[f"{h}.weight"], sd[f"{h}.bias"], 0) for h, t in zip(heads(cfg), feats)]


def k4_nodes(cfg, batch):
    """The decoder nodes' first convs, which the program computes over the
    parts without the concat: (b, h, w, part channels, out channels)."""
    h, w = cfg["input_hw"]
    return [(batch, h >> int(n[4]), w >> int(n[4]), parts, cout)
            for n, _, cout, parts in blocks(cfg) if parts is not None]


def bn_layers(cfg, batch):
    """(rows, channels) of each train-mode BN layer: rows = b * h * w."""
    h, w = cfg["input_hw"]
    out = []
    for n, _, cout, _ in blocks(cfg):
        level = int(n[4])
        out += [(batch * (h >> level) * (w >> level), cout)] * 2
    return out
