"""Frozen plain reference of VGG16RNN (CRDN), the husheng876/pytorch_nested-unet
fork's CRDN.py:250-407: a VGG-16-BN encoder of stages (64, 2) (128, 2) (256, 3)
(512, 3) (512, 3), each after the first behind a 2x2 max-pool; a score block
(conv5x5 -> BN -> ReLU to num_classes) per stage; the Recurrent Decoding Cell
with its ConvLSTM over the score maps, coarsest first, from a zero carry, the
carry resized bilinearly (align corners) to each level. The last carry h is
the logits. NCHW (float64), functional over the upstream state dict's keys.
"""

import torch

from .common import max_pool, upsample

STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


def _units(cfg):
    """(conv key prefix, BN key prefix, in channels, out channels, stage) of
    each conv unit, in upstream order."""
    out, cin = [], cfg["input_channels"]
    for s, (ch, n) in enumerate(STAGES):
        first = int(s > 0)  # index 0 holds the stage's max-pool after the first
        for i in range(n):
            out.append((f"conv_block{s + 1}.{first + 3 * i}.",
                        f"conv_block{s + 1}.{first + 3 * i + 1}.", cin, ch, s))
            cin = ch
    return out


def param_specs(cfg):
    """[(key, shape)] of the state dict, in upstream order."""
    nc, specs = cfg["num_classes"], []

    def conv_bn(conv, bn, cin, cout, k):
        return [(conv + "weight", (cout, cin, k, k)), (conv + "bias", (cout,)),
                (bn + "weight", (cout,)), (bn + "bias", (cout,)),
                (bn + "running_mean", (cout,)), (bn + "running_var", (cout,))]

    for conv, bn, cin, cout, _ in _units(cfg):
        specs += conv_bn(conv, bn, cin, cout, 3)
    for s, (ch, _) in enumerate(STAGES):
        specs += conv_bn(f"score_block{s + 1}.0.", f"score_block{s + 1}.1.", ch, nc, 5)
    specs += [("RDC.lstm_catconv.weight", (4 * nc, 2 * nc, 3, 3)),
              ("RDC.lstm_catconv.bias", (4 * nc,))]
    return specs


def forward(sd, x, cfg, bn, num):
    """NCHW images -> [logits]."""
    feats, stage = [], 0
    for conv, bnp, _, _, s in _units(cfg):
        if s != stage:
            feats.append(x)
            x, stage = max_pool(x), s
        x = num.checkpointed(lambda t, c=conv, b=bnp: num.keep(bn(
            num.conv(t, sd[c + "weight"], sd[c + "bias"], 1), b).relu()), x)
    feats.append(x)
    scores = []
    for s in reversed(range(len(STAGES))):
        p = f"score_block{s + 1}."
        y = num.conv(feats[s], sd[p + "0.weight"], sd[p + "0.bias"], 2)
        scores.append(num.keep(bn(y, p + "1.").relu()))
    h = torch.zeros_like(scores[0])
    c = torch.zeros_like(h)
    w, b = sd["RDC.lstm_catconv.weight"], sd["RDC.lstm_catconv.bias"]
    for score in scores:
        size = score.shape[2:]
        h_up = h if h.shape[2:] == size else num.keep(upsample(h, size))
        c_up = c if c.shape[2:] == size else num.keep(upsample(c, size))
        i, f, o, g = torch.chunk(num.conv(torch.cat([h_up, score], 1), w, b, 1), 4, dim=1)
        c = num.keep(torch.sigmoid(f) * c_up + torch.sigmoid(i) * torch.tanh(g))
        h = num.keep(torch.sigmoid(o) * torch.tanh(c))
    return [h]


def k4_nodes(cfg, batch):
    """No multipart convolution: the program runs no K4 on this model."""
    return []


def bn_layers(cfg, batch):
    """(rows, channels) of each train-mode BN layer: rows = b * h * w."""
    h, w = cfg["input_hw"]
    out = [(batch * (h >> s) * (w >> s), cout) for _, _, _, cout, s in _units(cfg)]
    return out + [(batch * (h >> s) * (w >> s), cfg["num_classes"]) for s in range(len(STAGES))]
