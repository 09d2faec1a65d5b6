"""The work a configuration asks for, counted from its shapes alone: the
least time of K4's decoder convolutions and of K1-K3's BN passes at a
batch, against the H100 SXM data sheet, and the FLOPs of a whole forward or
training step, counted by `torch.utils.flop_counter` over the frozen
reference on the meta device. Nothing here reads the program under test or
the time it took.
"""

import functools
import json

import torch

from cardbench import reference

# H100 SXM data sheet, dense: bf16 tensor cores, float32 outside them, HBM3.
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
PEAK_BYTES = 3.35e12
ELEMENT_BYTES = {"bf16": 2, "fp32": 4}

# K1-K3 per element of a (rows, C) map: float32 operations (on the FP32
# cores), passes over the map in the activation dtype (K1 reads x; K2 reads
# x and dy; K3 reads x and dy and writes dx) and per-channel float32 vectors.
BN_OPS = {"K1": 3, "K2": 8, "K3": 9}
BN_PASSES = {"K1": 1, "K2": 2, "K3": 3}
BN_VECTORS = {"K1": 9, "K2": 6, "K3": 6}


def conv_bound_s(b, h, w, parts, co, precision):
    """Least seconds of a 3x3 conv over the concatenated parts: each input
    and weight element read once, the output written once (and a float32
    bias), 2 * 9 * cin * co operations per output pixel."""
    esz = ELEMENT_BYTES[precision]
    cin = sum(parts)
    nbytes = (b * h * w * (cin + co) + 9 * cin * co) * esz + co * 4
    flops = 2.0 * b * h * w * 9 * cin * co
    return max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS[precision])


def bn_bound_s(kernel, rows, c, precision):
    """Least seconds of one K1, K2 or K3 pass over a (rows, c) map."""
    esz = ELEMENT_BYTES[precision]
    nbytes = rows * c * esz * BN_PASSES[kernel] + BN_VECTORS[kernel] * c * 4
    return max(nbytes / PEAK_BYTES, rows * c * BN_OPS[kernel] / PEAK_FLOPS["fp32"])


def k4_bound_s(cfg, batch):
    """Least seconds of one forward's K4 work: every decoder node's first
    conv at `batch`."""
    return sum(conv_bound_s(b, h, w, parts, co, cfg["precision"])
               for b, h, w, parts, co in reference.module(cfg["arch"]).k4_nodes(cfg, batch))


def bn_bound_s_per_step(cfg, batch):
    """Least seconds of one training step's K1 + K2 + K3 over every BN layer."""
    return sum(bn_bound_s(k, rows, c, cfg["precision"])
               for rows, c in reference.module(cfg["arch"]).bn_layers(cfg, batch)
               for k in ("K1", "K2", "K3"))


@functools.lru_cache(maxsize=16)
def _flops(key: str, train: bool) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    cfg = json.loads(key)
    h, w = cfg["input_hw"]
    with torch.device("meta"):
        sd = {k: torch.zeros(s) for k, s in reference.module(cfg["arch"]).param_specs(cfg)}
        x = torch.zeros(1, cfg["input_channels"], h, w)
        target = torch.zeros(1, cfg["num_classes"], h, w)
    params = [v.requires_grad_(True) for k, v in sd.items() if reference.is_param(k)]
    bn = reference.BatchNorms(sd, train=train)
    counter = FlopCounterMode(display=False)
    with counter:
        heads = reference.module(cfg["arch"]).forward(sd, x, cfg, bn,
                                                       reference.Numerics(recompute=False))
        if train:
            loss = reference.heads_loss(heads, target)
            torch.autograd.grad(loss, params)
    return int(counter.get_total_flops())


def flops_per_image(cfg, train: bool) -> int:
    """FLOPs of one image's forward (train=False) or forward and backward
    (train=True), as torch.utils.flop_counter counts them (convolutions and
    matrix products) over the frozen reference."""
    return _flops(json.dumps(cfg, sort_keys=True), train)
