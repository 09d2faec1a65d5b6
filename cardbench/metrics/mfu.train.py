"""mfu.train: a training cell's FLOPs a second over the cards' bf16 peak.

The FLOPs of an image's forward and backward come from the frozen reference
(cardbench/counts, no recomputed work); the rate is the images of the
untraced window over its seconds, every card's images over every card's peak.
"""

from cardbench import counts


def read(ctx):
    if ctx.cell.kind != "train" or not ctx.rate:
        return None
    cfg = ctx.cell.config
    peak = counts.PEAK_FLOPS[cfg["precision"]] * ctx.chips
    return 100.0 * ctx.rate * counts.flops_per_image(cfg, train=True) / peak
