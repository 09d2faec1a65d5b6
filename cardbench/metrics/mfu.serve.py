"""mfu.serve: a serving cell's forward FLOPs a second over the card's bf16
peak (the FLOPs from the frozen reference, the rate of the untraced window)."""

from cardbench import counts


def read(ctx):
    if ctx.cell.kind != "serve" or not ctx.rate:
        return None
    cfg = ctx.cell.config
    peak = counts.PEAK_FLOPS[cfg["precision"]] * ctx.chips
    return 100.0 * ctx.rate * counts.flops_per_image(cfg, train=False) / peak
