"""device_idle_pct.train: the share of the traced training stretch in which
no kernel, copy or memset ran on the card (the union of their intervals)."""


def read(ctx):
    if ctx.cell.kind != "train" or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
