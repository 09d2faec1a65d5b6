"""device_idle_pct.serve: the share of the traced serving stretch in which
no kernel, copy or memset ran on the card (the union of their intervals)."""


def read(ctx):
    if ctx.cell.kind != "serve" or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
