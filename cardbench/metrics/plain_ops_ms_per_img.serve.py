"""plain_ops_ms_per_img.serve: device ms a served image spends in every
kernel that is not K1-K4 or NCCL (kernel names as in
plain_ops_ms_per_img.train)."""

from cardbench.lib.spec import metric_module

plain = metric_module("plain_ops_ms_per_img.train").plain


def read(ctx):
    t = ctx.trace.kernel_seconds(plain)
    if ctx.cell.kind != "serve" or not ctx.images or t == 0:
        return None
    return 1e3 * t / ctx.images
