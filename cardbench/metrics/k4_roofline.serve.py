"""k4_roofline.serve: K4's least time over its device time in serving: the
decoder nodes' first convs, once a served batch (kernel names and counts as
in k4_roofline.train)."""

from cardbench import counts
from cardbench.lib.spec import metric_module

KERNELS = metric_module("k4_roofline.train").KERNELS


def read(ctx):
    t = ctx.trace.kernel_seconds(KERNELS.search)
    if ctx.cell.kind != "serve" or t == 0:
        return None
    bound = counts.k4_bound_s(ctx.cell.config, ctx.cell.traffic["batch"]) * ctx.steps
    return 100.0 * bound / t
