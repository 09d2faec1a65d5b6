"""bn_roofline.train: K1-K3's least time over their device time in training.

K1 (statistics; under a mesh its sums-only mode and bn_finish), K2 and K3
(ops/csrc/fused_bn.cu) run at every train-mode BN layer a step; their least
time is counted from the configuration's BN shapes at this card's batch
(cardbench/counts).
"""

import re

from cardbench import counts

KERNELS = re.compile(r"(^|[\s:])(stats_kernel|bwd_reduce_kernel|bwd_dx_kernel|finish_kernel)\b")


def read(ctx):
    t = ctx.trace.kernel_seconds(KERNELS.search)
    if ctx.cell.kind != "train" or t == 0:
        return None
    bound = counts.bn_bound_s_per_step(ctx.cell.config, ctx.cell.traffic["batch"]) * ctx.steps
    return 100.0 * bound / t
