"""k4_roofline.train: K4's least time over its device time in training.

K4 (ops/csrc/decoder_fusion.cu) runs the forward of every decoder node's
first conv once a step; its least time is counted from the configuration's
node shapes at this card's batch (cardbench/counts). Its kernels are named
below; a trace without them reads nothing.
"""

import re

from cardbench import counts

KERNELS = re.compile(r"conv3x3_(bf16_mma|f32_fma)_kernel")


def read(ctx):
    t = ctx.trace.kernel_seconds(KERNELS.search)
    if ctx.cell.kind != "train" or t == 0:
        return None
    bound = counts.k4_bound_s(ctx.cell.config, ctx.cell.traffic["batch"]) * ctx.steps
    return 100.0 * bound / t
