"""plain_ops_ms_per_img.train: device ms a trained image spends in every
kernel that is not K1-K4 or NCCL (cuDNN convs and their gradients, the
elementwise, pooling, resize, loss and optimizer kernels), summed."""

from cardbench.lib.spec import metric_module

K4 = metric_module("k4_roofline.train").KERNELS
BN = metric_module("bn_roofline.train").KERNELS


def plain(name):
    return not (K4.search(name) or BN.search(name) or "nccl" in name.lower())


def read(ctx):
    t = ctx.trace.kernel_seconds(plain)
    if ctx.cell.kind != "train" or not ctx.images or t == 0:
        return None
    return 1e3 * t / ctx.images
