"""One f32 train step of the CRDN backbones against the JAX package's:
VGG16RNN (LSTM: its 18 BN layers on the K1-K3 path), ResNet18RNN (GRU: the
trunk's plain BN, K1-K3 at the 5 score blocks) and ResNet50UNet (the
trunk's 53 plain BN layers and the transposed convs), full width, 32x32,
batch 2, from the same JAX variables on the same batch
(`test_torch_crdn.check_train_step_against_jax`), with a floor for how far
f32 rounding alone moves the step (`f32_movement`).
"""

import pytest
import torch
import torch.nn.functional as F

from pytorch_nested_unet_tpu_torch.models import create_model
from pytorch_nested_unet_tpu_torch.ops.fused_bn import FusedBatchNormReLU
from pytorch_nested_unet_tpu_torch.ops.layers import BatchNorm, TorchConv, TorchConvTranspose
from pytorch_nested_unet_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_crdn import check_train_step_against_jax


def _step_gradients(arch, kw, variables, imgs, masks, dtype, noise=0.0):
    """The port's train-step gradients and running statistics (BCEDice,
    augment none) from `variables`, float64 where `dtype` says so: then every
    BN layer runs as F.batch_norm in float64 (the port's BN layers take their
    statistics in float32) and the loss too; the model's float32 output cast
    is kept. `noise` > 0 adds to every conv's output Gaussian noise of that
    fraction of the output's rms (seeded)."""
    from pytorch_nested_unet_tpu_torch.data.augment import eval_transform
    from pytorch_nested_unet_tpu_torch.losses import _bce_elementwise, _soft_dice

    model = create_model(arch, 1, 3, False, **kw)
    model.load_state_dict(state_dict_from_jax(variables, arch), strict=True)
    model = model.to(dtype).train()
    if dtype == torch.float64:
        for bn in model.modules():
            if isinstance(bn, (BatchNorm, FusedBatchNormReLU)):
                def forward(x, bn=bn, relu=isinstance(bn, FusedBatchNormReLU)):
                    y = F.batch_norm(x.permute(0, 3, 1, 2), bn.running_mean, bn.running_var,
                                     bn.weight, bn.bias, True, 0.1, bn.eps).permute(0, 2, 3, 1)
                    return torch.relu(y) if relu else y
                bn.forward = forward
    if noise:
        gen = torch.Generator().manual_seed(0)
        for conv in model.modules():
            if isinstance(conv, (TorchConv, TorchConvTranspose)):
                conv.register_forward_hook(lambda _, args, y: y + noise * y.detach().pow(2).mean(
                    ).sqrt() * torch.randn(y.shape, generator=gen, dtype=y.dtype))
    x, m = eval_transform(torch.from_numpy(imgs), torch.from_numpy(masks))
    logits, m = model(x.to(dtype)).to(dtype), m.to(dtype)
    loss = 0.5 * _bce_elementwise(logits, m).mean() + 1.0 - _soft_dice(logits, m, 1e-5).mean()
    loss.backward()
    return ({n: p.grad.double() for n, p in model.named_parameters()},
            {n: b.double() for n, b in model.named_buffers()})


# f32 rounding of a conv's output, as a share of its rms: 2.1e-7 - 9.7e-7
# for the convs of these models on this CPU, forward and backward
CONV_ROUNDING = 1e-6


def f32_movement(arch, kw):
    """check_train_step_against_jax's `floor`: how far f32 rounding moves the
    port's step, the larger of two readings: its distance from the same step
    in float64, and how far it moves when every conv output moves by
    CONV_ROUNDING of its rms (another f32 implementation's convs round
    otherwise). Per parameter, relative to the larger of the reference
    gradient's norm and its module's weight gradient norm; per running
    statistic, elementwise."""
    def floor(variables, imgs, masks):
        g32, s32 = _step_gradients(arch, kw, variables, imgs, masks, torch.float32)
        readings = [_step_gradients(arch, kw, variables, imgs, masks, torch.float64),
                    _step_gradients(arch, kw, variables, imgs, masks, torch.float32,
                                    CONV_ROUNDING)]

        def rel(n, ref):
            return float((g32[n] - ref[n]).norm() / max(
                ref[n].norm(), ref.get(n.rsplit(".", 1)[0] + ".weight", ref[n]).norm()))

        grads = {n: max(rel(n, ref) for ref, _ in readings) for n in g32}
        stats = {n: torch.stack([(s - ref[n]).abs() for _, ref in readings]).amax(0).float()
                 for n, s in s32.items()}
        return {"grads": grads, "stats": stats}
    return floor


@pytest.mark.parametrize("arch,kw", [("VGG16RNN", {}), ("ResNet18RNN", {"decoder": "GRU"}),
                                     ("ResNet50UNet", {})])
def test_train_step_matches_jax(arch, kw):
    """One f32 train step from the same variables on the same batch: loss,
    every gradient and the running stats (VGG16RNN: its 18 BN layers on the
    K1-K3 path; ResNet18RNN: plain BN in the trunk and 5 score blocks on
    K1-K3; ResNet50UNet: the trunk's 53 plain BN layers and the transposed
    convs), at the tolerances of `check_train_step_against_jax`.

    The port's convs run torch's direct CPU convolution here, not oneDNN's:
    oneDNN's f32 convs round 2-3x coarser (5.7e-7 against 2.1e-7 of the
    output's norm for a 3x3 conv over 128 channels at 8x8), and in
    ResNet18RNN that is enough to flip the ReLU of one BN output in
    layer2.0.bn1 that lies that close to 0: one element of its 16,384 moves
    its gradient by 3e-3. With the direct convolution the port's and the
    JAX package's f32 steps of ResNet18RNN are both within 1.2e-5 of the
    same step in float64 (the JAX side is pinned to exact f32 matmuls by
    tests/conftest.py). At full width a ReLU input can also sit within f32
    rounding of 0 for every implementation: in ResNet50UNet one of the
    131,072 inputs of up_concat1's first ReLU lies 6.7e-7 from 0, and that
    one flip moves the decoder's and the trunk's f32 gradients by 1.5e-2
    from float64 in either package. So each gradient is held to 1e-4 or to
    4x how far f32 rounding moves the port's own gradient (`f32_movement`),
    whichever is larger; likewise the running statistics, where a BN over 8
    values (layer4.0.downsample.1, mean^2 / var up to 49) moves the f32
    running variance by 3e-5 of itself."""
    with torch.backends.mkldnn.flags(enabled=False):
        check_train_step_against_jax(arch, floor=f32_movement(arch, kw), **kw)
