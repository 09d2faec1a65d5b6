"""The port's UNet against the JAX package's, weights carried across.

A narrow UNet (nb_filter (4, 8, 16, 32, 64), 32x32, batch 2) with JAX
variables drawn from a numpy seed, exported by `state_dict_from_jax` and
loaded strict: the eval forward in f32 within atol = rtol = 1e-4, with the
JAX side on its plain path and on its Pallas decoder-fusion kernel (interpret
mode); one train step against `jax.value_and_grad`; the full-width parameter
count and key layout.
"""

import numpy as np
import torch

from pytorch_nested_unet_tpu.models import create_model as jax_create_model
from pytorch_nested_unet_tpu.ops import decoder_fusion as jdf
from pytorch_nested_unet_tpu.utils.torch_convert import converters_for_arch
from pytorch_nested_unet_tpu_torch.models import create_model
from pytorch_nested_unet_tpu_torch.models.blocks import MultipartConv3x3
from pytorch_nested_unet_tpu_torch.ops import decoder_fusion as tdf
from pytorch_nested_unet_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_crdn import check_train_step_against_jax, compare_eval, jax_variables, make_pair

NARROW = (4, 8, 16, 32, 64)


def test_eval_forward_matches_jax():
    compare_eval(*make_pair("UNet", nb_filter=NARROW))


def test_eval_forward_matches_jax_pallas_decoder_fusion():
    jm, variables, tm, x = make_pair("UNet", seed=1, nb_filter=NARROW)
    jdf.enable_decoder_fusion(True, interpret=True)
    try:
        compare_eval(jm, variables, tm, x)
    finally:
        jdf.enable_decoder_fusion(False)


def test_decoder_nodes_are_multipart():
    """The 4 decoder nodes hand their first conv the (skip, up(x)) parts:
    (32, 64) @ 96, (64, 128) @ 48, (128, 256) @ 24, (256, 512) @ 12 at full
    width, the shapes of NestedUNet's x0_1, x1_1, x2_1 and x3_1."""
    m = create_model("UNet")
    multipart = {n: tuple(mod.weight.shape[:2]) for n, mod in m.named_modules()
                 if isinstance(mod, MultipartConv3x3)}
    assert multipart == {"conv3_1.conv1": (256, 768), "conv2_2.conv1": (128, 384),
                         "conv1_3.conv1": (64, 192), "conv0_4.conv1": (32, 96)}


def test_train_step_matches_jax():
    check_train_step_against_jax("UNet", nb_filter=NARROW)
    assert tdf.LAUNCHES == 0


def test_full_width_parameter_count():
    m = create_model("UNet")
    assert sum(p.numel() for p in m.parameters()) == 7_852_545  # PARITY.md:23
    assert all(p.dtype == torch.float32 for p in m.parameters())


def test_state_dict_from_jax_equals_jax_export():
    jm = jax_create_model("UNet", 1, 3, False, nb_filter=NARROW)
    variables = jax_variables(jm, (1, 32, 32, 3), 0)
    ref = converters_for_arch("UNet")[1](variables)
    sd = state_dict_from_jax(variables, "UNet")
    assert sorted(sd) == sorted(ref) == sorted(create_model("UNet", nb_filter=NARROW).state_dict())
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)


def test_bf16_forward_keeps_f32_params_and_head():
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 16, 16, 3))
                         .astype(np.float32))
    bf16 = create_model("UNet", nb_filter=NARROW, dtype=torch.bfloat16).eval()
    f32 = create_model("UNet", nb_filter=NARROW).eval()
    with torch.inference_mode():
        a, b = f32(x), bf16(x)
    assert b.dtype == torch.float32 and all(p.dtype == torch.float32 for p in bf16.parameters())
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=0.1)
