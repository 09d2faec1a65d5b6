"""The port's weight carriers against the JAX package's own converter."""

import jax
import numpy as np
import pytest
import torch

from pytorch_nested_unet_tpu.models import create_model as jax_create_model
from pytorch_nested_unet_tpu.utils.torch_convert import converters_for_arch
from pytorch_nested_unet_tpu_torch.models import create_model
from pytorch_nested_unet_tpu_torch.utils.convert import load_reference_pth, state_dict_from_jax

NARROW = (4, 8, 16, 32, 64)


def _jax_variables(ds):
    jm = jax_create_model("NestedUNet", 1, 3, ds, nb_filter=NARROW)
    return jax.device_get(jm.init(jax.random.PRNGKey(0), np.zeros((1, 16, 16, 3), np.float32)))


@pytest.mark.parametrize("ds", [False, True])
def test_state_dict_from_jax_equals_jax_export(ds):
    variables = _jax_variables(ds)
    ref = converters_for_arch("NestedUNet")[1](variables)
    sd = state_dict_from_jax(variables)
    assert sorted(sd) == sorted(ref)
    for k, v in ref.items():
        assert sd[k].dtype == torch.float32 and tuple(sd[k].shape) == v.shape, k
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    # and it is exactly the port's key set, so strict loading works
    assert sorted(sd) == sorted(create_model("NestedUNet", 1, 3, ds, nb_filter=NARROW)
                                .state_dict())


def test_state_dict_from_jax_rejects_unknown_leaf():
    with pytest.raises(KeyError, match="unrecognized"):
        state_dict_from_jax({"params": {"x": {"gamma": np.zeros(1)}}})


def test_load_reference_pth_round_trip(tmp_path):
    model = create_model("NestedUNet", 1, 3, True, nb_filter=NARROW,
                         generator=torch.Generator().manual_seed(7))
    sd = model.state_dict()
    # the reference trainer saves a DataParallel model with BN counters
    saved = {"module." + k: v for k, v in sd.items()}
    saved["module.conv0_0.bn1.num_batches_tracked"] = torch.tensor(5)
    path = tmp_path / "model.pth"
    torch.save(saved, path)
    loaded = load_reference_pth(path)
    assert sorted(loaded) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(loaded[k], v), k
    fresh = create_model("NestedUNet", 1, 3, True, nb_filter=NARROW)
    fresh.load_state_dict(loaded, strict=True)
