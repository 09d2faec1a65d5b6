"""The port's NestedUNet against the JAX package's, weights carried across.

A narrow NestedUNet (nb_filter (4,8,16,32,64), 32x32, batch 2) is initialized
in JAX with non-trivial BN running statistics, its variables go through
`state_dict_from_jax` and load strict into the port, and every head of the eval
forward is compared in f32 within atol = rtol = 1e-4 (ten nested convs of
summation-order differences).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_nested_unet_tpu.models import create_model as jax_create_model
from pytorch_nested_unet_tpu.ops import decoder_fusion as jdf
from pytorch_nested_unet_tpu_torch.models import create_model
from pytorch_nested_unet_tpu_torch.utils.convert import state_dict_from_jax

NARROW = (4, 8, 16, 32, 64)


def _randomize_stats(variables, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        name = path[-1].key
        if name == "mean":
            return jnp.asarray(rng.standard_normal(v.shape) * 0.1, v.dtype)
        if name == "var":
            return jnp.asarray(rng.uniform(0.5, 2.0, v.shape), v.dtype)
        return v

    return {"params": variables["params"],
            "batch_stats": jax.tree_util.tree_map_with_path(leaf, variables["batch_stats"])}


def _pair(ds, seed=0):
    jm = jax_create_model("NestedUNet", 1, 3, ds, nb_filter=NARROW)
    x = np.random.default_rng(seed).standard_normal((2, 32, 32, 3)).astype(np.float32)
    variables = _randomize_stats(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x)), seed)
    tm = create_model("NestedUNet", 1, 3, ds, nb_filter=NARROW)
    tm.load_state_dict(state_dict_from_jax(jax.device_get(variables)), strict=True)
    return jm, variables, tm.eval(), x


def _compare(jm, variables, tm, x):
    ref = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.inference_mode():
        out = tm(torch.from_numpy(x))
    refs = ref if isinstance(ref, (list, tuple)) else [ref]
    outs = out if isinstance(out, (list, tuple)) else [out]
    assert len(outs) == len(refs)
    for o, r in zip(outs, refs):
        assert o.dtype == torch.float32 and o.shape == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("ds", [False, True])
def test_heads_match_jax(ds):
    _compare(*_pair(ds))


def test_heads_match_jax_with_pallas_decoder_fusion():
    jm, variables, tm, x = _pair(True, seed=1)
    jdf.enable_decoder_fusion(True, interpret=True)
    try:
        _compare(jm, variables, tm, x)
    finally:
        jdf.enable_decoder_fusion(False)


@pytest.mark.parametrize("ds,count", [(False, 9_163_329), (True, 9_163_428)])
def test_full_width_parameter_count(ds, count):
    m = create_model("NestedUNet", 1, 3, ds)
    assert sum(p.numel() for p in m.parameters()) == count
    assert all(p.dtype == torch.float32 for p in m.parameters())


def test_bf16_forward_keeps_f32_params_and_heads():
    m = create_model("NestedUNet", 1, 3, True, nb_filter=NARROW,
                     dtype=torch.bfloat16).eval()
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 16, 16, 3))
                         .astype(np.float32))
    f32_model = create_model("NestedUNet", 1, 3, True, nb_filter=NARROW).eval()
    with torch.inference_mode():
        f32, heads = f32_model(x), m(x)
    assert len(heads) == 4 and all(h.dtype == torch.float32 for h in heads)
    assert all(p.dtype == torch.float32 for p in m.parameters())
    # same seed-0 init: bf16 drifts from f32 by rounding only
    np.testing.assert_allclose(heads[-1].numpy(), f32[-1].numpy(), atol=0.1)


def test_same_seed_same_weights_and_unknown_arch():
    a = create_model("NestedUNet", generator=torch.Generator().manual_seed(3))
    b = create_model("NestedUNet", generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(a.state_dict()[k], v) for k, v in b.state_dict().items())
    with pytest.raises(KeyError, match="ROADMAP"):
        create_model("DoubleUnet")
