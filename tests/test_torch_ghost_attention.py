"""The port's UNetRNNGhost and UNetRNN attention variants against the JAX
package's, weights carried across.

Narrow models (feature_scale 16, 32x32, batch 2), JAX variables drawn from a
numpy seed (attention gammas nonzero), exported by `state_dict_from_jax` and
loaded strict: the eval forward in f32 within atol = rtol = 1e-4, on the exact
PAM and on the rank-1 grid PAM (`fast_pam`, compared with the JAX package's
own grid PAM); one train step of Ghost (its plain BatchNorms in train
mode); the full-width parameter counts and key layouts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_nested_unet_tpu.models import create_model as jax_create_model
from pytorch_nested_unet_tpu.models import dual_attention as jda
from pytorch_nested_unet_tpu.models import ghost as jghost
from pytorch_nested_unet_tpu.utils.torch_convert import converters_for_arch
from pytorch_nested_unet_tpu_torch.models import create_model
from pytorch_nested_unet_tpu_torch.models import dual_attention as tda
from pytorch_nested_unet_tpu_torch.models import ghost as tghost
from pytorch_nested_unet_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_crdn import FS, check_train_step_against_jax, compare_eval, jax_variables, make_pair

ATTENTION = ("UNetRNNPAttention", "UNetRNNCAttention", "UNetRNNAttention")


@pytest.mark.parametrize("arch,kw", [
    ("UNetRNNGhost", {}), ("UNetRNNGhost", {"decoder": "GRU"}),
    ("UNetRNNPAttention", {}), ("UNetRNNCAttention", {}), ("UNetRNNAttention", {}),
    ("UNetRNNPAttention", {"fast_pam": True}),
    ("UNetRNNAttention", {"fast_pam": True, "pam_grid": 64}),
])
def test_eval_forward_matches_jax(arch, kw):
    compare_eval(*make_pair(arch, feature_scale=FS, **kw))


def test_ghost_bottleneck_with_squeeze_excite_matches_jax():
    """GhostBottleneck with SE (not on UNetRNNGhost's path) and with an
    identity shortcut, eval and train, under a score block's key layout."""
    x = np.random.default_rng(1).standard_normal((2, 6, 5, 8)).astype(np.float32)
    for out_chs, se in ((3, 0.25), (8, 0.25), (8, 0.0)):
        jm = jghost.GhostBottleneck(mid_chs=12, out_chs=out_chs, se_ratio=se)
        variables = jax_variables(jm, x.shape, 2)
        sd = state_dict_from_jax({c: {"score_block1": variables[c]} for c in variables},
                                 "UNetRNNGhost")
        tm = tghost.GhostBottleneck(8, 12, out_chs, se_ratio=se)
        tm.load_state_dict({k[len("score_block1.0."):]: v for k, v in sd.items()}, strict=True)
        assert (tm.se is not None) == bool(se) and len(tm.shortcut) == (0 if out_chs == 8 else 4)
        ref = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, x))
        with torch.inference_mode():
            out = tm.eval()(torch.from_numpy(x))
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)
        ref, _ = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))(
            variables, x)
        out = tm.train()(torch.from_numpy(x))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_ghost_helpers():
    for v, d in ((8 * 0.25, 4), (37, 8), (3, 4), (100, 16)):
        assert tghost._make_divisible(v, d) == jghost._make_divisible(v, d)
    x = np.linspace(-5, 5, 41, dtype=np.float32)
    np.testing.assert_allclose(tghost.hard_sigmoid(torch.from_numpy(x)).numpy(),
                               np.asarray(jghost.hard_sigmoid(jnp.asarray(x))), atol=1e-7)


@pytest.mark.parametrize("grid", [16, 256])
def test_rank1_attention_interp_matches_jax(grid):
    rng = np.random.default_rng(3)
    t, k = (rng.standard_normal((2, 50)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((2, 50, 3)).astype(np.float32)
    ref = np.asarray(jda._rank1_attention_interp(jnp.asarray(t), jnp.asarray(k),
                                                  jnp.asarray(v), grid))
    out = tda._rank1_attention_interp(torch.from_numpy(t), torch.from_numpy(k),
                                      torch.from_numpy(v), grid)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_ghost_train_step_matches_jax():
    check_train_step_against_jax("UNetRNNGhost", feature_scale=FS)


@pytest.mark.parametrize("arch,count", [("UNetRNNGhost", 1_210_482),
                                        ("UNetRNNCAttention", 1_193_229),
                                        ("UNetRNNPAttention", None),
                                        ("UNetRNNAttention", None)])
def test_full_width_parameter_count(arch, count):
    """Ghost and CAttention at the reference's counts less its dead RDC gates
    (tests/test_model_zoo.py); every variant at the JAX package's count."""
    n = sum(p.numel() for p in create_model(arch).parameters())
    shapes = jax.eval_shape(lambda: jax_create_model(arch).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    assert n == sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes["params"]))
    if count is not None:
        assert n == count


@pytest.mark.parametrize("arch", ("UNetRNNGhost",) + ATTENTION)
def test_state_dict_from_jax_equals_jax_export(arch):
    jm = jax_create_model(arch, 1, 3, False, feature_scale=FS)
    variables = jax_variables(jm, (1, 32, 32, 3), 0)
    ref = converters_for_arch(arch)[1](variables)
    sd = state_dict_from_jax(variables, arch)
    assert sorted(sd) == sorted(ref) == sorted(
        create_model(arch, 1, 3, False, feature_scale=FS).state_dict())
    for k, v in ref.items():
        assert tuple(sd[k].shape) == v.shape, k
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
