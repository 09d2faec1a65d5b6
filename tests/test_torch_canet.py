"""The port's CA-Net (Comprehensive_Atten_Unet), its blocks and the
multi-head attention block against the JAX package's, weights carried
across.

Narrow CA-Net (feature_scale 16: filters 4..64) at 32x32, batch 2, and each
block at small odd sizes, JAX variables drawn from a numpy seed (BN scales,
statistics and biases off their init values, the non-local W BN's scale
nonzero, conv and linear biases nonzero), exported by `state_dict_from_jax`
and loaded strict: every block in eval and train mode within 1e-5, the
running statistics of both flax-semantics BNs (biased variance, flax's
momenta) after one train forward within 1e-6, the whole net with 1 class
(the logit) and 2 (the softmax) in eval within atol = rtol = 1e-4, one
train step with drop_rate 0 against `jax.value_and_grad`, the full-width
parameter counts and the key layout; MultiHeadAttention2D in its three
layer types.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_nested_unet_tpu.models import canet as jcanet
from pytorch_nested_unet_tpu.models import create_model as jax_create_model
from pytorch_nested_unet_tpu.models import nonlocal_attention as jnl
from pytorch_nested_unet_tpu.utils.torch_convert import converters_for_arch
from pytorch_nested_unet_tpu_torch.models import canet as tcanet
from pytorch_nested_unet_tpu_torch.models import create_model
from pytorch_nested_unet_tpu_torch.models import nonlocal_attention as tnl
from pytorch_nested_unet_tpu_torch.ops.init import init_convs_
from pytorch_nested_unet_tpu_torch.ops.layers import FlaxBatchNorm
from pytorch_nested_unet_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_attention_unet import compare_block, compare_stats, load_block
from test_torch_crdn import check_train_step_against_jax, compare_eval, jax_variables, make_pair

ARCH = "Comprehensive_Atten_Unet"
FS = 16


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in shapes)


def _check_block(jm, tm, scope, inputs, seed, has_train=True):
    variables = jax_variables(jm, tuple(a.shape for a in inputs), seed)
    prefix = load_block(tm, variables, ARCH, scope)
    stats = compare_block(jm, variables, tm, inputs, has_train=has_train)
    if stats:
        compare_stats(tm, stats, ARCH, scope, prefix)
    return tm


@pytest.mark.parametrize("mode,sf", [("concatenation", (1, 1)),
                                     ("concatenation_debug", (1, 1)),
                                     ("concatenation_residual", (1, 1)),
                                     ("concatenation", (2, 2))])
def test_grid_attention_block_matches_jax(mode, sf):
    """Both outputs (the gated, transformed x and the gate map) of each mode,
    the gating signal at half x's size (bilinear, align_corners False)."""
    x, g = _inputs(1, (2, 8, 6, 6), (2, 4, 3, 10))
    _check_block(jcanet.GridAttentionBlock2D(5, mode, sf),
                 tcanet.GridAttentionBlock2D(6, 10, 5, mode, sf),
                 ("attentionblock3", "gate_block_1"), (x, g), 2)


def test_multi_attention_block_matches_jax():
    x, g = _inputs(3, (2, 8, 6, 6), (2, 4, 3, 10))
    _check_block(jcanet.MultiAttentionBlock(5), tcanet.MultiAttentionBlock(6, 10, 5),
                 ("attentionblock2",), (x, g), 4)


@pytest.mark.parametrize("mode", ["embedded_gaussian", "dot_product"])
def test_nonlocal_block_matches_jax(mode):
    """Both modes, 2x2 max-pooled g and phi over an odd size (floor), and the
    flax-semantics W BN: momentum 0.1 in torch's convention, the biased
    running variance (compared after the train forward by _check_block).
    The input has a standard deviation of 3: at 1 the attention is nearly
    flat, W's output nearly constant over the positions (mean^2 / var 198),
    and the BN's variance E[x^2] - E[x]^2 (flax's, in both packages)
    cancels to 1.3e-4 of the output between summation orders; at 3 the
    ratio is 20."""
    (x,) = _inputs(5, (2, 7, 6, 16))
    x = 3 * x
    tm = _check_block(jcanet.NonLocalBlock2D(4, mode), tcanet.NonLocalBlock2D(16, 4, mode),
                      ("nonlocal4_2",), (x,), 6)
    assert isinstance(tm.W[1], FlaxBatchNorm) and tm.W[1].momentum == 0.1


def test_nonlocal_block_starts_as_identity():
    """W's BN scale starts at 0 (reference archs.py:329-330): a fresh block
    returns its input in eval and in train mode."""
    tm = tcanet.NonLocalBlock2D(16, 4)
    init_convs_(tm, torch.Generator().manual_seed(0))
    x = torch.randn(2, 6, 6, 16)
    assert torch.equal(tm.W[1].weight, torch.zeros(16))
    for train in (False, True):
        assert torch.allclose(tm.train(train)(x), x, atol=0, rtol=0)


@pytest.mark.parametrize("is_deconv", [True, False])
def test_upcat_pads_an_odd_skip_by_edge_replication(is_deconv):
    """A 2x upsample of 3x4 against a 7x9 skip: the last row and column are
    copies of their neighbours (edge replication), after the skip."""
    skip, down = _inputs(7, (2, 7, 9, 3), (2, 3, 4, 5))
    tm = _check_block(jcanet.UpCat(4, is_deconv), tcanet.UpCat(5, 4, is_deconv),
                      ("up_concat3",), (skip, down), 8)
    out = tm(torch.from_numpy(skip), torch.from_numpy(down))
    assert out.shape == (2, 7, 9, 3 + (4 if is_deconv else 5))
    up = out[..., 3:]
    assert torch.equal(up[:, 6], up[:, 5]) and torch.equal(up[:, :, 8], up[:, :, 7])
    assert torch.equal(out[..., :3], torch.from_numpy(skip))


def test_se_conv_block_matches_jax():
    """With the 1x1 downchannel residual, as every CA-Net SE block has
    (inplanes = 2 * planes): both outputs (the block's and the summed
    channel gates)."""
    (x,) = _inputs(9, (2, 6, 5, 16))
    tm = _check_block(jcanet.SEConvBlock(8), tcanet.SEConvBlock(16, 8), ("up3",), (x,), 10)
    assert tm.downchannel is not None


def test_se_conv_block_without_downchannel_fails_in_both_packages():
    """Without the downchannel (inplanes == planes) the identity residual has
    `planes` channels against the block's 2 * planes, in the reference
    (archs.py:598-712), the JAX package and the port alike: no CA-Net block
    is built so, and neither package can run one (ROADMAP.md queue 3)."""
    (x,) = _inputs(9, (2, 6, 5, 8))
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax.eval_shape(jcanet.SEConvBlock(8).init, jax.random.PRNGKey(0), jnp.asarray(x))
    tm = tcanet.SEConvBlock(8, 8)
    assert tm.downchannel is None
    with pytest.raises(RuntimeError, match="size of tensor"):
        tm(torch.from_numpy(x))


def test_se_conv_block_gradient_spreads_max_ties_like_jax():
    """On a constant input the interior positions of every map tie for the
    global max; the input gradient (eval mode) equals JAX's, whose
    reduce_max spreads a tie's gradient evenly, as `amax` does (`max(dim)`
    would send it all to one position)."""
    x = np.ones((2, 6, 5, 16), np.float32)
    jm, tm = jcanet.SEConvBlock(8), tcanet.SEConvBlock(16, 8)
    variables = jax_variables(jm, x.shape, 20)
    load_block(tm, variables, ARCH, ("up3",))
    ref = jax.grad(lambda v: jm.apply(variables, v)[0].sum())(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    tm.eval()(xt)[0].sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_channel_gate_matches_jax():
    """The 4-scale mean gate: both outputs; the gate is constant over each
    scale's channels."""
    (x,) = _inputs(11, (2, 5, 6, 16))
    tm = _check_block(jcanet.ChannelGate(4), tcanet.ChannelGate(16),
                      ("scale_att", "channel_gate"), (x,), 12, has_train=False)
    _, scale = tm(torch.from_numpy(x))
    groups = scale.reshape(2, 4, 4)
    assert torch.equal(groups, groups[:, :, :1].expand_as(groups))


def test_spatial_atten_matches_jax():
    """Its conv1 BN is flax's (momentum 0.99 in flax's convention, 0.01 in
    torch's; biased running variance), compared after the train forward."""
    (x,) = _inputs(13, (2, 6, 5, 16))
    tm = _check_block(jcanet.SpatialAtten(4), tcanet.SpatialAtten(16, 4),
                      ("scale_att", "spatial_gate"), (x,), 14)
    assert isinstance(tm.conv1.bn, FlaxBatchNorm) and tm.conv1.bn.momentum == 0.01


def test_flax_batch_norm_running_stats_match_flax():
    """FlaxBatchNorm against flax's own nn.BatchNorm at both momenta, on an
    input with a large mean: the output in train and eval mode, and the
    running statistics (the biased variance) within 1e-6."""
    import flax.linen as fnn

    (x,) = _inputs(15, (3, 5, 4, 6))
    x = x * 0.3 + 2.0
    for flax_m in (0.9, 0.99):
        jm = fnn.BatchNorm(momentum=flax_m, epsilon=1e-5, dtype=jnp.float32)
        v = jax.tree_util.tree_map(np.asarray, dict(jm.init(jax.random.PRNGKey(0), x,
                                                             use_running_average=False)))
        rng = np.random.default_rng(16)
        v = {"params": {"scale": rng.uniform(0.5, 2, 6).astype(np.float32),
                        "bias": rng.normal(0, 0.1, 6).astype(np.float32)},
             "batch_stats": {"mean": rng.normal(0, 0.1, 6).astype(np.float32),
                             "var": rng.uniform(0.5, 2, 6).astype(np.float32)}}
        tm = FlaxBatchNorm(6, momentum=round(1 - flax_m, 2))
        tm.load_state_dict({"weight": torch.from_numpy(v["params"]["scale"]),
                            "bias": torch.from_numpy(v["params"]["bias"]),
                            "running_mean": torch.from_numpy(v["batch_stats"]["mean"]),
                            "running_var": torch.from_numpy(v["batch_stats"]["var"])})
        ref, mut = jm.apply(v, x, use_running_average=False, mutable=["batch_stats"])
        out = tm.train()(torch.from_numpy(x))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(tm.running_mean.numpy(), mut["batch_stats"]["mean"], atol=1e-6)
        np.testing.assert_allclose(tm.running_var.numpy(), mut["batch_stats"]["var"], atol=1e-6)
        biased = x.reshape(-1, 6).var(axis=0)
        np.testing.assert_allclose(tm.running_var.numpy(), flax_m * v["batch_stats"]["var"]
                                   + (1 - flax_m) * biased, atol=1e-6)
        ref = jm.apply({"params": v["params"], "batch_stats": mut["batch_stats"]}, x,
                       use_running_average=True)
        np.testing.assert_allclose(tm.eval()(torch.from_numpy(x)).detach().numpy(),
                                   np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_scale_atten_conv_block_matches_jax():
    (x,) = _inputs(17, (2, 6, 5, 16))
    _check_block(jcanet.ScaleAttenConvBlock(4), tcanet.ScaleAttenConvBlock(16, 4),
                 ("scale_att",), (x,), 18)


@pytest.mark.parametrize("num_classes,kw", [
    (1, {}), (2, {}), (1, {"nonlocal_mode": "concatenation_residual"}),
    (1, {"nonlocal_mode": "concatenation_debug", "attention_dsample": (2, 2)}),
    (1, {"is_deconv": False})])
def test_eval_forward_matches_jax(num_classes, kw):
    """1 class: the float32 logit; 2: the float32 softmax over the classes."""
    jm, variables, tm, x = make_pair(ARCH, num_classes=num_classes, feature_scale=FS, **kw)
    compare_eval(jm, variables, tm, x)
    if num_classes > 1:
        with torch.inference_mode():
            s = tm(torch.from_numpy(x)).sum(-1)
        torch.testing.assert_close(s, torch.ones_like(s))


def test_train_step_matches_jax():
    """One f32 train step with drop_rate 0 (no dropout on either side), its
    two flax-semantics BNs and 33 plain BNs in train mode, the port's convs
    on torch's direct CPU convolution (test_torch_attention_unet.py)."""
    with torch.backends.mkldnn.flags(enabled=False):
        check_train_step_against_jax(ARCH, feature_scale=FS, drop_rate=0.0)


def test_dropout_runs_in_train_mode_only():
    """With drop_rate 0.5, conv4, center and up4 drop channels in train
    mode only, the same channels from the same seed."""
    def build():
        return create_model(ARCH, 1, 3, False, feature_scale=FS,
                            generator=torch.Generator().manual_seed(3))

    x = torch.from_numpy(_inputs(19, (2, 32, 32, 3))[0])
    a, b = build(), build()
    assert a.conv4.dropout.p == a.center.dropout.p == a.up4.dropout.p == 0.5
    assert a.up3.dropout is None
    with torch.no_grad():
        assert torch.equal(a.eval()(x), b.eval()(x))
        ya, yb = a.train()(x), b.train()(x)
        assert torch.equal(ya, yb)
        assert not torch.allclose(ya, a.train()(x))


@pytest.mark.parametrize("num_classes,count", [(1, 2_785_605), (2, 2_785_610)])
def test_full_width_parameter_count(num_classes, count):
    m = create_model(ARCH, num_classes)
    assert sum(p.numel() for p in m.parameters()) == count
    shapes = jax.eval_shape(lambda: jax_create_model(ARCH, num_classes).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    assert sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes["params"])) \
        == count


@pytest.mark.parametrize("kw", [{}, {"is_deconv": False}])
def test_state_dict_from_jax_equals_jax_export(kw):
    jm = jax_create_model(ARCH, 1, 3, False, feature_scale=FS, **kw)
    variables = jax_variables(jm, (1, 32, 32, 3), 0)
    ref = converters_for_arch(ARCH)[1](variables)
    sd = state_dict_from_jax(variables, ARCH)
    assert sorted(sd) == sorted(ref) == sorted(
        create_model(ARCH, 1, 3, False, feature_scale=FS, **kw).state_dict())
    for k, v in ref.items():
        assert sd[k].dtype == torch.float32 and tuple(sd[k].shape) == v.shape, k
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    for k in ("nonlocal4_2.W.1.running_var", "up4.fc1.weight",
              "scale_att.cbam.SpatialGate.conv1.bn.weight", "final.0.bias"):
        assert k in sd, k
    assert ("up_concat4.up.weight" in sd) == kw.get("is_deconv", True)


@pytest.mark.parametrize("layer_type,hw", [("SAME", (6, 5)), ("DOWN", (6, 5)),
                                           ("UP", (4, 3))])
def test_multi_head_attention_2d_matches_jax(layer_type, hw):
    """SAME, DOWN (3x3 stride 2) and UP (3x3 stride-2 transposed, output
    padding 1: twice the input's size) in eval mode, and the alias."""
    (x,) = _inputs(21, (2, *hw, 6))
    jm = jnl.MultiHeadAttention2D(8, 6, 5, num_heads=2, layer_type=layer_type)
    tm = tnl.multi_head_attention_2d(6, 8, 6, 5, num_heads=2, layer_type=layer_type)
    variables = jax_variables(jm, x.shape, 22)
    tm.load_state_dict(state_dict_from_jax(variables, "NestedUNet"), strict=True)
    ref = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.inference_mode():
        out = tm.eval()(torch.from_numpy(x))
    scale = {"SAME": 1, "DOWN": 0.5, "UP": 2}[layer_type]
    assert out.shape == (2, int(np.ceil(hw[0] * scale)), int(np.ceil(hw[1] * scale)), 5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    for bad in ({"key_filters": 7}, {"value_filters": 5}, {"layer_type": "LEFT"}):
        with pytest.raises(ValueError):
            tnl.MultiHeadAttention2D(6, **{"key_filters": 8, "value_filters": 6, **bad})
