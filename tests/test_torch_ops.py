"""The port's ops against the JAX package's, on the same numpy inputs (f32, CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_nested_unet_tpu.data import augment as jaug
from pytorch_nested_unet_tpu.ops import fused_bn as jbn
from pytorch_nested_unet_tpu.ops import layers as jlayers
from pytorch_nested_unet_tpu.ops import pool as jpool
from pytorch_nested_unet_tpu.ops import resize as jresize
from pytorch_nested_unet_tpu_torch.data import augment as taug
from pytorch_nested_unet_tpu_torch.ops import fused_bn as tbn
from pytorch_nested_unet_tpu_torch.ops import init as tinit
from pytorch_nested_unet_tpu_torch.ops import layers as tlayers
from pytorch_nested_unet_tpu_torch.ops import pool as tpool
from pytorch_nested_unet_tpu_torch.ops import resize as tresize


@pytest.mark.parametrize("hw", [(48, 48), (7, 5), (1, 3)])
def test_upsample2x(hw):
    x = np.random.default_rng(0).standard_normal((2, *hw, 3)).astype(np.float32)
    ref = np.asarray(jresize.upsample2x(jnp.asarray(x)))
    out = tresize.upsample2x(torch.from_numpy(x))
    assert out.is_contiguous() and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_resize_bilinear_identity_and_shrink():
    x = np.random.default_rng(1).standard_normal((1, 9, 6, 2)).astype(np.float32)
    t = torch.from_numpy(x)
    assert tresize.resize_bilinear(t, (9, 6)) is t
    ref = np.asarray(jresize.resize_bilinear(jnp.asarray(x), (4, 5)))
    np.testing.assert_allclose(tresize.resize_bilinear(t, (4, 5)).numpy(), ref,
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("hw", [(8, 8), (7, 9), (5, 4)])
def test_max_pool2x2_floor_mode(hw):
    x = np.random.default_rng(2).standard_normal((2, *hw, 3)).astype(np.float32)
    ref = np.asarray(jpool.max_pool2x2(jnp.asarray(x)))
    out = tpool.max_pool2x2(torch.from_numpy(x))
    assert out.shape == (2, hw[0] // 2, hw[1] // 2, 3) and out.is_contiguous()
    np.testing.assert_array_equal(out.numpy(), ref)


def test_eval_transform():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    mask = rng.integers(0, 256, (2, 8, 8, 1), dtype=np.uint8)
    ri, rm = jaug.eval_transform(jnp.asarray(img), jnp.asarray(mask))
    ti, tm = taug.eval_transform(torch.from_numpy(img), torch.from_numpy(mask))
    np.testing.assert_allclose(ti.numpy(), np.asarray(ri), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tm.numpy(), np.asarray(rm), atol=1e-6, rtol=1e-6)
    assert taug.eval_transform(torch.from_numpy(img))[1] is None


def _bn_inputs(c, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 5, 6, c)).astype(np.float32)
    stats = {"scale": rng.uniform(0.5, 1.5, c), "bias": rng.standard_normal(c),
             "mean": rng.standard_normal(c), "var": rng.uniform(0.2, 3.0, c)}
    return x, {k: v.astype(np.float32) for k, v in stats.items()}


@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_fused_bn_relu_eval(dtype):
    c = 6
    x, s = _bn_inputs(c)
    jdt, tdt = (None, None) if dtype is None else (jnp.bfloat16, torch.bfloat16)
    jm = jbn.FusedBatchNormReLU(dtype=jdt)
    variables = {"params": {"scale": jnp.asarray(s["scale"]), "bias": jnp.asarray(s["bias"])},
                 "batch_stats": {"mean": jnp.asarray(s["mean"]), "var": jnp.asarray(s["var"])}}
    ref = jm.apply(variables, jnp.asarray(x), use_running_average=True)
    tm = tbn.FusedBatchNormReLU(c, dtype=tdt).eval()
    tm.load_state_dict({"weight": torch.from_numpy(s["scale"]),
                        "bias": torch.from_numpy(s["bias"]),
                        "running_mean": torch.from_numpy(s["mean"]),
                        "running_var": torch.from_numpy(s["var"])})
    with torch.inference_mode():
        out = tm(torch.from_numpy(x))
    assert out.dtype == (tdt or torch.float32)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=1e-5, rtol=1e-5)


def test_fused_bn_relu_train_mode_raises():
    """Train mode normalizes with the batch statistics (K1-K3; their plain
    versions on the CPU) and updates the running stats; it raises on an input
    whose channel count is not the module's."""
    m = tbn.FusedBatchNormReLU(4).train()
    x = torch.arange(16.0).reshape(1, 2, 2, 4)
    y = m(x)
    mean, var = x.reshape(-1, 4).mean(0), x.reshape(-1, 4).var(0, unbiased=False)
    torch.testing.assert_close(y, torch.relu((x - mean) / torch.sqrt(var + 1e-5)))
    torch.testing.assert_close(m.running_mean, 0.1 * mean)
    torch.testing.assert_close(m.running_var, 0.9 + 0.1 * var * 4 / 3)
    with pytest.raises(RuntimeError):
        m(torch.zeros(1, 2, 2, 3))


@pytest.mark.parametrize("k,pad", [(3, 1), (1, 0)])
def test_torch_conv(k, pad):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 6, 4)).astype(np.float32)
    jm = jlayers.TorchConv(5, k, padding=pad)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = np.asarray(jm.apply(variables, jnp.asarray(x)))
    tm = tlayers.TorchConv(4, 5, k, padding=pad)
    kern = np.asarray(variables["params"]["conv"]["kernel"])
    tm.load_state_dict({"weight": torch.from_numpy(kern.transpose(3, 2, 0, 1).copy()),
                        "bias": torch.from_numpy(np.array(variables["params"]["conv"]["bias"]))})
    with torch.inference_mode():
        out = tm(torch.from_numpy(x))
    assert out.is_contiguous()
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_conv_init_bounds_and_seed():
    def draw(seed):
        w, b = torch.empty(8, 4, 3, 3), torch.empty(8)
        tinit.torch_conv_init_(w, b, torch.Generator().manual_seed(seed))
        return w, b

    w, b = draw(0)
    bound = 1.0 / np.sqrt(4 * 9)
    assert w.abs().max() <= bound and b.abs().max() <= bound
    assert w.std() > bound / 3  # uniform, not collapsed
    assert torch.equal(draw(0)[0], w) and not torch.equal(draw(1)[0], w)


def _load_conv(tm, variables):
    conv = variables["params"]["conv"]
    sd = {"weight": torch.from_numpy(np.asarray(conv["kernel"]).transpose(3, 2, 0, 1).copy())}
    if "bias" in conv:
        sd["bias"] = torch.from_numpy(np.array(conv["bias"]))
    tm.load_state_dict(sd, strict=True)
    return tm


@pytest.mark.parametrize("k,stride,pad,dil,groups,bias", [
    (3, 2, 1, 1, 1, True), (3, 1, 2, 2, 1, True), (3, 1, 1, 1, 4, False),
    (5, 2, 2, 1, 2, False), (1, 1, 0, 1, 1, False)])
def test_torch_conv_stride_dilation_groups_bias(k, stride, pad, dil, groups, bias):
    """TorchConv's full signature against the JAX module's; a grouped conv's
    fan-in (its init bound) is in/groups * k * k, as the JAX package's."""
    x = np.random.default_rng(6).standard_normal((2, 9, 8, 4)).astype(np.float32)
    jm = jlayers.TorchConv(8, k, stride=stride, padding=pad, dilation=dil, groups=groups,
                           use_bias=bias)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    ref = np.asarray(jm.apply(variables, jnp.asarray(x)))
    tm = tlayers.TorchConv(4, 8, k, pad, stride=stride, dilation=dil, groups=groups,
                           use_bias=bias)
    assert tuple(tm.weight.shape) == (8, 4 // groups, k, k) and (tm.bias is None) != bias
    assert sorted(tm.state_dict()) == sorted(["weight", "bias"] if bias else ["weight"])
    tinit.init_convs_(tm, torch.Generator().manual_seed(0))
    assert tm.weight.abs().max() <= 1.0 / np.sqrt(4 // groups * k * k)
    _load_conv(tm, variables)
    with torch.inference_mode():
        out = tm(torch.from_numpy(x))
    assert out.is_contiguous() and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_shift_conv_is_the_jax_shift_conv():
    """The JAX package's ShiftConv (conv_impl 'shift') is the port's TorchConv."""
    from pytorch_nested_unet_tpu.ops import small_conv as jsc

    x = np.random.default_rng(7).standard_normal((2, 6, 7, 2)).astype(np.float32)
    for bias in (True, False):
        jm = jsc.ShiftConv(4, 3, padding=1, use_bias=bias)
        variables = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))
        tm = _load_conv(tlayers.TorchConv(2, 4, 3, 1, use_bias=bias), variables)
        with torch.inference_mode():
            out = tm(torch.from_numpy(x))
        np.testing.assert_allclose(out.numpy(), np.asarray(jm.apply(variables, jnp.asarray(x))),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_batch_norm_eval_and_train(dtype):
    """The plain BatchNorm (no ReLU): eval with the running stats; train with
    the batch stats, f32 statistics whatever the compute dtype, and the
    running stats updated with momentum 0.1 and the unbiased variance."""
    c = 5
    x, s = _bn_inputs(c, seed=8)
    jdt, tdt = (None, None) if dtype is None else (jnp.bfloat16, torch.bfloat16)
    xin = jnp.asarray(x, jdt or jnp.float32)
    jm = jlayers.BatchNorm(dtype=jdt)
    variables = {"params": {"bn": {"scale": jnp.asarray(s["scale"]),
                                   "bias": jnp.asarray(s["bias"])}},
                 "batch_stats": {"bn": {"mean": jnp.asarray(s["mean"]),
                                        "var": jnp.asarray(s["var"])}}}
    tm = tlayers.BatchNorm(c, dtype=tdt)
    tm.load_state_dict({"weight": torch.from_numpy(s["scale"]), "bias": torch.from_numpy(s["bias"]),
                        "running_mean": torch.from_numpy(s["mean"]),
                        "running_var": torch.from_numpy(s["var"])}, strict=True)
    tol = 1e-5 if dtype is None else 1e-2
    tx = torch.from_numpy(np.array(xin.astype(jnp.float32))).to(tdt or torch.float32)
    ref = jm.apply(variables, xin, use_running_average=True)
    with torch.inference_mode():
        out = tm.eval()(tx)
    assert out.dtype == (tdt or torch.float32) and out.is_contiguous()
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=tol, rtol=tol)

    ref, mut = jm.apply(variables, xin, use_running_average=False, mutable=["batch_stats"])
    out = tm.train()(tx)
    np.testing.assert_allclose(out.float().detach().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)
    for k, leaf in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(tm, k).numpy(),
                                   np.asarray(mut["batch_stats"]["bn"][leaf]), atol=1e-5, rtol=1e-5)


def test_global_avg_pool():
    x = np.random.default_rng(9).standard_normal((2, 5, 7, 3)).astype(np.float32)
    for keep in (True, False):
        ref = np.asarray(jpool.global_avg_pool(jnp.asarray(x), keepdims=keep))
        out = tpool.global_avg_pool(torch.from_numpy(x), keepdims=keep)
        assert out.shape == ref.shape
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("src,dst", [((1, 1), (3, 3)), ((3, 3), (6, 6)), ((1, 1), (1, 1))])
def test_resize_bilinear_from_one_pixel(src, dst):
    """The CRDN carry at RM7's deepest levels (96 -> ... -> 3 -> 1 with floor
    pooling) is resized 1 -> 3 and 3 -> 6 with align_corners."""
    x = np.random.default_rng(10).standard_normal((2, *src, 2)).astype(np.float32)
    ref = np.asarray(jresize.resize_bilinear(jnp.asarray(x), dst, align_corners=True))
    out = tresize.resize_bilinear(torch.from_numpy(x), dst, align_corners=True)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=1e-6)
