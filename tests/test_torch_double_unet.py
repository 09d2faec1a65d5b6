"""The port's DoubleUnet against the JAX package's, weights carried across.

DoubleUnet has no width option: every model is full width (layers (1, 1, 1,
1) or the default (2, 2, 2, 2), 2 iterations), at 32x32 and 64x64 (inputs
must be multiples of 32), batch 2. JAX variables are drawn from a numpy seed
over the JAX model's abstract init (`test_torch_crdn.jax_variables`; the
1-D `iteration_weights` from N(0, 1)), carried by `state_dict_from_jax`
(its own keys: no reference layout exists) and loaded strict into the port.
Eval forwards are compared in f32 within atol = rtol = 1e-4, the running
statistics after one train forward within 1e-5, and one train step's
gradients as `test_torch_crdn.check_train_step_against_jax` holds them, with
a floor for how far f32 rounding alone moves the step (`f32_movement`).
Torch runs on 2 intra-op threads (the suite runs several workers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_nested_unet_tpu.models import create_model as jax_create_model
from pytorch_nested_unet_tpu.models import double_unet as jdu
from pytorch_nested_unet_tpu_torch.models import create_model
from pytorch_nested_unet_tpu_torch.models.double_unet import UnetBlock
from pytorch_nested_unet_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_crdn import check_train_step_against_jax, fill_variables, jax_variables
from test_torch_crdn_backbones_training import f32_movement

SMALL = {"layers": (1, 1, 1, 1)}
# full-width counts of the JAX package's init (jax.eval_shape, 1 class, 3 channels in)
PARAMS, BUFFERS = 45_951_616, 21_632


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(ds=False, hw=32, b=2, seed=0, **kw):
    jm = jax_create_model("DoubleUnet", 1, 3, ds, **kw)
    x = np.random.default_rng(seed).standard_normal((b, hw, hw, 3)).astype(np.float32)
    variables = jax_variables(jm, x.shape, seed)
    tm = create_model("DoubleUnet", 1, 3, ds, **kw)
    tm.load_state_dict(state_dict_from_jax(variables, "DoubleUnet"), strict=True)
    return jm, variables, tm, x


def _heads(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _compare_eval(jm, variables, tm, x):
    ref = _heads(jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, x))
    with torch.inference_mode():
        out = _heads(tm.eval()(torch.from_numpy(x)))
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        assert o.dtype == torch.float32 and o.shape == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("upsample", [False, True])
def test_unet_block_matches_jax(upsample):
    """UnetBlock eval and train (bilinear x2 with align_corners=False on an
    odd 5x7 map), and its running statistics after the train forward."""
    x = np.random.default_rng(1).standard_normal((2, 5, 7, 6)).astype(np.float32)
    jm = jdu.UnetBlock(4, upsample=upsample)
    variables = fill_variables(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                              jnp.zeros(x.shape)), 1)
    tm = UnetBlock(6, 4, upsample)
    tm.load_state_dict(state_dict_from_jax(variables, "DoubleUnet"), strict=True)
    want = jm.apply(variables, x, train=False)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 10 if upsample else 5, 14 if upsample else 7, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    want, stats = jm.apply(variables, x, train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got = tm.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    want_stats = state_dict_from_jax({"params": {}, **stats}, "DoubleUnet")
    for name, b in tm.named_buffers():
        np.testing.assert_allclose(b.numpy(), want_stats[name].numpy(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("hw,kw", [(32, SMALL), (64, {})])
def test_eval_forward_matches_jax(hw, kw):
    _compare_eval(*_pair(hw=hw, **kw))


@pytest.mark.parametrize("ds", [False, True])
def test_weighted_sum_and_deep_supervision_match_jax(ds):
    """weighted_sum: the softmax of `iteration_weights` combines the rounds;
    with deep_supervision the rounds plus the combination (3 heads), else
    the combination; without weighted_sum, deep_supervision gives the 2
    rounds."""
    jm, variables, tm, x = _pair(ds, weighted_sum=True, iterations=2, **SMALL)
    assert tm.iteration_weights.shape == (2,)
    _compare_eval(jm, variables, tm, x)
    with torch.inference_mode():
        assert len(_heads(tm(torch.from_numpy(x)))) == (3 if ds else 1)
        plain = create_model("DoubleUnet", 1, 3, ds, **SMALL).eval()
        assert len(_heads(plain(torch.from_numpy(x)))) == (2 if ds else 1)


@pytest.mark.parametrize("b,hw", [(2, 64), (1, 32)])
def test_train_forward_running_stats_match_jax(b, hw):
    """One train-mode forward: the output within 1e-4 and every running
    statistic within 1e-5. At batch 1, 32x32, the deepest BU group, the
    middle and TD group 3 work on 1x1 maps, so their BNs see one value per
    channel: the port computes them as the JAX package does. (At batch 2,
    32x32, those BNs see 2 values per channel: a channel whose two values lie
    within ~sqrt(eps) of each other magnifies a rounding difference up to
    ~1 / sqrt(eps) = 316-fold, so the comparison runs at 64x64, 8 values.)"""
    jm, variables, tm, x = _pair(b=b, hw=hw, **SMALL)
    want, stats = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))(
        variables, x)
    with torch.no_grad():
        got = tm.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    want_stats = state_dict_from_jax({"params": {}, **stats}, "DoubleUnet")
    bufs = dict(tm.named_buffers())
    assert sorted(bufs) == sorted(want_stats)
    for name, v in want_stats.items():
        np.testing.assert_allclose(bufs[name].numpy(), v.numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=name)


def test_train_step_matches_jax():
    """One f32 train step at layers (1, 1, 1, 1), 64x64, batch 2, oneDNN off:
    loss, metrics, every gradient and running statistic (the UnetBlocks'
    BN-fed conv biases at 0)."""
    with torch.backends.mkldnn.flags(enabled=False):
        check_train_step_against_jax("DoubleUnet", hw=64,
                                     floor=f32_movement("DoubleUnet", SMALL), **SMALL)


def test_parameter_counts_and_keys():
    """Full width: 45,951,616 parameters (+2 with weighted_sum) and 21,632
    running-statistic values, as the JAX package counts them; the keys are
    the JAX paths (plain BN's inner `bn` scope dropped)."""
    m = create_model("DoubleUnet")
    assert sum(p.numel() for p in m.parameters()) == PARAMS
    assert sum(b.numel() for b in m.buffers()) == BUFFERS
    ws = create_model("DoubleUnet", weighted_sum=True)
    assert sum(p.numel() for p in ws.parameters()) == PARAMS + 2
    assert torch.equal(ws.iteration_weights.detach(), torch.ones(2))
    keys = set(m.state_dict())
    assert {"bu0_block0.downsample_bn.running_var", "td3_block1.conv2.weight",
            "middle0.bn.weight", "fe_bn1.running_mean", "td_head1.weight"} <= keys
    jm = jax_create_model("DoubleUnet", 1, 3, False, **SMALL)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    small = create_model("DoubleUnet", **SMALL)
    assert sum(p.numel() for p in small.parameters()) == sum(
        int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes["params"]))


def test_fit_model_pth_serves_through_predictor(tmp_path):
    """`fit` trains DoubleUnet with deep supervision (the loss averaged over
    both rounds; `remat` given and ignored: DoubleUnet has no such option)
    and writes model.pth under the port's own keys; a Predictor on it gives
    the trained model's last-round probabilities."""
    from pytorch_nested_unet_tpu_torch.data.augment import eval_transform
    from pytorch_nested_unet_tpu_torch.infer import Predictor
    from pytorch_nested_unet_tpu_torch.train import fit

    rng = np.random.default_rng(8)
    x = rng.integers(0, 256, (6, 32, 32, 3), dtype=np.uint8)
    y = (rng.random((6, 32, 32, 1)) > 0.5).astype(np.uint8) * 255
    r = fit(x[:4], y[:4], x[4:], y[4:], output_dir=str(tmp_path), epochs=1, batch_size=2,
            arch="DoubleUnet", deep_supervision=True, precision="fp32", augment="none",
            device="cpu", arch_kwargs={"layers": [1, 1, 1, 1]}, remat="policy")
    assert np.isfinite(r["log"]["loss"]).all()
    pth = tmp_path / "run" / "model.pth"
    assert set(torch.load(pth, weights_only=True)) == set(r["model"].state_dict())
    pred = Predictor("DoubleUnet", deep_supervision=True, batch_size=2, weights=str(pth),
                     device="cpu", arch_kwargs={"layers": [1, 1, 1, 1]})
    probs = pred.predict_u8(x[4:])
    model = r["model"].eval()
    model.load_state_dict(torch.load(pth, weights_only=True))
    with torch.no_grad():
        want = torch.sigmoid(model(eval_transform(torch.from_numpy(x[4:]))[0])[-1])
    assert probs.shape == (2, 32, 32, 1)
    np.testing.assert_allclose(probs, want.numpy(), atol=1e-6, rtol=0)
