"""The port's DeepLab (dual-path ResNet + SAGate + DeepLabV3+ head) against the
JAX package's, weights carried across; and the plain BN's batch of one value
per channel.

DeepLab has no width option: the models are full width at layers (1, 1, 1,
1), 32x32, batch 2; the modules (FSP, SAGate, a dilated DualBottleneck,
ASPP, Head) at their full widths on small maps. JAX variables are drawn from
a numpy seed over the JAX module's abstract init (`test_torch_crdn.
fill_variables`), carried by `state_dict_from_jax` (its own keys: no
reference layout exists) and loaded strict into the port. Eval forwards are
compared in f32 within atol = rtol = 1e-4, the running statistics after one
train forward within 1e-5, and one train step's gradients as
`test_torch_crdn.check_train_step_against_jax` holds them, with a floor for
how far f32 rounding alone moves the step (`f32_movement`). Train mode
drops 10% of two activations: for the train-mode comparisons the port's two
Dropout modules are built with p = 0 and flax's Dropout is the identity
inside the test (monkeypatch; nothing in the JAX package changes). Torch
runs on 2 intra-op threads.
"""

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_nested_unet_tpu.models import create_model as jax_create_model
from pytorch_nested_unet_tpu.models import dual_deeplab as jdl
from pytorch_nested_unet_tpu.ops import layers as jlayers
from pytorch_nested_unet_tpu_torch.models import create_model
from pytorch_nested_unet_tpu_torch.models import dual_deeplab as tdl
from pytorch_nested_unet_tpu_torch.ops.layers import BatchNorm, Dropout
from pytorch_nested_unet_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_crdn import check_train_step_against_jax, fill_variables
from test_torch_crdn_backbones_training import f32_movement

SMALL = {"layers": (1, 1, 1, 1)}
# full-width counts of the JAX package's init (jax.eval_shape, 1 class, 3 channels in)
PARAMS, BUFFERS = 115_727_530, 216_672


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_dropout(monkeypatch):
    """The port's DeepLab built with p = 0 dropouts, flax's Dropout the
    identity."""
    monkeypatch.setattr(tdl, "Dropout", lambda p, generator=None: Dropout(0.0, generator))
    monkeypatch.setattr(flax_nn.Dropout, "__call__", lambda self, x, *a, **k: x)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _carry(jm, tm, args, seed=0, **init_kw):
    """Fill the JAX module's variables from `seed` over its abstract init on
    `args`, load them strict into `tm`; returns the variables."""
    variables = fill_variables(jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args,
                                              **init_kw), seed)
    tm.load_state_dict(state_dict_from_jax(variables, "DeepLab"), strict=True)
    return variables


def _close(got, want, tol=1e-4):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", [(1, 1, 1, 5), (1, 1, 1, 256)])
def test_batchnorm_one_value_per_channel_matches_jax(shape):
    """Train mode on one value per channel (N*H*W = 1: ASPP's pooled branch
    at batch 1, a 1x1 map at batch 1), which F.batch_norm refuses: the
    output, running_mean and running_var as the JAX package's `_TorchBN`
    computes them (the output is the bias; the running variance moves
    towards 0), each within 1e-7."""
    c = shape[-1]
    rng = np.random.default_rng(5)
    x = rng.standard_normal(shape).astype(np.float32)
    params = {"scale": rng.uniform(0.5, 2, c), "bias": rng.standard_normal(c)}
    stats = {"mean": rng.standard_normal(c) * 0.1, "var": rng.uniform(0.5, 2, c)}
    variables = {"params": {"bn": {k: v.astype(np.float32) for k, v in params.items()}},
                 "batch_stats": {"bn": {k: v.astype(np.float32) for k, v in stats.items()}}}
    want, mut = jlayers.BatchNorm().apply(variables, x, use_running_average=False,
                                          mutable=["batch_stats"])
    bn = BatchNorm(c)
    bn.load_state_dict({k[len("bn."):]: v for k, v in state_dict_from_jax(variables).items()})
    got = bn.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-7, rtol=0)
    np.testing.assert_allclose(got.detach().numpy().reshape(-1), params["bias"], atol=1e-7)
    for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(bn, ours).numpy(),
                                   np.asarray(mut["batch_stats"]["bn"][theirs]),
                                   atol=1e-7, rtol=0, err_msg=ours)
    got.sum().backward()  # differentiable: the bias takes the gradient
    assert torch.equal(bn.bias.grad, torch.ones(c))


def test_fsp_and_sagate_match_jax():
    """FSP's raw Dense fc1 / fc2 ([in, out] kernels -> [out, in]) and the
    gate's softmax blend, eval: both SAGate outputs and the merge."""
    rgb, hha = _x((2, 5, 6, 64), 1), _x((2, 5, 6, 64), 2)
    jm, tm = jdl.FSP(64), tdl.FSP(64)
    variables = _carry(jm, tm, (rgb, hha))
    assert tm.fc1.weight.shape == (8, 128)  # max(1, 2C // 16) hidden units
    _close(tm(torch.from_numpy(rgb), torch.from_numpy(hha)), jm.apply(variables, rgb, hha))
    jm, tm = jdl.SAGate(64), tdl.SAGate(64)
    variables = _carry(jm, tm, ([rgb, hha],), seed=1)
    (want_rgb, want_hha), want_merge = jm.apply(variables, [rgb, hha])
    (got_rgb, got_hha), got_merge = tm([torch.from_numpy(rgb), torch.from_numpy(hha)])
    for got, want in ((got_rgb, want_rgb), (got_hha, want_hha), (got_merge, want_merge)):
        _close(got, want)


@pytest.mark.parametrize("stride,dilation,downsample", [(1, 4, True), (2, 1, True),
                                                        (1, 2, False)])
def test_dual_bottleneck_matches_jax(stride, dilation, downsample):
    """Both paths, eval and train (with the running statistics), dilated
    (padding = dilation) and strided."""
    cin = 64 if downsample else 128
    pair = [_x((2, 7, 6, cin), 3), _x((2, 7, 6, cin), 4)]
    jm = jdl.DualBottleneck(32, stride, dilation, downsample)
    tm = tdl.DualBottleneck(cin, 32, stride, dilation, downsample)
    variables = _carry(jm, tm, (pair,))
    tpair = [torch.from_numpy(p) for p in pair]
    with torch.no_grad():
        for got, want in zip(tm.eval()(tpair), jm.apply(variables, pair, train=False)):
            _close(got, want)
        want, mut = jm.apply(variables, pair, train=True, mutable=["batch_stats"])
        for got, w in zip(tm.train()(tpair), want):
            _close(got, w)
    stats = state_dict_from_jax({"params": {}, **mut}, "DeepLab")
    for name, b in tm.named_buffers():
        _close(b, stats[name], 1e-5)


def test_aspp_and_head_match_jax():
    """ASPP (dilations 6, 12, 18 on a 5x5 map, LeakyReLU, the pooled branch
    added by broadcast) and Head (ASPP, the low-level reduction, the
    align-corners upsample, the classifier and the auxiliary FCN head),
    eval."""
    x = _x((2, 5, 5, 2048), 5)
    jm, tm = jdl.ASPP(256, (6, 12, 18)), tdl.ASPP(2048, 256, (6, 12, 18))
    variables = _carry(jm, tm, (x,))
    with torch.no_grad():
        _close(tm.eval()(torch.from_numpy(x)), jm.apply(variables, x, train=False))
    merges = [_x((2, 10, 10, 256), 6), None, None, x]
    jm, tm = jdl.Head(1), tdl.Head(1)
    variables = _carry(jm, tm, (merges,), seed=2)
    with torch.no_grad():
        got = tm.eval()([None if m is None else torch.from_numpy(m) for m in merges])
    for g, w in zip(got, jm.apply(variables, merges, train=False)):
        _close(g, w)


def test_eval_forward_matches_jax():
    """DeepLab at layers (1, 1, 1, 1), 32x32: eval returns pred; with an
    explicit hha input too; deep_supervision returns [aux, pred]."""
    x, hha = _x((2, 32, 32, 3), 0), _x((2, 32, 32, 3), 7)
    jm = jax_create_model("DeepLab", 1, 3, True, **SMALL)
    tm = create_model("DeepLab", 1, 3, True, **SMALL).eval()
    variables = _carry(jm, tm, (x,))
    apply = jax.jit(lambda v, x, hha: jm.apply(v, x, hha, train=False))
    with torch.inference_mode():
        for h in (None, hha):
            got = tm(torch.from_numpy(x), None if h is None else torch.from_numpy(h))
            want = apply(variables, x, h)
            assert len(got) == len(want) == 2 and all(g.dtype == torch.float32 for g in got)
            for g, w in zip(got, want):
                _close(g, w)
        tm.deep_supervision = False
        assert tm(torch.from_numpy(x)).shape == (2, 32, 32, 1)


def test_train_forward_running_stats_match_jax(no_dropout):
    """One train-mode forward: every running statistic of the backbone and
    the head within 1e-5, and [aux, pred] within 1e-3 (in train mode ASPP's
    pooled BN normalizes 2 values per channel, which magnifies a rounding
    difference of its input up to 1 / sqrt(eps) = 316-fold where they lie
    close: here its output differs by 4e-4 of its largest value, 16 times
    its input's difference, and pred by 1.1e-4)."""
    x = _x((2, 32, 32, 3), 0)
    jm = jax_create_model("DeepLab", 1, 3, False, **SMALL)
    tm = create_model("DeepLab", 1, 3, False, **SMALL)
    variables = _carry(jm, tm, (x,))
    want, mut = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))(
        variables, x)
    with torch.no_grad():
        got = tm.train()(torch.from_numpy(x))
    stats = state_dict_from_jax({"params": {}, **mut}, "DeepLab")
    bufs = dict(tm.named_buffers())
    assert sorted(bufs) == sorted(stats)
    for name, v in stats.items():
        _close(bufs[name], v, 1e-5)
    assert len(got) == 2
    for g, w in zip(got, want):
        _close(g, w, 1e-3)


def test_train_step_matches_jax(no_dropout):
    """One f32 train step at layers (1, 1, 1, 1), 32x32, batch 2, oneDNN off:
    the loss averaged over [aux, pred], the metrics off pred, every gradient
    and running statistic."""
    with torch.backends.mkldnn.flags(enabled=False):
        check_train_step_against_jax("DeepLab", hw=32, floor=f32_movement("DeepLab", SMALL),
                                     **SMALL)


def test_dropout_drops_a_tenth_in_train_mode_only():
    """The head's and the auxiliary head's dropouts: element-wise, 10% of
    the elements zeroed and the rest scaled by 1 / 0.9 in train mode, the
    same seed the same mask, the identity in eval."""
    m = create_model("DeepLab", **SMALL, generator=torch.Generator().manual_seed(2))
    drops = [d for d in m.modules() if isinstance(d, Dropout)]
    assert len(drops) == 2 and all(d.p == 0.1 for d in drops)
    x = torch.rand(16, 12, 12, 256) + 0.5
    y = drops[0].train()(x)
    zero = y == 0
    torch.testing.assert_close(y[~zero], x[~zero] / 0.9)
    assert 0.095 < float(zero.float().mean()) < 0.105  # 589,824 draws: 8 sigma either side
    again = create_model("DeepLab", **SMALL, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close([d for d in again.modules() if isinstance(d, Dropout)][0]
                               .train()(x), y)
    assert drops[0].eval()(x) is x


def test_parameter_counts_and_dualpath_copy():
    """Full width: 115,727,530 parameters and 216,672 running-statistic
    values, as the JAX package counts them (at layers (1, 1, 1, 1) against
    its abstract init here); FSP's Dense weights start LeCun-normal with
    zero biases; `duplicate_dualpath_params` copies every `hha_` tensor
    whose rgb sibling exists from it, and leaves every other key alone."""
    m = create_model("DeepLab")
    assert sum(p.numel() for p in m.parameters()) == PARAMS
    assert sum(b.numel() for b in m.buffers()) == BUFFERS
    jm = jax_create_model("DeepLab", 1, 3, False, **SMALL)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    small = create_model("DeepLab", **SMALL)
    assert sum(p.numel() for p in small.parameters()) == sum(
        int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes["params"]))
    fc = m.backbone.sagate2.fsp_rgb.fc1
    assert fc.weight.shape == (128, 2048) and torch.equal(fc.bias, torch.zeros(128))
    std = float(fc.weight.std())
    assert abs(std - 2048 ** -0.5) < 0.02 * 2048 ** -0.5
    assert float(fc.weight.abs().max()) <= 2 * 2048 ** -0.5 / 0.87962566 + 1e-6

    gen = torch.Generator().manual_seed(0)
    sd = {k: torch.randn(v.shape, generator=gen) for k, v in small.state_dict().items()}
    out = tdl.duplicate_dualpath_params(sd)
    assert sorted(out) == sorted(sd)
    hha = [k for k in sd if ".hha_" in k]
    assert {"backbone.hha_stem.conv1_0.weight", "backbone.layer4_0.hha_conv2.weight",
            "backbone.layer1_0.hha_downsample_bn.running_var"} <= set(hha)
    for k, v in out.items():
        if k in hha:
            assert torch.equal(v, sd[k.replace(".hha_", ".", 1)]), k
        else:
            assert v is sd[k], k


def test_folder_cli_round_trip(tmp_path):
    """`train --arch DeepLab` (1 epoch on a 32x32 PNG folder, --remat given:
    DeepLab has no such option and ignores it, as the JAX CLI does) writes
    model.pth under the port's own keys; `val` and `infer` load the capsule
    and serve it as a Predictor built on the same weights does."""
    from pytorch_nested_unet_tpu_torch import infer as tinfer
    from pytorch_nested_unet_tpu_torch import train as ttrain
    from pytorch_nested_unet_tpu_torch import val as tval
    from pytorch_nested_unet_tpu_torch.data import image_io
    from pytorch_nested_unet_tpu_torch.infer import Predictor

    rng = np.random.default_rng(9)
    root = tmp_path / "inputs" / "synth"
    for d in ("images", "masks/0"):
        (root / d).mkdir(parents=True)
    for i in range(10):
        image_io.write_png(str(root / "images" / f"{i}.png"),
                           rng.integers(0, 256, (32, 32, 3), dtype=np.uint8))
        image_io.write_png(str(root / "masks" / "0" / f"{i}.png"),
                           (rng.random((32, 32)) > 0.5).astype(np.uint8) * 255)
    models = tmp_path / "models"
    ttrain.main(["--dataset", "synth", "--data_dir", str(tmp_path / "inputs"), "--output_dir",
                 str(models), "--arch", "DeepLab", "--arch_kwargs", '{"layers": [1, 1, 1, 1]}',
                 "--input_w", "32", "--input_h", "32", "-b", "2", "--epochs", "1",
                 "--precision", "fp32", "--remat", "full", "--device", "cpu"])
    run = models / "synth_DeepLab_woDS"
    sd = torch.load(run / "model.pth", weights_only=True)
    assert set(sd) == set(create_model("DeepLab", **SMALL).state_dict())
    assert "backbone.sagate0.fsp_rgb.fc1.weight" in sd and "head.aspp.map_conv3.weight" in sd

    iou = tval.main(["--name", run.name, "--data_dir", str(tmp_path / "inputs"),
                     "--output_dir", str(models), "--save_dir", str(tmp_path / "val"),
                     "-b", "2", "--out_ext", ".png", "--device", "cpu"])
    assert 0.0 <= iou <= 1.0
    assert len(list((tmp_path / "val" / run.name / "0").glob("*.png"))) == 2
    tinfer.main(["--name", run.name, "--input_dir", str(root / "images"), "--output_dir",
                 str(models), "--save_dir", str(tmp_path / "infer"), "-b", "4",
                 "--device", "cpu"])
    written = sorted((tmp_path / "infer" / run.name / "0").glob("*.png"))
    assert len(written) == 10
    pred = Predictor("DeepLab", batch_size=4, weights=str(run / "model.pth"), device="cpu",
                     arch_kwargs={"layers": [1, 1, 1, 1]})
    probs = pred.predict_u8(image_io.decode_batch([str(root / "images" / "0.png")],
                                                  (32, 32), 3)[0])
    got = image_io.load_image(str(tmp_path / "infer" / run.name / "0" / "0.png"), 1)
    np.testing.assert_allclose(got.reshape(32, 32), (probs[0, ..., 0] * 255).astype(np.uint8),
                               atol=1)
