"""The port's CRDN backbones (VGG16RNN, ResNet{18,34,50,101,152}RNN,
ResNet50UNet, ResNet50FCN) and their ops against the JAX package's, weights
carried across.

The backbones have no width option, so every model is full width, at 32x32
(ResNet50FCN at 48x48 and 50x50: its valid 3x3 classifier conv needs down5
of 3x3 or more), batch 2. JAX variables are drawn from a numpy seed over
the JAX model's abstract init (`test_torch_crdn.jax_variables`), exported
by `state_dict_from_jax` and loaded strict into the port; the eval forward
is compared in f32 within atol = rtol = 1e-4. ResNet101/152RNN are compared
by their parameter shapes only (their JAX init traces 33 and 50 blocks).
The train steps are in test_torch_crdn_backbones_training.py. The ops
`max_pool_3x3_s2_p1`, `resize_nearest` and `TorchConvTranspose` are held
against the JAX ops at odd sizes, and the channel dropout by its form.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_nested_unet_tpu.models import create_model as jax_create_model
from pytorch_nested_unet_tpu.ops import layers as jlayers
from pytorch_nested_unet_tpu.ops.pool import max_pool_3x3_s2_p1 as jax_pool
from pytorch_nested_unet_tpu.ops.resize import resize_nearest as jax_resize_nearest
from pytorch_nested_unet_tpu.utils.torch_convert import converters_for_arch
from pytorch_nested_unet_tpu_torch.infer import Predictor
from pytorch_nested_unet_tpu_torch.models import create_model, parse_arch_kwargs
from pytorch_nested_unet_tpu_torch.models.rdc import GATES
from pytorch_nested_unet_tpu_torch.ops.fused_bn import FusedBatchNormReLU
from pytorch_nested_unet_tpu_torch.ops.init import init_convs_
from pytorch_nested_unet_tpu_torch.ops.layers import ChannelDropout, TorchConvTranspose
from pytorch_nested_unet_tpu_torch.ops.pool import max_pool_3x3_s2_p1
from pytorch_nested_unet_tpu_torch.ops.resize import resize_nearest
from pytorch_nested_unet_tpu_torch.utils.convert import load_reference_pth, state_dict_from_jax
from test_torch_crdn import compare_eval, jax_variables, make_pair

# full-width parameter counts (jax.eval_shape of the JAX package's init, 1
# class, 3 channels in)
COUNTS = {"VGG16RNN": 14_760_027, "ResNet18RNN": 11_185_819, "ResNet34RNN": 21_293_979,
          "ResNet50RNN": 23_543_259, "ResNet101RNN": 42_535_387,
          "ResNet152RNN": 58_179_035, "ResNet50UNet": 71_858_753,
          "ResNet50FCN": 115_813_253}


def jax_param_count(arch, hw=32, **kw):
    shapes = jax.eval_shape(lambda: jax_create_model(arch, 1, 3, False, **kw).init(
        jax.random.PRNGKey(0), jnp.zeros((1, hw, hw, 3))))
    return sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes["params"]))


@pytest.mark.parametrize("shape", [(2, 7, 9, 3), (1, 5, 6, 2), (2, 1, 4, 5), (1, 12, 12, 4)])
def test_max_pool_3x3_s2_p1_matches_jax(shape):
    """Odd and even sizes, inputs mostly negative (the padding never wins);
    the result NHWC-contiguous."""
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32) - 1.0
    got = max_pool_3x3_s2_p1(torch.from_numpy(x))
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_pool(jnp.asarray(x))))


@pytest.mark.parametrize("in_hw,out_hw", [
    ((4, 4), (12, 12)), ((12, 12), (24, 24)), ((24, 24), (48, 48)), ((48, 48), (96, 96)),
    ((2, 2), (7, 7)), ((7, 7), (13, 13)), ((13, 13), (25, 25)), ((25, 25), (50, 50)),
    ((3, 5), (7, 11)), ((9, 10), (4, 10)), ((1, 1), (3, 2))])
def test_resize_nearest_matches_jax(in_hw, out_hw):
    """The ratios ResNetFCN's pyramid gives at 96x96 (4 -> 12 -> ... -> 96)
    and at 50x50 (2 -> 7 -> 13 -> 25 -> 50), and others, index for index."""
    x = np.random.default_rng(2).standard_normal((2, *in_hw, 3)).astype(np.float32)
    got = resize_nearest(torch.from_numpy(x), out_hw)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_resize_nearest(jnp.asarray(x), out_hw)))


@pytest.mark.parametrize("hw,k,s,p,op", [((5, 7), 2, 2, 0, 0), ((5, 3), 3, 2, 1, 1),
                                         ((4, 5), 4, 3, 1, 0), ((3, 3), 3, 1, 1, 0)])
def test_conv_transpose_matches_jax(hw, k, s, p, op):
    """TorchConvTranspose against the JAX package's from the same weights
    (carried by `state_dict_from_jax`: flax's transpose kernel (kh, kw, out,
    in) -> torch's [in, out, kh, kw]), at odd sizes: the output is
    (in - 1) * s - 2p + k + op per axis. The port's init draws U(+-1 /
    sqrt(out * kh * kw)) for weight and bias, as torch does."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, *hw, 6)).astype(np.float32)
    jm = jlayers.TorchConvTranspose(5, k, stride=s, padding=p, output_padding=op)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = jax.tree_util.tree_map(
        lambda a: rng.uniform(-0.3, 0.3, a.shape).astype(np.float32), variables)
    ref = np.asarray(jm.apply(variables, jnp.asarray(x)))
    sd = state_dict_from_jax({"params": {"up": variables["params"]}})
    tm = TorchConvTranspose(6, 5, k, s, p, op)
    tm.load_state_dict({k_[len("up."):]: v for k_, v in sd.items()}, strict=True)
    got = tm(torch.from_numpy(x))
    want_hw = tuple((n - 1) * s - 2 * p + k + op for n in hw)
    assert tuple(got.shape) == (2, *want_hw, 5) == ref.shape
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-5, rtol=1e-5)

    fresh = TorchConvTranspose(6, 5, k, s, p, op)
    init_convs_(fresh, torch.Generator().manual_seed(0))
    bound = 1.0 / np.sqrt(5 * k * k)
    for t in (fresh.weight.detach(), fresh.bias.detach()):
        assert float(t.abs().max()) <= bound and float(t.abs().max()) > 0.8 * bound


def test_channel_dropout_form():
    """Whole (sample, channel) planes are zeroed, the survivors scaled by 2,
    about half dropped over many draws; the same seed drops the same
    channels; eval is the identity."""
    x = torch.rand(64, 5, 3, 256) + 0.5
    drop = ChannelDropout(0.5, torch.Generator().manual_seed(3))
    y = drop(x)
    zero = (y == 0).all(dim=(1, 2))
    kept = (y != 0).all(dim=(1, 2))
    assert bool((zero | kept).all())  # no partial plane
    torch.testing.assert_close(y.permute(0, 3, 1, 2)[kept], 2 * x.permute(0, 3, 1, 2)[kept])
    share = float(zero.float().mean())
    assert 0.47 < share < 0.53, share  # 16,384 draws: 3.8 sigma either side
    again = ChannelDropout(0.5, torch.Generator().manual_seed(3))(x)
    torch.testing.assert_close(again, y)
    assert not torch.equal(drop(x), y)  # the next draw differs
    assert drop.eval()(x) is x


@pytest.mark.parametrize("arch,kw", [
    ("VGG16RNN", {}), ("VGG16RNN", {"decoder": "GRU"}), ("ResNet18RNN", {}),
    ("ResNet34RNN", {}), ("ResNet50RNN", {}),
    ("ResNet50RNN", {"decoder": "vanilla", "layers": (1, 1, 1, 1), "use_bias": False}),
    ("ResNet50UNet", {}), ("ResNet50UNet", {"is_deconv": False, "layers": (1, 1, 1, 1)})])
def test_eval_forward_matches_jax(arch, kw):
    compare_eval(*make_pair(arch, hw=32, **kw))


@pytest.mark.parametrize("arch", [a for a in COUNTS if a != "ResNet50FCN"])
def test_full_width_parameter_count(arch):
    m = create_model(arch)
    assert sum(p.numel() for p in m.parameters()) == COUNTS[arch] == jax_param_count(arch)
    assert all(p.dtype == torch.float32 for p in m.parameters())


@pytest.mark.parametrize("arch,kw", [
    ("VGG16RNN", {}), ("ResNet18RNN", {"decoder": "GRU"}), ("ResNet50RNN", {}),
    ("ResNet101RNN", {}), ("ResNet152RNN", {}), ("ResNet50UNet", {})])
def test_state_dict_from_jax_equals_jax_export(arch, kw):
    """Key for key and value for value the JAX package's export, and the
    port model's own keys and shapes (ResNet101/152RNN: shapes only, no
    forward)."""
    jm = jax_create_model(arch, 1, 3, False, **kw)
    variables = jax_variables(jm, (1, 32, 32, 3), 0)
    ref = converters_for_arch(arch)[1](variables)
    sd = state_dict_from_jax(variables, arch)
    assert sorted(sd) == sorted(ref)
    for k, v in ref.items():
        assert sd[k].dtype == torch.float32 and tuple(sd[k].shape) == v.shape, k
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    port = create_model(arch, 1, 3, False, **kw).state_dict()
    assert {k: tuple(v.shape) for k, v in port.items()} == {
        k: tuple(v.shape) for k, v in sd.items()}


def test_resnet50fcn_matches_jax():
    """ResNet50FCN's one test (115.8 M parameters): its count, its keys
    against the JAX export, and its eval forward (no dropout) at 48x48
    (down5 3x3, the classifier 1x1) and 50x50 (the pyramid 2 -> 7 -> 13 ->
    25 -> 25 -> 50) from one set of weights."""
    jm = jax_create_model("ResNet50FCN", 1, 3, False)
    variables = jax_variables(jm, (2, 48, 48, 3), 0)
    sd = state_dict_from_jax(variables, "ResNet50FCN")
    assert sorted(sd) == sorted(converters_for_arch("ResNet50FCN")[1](variables))
    assert sum(v.numel() for k, v in sd.items() if not k.endswith(("running_mean",
                                                                  "running_var"))) \
        == COUNTS["ResNet50FCN"] == jax_param_count("ResNet50FCN", hw=48)
    tm = create_model("ResNet50FCN")
    assert sum(p.numel() for p in tm.parameters()) == COUNTS["ResNet50FCN"]
    tm.load_state_dict(sd, strict=True)
    del sd
    for hw, seed in ((48, 0), (50, 1)):
        x = np.random.default_rng(seed).standard_normal((2, hw, hw, 3)).astype(np.float32)
        compare_eval(jm, variables, tm.eval(), x)


def test_factory_arch_kwargs():
    """A preset's constructor options are those of its class, checked as
    for any arch: the decoder, block and layers may be set, others raise."""
    assert parse_arch_kwargs("ResNet50RNN", '{"decoder": "GRU"}') == {"decoder": "GRU"}
    assert parse_arch_kwargs("ResNet18RNN", {"layers": [1, 1, 1, 1]}) == {"layers": (1, 1, 1, 1)}
    with pytest.raises(ValueError, match="feature_scale"):
        parse_arch_kwargs("ResNet50RNN", '{"feature_scale": 4}')
    with pytest.raises(ValueError, match="layers"):
        parse_arch_kwargs("VGG16RNN", '{"layers": [1, 1, 1, 1]}')
    pred = Predictor("ResNet50RNN", device="cpu",
                     arch_kwargs={"decoder": "GRU", "layers": [1, 1, 1, 1]})
    assert pred.model.decoder == "GRU" and len(pred.model.layer3) == 1
    assert [n for n, _ in pred.model.RDC.named_children()] == list(GATES["GRU"])
    assert create_model("ResNet50RNN").decoder == "LSTM"


def _with_dead(sd, extra):
    saved = {"module." + k: v for k, v in {**sd, **extra}.items()}
    saved["module.bn1.num_batches_tracked"] = torch.tensor(3)
    return saved


@pytest.mark.parametrize("arch,kw,head", [
    ("VGG16RNN", {}, {"score.weight": (1, 512, 1, 1), "score.bias": (1,)}),
    ("ResNet18RNN", {"decoder": "GRU"}, {"fc.weight": (1000, 512), "fc.bias": (1000,)})])
def test_load_reference_pth_drops_the_dead_head_and_gates(tmp_path, arch, kw, head):
    """A reference model.pth (DataParallel prefixes, BN counters, all four
    RDC gates, the unused `score` conv or `fc` head) loads strict after
    exactly the dead head and the other decoders' gates are dropped."""
    model = create_model(arch, 1, 3, False, generator=torch.Generator().manual_seed(7), **kw)
    sd = model.state_dict()
    decoder = model.decoder
    dead = {k: torch.randn(s) for k, s in head.items()}
    for dec, gates in GATES.items():
        if dec != decoder:
            for name, mult in gates.items():
                dead[f"RDC.{name}.weight"] = torch.randn(mult, 2, 3, 3)
                dead[f"RDC.{name}.bias"] = torch.randn(mult)
    path = tmp_path / "model.pth"
    torch.save(_with_dead(sd, dead), path)
    dropped = set()
    loaded = load_reference_pth(path, arch, decoder, dropped)
    assert dropped == set(dead)
    assert sorted(loaded) == sorted(sd) and all(torch.equal(loaded[k], v) for k, v in sd.items())
    create_model(arch, 1, 3, False, **kw).load_state_dict(loaded, strict=True)


@pytest.mark.parametrize("arch", ["ResNet50UNet", "ResNet50FCN"])
def test_load_reference_pth_drops_fc_of_the_decoderless_resnets(tmp_path, arch):
    """ResNetUNet and ResNetFCN: `fc.*` goes, every other key stays (no RDC
    here, so an `RDC.`-looking key would be kept)."""
    keep = {"conv1.weight": torch.randn(2, 3, 1, 1), "layer1.0.bn1.running_var": torch.ones(2),
            "final.bias": torch.zeros(1), "classifier.5.weight": torch.ones(2),
            "score_pool4.weight": torch.randn(1, 2, 1, 1), "RDC.gru_conv.bias": torch.zeros(1)}
    dead = {"fc.weight": torch.randn(3, 2), "fc.bias": torch.zeros(3)}
    path = tmp_path / "model.pth"
    torch.save(_with_dead(keep, dead), path)
    dropped = set()
    assert sorted(load_reference_pth(path, arch, dropped=dropped)) == sorted(keep)
    assert dropped == set(dead)


def test_port_model_pth_loads_into_jax(tmp_path):
    """A port VGG16RNN model.pth, as `checkpoint.save_model` writes it, reads
    through the JAX package's converter into the JAX model's exact variable
    tree, and the JAX model serves what the port does."""
    from pytorch_nested_unet_tpu_torch.training.checkpoint import save_model

    model = create_model("VGG16RNN", generator=torch.Generator().manual_seed(2)).eval()
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():  # BN scales, biases and statistics off their init values
        for bn in model.modules():
            if isinstance(bn, FusedBatchNormReLU):
                for t in (bn.weight, bn.running_var):
                    t.uniform_(0.5, 2.0, generator=gen)
                for t in (bn.bias, bn.running_mean):
                    t.normal_(0.0, 0.1, generator=gen)
    save_model(str(tmp_path), model)
    sd = torch.load(tmp_path / "model.pth", weights_only=True)
    variables = converters_for_arch("VGG16RNN")[0](sd)
    jm = jax_create_model("VGG16RNN", 1, 3, False)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    assert jax.tree_util.tree_map(np.shape, variables) == \
        jax.tree_util.tree_map(lambda a: a.shape, dict(shapes))
    x = np.random.default_rng(5).standard_normal((2, 32, 32, 3)).astype(np.float32)
    compare_eval(jm, variables, model, x)
