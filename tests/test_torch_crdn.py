"""The port's CRDN family (UNetRNN, UNetRM3, UNetRM7) against the JAX package's,
weights carried across.

Narrow models (feature_scale 16: filters 4..64; RM3 4, 18, 32; RM7 2..128) at
32x32 (RM7 at 96x96, so the carry is resized 1 -> 3 and 3 -> 6 as at full
width), batch 2. Each gets JAX variables drawn from a numpy seed (BN
statistics and scales off their init values), exported by `state_dict_from_jax` and loaded strict into the port; the
eval forward is compared in f32 within atol = rtol = 1e-4. The key layout is
held against the JAX package's own exporter, and reference checkpoints with
the dead RDC gates load through `load_reference_pth`.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_nested_unet_tpu.models import create_model as jax_create_model
from pytorch_nested_unet_tpu.utils.torch_convert import converters_for_arch
from pytorch_nested_unet_tpu_torch.models import create_model
from pytorch_nested_unet_tpu_torch.models.rdc import GATES, RDC
from pytorch_nested_unet_tpu_torch.ops.layers import TorchConv
from pytorch_nested_unet_tpu_torch.utils.convert import (load_reference_pth,
                                                         state_dict_from_jax)

FS = 16


def jax_variables(jm, shape, seed):
    """The JAX model's variable tree from its abstract init (nothing is
    compiled), filled from a numpy seed: conv kernels U(+-1/sqrt(fan_in)),
    conv biases U(+-0.1), BN scales, biases and statistics off their init
    values, attention gammas nonzero (at their init of 0 attention is a
    no-op)."""
    tree = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros(shape, jnp.float32))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        names = [p.key for p in path]
        if names[-1] == "kernel":
            b = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
            v = rng.uniform(-b, b, s.shape)
        elif names[-1] == "bias" and names[-2] == "conv":
            v = rng.uniform(-0.1, 0.1, s.shape)
        elif names[-1] in ("var", "scale"):
            v = rng.uniform(0.5, 2.0, s.shape)
        elif names[-1] in ("mean", "bias"):
            v = rng.standard_normal(s.shape) * 0.1
        elif names[-1] == "gamma":
            v = rng.uniform(0.3, 0.8, s.shape)
        else:
            raise KeyError(names)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, dict(tree))


def make_pair(arch, hw=32, seed=0, num_classes=1, **kw):
    """(JAX model, its variables, the port model loaded strict from them in
    eval mode, a (2, hw, hw, 3) input)."""
    jm = jax_create_model(arch, num_classes, 3, False, **kw)
    x = np.random.default_rng(seed).standard_normal((2, hw, hw, 3)).astype(np.float32)
    variables = jax_variables(jm, x.shape, seed)
    tm = create_model(arch, num_classes, 3, False, **kw)
    tm.load_state_dict(state_dict_from_jax(variables, arch), strict=True)
    return jm, variables, tm.eval(), x


def compare_eval(jm, variables, tm, x, tol=1e-4):
    ref = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, x))
    with torch.inference_mode():
        out = tm(torch.from_numpy(x))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=tol, rtol=tol)


@pytest.mark.parametrize("arch,hw,kw", [
    ("UNetRNN", 32, {}),
    ("UNetRNN", 32, {"decoder": "LSTM"}),
    ("UNetRNN", 32, {"decoder": "vanilla"}),
    ("UNetRNN", 32, {"conv_impl": "shift"}),
    ("UNetRNN", 32, {"conv_impl": "mxu", "decoder": "LSTM"}),
    ("UNetRNN", 32, {"num_classes": 2}),
    ("UNetRNN", 32, {"use_bias": False, "kernel_size": 5}),
    ("UNetRM3", 32, {}),
    ("UNetRM7", 96, {}),
])
def test_eval_forward_matches_jax(arch, hw, kw):
    kw = dict(kw)
    nc = kw.pop("num_classes", 1)
    compare_eval(*make_pair(arch, hw=hw, num_classes=nc, feature_scale=FS, **kw))


@pytest.mark.parametrize("decoder", ["GRU", "LSTM", "vanilla"])
@pytest.mark.parametrize("conv_impl,hidden", [("auto", 1), ("auto", 4), ("mxu", 1),
                                              ("shift", 4)])
def test_rdc_builds_the_jax_gates(decoder, conv_impl, hidden):
    """Only the chosen decoder's gates, each a TorchConv whatever conv_impl
    (the JAX package's ShiftConv, chosen by 'shift' or by 'auto' with in * out
    channels <= 64, is the same conv); an unknown conv_impl raises."""
    cell = RDC(hidden, decoder=decoder, conv_impl=conv_impl)
    names = [n for n, _ in cell.named_children()]
    assert names == list(GATES[decoder])
    for name, mult in GATES[decoder].items():
        conv = getattr(cell, name)
        assert isinstance(conv, TorchConv)
        assert tuple(conv.weight.shape) == (mult * hidden, 2 * hidden, 3, 3)
    with pytest.raises(NotImplementedError):
        RDC(1, decoder="LSTM2")
    with pytest.raises(NotImplementedError):
        RDC(1, conv_impl="winograd")


@pytest.mark.parametrize("arch,count,hw", [("UNetRNN", 1_193_224, 32),
                                           ("UNetRM3", 296_922, 32),
                                           ("UNetRM7", 4_749_806, 64)])
def test_full_width_parameter_count(arch, count, hw):
    """The reference's counts less its dead RDC gates (tests/test_model_zoo.py),
    equal to the JAX package's."""
    m = create_model(arch)
    assert sum(p.numel() for p in m.parameters()) == count
    assert all(p.dtype == torch.float32 for p in m.parameters())
    shapes = jax.eval_shape(lambda: jax_create_model(arch).init(
        jax.random.PRNGKey(0), jnp.zeros((1, hw, hw, 3))))
    assert sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes["params"])) \
        == count


@pytest.mark.parametrize("arch,kw", [("UNetRNN", {}), ("UNetRNN", {"decoder": "LSTM"}),
                                     ("UNetRM3", {}), ("UNetRM7", {})])
def test_state_dict_from_jax_equals_jax_export(arch, kw):
    jm = jax_create_model(arch, 1, 3, False, feature_scale=FS, **kw)
    variables = jax_variables(jm, (1, 64, 64, 3), 0)
    ref = converters_for_arch(arch)[1](variables)
    sd = state_dict_from_jax(variables, arch)
    assert sorted(sd) == sorted(ref)
    for k, v in ref.items():
        assert sd[k].dtype == torch.float32 and tuple(sd[k].shape) == v.shape, k
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    port = create_model(arch, 1, 3, False, feature_scale=FS, **kw).state_dict()
    assert sorted(sd) == sorted(port)
    assert ("center.conv1.0.weight" in sd) == (arch == "UNetRNN")


def _dead_gate_tensors(decoder, hidden=1, k=3):
    """The gate convs the reference builds for the decoders other than
    `decoder` (reference finished/archs1.py:145-210)."""
    out = {}
    for dec, gates in GATES.items():
        if dec == decoder:
            continue
        for name, mult in gates.items():
            out[f"RDC.{name}.weight"] = torch.randn(mult * hidden, 2 * hidden, k, k)
            out[f"RDC.{name}.bias"] = torch.randn(mult * hidden)
    return out


@pytest.mark.parametrize("decoder,dead_params", [("GRU", 95), ("LSTM", 76), ("vanilla", 133)])
def test_load_reference_pth_drops_exactly_the_dead_gates(tmp_path, decoder, dead_params):
    """A reference-trained UNetRNN model.pth (DataParallel prefixes, BN
    counters, all four gate convs) loads strict after the other decoders'
    gates are dropped, and nothing else is."""
    model = create_model("UNetRNN", 1, 3, False, feature_scale=FS, decoder=decoder,
                         generator=torch.Generator().manual_seed(7))
    sd = model.state_dict()
    dead = _dead_gate_tensors(decoder)
    assert sum(v.numel() for k, v in dead.items()) == dead_params
    saved = {"module." + k: v for k, v in {**sd, **dead}.items()}
    saved["module.conv1.conv1.1.num_batches_tracked"] = torch.tensor(3)
    path = tmp_path / "model.pth"
    torch.save(saved, path)
    dropped = set()
    loaded = load_reference_pth(path, "UNetRNN", decoder=decoder, dropped=dropped)
    assert dropped == set(dead)
    assert sorted(loaded) == sorted(sd)
    assert all(torch.equal(loaded[k], v) for k, v in sd.items())
    create_model("UNetRNN", 1, 3, False, feature_scale=FS, decoder=decoder).load_state_dict(
        loaded, strict=True)
    # the same file read as another decoder's keeps that decoder's gates only
    other = {"GRU": "vanilla", "LSTM": "GRU", "vanilla": "LSTM"}[decoder]
    kept = load_reference_pth(path, "UNetRNN", decoder=other)
    assert {k.split(".")[1] for k in kept if k.startswith("RDC.")} == set(GATES[other])
    # NestedUNet-family checkpoints keep every key
    assert sorted(load_reference_pth(path)) == sorted({**sd, **dead})


def train_batch(seed, b=2, hw=32):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (b, hw, hw, 3), dtype=np.uint8)
    masks = (rng.random((b, hw, hw, 1)) > 0.6).astype(np.uint8) * 255
    return imgs, masks


# conv biases that feed a BN: UnetConv2's and VGGBlock's convs, score blocks,
# VGG16RNN's encoder units and the ResNet backbones' score blocks
_BN_FED_BIAS = re.compile(r"^(conv\d+|conv\d_\d|center)/conv[12]/conv/bias$|"
                          r"^(score_block\d|conv\d_score_block|conv_block\d_\d)/conv/conv/bias$")


def zero_bn_fed_biases(variables):
    """Every conv bias that feeds a BN set to 0. Train-mode BN subtracts the
    batch mean, so such a bias changes nothing in exact arithmetic; drawn at
    random it dominates the first conv's output on these inputs (mean^2 up to
    1,000 times var), and var = E[x^2] - mean^2 then turns the last bit of a
    BN sum into a 1e-3 change of var (bn_conditioning.py): the comparison
    would hold the port to the JAX package's summation order, not to the
    step."""
    def leaf(path, v):
        key = "/".join(p.key for p in path)
        return np.zeros_like(v) if _BN_FED_BIAS.match(key) else v

    return {"params": jax.tree_util.tree_map_with_path(leaf, variables["params"]),
            "batch_stats": variables["batch_stats"]}


def check_train_step_against_jax(arch, hw=32, seed=0, floor=None, **kw):
    """One f32 train step (BCEDice, SGD lr 1e-2, momentum 0.9, wd 1e-4,
    augment none) of the port against `jax.value_and_grad` of the JAX
    model's train-mode forward, from the same variables (the BN-fed conv
    biases at 0) on the same batch:
    the loss within 1e-5, IoU and accuracy within 5e-3 (pixels whose logit
    sits at 0 flip under rounding), every running statistic within atol =
    rtol = 1e-5 and every gradient within 1e-4 relative L2 norm of the
    larger of its own norm and its module's weight gradient norm (a conv
    bias that feeds a BN has a true gradient of 0, so both sides compute
    rounding noise for it), plus 1e-7 of the largest gradient norm (f32
    rounding of the flow it was cancelled from: a Ghost score block's BN
    scale at the coarsest level has gradients of 1e-8). `floor`, when given,
    maps (variables, imgs, masks) to how far f32 rounding alone moves the
    step: {"grads": {name: relative movement as above}, "stats": {name:
    elementwise movement}}; a gradient or statistic that moves by more than
    a quarter of its tolerance is held to 4x its movement instead (at full
    width a ReLU input can sit within rounding of 0, and a BN over 8 values
    can cancel 50-fold). Returns the port model."""
    from pytorch_nested_unet_tpu.data.augment import eval_transform
    from pytorch_nested_unet_tpu.losses import get_loss
    from pytorch_nested_unet_tpu.metrics import iou_score, pixel_accuracy
    from pytorch_nested_unet_tpu_torch.training.loop import make_train_step
    from pytorch_nested_unet_tpu_torch.training.optim import build_optimizer

    jm = jax_create_model(arch, 1, 3, False, **kw)
    imgs, masks = train_batch(seed, hw=hw)
    variables = zero_bn_fed_biases(jax_variables(jm, imgs.shape, seed))
    loss_fn = get_loss("BCEDiceLoss")

    @jax.jit
    def jax_step(params, stats, imgs, masks):
        x, m = eval_transform(imgs, masks)

        def f(p):
            out, mut = jm.apply({"params": p, "batch_stats": stats}, x, train=True,
                                mutable=["batch_stats"])
            return loss_fn(out, m), (mut["batch_stats"], out)

        (loss, (new_stats, out)), grads = jax.value_and_grad(f, has_aux=True)(params)
        return loss, grads, new_stats, iou_score(out, m), pixel_accuracy(out, m)

    loss, grads, new_stats, iou, acc = jax.device_get(jax_step(
        variables["params"], variables["batch_stats"], imgs, masks))

    tm = create_model(arch, 1, 3, False, **kw)
    tm.load_state_dict(state_dict_from_jax(variables, arch), strict=True)
    step = make_train_step(tm, build_optimizer(tm.parameters(), "SGD", 1e-2, 0.9, 1e-4),
                           "BCEDiceLoss", False, augment="none")
    m = step(torch.from_numpy(imgs), torch.from_numpy(masks), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(m["loss"]), float(loss), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(m["iou"]), float(iou), atol=5e-3, rtol=0)
    np.testing.assert_allclose(float(m["acc"]), float(acc), atol=5e-3, rtol=0)

    want = state_dict_from_jax({"params": grads}, arch)
    got = {n: p.grad for n, p in tm.named_parameters()}
    assert sorted(got) == sorted(want)
    moved = floor(variables, imgs, masks) if floor else {"grads": {}, "stats": {}}
    top = max(w.norm() for w in want.values())
    for name, g in got.items():
        w = want[name]
        scale = max(w.norm(), want.get(name.rsplit(".", 1)[0] + ".weight", w).norm())
        tol = max(1e-4, 4 * moved["grads"].get(name, 0.0))
        assert (g - w).norm() <= tol * scale + 1e-7 * top, (name, float((g - w).norm() / scale),
                                                           tol)
    stats = state_dict_from_jax({"params": {}, "batch_stats": new_stats}, arch)
    bufs = dict(tm.named_buffers())
    assert sorted(stats) == sorted(bufs)
    for name, v in stats.items():
        assert bufs[name].shape == v.shape and bufs[name].dtype == v.dtype, name
        allowed = torch.maximum(1e-5 + 1e-5 * v.abs(), 4 * moved["stats"].get(name, 0 * v))
        excess = float(((bufs[name] - v).abs() - allowed).max())
        assert excess <= 0, (name, float((bufs[name] - v).abs().max()))
    return tm


@pytest.mark.parametrize("is_batchnorm", [True, False])
def test_unet_conv2_matches_jax(is_batchnorm):
    """UnetConv2 with its BNs (K1-K3 path in train mode) and without (a plain
    ReLU after each conv), eval and train, under an encoder block's keys."""
    from pytorch_nested_unet_tpu.models import blocks as jblocks
    from pytorch_nested_unet_tpu_torch.models.blocks import UnetConv2

    x = np.random.default_rng(4).standard_normal((2, 6, 5, 3)).astype(np.float32)
    jm = jblocks.UnetConv2(4, is_batchnorm=is_batchnorm)
    variables = jax_variables(jm, x.shape, 5)
    sd = state_dict_from_jax({c: {"conv1": variables[c]} for c in variables}, "UNetRNN")
    tm = UnetConv2(3, 4, is_batchnorm=is_batchnorm)
    tm.load_state_dict({k[len("conv1."):]: v for k, v in sd.items()}, strict=True)
    for train in (False, True):
        ref = jm.apply(variables, jnp.asarray(x), train=train, mutable=["batch_stats"])[0]
        out = tm.train(train)(torch.from_numpy(x))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
