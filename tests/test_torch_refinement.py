"""The port's CascadePSP refinement stack against the JAX package's: the new
ops (adaptive pools, area and bicubic resize, Sobel), the RefinementModule's
parts and the whole network, the tiled driver, the `Refiner` front end and
its weight formats, on numpy inputs, on the CPU.

Weights come from the JAX package: its modules' variables drawn from a numpy
seed (`test_torch_crdn.jax_variables`), or the JAX `Refiner()`'s own flax
init at PRNGKey(0), exported under the released checkpoint's keys by
`export_torch_style_state_dict` and loaded strict into the port.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_nested_unet_tpu import refinement as jref
from pytorch_nested_unet_tpu.ops import pool as jpool
from pytorch_nested_unet_tpu.ops import resize as jresize
from pytorch_nested_unet_tpu.ops import sobel as jsobel
from pytorch_nested_unet_tpu.refinement import driver as jdriver
from pytorch_nested_unet_tpu_torch import refinement as ref
from pytorch_nested_unet_tpu_torch.ops import pool, resize, sobel
from pytorch_nested_unet_tpu_torch.refinement import driver
from chip_smoke import mask_guided
from test_refinement_golden import _GOLDEN_DIR, _scene
from test_torch_crdn import jax_variables

RM_PARAMS, RM_TENSORS = 67_683_433, 361
OUTPUT_KEYS = ("pred_28", "out_28", "pred_28_2", "out_28_2", "pred_56", "out_56",
               "pred_224", "out_224", "pred_28_3", "out_28_3", "pred_56_2", "out_56_2")


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads for this module's torch work: the suite runs in
    several worker processes at once, and the 67.7M-parameter refinement
    network runs several times faster on 2 threads per process than on one
    per core in each (oversubscribed)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def normal(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------- ops


@pytest.mark.parametrize("op", ["avg", "max"])
@pytest.mark.parametrize("in_hw,out_hw", [((7, 7), (3, 3)), ((13, 13), (6, 6)),
                                          ((13, 7), (6, 3)), ((9, 9), (1, 1)),
                                          ((6, 6), (6, 6))])
def test_adaptive_pool_matches_jax(op, in_hw, out_hw):
    """torch's adaptive bins, floor(i*in/out) to ceil((i+1)*in/out), against
    the JAX package's integral-image sums (avg) and slices (max), bins that do
    not divide the input included: within 1e-6."""
    x = normal((2, *in_hw, 5))
    jfn, fn = ((jpool.adaptive_avg_pool, pool.adaptive_avg_pool) if op == "avg"
               else (jpool.adaptive_max_pool, pool.adaptive_max_pool))
    want = np.asarray(jfn(jnp.asarray(x), out_hw))
    got = fn(t(x), out_hw)
    assert got.shape == want.shape and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("window,stride", [((2, 2), None), ((3, 3), (1, 1)), ((3, 2), (2, 1))])
def test_avg_pool2d_matches_jax(window, stride):
    x = normal((2, 9, 8, 3), 1)
    want = np.asarray(jpool.avg_pool2d(jnp.asarray(x), window, stride))
    np.testing.assert_allclose(pool.avg_pool2d(t(x), window, stride).numpy(), want,
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("in_hw,out_hw", [((20, 30), (7, 9)), ((13, 6), (6, 6)),
                                          ((8, 8), (8, 8))])
def test_resize_area_matches_jax(in_hw, out_hw):
    x = normal((1, *in_hw, 3), 2)
    want = np.asarray(jresize.resize_area(jnp.asarray(x), out_hw))
    np.testing.assert_allclose(resize.resize_area(t(x), out_hw).numpy(), want,
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("in_hw,out_hw", [((7, 9), (20, 23)), ((20, 23), (7, 9)),
                                          ((5, 16), (32, 6)), ((11, 11), (11, 11))])
def test_resize_bicubic_matches_jax(in_hw, out_hw, align_corners):
    """`F.interpolate(mode='bicubic')` against the JAX package's four gathers
    per axis (a = -0.75, border-clamped taps), up- and downscales."""
    x = normal((2, *in_hw, 3), 3)
    want = np.asarray(jresize.resize_bicubic(jnp.asarray(x), out_hw, align_corners))
    got = resize.resize_bicubic(t(x), out_hw, align_corners)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_sobel_and_sobel_computer_match_jax():
    x, p = normal((2, 9, 11, 2), 4), np.abs(normal((2, 9, 11, 1), 5))
    np.testing.assert_allclose(sobel.sobel(t(x)).numpy(),
                               np.asarray(jsobel.sobel(jnp.asarray(x))), atol=1e-6, rtol=0)
    got = sobel.SobelComputer().compute_edges({"gt": t(p), "pred_224": t(p * 0.5)})
    want = jsobel.SobelComputer().compute_edges({"gt": jnp.asarray(p),
                                                 "pred_224": jnp.asarray(p * 0.5)})
    for k in ("gt_sobel", "pred_sobel"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-6, rtol=0)


# ---------------------------------------------------------------- modules


def port_state(variables, head):
    """JAX variables of a refinement submodule that the released checkpoint
    keys under `head` (feats, psp, up_1) -> the port's state dict for it."""
    sd = jref.export_torch_style_state_dict(
        {"params": {head: variables["params"]},
         "batch_stats": {head: variables.get("batch_stats", {})}})
    return {k[len(head) + 1:]: t(v) for k, v in sd.items()}


def assert_close_to_scale(got, want, tol=1e-5, what=""):
    """max |got - want| within tol of max |want|."""
    got, want = np.asarray(got.detach() if torch.is_tensor(got) else got), np.asarray(want)
    assert got.shape == want.shape, what
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= tol * scale, (what, err, scale)


def check_grads(got_module, jax_grads, head, x_grad, jax_x_grads, tol=1e-5):
    """Every parameter gradient and the input gradients within tol of the
    largest JAX gradient of the same tensor, or of its module's weight
    gradient where that is larger: a conv bias that feeds a train-mode BN
    has a true gradient of 0 (the BN subtracts the batch mean), so both
    sides compute rounding noise for it."""
    want = port_state({"params": jax_grads}, head)
    got = {n: p.grad for n, p in got_module.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, g in list(got.items()) + list(zip(range(len(x_grad)), x_grad)):
        w = want[name] if name in want else t(jax_x_grads[name])
        sibling = want.get(str(name).rsplit(".", 1)[0] + ".weight", w)
        scale = max(float(w.abs().max()), float(sibling.abs().max()), 1e-30)
        assert float((g - w).abs().max()) <= tol * scale, (name, float((g - w).abs().max()),
                                                           scale)


def run_train(jm, variables, jax_inputs, port_module, cotangents):
    """Train-mode forward and VJP of both: JAX's (outputs, param grads, input
    grads, new batch stats) and the port's outputs (its grads in .grad)."""
    def f(params, *xs):
        out, mut = jm.apply({"params": params, "batch_stats": variables.get("batch_stats", {})},
                            *xs, **({"train": True} if variables.get("batch_stats") else {}),
                            mutable=["batch_stats"])
        outs = out if isinstance(out, tuple) else (out,)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cotangents)), (outs, mut)

    argnums = tuple(range(len(jax_inputs) + 1))
    (_, (outs, mut)), grads = jax.jit(jax.value_and_grad(f, argnums=argnums, has_aux=True))(
        variables["params"], *(jnp.asarray(a) for a in jax_inputs))
    xs = [t(a).requires_grad_(True) for a in jax_inputs]
    got = port_module.train()(*xs)
    got = got if isinstance(got, tuple) else (got,)
    sum((o * t(c)).sum() for o, c in zip(got, cotangents)).backward()
    return outs, grads[0], grads[1:], mut.get("batch_stats", {}), got, [x.grad for x in xs]


def test_psp_module_matches_jax():
    """PSPModule (pools 1, 2, 3, 6 over a 7x7 map, 1x1 convs, half-pixel
    resizes, the bottleneck): output and every gradient within 1e-5 of
    their largest element."""
    jm = jref.PSPModule(out_features=8, sizes=(1, 2, 3, 6))
    x = normal((2, 7, 7, 16), 6)
    variables = jax_variables(jm, x.shape, 6)
    m = ref.PSPModule(16, 8, (1, 2, 3, 6))
    m.load_state_dict(port_state(variables, "psp"), strict=True)
    cot = [normal((2, 7, 7, 8), 7)]
    outs, pg, xg, _, got, gx = run_train(jm, variables, [x], m, cot)
    assert_close_to_scale(got[0], outs[0])
    check_grads(m, pg, "psp", gx, xg)


def test_psp_upsample_matches_jax():
    """PSPUpsample in train mode (its first BN over the concatenation of the
    upsampled x and the skip): output and every gradient within 1e-5 of
    their largest element, the running statistics within atol = rtol =
    1e-5."""
    jm = jref.PSPUpsample(12)
    x, up = normal((2, 5, 6, 8), 8), normal((2, 10, 12, 4), 9)
    variables = jax_variables(jm, (x.shape, up.shape), 8)
    m = ref.PSPUpsample(8, 4, 12)
    m.load_state_dict(port_state(variables, "up_1"), strict=True)
    assert m.conv[0].weight.shape == (12,)  # 8 + 4 channels
    outs, pg, xg, stats, got, gx = run_train(jm, variables, [x, up], m,
                                             [normal((2, 10, 12, 12), 10)])
    assert_close_to_scale(got[0], outs[0])
    check_grads(m, pg, "up_1", gx, xg)
    want = port_state({"params": {}, "batch_stats": stats}, "up_1")
    for name, v in want.items():
        np.testing.assert_allclose(dict(m.named_buffers())[name].numpy(), v.numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=name)


def test_dilated_resnet_matches_jax():
    """DilatedResNet50(layers=(1, 1, 1, 1)) on 6 channels in train mode: the
    three outputs (layer4 at 1/8, the stem conv before its BN at 1/2, layer1
    at 1/4) and every gradient within 1e-5 of their largest element
    (measured: 4.3e-6 at layer4, after 16 train-mode BNs over as few as 72
    values), the running statistics within atol = rtol = 1e-5."""
    jm = jref.DilatedResNet50(layers=(1, 1, 1, 1))
    x = normal((2, 48, 48, 6), 11)
    variables = jax_variables(jm, x.shape, 11)
    m = ref.DilatedResNet50(layers=(1, 1, 1, 1))
    m.load_state_dict(port_state(variables, "feats"), strict=True)
    cot = [normal((2, 6, 6, 2048), 12), normal((2, 24, 24, 64), 13),
           normal((2, 12, 12, 256), 14)]
    outs, pg, xg, stats, got, gx = run_train(jm, variables, [x], m, cot)
    for i, (o, w) in enumerate(zip(got, outs)):
        assert_close_to_scale(o, w, what=i)
    check_grads(m, pg, "feats", gx, xg)
    want = port_state({"params": {}, "batch_stats": stats}, "feats")
    for name, v in want.items():
        np.testing.assert_allclose(dict(m.named_buffers())[name].numpy(), v.numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=name)


# ---------------------------------------------------------------- the network


@pytest.fixture(scope="module")
def jax_refiner():
    """The JAX package's Refiner on the variables of `Refiner()` (the flax
    init at PRNGKey(0), drawn under jit: the same bits, in half the time),
    and those variables exported under the released keys."""
    variables = jax.jit(jref.RefinementModule().init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32),
        jnp.zeros((1, 32, 32, 1), jnp.float32))
    r = jref.Refiner(variables=variables)
    return r, jref.export_torch_style_state_dict(r.variables)


@pytest.fixture(scope="module")
def port_module(jax_refiner):
    m = ref.RefinementModule()
    m.load_state_dict(ref.convert_torch_state_dict(jax_refiner[1]), strict=True)
    return m.eval()


def test_parameter_count_and_keys(jax_refiner, port_module):
    """67,683,433 parameters in 361 tensors under the released keys (the JAX
    package's export), none missing or extra."""
    sd = port_module.state_dict()
    assert sum(p.numel() for p in port_module.parameters()) == RM_PARAMS
    assert len(sd) == RM_TENSORS and set(sd) == set(jax_refiner[1])
    for k in ("feats.layer1.0.downsample.1.running_var", "psp.stages.3.1.weight",
              "up_1.conv.0.weight", "up_3.conv2.5.bias", "final_28.2.weight", "final_21.bias"):
        assert k in sd
    assert sd["up_1.conv.0.weight"].shape == (1024 + 256,)  # the BN over the concatenation
    assert sd["feats.conv1.weight"].shape == (64, 6, 7, 7)


def test_module_prefix_round_trip(port_module, tmp_path):
    """export -> DataParallel `module.` keys plus BN counters -> the .pth and
    .npz loaders -> the same tensors, loaded strict."""
    sd = ref.export_torch_style_state_dict(port_module)
    prefixed = {f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}
    prefixed["module.feats.bn1.num_batches_tracked"] = torch.tensor(7)
    torch.save(prefixed, tmp_path / "model.pth")
    np.savez(tmp_path / "model.npz", **sd)
    for path in (tmp_path / "model.pth", tmp_path / "model.npz"):
        back = ref.Refiner(model_path=str(path), device="cpu").model.state_dict()
        assert set(back) == set(sd)
        assert all(np.array_equal(back[k].numpy(), sd[k]) for k in sd), path
    back = ref.convert_torch_state_dict(prefixed)
    assert set(back) == set(sd) and all(back[k].dtype == torch.float32 for k in back)


@pytest.mark.parametrize("skip", ["none", "s8", "s8_s4"])
def test_refinement_module_eval_matches_jax(jax_refiner, port_module, skip):
    """Every output of the eval forward at 32x32 (batch 2) within 1e-4 of the
    JAX package's (measured: 1.2e-7), with no pass skipped, pass 1 skipped
    (inter_s8) and passes 1-2 skipped (inter_s8 and inter_s4)."""
    jr, _ = jax_refiner
    x, seg = normal((2, 32, 32, 3), 15), np.tanh(normal((2, 32, 32, 1), 16))
    inter = {"none": (), "s8": (np.tanh(normal((2, 32, 32, 1), 17)),),
             "s8_s4": (np.tanh(normal((2, 32, 32, 1), 17)), np.tanh(normal((2, 32, 32, 1), 18)))}
    extra = inter[skip] + (None,) * (2 - len(inter[skip]))
    want = jax.jit(lambda v, *a: jr.model.apply(v, *a, train=False))(
        jr.variables, jnp.asarray(x), jnp.asarray(seg),
        *(None if e is None else jnp.asarray(e) for e in extra))
    with torch.no_grad():
        got = port_module(t(x), t(seg), *(None if e is None else t(e) for e in extra))
    assert sorted(got) == sorted(want)
    assert set(got) <= set(OUTPUT_KEYS) and "pred_224" in got
    for k in got:
        assert got[k].dtype == torch.float32 and got[k].shape == (2, 32, 32, 1)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-4, rtol=1e-4,
                                   err_msg=k)


def _f64_train_stats(model, x, seg):
    """The running statistics after one train forward of `model` run in
    float64 (each BN as F.batch_norm in float64)."""
    import copy

    import torch.nn.functional as F
    from pytorch_nested_unet_tpu_torch.ops.layers import BatchNorm

    m = copy.deepcopy(model).double().train()
    for bn in m.modules():
        if isinstance(bn, BatchNorm):
            bn.forward = lambda y, bn=bn: F.batch_norm(
                y.permute(0, 3, 1, 2), bn.running_mean, bn.running_var, bn.weight, bn.bias,
                True, 0.1, bn.eps).permute(0, 2, 3, 1)
    with torch.no_grad():
        m(x.double(), seg.double())
    return {n: b.float() for n, b in m.named_buffers()}


def test_running_stats_after_a_train_forward_match_jax(jax_refiner, port_module):
    """One train-mode forward at 32x32 (batch 2): each BN of feats and psp
    moves its running statistics once per pass (3 times), up_1's twice,
    up_2's and up_3's once, as flax does. Every statistic equals the JAX
    package's within atol = rtol = 1e-5, or within 4x how far f32 rounding
    moves the port's own statistics from float64 (the largest move in that
    tensor) where that is more: a random network in train mode at this size
    feeds each pass's rounding into the next pass's input (the port's f32
    outputs move 0.05 from float64 by pass 3), so the later passes' deep
    statistics are held to that. The stem BN's mean, which sees pass 1's
    input as it is, is held to 1e-5 alone: 1 or 2 updates instead of 3
    would miss it by far."""
    import copy

    jr, _ = jax_refiner
    x, seg = normal((2, 32, 32, 3), 19), np.tanh(normal((2, 32, 32, 1), 20))
    _, mut = jr.model.apply(jr.variables, jnp.asarray(x), jnp.asarray(seg), train=True,
                            mutable=["batch_stats"])
    want = ref.convert_torch_state_dict(jref.export_torch_style_state_dict(
        {"params": jr.variables["params"], "batch_stats": mut["batch_stats"]}))
    start = copy.deepcopy(port_module)
    m = copy.deepcopy(port_module).train()
    with torch.no_grad():
        m(t(x), t(seg))
    got = dict(m.named_buffers())
    f64 = _f64_train_stats(start, t(x), t(seg))
    # the stem BN sees pass 1's input exactly: 3 updates, not 1 or 2
    bn1 = got["feats.bn1.running_mean"]
    np.testing.assert_allclose(bn1.numpy(), want["feats.bn1.running_mean"].numpy(),
                               atol=1e-5, rtol=1e-5)
    for name, v in want.items():
        if "running" not in name:
            continue
        moved = float((got[name] - f64[name]).abs().max())
        allowed = torch.clamp(1e-5 + 1e-5 * v.abs(), min=4 * moved)
        excess = float(((got[name] - v).abs() - allowed).max())
        assert excess <= 0, (name, float((got[name] - v).abs().max()))


# ---------------------------------------------------------------- Refiner


def _golden_check(name, out):
    """The rule of tests/test_refinement_golden.py: within 1 gray level
    everywhere and exact on >= 99% of the pixels."""
    golden = np.load(os.path.join(_GOLDEN_DIR, name))
    assert out.shape == golden.shape and out.dtype == golden.dtype == np.uint8
    diff = np.abs(out.astype(np.int16) - golden.astype(np.int16))
    assert diff.max() <= 1, f"{name}: max gray-level diff {diff.max()}"
    assert (diff == 0).mean() >= 0.99, f"{name}: only {(diff == 0).mean():.4f} exact"


@pytest.fixture(scope="module")
def port_refiner(jax_refiner):
    return ref.Refiner(state_dict=jax_refiner[1], device="cpu")


@pytest.mark.parametrize("fast,golden", [(True, "refiner_fast_L32.npy"),
                                         (False, "refiner_full_L32.npy")])
def test_refiner_reproduces_the_golden(port_refiner, fast, golden):
    """The port's Refiner on the JAX Refiner()'s weights reproduces the
    checked-in goldens of the JAX pipeline (tests/golden/), fast and full,
    on the same 48x48 scene at L = 32."""
    image, mask = _scene()
    _golden_check(golden, port_refiner.refine(image, mask, fast=fast, L=32))


def _diagonal_case():
    """JAX's tiled-pass case: 112x112, L = 96, a diagonal split (4 tiles)."""
    rng = np.random.default_rng(5)
    h = w = 112
    im = rng.normal(size=(1, h, w, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    seg = (((yy + xx) < h).astype(np.float32) * 2 - 1)[None, ..., None]
    return im, seg


def test_tile_batch_equals_sequential_tiles(port_refiner):
    """On the JAX package's tiled-pass case (112x112, L = 96, a diagonal
    split), the global pass guided by the mask (`chip_smoke.mask_guided`: a
    random network's global prediction is on one side of 0.5 everywhere, so
    every tile would be trivial): the 4 tiles run one per
    forward and 3 per forward (a chunk of 3, then 1 padded to 3) give the
    same map within 1e-5."""
    im, seg = _diagonal_case()
    runs, outs = [], []
    for tb in (None, 3):
        tiles = []
        outs.append(driver.process_high_res_im(mask_guided(port_refiner.apply_fn), t(im),
                                               t(seg), 96, tile_batch=tb,
                                               tiles_run=tiles).numpy())
        runs.append(tiles)
    assert runs[0] == runs[1] and len(runs[0]) == 4
    assert outs[0].shape == (1, 112, 112, 1)
    np.testing.assert_allclose(outs[1], outs[0], atol=1e-5, rtol=0)


def test_tiled_pass_matches_jax(jax_refiner, port_refiner):
    """The same mask-guided full pipeline through the JAX driver and network
    and through the port's: its 4 tiles run the network's pass 3 on the
    same weights; the refined maps agree within 1e-5."""
    im, seg = _diagonal_case()
    jr, _ = jax_refiner
    want = jdriver.process_high_res_im(mask_guided(jr.apply_fn), jnp.asarray(im),
                                       jnp.asarray(seg), 96)
    got = driver.process_high_res_im(mask_guided(port_refiner.apply_fn), t(im), t(seg), 96)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_safe_forward_pads_and_crops():
    """30x43 -> 32x48 (both sides to the next multiple of 8 above; the image
    padded with 0, the segmentations with -1) -> 30x43."""
    seen = {}

    def apply_fn(im, seg, s8=None, s4=None):
        seen.update(im=im, seg=seg, s8=s8)
        out = torch.sigmoid(seg + im[..., :1])
        return {"pred_224": out, "pred_28_3": out, "pred_56_2": out}

    im, seg = t(normal((1, 30, 43, 3), 21)), t(np.tanh(normal((1, 30, 43, 1), 22)))
    out = driver.safe_forward(apply_fn, im, seg, seg)
    assert seen["seg"].shape == (1, 32, 48, 1) and seen["im"].shape == (1, 32, 48, 3)
    assert float(seen["im"][:, 30:].abs().max()) == 0 and float(seen["im"][:, :, 43:].abs().max()) == 0
    assert bool((seen["seg"][:, 30:] == -1).all()) and bool((seen["s8"][:, :, 43:] == -1).all())
    assert all(v.shape == (1, 30, 43, 1) for v in out.values())
    np.testing.assert_allclose(out["pred_224"].numpy(),
                               torch.sigmoid(seg + im[..., :1]).numpy(), atol=1e-7, rtol=0)


def _toy_apply_fns():
    """The same cheap network-free function in both frameworks, for the
    drivers' geometry: pred_224 = sigmoid(4 seg + 0.3 im_0), the others
    sigmoid(seg + 0.2 im_1) and sigmoid(2 seg); inter_s4 shifts pred_224."""
    def port(im, seg, s8=None, s4=None):
        b = 0 if s4 is None else 0.5 * s4
        return {"pred_224": torch.sigmoid(4 * seg + 0.3 * im[..., :1] + b),
                "pred_28_3": torch.sigmoid(seg + 0.2 * im[..., 1:2]),
                "pred_56_2": torch.sigmoid(2 * seg)}

    def jax_fn(im, seg, s8=None, s4=None):
        b = 0 if s4 is None else 0.5 * s4
        return {"pred_224": jax.nn.sigmoid(4 * seg + 0.3 * im[..., :1] + b),
                "pred_28_3": jax.nn.sigmoid(seg + 0.2 * im[..., 1:2]),
                "pred_56_2": jax.nn.sigmoid(2 * seg)}

    return port, jax_fn


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("hw,L", [((50, 70), 32), ((40, 40), 96), ((72, 72), 72),
                                  ((150, 110), 80)])
def test_drivers_match_jax(fast, hw, L):
    """process_im_single_pass and process_high_res_im around the same toy
    function: area down or bicubic up to a longer side of L, the tile grid,
    the trivial-tile skip, the 16-pixel trims, the overlap average and the
    fall-back, within 1e-5 of the JAX drivers."""
    port_fn, jax_fn = _toy_apply_fns()
    rng = np.random.default_rng(23)
    im = rng.normal(size=(1, *hw, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]]
    seg = ((((yy - hw[0] / 2) ** 2 + (xx - hw[1] / 3) ** 2) < (hw[0] / 3) ** 2)
           .astype(np.float32) * 2 - 1)[None, ..., None]
    if fast:
        want = jdriver.process_im_single_pass(jax_fn, jnp.asarray(im), jnp.asarray(seg), L)
        got = driver.process_im_single_pass(port_fn, t(im), t(seg), L)
    else:
        want = jdriver.process_high_res_im(jax_fn, jnp.asarray(im), jnp.asarray(seg), L)
        got = driver.process_high_res_im(port_fn, t(im), t(seg), L)
    assert got.shape == (1, *hw, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("hw,size,method", [((1200, 1600), 900, "area"),
                                            ((96, 96), 900, "bicubic"),
                                            ((30, 43), 32, "bilinear"),
                                            ((43, 30), 90, "bicubic")])
def test_resize_max_side_matches_jax(hw, size, method):
    """Output sizes int(h * ratio) in Python floats, values within 1e-5
    (shapes only at 1200x1600: the area pool is checked at smaller sizes)."""
    shape = (1, *hw, 1)
    want_hw = tuple(int(s * size / max(hw)) for s in hw)
    if max(hw) > 200:
        got = driver.resize_max_side(torch.zeros(shape), size, method)
        assert got.shape[1:3] == want_hw
        return
    x = normal(shape, 24)
    want = np.asarray(jdriver.resize_max_side(jnp.asarray(x), size, method))
    got = driver.resize_max_side(t(x), size, method)
    assert got.shape[1:3] == want_hw == want.shape[1:3]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_refiner_weights_options(monkeypatch):
    """model_path="auto" raises WeightsUnavailable naming where to put the
    released file (nothing is downloaded); an absent path raises
    FileNotFoundError; CUDA without a card raises; a bad tile_batch raises."""
    with pytest.raises(ref.WeightsUnavailable, match="segmentation-refinement"):
        ref.Refiner(model_path="auto", device="cpu")
    with pytest.raises(FileNotFoundError):
        ref.Refiner(model_path="/nonexistent/cascadepsp.pth", device="cpu")
    with pytest.raises(ValueError, match="tile_batch"):
        ref.Refiner(tile_batch=0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ref.Refiner()


def test_seeded_init_is_deterministic():
    """Without weights the network is the port's seeded init: the same seed
    gives the same weights, another seed others."""
    a = ref.RefinementModule(generator=torch.Generator().manual_seed(3)).state_dict()
    b = ref.RefinementModule(generator=torch.Generator().manual_seed(3)).state_dict()
    c = ref.RefinementModule(generator=torch.Generator().manual_seed(4)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["final_21.weight"], c["final_21.weight"])
