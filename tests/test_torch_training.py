"""The port's training path against the JAX package's, from JAX's init.

A narrow NestedUNet with deep supervision (nb_filter (4,8,16,32,64), 32x32,
batch 2) is initialized in JAX; its variables are carried into the port with
`state_dict_from_jax`. Both sides take the same uint8 batches with
augmentation off (the random streams differ; the transforms are held at fixed
parameters in test_torch_augment.py), BCEDice over the four heads, SGD lr 1e-2,
momentum 0.9, weight decay 1e-4, float32.

Tolerances, set from how far the JAX package's own two paths (Pallas in
interpret mode and plain XLA) drift apart on the same run: 7e-5 in the worst
parameter or running statistic after one step, 1.7e-4 after three (a max-pool
window whose two largest values swap under rounding sends a gradient
elsewhere). So: the loss within 1e-5 at every step; every parameter and
running statistic within atol 2e-4 after one step and 5e-4 after three. IoU
and accuracy count pixels whose logit is above 0; at init many logits sit near
0, so rounding flips a few pixels (one pixel moves the IoU by ~1e-3 here; the
two JAX paths differ by 1.2e-3): they are held within 5e-3. bf16: 2e-2 on the
loss, the metrics and the parameters after one step, rounding of activations
at every layer on both sides.
"""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_nested_unet_tpu.models import create_model as jax_create_model
from pytorch_nested_unet_tpu.ops import decoder_fusion as jdf
from pytorch_nested_unet_tpu.ops import fused_bn as jbn
from pytorch_nested_unet_tpu.training import (TrainState, build_optimizer as jax_build_optimizer,
                                              make_eval_step as jax_make_eval_step,
                                              make_train_step as jax_make_train_step)
from pytorch_nested_unet_tpu.utils.torch_convert import converters_for_arch
from pytorch_nested_unet_tpu_torch import train as ttrain
from pytorch_nested_unet_tpu_torch.infer import Predictor
from pytorch_nested_unet_tpu_torch.models import create_model
from pytorch_nested_unet_tpu_torch.ops import decoder_fusion as tdf
from pytorch_nested_unet_tpu_torch.ops import fused_bn as tbn
from pytorch_nested_unet_tpu_torch.training.loop import make_eval_step, make_train_step
from pytorch_nested_unet_tpu_torch.training.optim import build_optimizer
from pytorch_nested_unet_tpu_torch.utils.convert import state_dict_from_jax

NARROW = (4, 8, 16, 32, 64)
LR = 1e-2


@pytest.fixture
def pallas():
    jbn.enable_fused_bn(True, interpret=True, mode="full")
    jdf.enable_decoder_fusion(True, interpret=True)
    yield
    jbn.enable_fused_bn(False, interpret=False)
    jdf.enable_decoder_fusion(False)


def _batches(steps, seed=0, b=2, hw=32):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (steps, b, hw, hw, 3), dtype=np.uint8)
    masks = (rng.random((steps, b, hw, hw, 1)) > 0.6).astype(np.uint8) * 255
    return imgs, masks


def _pair(dtype=None, seed=0):
    jm = jax_create_model("NestedUNet", 1, 3, True, nb_filter=NARROW,
                          dtype=jnp.bfloat16 if dtype is torch.bfloat16 else None)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(seed),
                                       np.zeros((2, 32, 32, 3), np.float32), train=True))
    tm = create_model("NestedUNet", 1, 3, True, nb_filter=NARROW, dtype=dtype)
    tm.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jm, variables, tm


def _run(steps, dtype=None):
    """`steps` train steps on each side; returns (jax metrics, jax variables,
    port metrics, port model)."""
    jm, variables, tm = _pair(dtype)
    tx = jax_build_optimizer("SGD", LR, 0.9, 1e-4)
    state = TrainState.create(variables, tx)
    jstep = jax_make_train_step(jm, tx, "BCEDiceLoss", True, augment=False, donate=False)
    opt = build_optimizer(tm.parameters(), "SGD", LR, 0.9, 1e-4)
    tstep = make_train_step(tm, opt, "BCEDiceLoss", True, augment="none")
    imgs, masks = _batches(steps)
    jmetrics, tmetrics = [], []
    gen = torch.Generator().manual_seed(0)
    for s in range(steps):
        state, m = jstep(state, jnp.asarray(imgs[s]), jnp.asarray(masks[s]),
                         jax.random.PRNGKey(s))
        jmetrics.append({k: float(v) for k, v in m.items()})
        m = tstep(torch.from_numpy(imgs[s]), torch.from_numpy(masks[s]), gen)
        assert all(v.dim() == 0 for v in m.values())
        tmetrics.append({k: float(v) for k, v in m.items()})
    jvars = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})
    return jmetrics, jvars, tmetrics, tm


def _compare(jmetrics, jvars, tmetrics, tm, loss_tol, param_tol, metric_tol=5e-3):
    for j, t in zip(jmetrics, tmetrics):
        np.testing.assert_allclose(t["loss"], j["loss"], atol=loss_tol, rtol=0)
        np.testing.assert_allclose(t["iou"], j["iou"], atol=metric_tol, rtol=0)
        np.testing.assert_allclose(t["acc"], j["acc"], atol=metric_tol, rtol=0)
    ref = state_dict_from_jax(jvars)
    sd = tm.state_dict()
    assert sorted(ref) == sorted(sd)
    for k, v in ref.items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=param_tol, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("jax_path", ["plain", "pallas"])
def test_one_train_step_matches_jax(jax_path, request):
    if jax_path == "pallas":
        request.getfixturevalue("pallas")
    _compare(*_run(1), loss_tol=1e-5, param_tol=2e-4)
    assert tbn.LAUNCHES == {"bn_stats": 0, "bn_bwd_reduce": 0, "bn_bwd_dx": 0}
    assert tdf.LAUNCHES == 0


def test_three_step_trajectory_matches_jax():
    _compare(*_run(3), loss_tol=1e-5, param_tol=5e-4)


def test_bf16_step_matches_jax_bf16():
    jmetrics, jvars, tmetrics, tm = _run(1, dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    _compare(jmetrics, jvars, tmetrics, tm, loss_tol=2e-2, param_tol=2e-2, metric_tol=2e-2)


def test_eval_step_on_padded_batch_matches_jax():
    jm, variables, tm = _pair(seed=1)
    imgs, masks = _batches(1, seed=2, b=3)
    weights = np.array([1.0, 1.0, 0.0], np.float32)  # the third image is padding
    ref = jax_make_eval_step(jm, "BCEDiceLoss", True)(
        variables["params"], variables["batch_stats"], jnp.asarray(imgs[0]),
        jnp.asarray(masks[0]), jnp.asarray(weights))
    tm.train()
    out = make_eval_step(tm, "BCEDiceLoss", True)(
        torch.from_numpy(imgs[0]), torch.from_numpy(masks[0]), torch.from_numpy(weights))
    assert tm.training, "the eval step restores train mode"
    np.testing.assert_allclose(float(out["loss"]), float(ref["loss"]), atol=1e-5, rtol=0)
    for k in ("iou", "acc"):
        np.testing.assert_allclose(float(out[k]), float(ref[k]), atol=5e-3, rtol=0, err_msg=k)


def _npy_set(tmp_path, hw):
    rng = np.random.default_rng(3)
    paths = {}
    for split, n in (("train", 4), ("val", 3)):
        paths[f"{split}_images"] = tmp_path / f"{split}_x.npy"
        paths[f"{split}_masks"] = tmp_path / f"{split}_y.npy"
        np.save(paths[f"{split}_images"], rng.integers(0, 256, (n, hw, hw, 3), dtype=np.uint8))
        np.save(paths[f"{split}_masks"],
                (rng.random((n, hw, hw, 1)) > 0.5).astype(np.uint8) * 255)
    return [f"--{k}={v}" for k, v in paths.items()]


def test_train_main_writes_log_and_a_model_jax_loads(tmp_path):
    argv = _npy_set(tmp_path, 16) + [
        "--output_dir", str(tmp_path / "models"), "--epochs", "2", "-b", "2",
        "--deep_supervision", "true", "--precision", "fp32", "--log_acc", "true"]
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.main(argv)  # the default device is the card
    summary = ttrain.main(argv + ["--device", "cpu"])
    run_dir = tmp_path / "models" / "NestedUNet_wDS"
    with open(run_dir / "log.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["epoch", "lr", "loss", "iou", "acc", "val_loss", "val_iou", "val_acc"]
    assert len(rows) == 3 and all(np.isfinite(float(v)) for v in rows[1][1:])
    assert float(rows[1][1]) == pytest.approx(1e-3) and len(summary["train_s"]) == 2

    # the full-width model.pth goes through the JAX package's converter into
    # exactly the JAX model's variable tree, and serves through Predictor
    sd = torch.load(run_dir / "model.pth", weights_only=True)
    variables = converters_for_arch("NestedUNet")[0](sd)
    jm = jax_create_model("NestedUNet", 1, 3, True)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 16, 16, 3)), train=True))
    want = jax.tree_util.tree_map(lambda a: a.shape, dict(shapes))
    assert jax.tree_util.tree_map(np.shape, variables) == want
    assert sorted(sd) == sorted(summary["model"].state_dict())
    assert all(v.dtype == torch.float32 and v.device.type == "cpu" for v in sd.values())
    pred = Predictor("NestedUNet", 1, 3, True, batch_size=2, weights=str(run_dir / "model.pth"),
                     device="cpu")
    probs = pred.predict_u8(np.load(tmp_path / "val_x.npy"))
    assert probs.shape == (3, 16, 16, 1) and np.isfinite(probs).all()


def test_fit_model_pth_serves_like_jax(tmp_path):
    """A narrow run through fit: its model.pth, loaded by the JAX converter,
    predicts what the port's Predictor predicts from it."""
    rng = np.random.default_rng(5)
    x = rng.integers(0, 256, (5, 16, 16, 3), dtype=np.uint8)
    y = (rng.random((5, 16, 16, 1)) > 0.5).astype(np.uint8) * 255
    summary = ttrain.fit(x[:3], y[:3], x[3:], y[3:], name="run", output_dir=str(tmp_path),
                         epochs=1, batch_size=2, deep_supervision=True, precision="fp32",
                         device="cpu", arch_kwargs={"nb_filter": NARROW})
    pth = tmp_path / "run" / "model.pth"
    assert summary["best_iou"] >= 0 and pth.exists()
    variables = converters_for_arch("NestedUNet")[0](torch.load(pth, weights_only=True))
    jm = jax_create_model("NestedUNet", 1, 3, True, nb_filter=NARROW)
    from pytorch_nested_unet_tpu.training.loop import make_predict_fn as jax_make_predict_fn
    ref = jax_make_predict_fn(jm, True)(variables["params"], variables["batch_stats"],
                                        jnp.asarray(x))
    pred = Predictor("NestedUNet", 1, 3, True, batch_size=5, weights=str(pth), device="cpu",
                     arch_kwargs={"nb_filter": NARROW})
    np.testing.assert_allclose(pred.predict_u8(x), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_fit_runs_main_with_full_width_defaults_but_raises_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    x = np.zeros((2, 8, 8, 3), np.uint8)
    y = np.zeros((2, 8, 8, 1), np.uint8)
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.fit(x, y, x, y, output_dir=str(tmp_path), epochs=1, batch_size=2)
    with pytest.raises(ValueError, match="batch_size"):
        ttrain.fit(x, y, x, y, output_dir=str(tmp_path), epochs=1, batch_size=4,
                   device="cpu")
