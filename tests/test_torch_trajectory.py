"""Whole training runs of the port held to the JAX package's, epoch by epoch.

A protocol is the `config` of a `PARITY_RUN*.json` (arch, deep supervision,
loss, decoder, classes, size, n_train / n_val, batch, epochs, lr) with
`min_lr` 1e-5 (parity.py's default) and seed 41. Both sides take:

- the data of `parity.make_synthetic_dataset(n_train + n_val, size, seed,
  classes)`: the first n_train images train, the rest validate;
- the batch order of `parity.batch_schedule(n_train, batch, epochs, seed)`,
  which the port's `fit` must draw by itself (asserted: one permutation a
  epoch from `default_rng(seed)`, nothing drawn by the val pass);
- the port's own init, the one `train.fit` draws
  (`create_model(..., generator=torch.Generator().manual_seed(seed))`),
  carried into JAX by the JAX package's converter, as `parity.run_jax` does;
- SGD (momentum 0.9, weight decay 1e-4), cosine LR by epoch, float32,
  augmentation off.

The JAX side (`jax_trajectory`) is `parity.run_jax`'s loop written once
here, line for line, with two changes: the model takes arch options
(`nb_filter` for the narrow case; `run_jax` builds full width only), and the
val pass scores the val images in batches of `batch`, the short last one
padded and weighted, as the JAX `train.py` and the port's `fit` do (`run_jax`
scores them as one batch, and the IoU of 16 images is not the mean of two
8-image IoUs). The port side is `train.fit(..., precision="fp32",
augment="none", device="cpu")`, read from its log and returned model.

The Tier-1 case runs a narrow NestedUNet wDS (nb_filter (4, 8, 16, 32, 64),
32x32, 16 / 8 images, batch 4, 3 epochs: 12 coupled steps, lr 1e-2): every
epoch's train and val loss within 1e-4, IoU within 5e-3 (one pixel at a
logit near 0 moves it ~1e-3, as in test_torch_training.py), the final
weights within 1e-3, and no kernel launched.

The `slow` cases run three protocols at full width (`python -m pytest -m
slow tests/test_torch_trajectory.py`) and hold each to its JSON's own
`checks` tolerances: the epoch-0 train-loss gap within 2e-3, the final val
IoU within 0.05, and the converted checkpoints' logits on the val images
within 5e-4 both ways (the port's final weights in the JAX model, the JAX
final weights in the port); and the train-loss gap at every epoch within
1e-3 for BCEDice, 2e-3 for Lovasz (PARITY.md saw <= 1.5e-3 between JAX and
upstream). They print the largest gap of each kind. The NestedUNet case
also holds the committed golden `tests/data/trajectory_NestedUNet_wDS.json`
(written by `trajectory_golden.py`, read by `chip_smoke.py` on the card) to
the JAX curves it recomputes, within 1e-5.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parity
from pytorch_nested_unet_tpu.data.augment import eval_transform as jax_eval_transform
from pytorch_nested_unet_tpu.data.pipeline import epoch_batches as jax_epoch_batches
from pytorch_nested_unet_tpu.models import create_model as jax_create_model
from pytorch_nested_unet_tpu.training import (TrainState, build_optimizer as jax_build_optimizer,
                                              make_eval_step as jax_make_eval_step,
                                              make_train_step as jax_make_train_step,
                                              set_learning_rate)
from pytorch_nested_unet_tpu.utils.torch_convert import converters_for_arch
from pytorch_nested_unet_tpu_torch import train as ttrain
from pytorch_nested_unet_tpu_torch.data.augment import eval_transform
from pytorch_nested_unet_tpu_torch.models import create_model
from pytorch_nested_unet_tpu_torch.ops import decoder_fusion as tdf
from pytorch_nested_unet_tpu_torch.ops import fused_bn as tbn
from pytorch_nested_unet_tpu_torch.utils.convert import state_dict_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "trajectory_NestedUNet_wDS.json")
CURVES = ("loss", "iou", "val_loss", "val_iou")
RDC_ARCHS = ("UNetRNN", "UNetRNNGhost", "UNetRM3", "UNetRM7", "UNetRNNCAttention",
             "ResNet50RNN", "VGG16RNN")  # the archs parity.run_jax gives a decoder
NARROW = (4, 8, 16, 32, 64)
NARROW_PROTOCOL = {"arch": "NestedUNet", "deep_supervision": True, "decoder": "vanilla",
                   "loss": "BCEDiceLoss", "num_classes": 1, "epochs": 3, "batch_size": 4,
                   "size": 32, "n_train": 16, "n_val": 8, "lr": 1e-2, "min_lr": 1e-5,
                   "seed": 41}


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """2 intra-op threads: under the suite's 6 workers, 8 threads each
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def protocol(parity_json):
    """The protocol of a PARITY_RUN*.json: its config, min_lr 1e-5, seed 41."""
    with open(os.path.join(ROOT, parity_json)) as f:
        config = json.load(f)["config"]
    return {"decoder": "vanilla", "num_classes": 1, **config, "min_lr": 1e-5, "seed": 41}


def arch_kwargs(p, **extra):
    return {**({"decoder": p["decoder"]} if p["arch"] in RDC_ARCHS else {}), **extra}


def dataset(p):
    """(images, masks, schedule) of the protocol, from parity.py."""
    images, masks = parity.make_synthetic_dataset(p["n_train"] + p["n_val"], p["size"],
                                                  p["seed"], p["num_classes"])
    schedule = parity.batch_schedule(p["n_train"], p["batch_size"], p["epochs"], p["seed"])
    return images, masks, schedule


def port_init(p, **extra):
    """The port's init as `fit` draws it, as a numpy state dict."""
    m = create_model(p["arch"], p["num_classes"], 3, p["deep_supervision"],
                     generator=torch.Generator().manual_seed(p["seed"]), **arch_kwargs(p, **extra))
    return {k: v.numpy().copy() for k, v in m.state_dict().items()}


def jax_trajectory(p, init_sd, images, masks, schedule, **extra):
    """`parity.run_jax` from the converted `init_sd`, with arch options and
    the val pass in padded, weighted batches of `batch_size` (the module
    docstring says why). Returns (model, final variables, curves)."""
    ds, n_train, bs = p["deep_supervision"], p["n_train"], p["batch_size"]
    model = jax_create_model(p["arch"], p["num_classes"], 3, ds, **arch_kwargs(p, **extra))
    variables = converters_for_arch(p["arch"])[0](init_sd)
    tx = jax_build_optimizer("SGD", p["lr"], 0.9, 1e-4)
    state = TrainState.create(variables, tx)
    step = jax_make_train_step(model, tx, p["loss"], ds, augment=False, donate=False)
    eval_step = jax_make_eval_step(model, p["loss"], ds)

    imgs_d = jnp.asarray(images)
    msks_d = jnp.asarray(masks)
    key = jax.random.PRNGKey(0)  # unused: augment=False
    val_batches = list(jax_epoch_batches(p["n_val"], bs, np.random.default_rng(0),
                                         shuffle=False, drop_last=False))

    curves = {k: [] for k in CURVES}
    for epoch in range(p["epochs"]):
        state = state.replace(opt_state=set_learning_rate(
            state.opt_state, parity.cosine_lr(epoch, p["lr"], p["epochs"], p["min_lr"])))
        ep_loss, ep_iou, seen = 0.0, 0.0, 0
        for idx in schedule[epoch]:
            i = jnp.asarray(idx)
            state, metrics = step(state, jnp.take(imgs_d, i, axis=0),
                                  jnp.take(msks_d, i, axis=0), key)
            b = len(idx)
            ep_loss += float(metrics["loss"]) * b
            ep_iou += float(metrics["iou"]) * b
            seen += b
        v_loss, v_iou, v_seen = 0.0, 0.0, 0
        for idx, valid in val_batches:
            i = jnp.asarray(n_train + idx)
            weights = jnp.asarray((np.arange(bs) < valid).astype(np.float32))
            vm = eval_step(state.params, state.batch_stats, jnp.take(imgs_d, i, axis=0),
                           jnp.take(msks_d, i, axis=0), weights)
            v_loss += float(vm["loss"]) * valid
            v_iou += float(vm["iou"]) * valid
            v_seen += valid
        curves["loss"].append(ep_loss / seen)
        curves["iou"].append(ep_iou / seen)
        curves["val_loss"].append(v_loss / v_seen)
        curves["val_iou"].append(v_iou / v_seen)
    final = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})
    return model, final, curves


def port_trajectory(p, images, masks, schedule, out_dir, monkeypatch, **extra):
    """`train.fit` on the protocol (CPU, fp32, augmentation off); asserts
    that it trains on `schedule` and validates in order. Returns (curves,
    model)."""
    drawn, epoch_batches = [], ttrain.epoch_batches

    def recorded(n, batch_size, rng, shuffle=True, drop_last=True):
        for idx, valid in epoch_batches(n, batch_size, rng, shuffle, drop_last):
            drawn.append((shuffle, idx.copy(), valid))
            yield idx, valid

    monkeypatch.setattr(ttrain, "epoch_batches", recorded)
    n = p["n_train"]
    r = ttrain.fit(images[:n], masks[:n], images[n:], masks[n:], name="trajectory",
                   output_dir=str(out_dir), epochs=p["epochs"], batch_size=p["batch_size"],
                   arch=p["arch"], deep_supervision=p["deep_supervision"],
                   num_classes=p["num_classes"], loss=p["loss"], lr=p["lr"],
                   min_lr=p["min_lr"], precision="fp32", seed=p["seed"], augment="none",
                   device="cpu", arch_kwargs=arch_kwargs(p, **extra))
    monkeypatch.undo()
    train = [idx for shuffle, idx, _ in drawn if shuffle]
    want = [idx for epoch in schedule for idx in epoch]
    assert len(train) == len(want) and all(np.array_equal(a, b) for a, b in zip(train, want)), \
        "the port's batch order is not parity.batch_schedule's"
    val = [idx[:valid] for shuffle, idx, valid in drawn if not shuffle]
    per_epoch = -(-p["n_val"] // p["batch_size"])
    assert len(val) == p["epochs"] * per_epoch
    assert all(np.array_equal(np.concatenate(val[e * per_epoch:(e + 1) * per_epoch]),
                              np.arange(p["n_val"])) for e in range(p["epochs"]))
    return {k: r["log"][k] for k in CURVES}, r["model"]


def gaps(ours, theirs):
    return {k: np.abs(np.asarray(ours[k]) - np.asarray(theirs[k])) for k in CURVES}


def launches_zero():
    assert tbn.LAUNCHES == {"bn_stats": 0, "bn_bwd_reduce": 0, "bn_bwd_dx": 0, "bn_finish": 0}
    assert tdf.LAUNCHES == 0


def test_narrow_nested_unet_trajectory_matches_jax(tmp_path, monkeypatch):
    p = NARROW_PROTOCOL
    images, masks, schedule = dataset(p)
    init_sd = port_init(p, nb_filter=NARROW)
    _, jvars, jcurves = jax_trajectory(p, init_sd, images, masks, schedule, nb_filter=NARROW)
    curves, model = port_trajectory(p, images, masks, schedule, tmp_path, monkeypatch,
                                    nb_filter=NARROW)
    launches_zero()
    g = gaps(curves, jcurves)
    print("largest gaps: " + ", ".join(f"{k} {g[k].max():.3e}" for k in CURVES))
    for k, tol in (("loss", 1e-4), ("val_loss", 1e-4), ("iou", 5e-3), ("val_iou", 5e-3)):
        assert g[k].max() <= tol, (k, curves[k], jcurves[k])
    ref = state_dict_from_jax(jvars)
    sd = model.state_dict()
    assert sorted(ref) == sorted(sd)
    for k, v in ref.items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=1e-3, rtol=0, err_msg=k)


def cross_logits(p, model, jmodel, jvars, val_images):
    """max |logit difference| on the val images between the two packages on
    the same weights: the port's final weights in the JAX model, then the
    JAX final weights in the port (a model built like `model`)."""
    xj, _ = jax_eval_transform(jnp.asarray(val_images), jnp.zeros_like(jnp.asarray(val_images)))
    x = eval_transform(torch.from_numpy(val_images))[0]

    def jax_logits(variables):
        out = jmodel.apply(variables, xj, train=False)
        return np.asarray(out[-1] if isinstance(out, (list, tuple)) else out)

    def port_logits(m):
        m.eval()
        with torch.no_grad():
            out = m(x)
        return (out[-1] if isinstance(out, (list, tuple)) else out).numpy()

    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    to_jax = float(np.abs(jax_logits(converters_for_arch(p["arch"])[0](sd))
                          - port_logits(model)).max())
    other = create_model(p["arch"], p["num_classes"], 3, p["deep_supervision"],
                         **arch_kwargs(p))
    other.load_state_dict(state_dict_from_jax(jvars, p["arch"]), strict=True)
    to_port = float(np.abs(jax_logits(jvars) - port_logits(other)).max())
    return to_jax, to_port


def read_golden():
    with open(GOLDEN) as f:
        return json.load(f)


@pytest.mark.slow
@pytest.mark.parametrize("parity_json,every_epoch_tol", [
    ("PARITY_RUN.json", 1e-3), ("PARITY_RUN_LOVASZ.json", 2e-3),
    ("PARITY_RUN_CRDN.json", 1e-3)])
def test_full_width_trajectory_matches_jax(parity_json, every_epoch_tol, tmp_path, monkeypatch):
    with open(os.path.join(ROOT, parity_json)) as f:
        checks = {k: c["tol"] for k, c in json.load(f)["checks"].items()}
    p = protocol(parity_json)
    images, masks, schedule = dataset(p)
    jmodel, jvars, jcurves = jax_trajectory(p, port_init(p), images, masks, schedule)
    curves, model = port_trajectory(p, images, masks, schedule, tmp_path, monkeypatch)
    launches_zero()
    to_jax, to_port = cross_logits(p, model, jmodel, jvars, images[p["n_train"]:])
    g = gaps(curves, jcurves)
    print(f"{parity_json}: epoch-0 loss gap {g['loss'][0]:.3e}, largest epoch loss gap "
          f"{g['loss'].max():.3e} (epoch {int(g['loss'].argmax())}), final val IoU gap "
          f"{g['val_iou'][-1]:.3e}, largest val IoU gap {g['val_iou'].max():.3e}, logits "
          f"port->JAX {to_jax:.3e}, JAX->port {to_port:.3e}")
    assert g["loss"][0] <= checks["epoch0_train_loss_gap"], (curves["loss"], jcurves["loss"])
    assert g["loss"].max() <= every_epoch_tol, (curves["loss"], jcurves["loss"])
    assert g["val_iou"][-1] <= checks["final_val_iou_gap"], (curves["val_iou"],
                                                              jcurves["val_iou"])
    assert to_jax <= checks["torch_to_ours_logits_maxdiff"]
    assert to_port <= checks["ours_to_torch_logits_maxdiff"]
    if parity_json == "PARITY_RUN.json":  # the card's golden is this run's JAX side
        golden = read_golden()
        assert golden["protocol"] == p
        for k in CURVES:
            np.testing.assert_allclose([e[k] for e in golden["epochs"]], jcurves[k], atol=1e-5,
                                       rtol=0, err_msg=k)


def test_chip_smoke_draws_parity_data():
    """chip_smoke.py's copy of parity.py's data (its trajectory phase imports
    nothing of the JAX harness) draws the same images and masks."""
    import chip_smoke

    p = protocol("PARITY_RUN.json")
    images, masks, _ = dataset(p)
    got = chip_smoke.synthetic_set(p["n_train"] + p["n_val"], p["seed"], p["size"])
    np.testing.assert_array_equal(got[0], images)
    np.testing.assert_array_equal(got[1], masks)
    assert read_golden()["protocol"] == p
