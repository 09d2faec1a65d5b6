"""The frozen plain references against the port, on the CPU, at batch 2 on
seeded weights: the state dict's keys and shapes, one float32 train step
(loss, every gradient as the optimizer got it, every weight and running
statistic after it) and the served probabilities. The references import
nothing of the port or of JAX."""

import subprocess
import sys

import pytest
import torch

from cardbench import reference
from cardbench.lib import inputs, spec
from cardbench.reference.common import Numerics

CONFIGS = {"NestedUNet_wDS": {"nb_filter": [8, 16, 32, 64, 128]}, "VGG16RNN": {}}


def config(name):
    """The configuration at 32x32 (NestedUNet narrowed), float32 on the port."""
    cell = next(w for w in spec.benchmark()["workloads"] if w["config"] == name)
    cfg = spec.resolve(cell["name"]).config
    return dict(cfg, input_hw=[32, 32], **CONFIGS[name])


def port_model(cfg):
    from pytorch_nested_unet_tpu_torch.models import create_model

    return create_model(cfg["arch"], cfg["num_classes"], cfg["input_channels"],
                        cfg["deep_supervision"], **{k: tuple(cfg[k]) for k in cfg["arch_kwargs"]})


def seeded(cfg, n, seed=3):
    gen = torch.Generator().manual_seed(seed)
    sd = inputs.state_dict(cfg, gen)
    images, masks = inputs.synthetic_set(n, cfg["input_hw"], gen)
    return sd, images, masks


@pytest.mark.parametrize("name", list(CONFIGS))
def test_state_dict_layout_is_the_ports(name):
    cfg = config(name)
    port = {k: tuple(v.shape) for k, v in port_model(cfg).state_dict().items()}
    ref = dict(reference.module(cfg["arch"]).param_specs(cfg))
    assert port == ref


@pytest.mark.parametrize("name", list(CONFIGS))
def test_train_step_matches_the_port(name):
    from pytorch_nested_unet_tpu_torch.training.loop import make_train_step
    from pytorch_nested_unet_tpu_torch.training.optim import build_optimizer

    cfg = config(name)
    sd0, images, masks = seeded(cfg, 2)
    opt_cfg = {"lr": 0.1, "momentum": 0.9, "weight_decay": 1e-4}
    model = port_model(cfg)
    model.load_state_dict(sd0)
    opt = build_optimizer(model.parameters(), "SGD", opt_cfg["lr"], 0.9, 1e-4)
    step = make_train_step(model, opt, "BCEDiceLoss", cfg["deep_supervision"], "none")
    with torch.backends.mkldnn.flags(enabled=False):
        loss = float(step(images, masks, torch.Generator())["loss"])
    losses, first, sd = reference.sgd_steps(cfg, sd0, [(images, masks)], opt_cfg, Numerics())
    assert abs(loss - losses[0]) <= 1e-5 * abs(losses[0])
    named = dict(model.named_parameters())
    median = sorted(float(g.norm()) for g in first.values())[len(first) // 2]
    for key, p in named.items():
        got = opt.inner.state[p]["momentum_buffer"] - 1e-4 * sd0[key]
        # float32 against float64: 1e-4 of the leaf; a leaf whose gradient
        # is nought but for rounding (a conv bias that feeds a BN) holds the
        # port's float32 rounding, amplified in the first layer: 1e-2 of the
        # median leaf
        gap = float((got.double() - first[key]).norm())
        dead = float(first[key].norm()) < 1e-3 * median
        limit = 1e-2 * median if dead else 1e-4 * max(float(first[key].norm()), median)
        assert gap <= limit, key
    now = model.state_dict()
    for key in sd:
        if key in first and float(first[key].norm()) < 1e-3 * median:
            limit = opt_cfg["lr"] * 1e-2 * median  # the rounding above, one step of it
            assert float((now[key].double() - sd[key]).abs().max()) <= limit, key
        else:  # 1e-4 of the change, and the float32 weight's own rounding
            change = (sd[key] - sd0[key].double()).abs().max()
            limit = 1e-4 * change + 2 ** -23 * sd[key].abs().max()
            assert (now[key].double() - sd[key]).abs().max() <= limit, key


@pytest.mark.parametrize("name", list(CONFIGS))
def test_served_probabilities_match_the_predictor(name):
    from pytorch_nested_unet_tpu_torch.infer import Predictor

    cfg = config(name)
    sd0, images, _ = seeded(cfg, 4)
    sd = reference.calibrate(cfg, sd0, images)
    assert not torch.equal(sd[next(k for k in sd if k.endswith("running_var"))],
                           sd0[next(k for k in sd if k.endswith("running_var"))])
    pred = Predictor(cfg["arch"], cfg["num_classes"], cfg["input_channels"],
                     cfg["deep_supervision"], precision="fp32", batch_size=2, weights=sd,
                     device="cpu", arch_kwargs={k: cfg[k] for k in cfg["arch_kwargs"]})
    with torch.backends.mkldnn.flags(enabled=False):
        got = torch.from_numpy(pred.predict_u8(images.numpy()))
    want = reference.predict(cfg, sd, images, Numerics())
    assert float((got - want).abs().max()) <= 1e-5


def test_fp8_control_moves_the_answers():
    """The control computes in fp8: the same served probabilities move by far
    more than float32 rounding."""
    cfg = config("NestedUNet_wDS")
    sd0, images, _ = seeded(cfg, 4)
    sd = reference.calibrate(cfg, sd0, images)
    exact = reference.predict(cfg, sd, images, Numerics())
    fp8 = reference.predict(cfg, sd, images, Numerics("fp8"))
    assert float((exact - fp8).abs().max()) > 1e-3


def test_references_import_nothing_of_the_port_or_jax():
    code = ("import sys; sys.path.insert(0, %r); import cardbench.reference, cardbench.counts; "
            "from cardbench.reference import NestedUNet, VGG16RNN; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', "
            "'pytorch_nested_unet_tpu', 'pytorch_nested_unet_tpu_torch'}))" % spec.REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=120)
    assert out.stdout.strip() == "[]"
