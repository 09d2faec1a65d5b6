"""The port's CRDN training path against the JAX package's, and the CLI's
`--arch_kwargs`.

One f32 train step of narrow UNetRNN models (feature_scale 16, 32x32, batch
2) against `jax.value_and_grad` through the JAX model from the same variables
(`test_torch_crdn.check_train_step_against_jax` states the tolerances); then
`train.main` / `infer.main` on a CRDN arch chosen by `--arch` and sized by
`--arch_kwargs`, its model.pth read by the JAX package's converter and served
by both packages.
"""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_nested_unet_tpu.models import create_model as jax_create_model
from pytorch_nested_unet_tpu.training.loop import make_predict_fn as jax_make_predict_fn
from pytorch_nested_unet_tpu.utils.torch_convert import converters_for_arch
from pytorch_nested_unet_tpu_torch import infer as tinfer
from pytorch_nested_unet_tpu_torch import train as ttrain
from pytorch_nested_unet_tpu_torch.infer import Predictor
from pytorch_nested_unet_tpu_torch.models import (arch_names, arch_options, model_class,
                                                  parse_arch_kwargs)
from pytorch_nested_unet_tpu_torch.ops import fused_bn as tbn
from test_torch_crdn import FS, check_train_step_against_jax


@pytest.mark.parametrize("decoder", ["GRU", "LSTM", "vanilla"])
def test_unetrnn_train_step_matches_jax(decoder):
    check_train_step_against_jax("UNetRNN", feature_scale=FS, decoder=decoder)
    assert tbn.LAUNCHES == {"bn_stats": 0, "bn_bwd_reduce": 0, "bn_bwd_dx": 0, "bn_finish": 0}


def test_unetrm3_train_step_matches_jax():
    check_train_step_against_jax("UNetRM3", feature_scale=FS)


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


KW = '{"decoder": "LSTM", "feature_scale": 16}'


def test_train_main_arch_kwargs_writes_a_model_jax_loads(tmp_path):
    argv = _npy_set(tmp_path, 16) + [
        "--output_dir", str(tmp_path / "models"), "--epochs", "2", "-b", "2",
        "--precision", "fp32", "--arch", "UNetRNN", "--arch_kwargs", KW]
    summary = ttrain.main(argv + ["--device", "cpu"])
    run_dir = tmp_path / "models" / "UNetRNN_woDS"
    with open(run_dir / "log.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["epoch", "lr", "loss", "iou", "val_loss", "val_iou"] and len(rows) == 3
    assert all(np.isfinite(float(v)) for v in rows[1][1:])
    model = summary["model"]
    assert model.decoder == "LSTM" and model.filters == [4, 8, 16, 32, 64]

    # the JAX package's converter reads model.pth into exactly the JAX
    # model's variable tree, and the JAX model predicts what Predictor does
    sd = torch.load(run_dir / "model.pth", weights_only=True)
    assert sorted(sd) == sorted(model.state_dict())
    variables = converters_for_arch("UNetRNN")[0](sd)
    jm = jax_create_model("UNetRNN", 1, 3, False, **parse_arch_kwargs("UNetRNN", KW))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3))))
    want = jax.tree_util.tree_map(lambda a: a.shape, dict(shapes))
    assert jax.tree_util.tree_map(np.shape, variables) == want
    images = np.load(tmp_path / "val_x.npy")
    ref = jax_make_predict_fn(jm, False)(variables["params"], variables["batch_stats"],
                                         jnp.asarray(images))
    out = tmp_path / "probs.npy"
    tinfer.main(["--input", str(tmp_path / "val_x.npy"), "--output", str(out),
                 "--weights", str(run_dir / "model.pth"), "--arch", "UNetRNN",
                 "--arch_kwargs", KW, "--batch_size", "2", "--device", "cpu"])
    np.testing.assert_allclose(np.load(out), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_unknown_arch_kwarg_raises(tmp_path):
    argv = _npy_set(tmp_path, 8) + ["--output_dir", str(tmp_path), "--epochs", "1", "-b", "2",
                                    "--arch", "UNetRNN", "--device", "cpu"]
    with pytest.raises(ValueError, match="nb_filter"):
        ttrain.main(argv + ["--arch_kwargs", '{"nb_filter": [4, 8, 16, 32, 64]}'])
    with pytest.raises(ValueError, match="decoderr"):
        Predictor("UNetRNN", device="cpu", arch_kwargs={"decoderr": "GRU"})
    with pytest.raises(ValueError, match="fast_pam"):
        parse_arch_kwargs("UNetRNNCAttention", '{"fast_pam": true}')
    with pytest.raises(SystemExit):  # argparse: not a registered arch
        ttrain.parse_args(argv + ["--arch", "NoSuchArch"])
    assert parse_arch_kwargs("UNet", '{"nb_filter": [4, 8, 16, 32, 64]}') == {
        "nb_filter": (4, 8, 16, 32, 64)}
    assert parse_arch_kwargs("UNetRNNAttention", {"fast_pam": True, "pam_grid": 64}) == {
        "fast_pam": True, "pam_grid": 64}


def test_every_registered_arch_serves_through_predictor():
    """Predictor(arch=...) builds and serves each of the 25 registered archs
    (the JAX package's registry): narrow where the arch has a width option,
    the CRDN backbones and DoubleUnet at full width (ResNet50FCN at 48x48:
    its valid 3x3 classifier conv needs down5 of 3x3; DoubleUnet at 32x32,
    the multiple of 32 it needs), DeepLab at layers (1, 1, 1, 1)."""
    from pytorch_nested_unet_tpu.models import arch_names as jax_arch_names

    rng = np.random.default_rng(4)
    assert len(arch_names()) == 25 and arch_names() == sorted(jax_arch_names())
    for arch in arch_names():
        options = arch_options(arch)
        kw = ({"nb_filter": (4, 8, 16, 32, 64)} if "nb_filter" in options
              else {"filters": (4, 8, 16, 32, 64)} if "filters" in options
              else {"feature_scale": 16} if "feature_scale" in options
              else {"layers": [1, 1, 1, 1]} if arch == "DeepLab" else {})
        hw = {"UNetRM7": 64, "ResNet50FCN": 48, "DoubleUnet": 32}.get(arch, 16)  # RM7 pools 6x
        images = rng.integers(0, 256, (3, hw, hw, 3), dtype=np.uint8)
        pred = Predictor(arch, batch_size=2, device="cpu", arch_kwargs=kw)
        probs = pred.predict_u8(images)
        assert probs.shape == (3, hw, hw, 1) and np.isfinite(probs).all(), arch
        assert type(pred.model) is model_class(arch)
