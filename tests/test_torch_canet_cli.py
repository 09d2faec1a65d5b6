"""The port's CA-Net preset (`train_canet`) and the attention U-Nets' capsules
held against the JAX package's CLIs from the same weights, on the CPU at a
narrow width (CA-Net feature_scale 16 with drop_rate 0, AttU_Net filters
4..64), on a PNG folder in the ISIC layout at 32x32, batch 2."""

import importlib

import cv2
import numpy as np
import pandas as pd
import pytest
import torch

import convert as jax_convert
import train as jax_train
import train_canet as jax_train_canet
from train_isic import _with_defaults as jax_with_defaults
from pytorch_nested_unet_tpu.training.checkpoint import load_capsule as jax_load_capsule
from pytorch_nested_unet_tpu.training.loop import make_predict_fn as jax_make_predict_fn
from pytorch_nested_unet_tpu_torch import train as ptrain
from pytorch_nested_unet_tpu_torch import train_canet as ptrain_canet
from pytorch_nested_unet_tpu_torch.infer import Predictor
from pytorch_nested_unet_tpu_torch.models import create_model, parse_arch_kwargs
from pytorch_nested_unet_tpu_torch.utils.config import load_config

CANET_KW = '{"feature_scale": 16, "drop_rate": 0}'
ATTU_KW = '{"filters": [4, 8, 16, 32, 64]}'
NAME = "ISIC_Comprehensive_Atten_Unet_woDS"


def _write_isic(root, n_train=6, n_test=2, size=32):
    """inputs/ISIC/{train,test}/{image,mask}: PNG images, `<id>_segmentation`
    masks, a bright disc on noise."""
    rng = np.random.default_rng(12)
    yy, xx = np.mgrid[0:size, 0:size]
    for split, n in (("train", n_train), ("test", n_test)):
        img_dir = root / "ISIC" / split / "image"
        mask_dir = root / "ISIC" / split / "mask"
        img_dir.mkdir(parents=True)
        mask_dir.mkdir(parents=True)
        for i in range(n):
            img = rng.integers(0, 200, (size, size, 3), dtype=np.uint8)
            cy, cx = rng.integers(size // 3, 2 * size // 3, 2)
            mask = (((yy - cy) ** 2 + (xx - cx) ** 2) < 40).astype(np.uint8) * 255
            img[mask > 0] = 230
            cv2.imwrite(str(img_dir / f"ISIC_{split}{i}.png"), img)
            cv2.imwrite(str(mask_dir / f"ISIC_{split}{i}_segmentation.png"), mask)


def _import_to_jax(pth, arch, kw, output_dir, name):
    """convert.py --pth: a port model.pth into a JAX capsule."""
    return jax_convert.main(["--pth", str(pth), "--arch", arch, "--arch_kwargs", kw,
                             "--input_w", "32", "--input_h", "32", "--dataset", "ISIC",
                             "--name", name, "--output_dir", str(output_dir),
                             "--platform", "cpu"])


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("canet_cli")
    _write_isic(root / "inputs")
    return root


def _common(root):
    return ["--data_dir", str(root / "inputs"), "--input_w", "32", "--input_h", "32",
            "--img_ext", ".png", "--arch_kwargs", CANET_KW, "--precision", "fp32",
            "--epochs", "1"]


def test_log_csv_matches_the_jax_train_canet(folder):
    """The preset through both CLIs from one init (the port's, with the
    BN-fed conv biases at 0, imported into a JAX capsule): 3 SGD steps and a
    validation; loss, IoU and their val counterparts within 1e-4, lr exact;
    config.yml names the preset's arch, batch size and layout."""
    root = folder
    init = root / "init_port"
    init.mkdir()
    model = create_model("Comprehensive_Atten_Unet", 1, 3, False, feature_scale=16,
                         drop_rate=0, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():  # BN-fed conv biases at 0 (test_torch_crdn.py's reason)
        for name, p in model.named_parameters():
            if name.endswith(("conv.0.bias", "conv.3.bias", "W.0.bias",
                              "combine_gates.0.bias")):
                p.zero_()
    torch.save(model.state_dict(), init / "model.pth")
    _import_to_jax(init / "model.pth", "Comprehensive_Atten_Unet", CANET_KW,
                   root / "jax_models", "init_jax")
    jax_train_canet.main(_common(root) + ["--output_dir", str(root / "jax_models"),
                                          "--init_from", "init_jax", "--platform", "cpu"])
    r = ptrain_canet.main(_common(root) + ["--output_dir", str(root / "port_models"),
                                           "--init_from", str(init), "--device", "cpu"])
    assert len(r["log"]["loss"]) == 1
    port = pd.read_csv(root / "port_models" / NAME / "log.csv")
    ref = pd.read_csv(root / "jax_models" / NAME / "log.csv")
    assert list(port.columns) == list(ref.columns) and len(port) == len(ref) == 1
    np.testing.assert_allclose(port["lr"], ref["lr"], rtol=1e-12)
    for col in ("loss", "iou", "val_loss", "val_iou"):
        np.testing.assert_allclose(port[col], ref[col], atol=1e-4, rtol=0, err_msg=col)
    config = load_config(str(root / "port_models" / NAME))
    assert (config["arch"], config["batch_size"], config["dataset_layout"],
            config["input_w"], config["img_ext"]) == (
        "Comprehensive_Atten_Unet", 2, "isic", 32, ".png")


def test_preset_yields_to_given_flags():
    """A flag given overrides the preset, in its short form too (-b, -a);
    unknown arch options still raise. The JAX package's preset appends its
    --batch_size 2 after a given -b 4, so its CLI trains at batch 2 (the
    reference's train_Canet.py takes -b: ROADMAP.md queue 3)."""
    cfg = ptrain.parse_args(ptrain_canet._with_defaults(["-b", "4"], ptrain_canet.PRESET))
    assert (cfg["batch_size"], cfg["arch"], cfg["input_w"], cfg["img_ext"]) == (
        4, "Comprehensive_Atten_Unet", 256, ".jpg")
    jax_cfg = jax_train.parse_args(jax_with_defaults(["-b", "4"], jax_train_canet.PRESET))
    assert jax_cfg["batch_size"] == 2
    cfg = ptrain.parse_args(ptrain_canet._with_defaults(["-a", "AttU_Net", "--input_w=64"],
                                                        ptrain_canet.PRESET))
    assert (cfg["arch"], cfg["input_w"], cfg["batch_size"]) == ("AttU_Net", 64, 2)
    with pytest.raises(ValueError, match="no option"):
        parse_arch_kwargs("Comprehensive_Atten_Unet", '{"filters": [4]}')


@pytest.mark.parametrize("given", [["-b4", "-aUNet"], ["--batch", "4", "-aUNet"],
                                   ["--batch=4", "-a", "UNet"]])
@pytest.mark.parametrize("preset", ["train_isic", "train_isic_wacc", "train_canet",
                                    "train_isic_ca"])
def test_presets_keep_every_spelling_of_a_given_flag(preset, given, monkeypatch):
    """What a preset counts as given is what the trainer's own parser reads:
    `-b4`, `--batch 4` (an abbreviation), `--batch=4` and `-aUNet` keep
    batch 4 and UNet under all four presets, which still set the rest (the
    ISIC layout; train_isic_wacc's --log_acc)."""
    seen = []
    monkeypatch.setattr(ptrain, "main", seen.append)
    importlib.import_module(f"pytorch_nested_unet_tpu_torch.{preset}").main(given)
    cfg = ptrain.parse_args(seen[0])
    assert (cfg["batch_size"], cfg["arch"]) == (4, "UNet")
    assert (cfg["dataset"], cfg["dataset_layout"], cfg["augment"]) == ("ISIC", "isic", "none")
    assert cfg["log_acc"] == (preset == "train_isic_wacc")


def test_attu_net_capsule_converts_to_jax(folder):
    """A port AttU_Net capsule (1 epoch of train.main on the ISIC folder),
    imported by the root convert.py --pth: the JAX capsule's probabilities
    equal the port's within 1e-4 on new images."""
    root = folder
    r = ptrain.main(["--dataset", "ISIC", "--dataset_layout", "isic", "--data_dir",
                     str(root / "inputs"), "--img_ext", ".png", "--input_w", "32",
                     "--input_h", "32", "-b", "2", "--arch", "AttU_Net", "--arch_kwargs",
                     ATTU_KW, "--precision", "fp32", "--epochs", "1", "--augment", "none",
                     "--output_dir", str(root / "attu"), "--device", "cpu"])
    pth = root / "attu" / "ISIC_AttU_Net_woDS" / "model.pth"
    assert pth.is_file() and len(r["log"]["loss"]) == 1
    _import_to_jax(pth, "AttU_Net", ATTU_KW, root / "attu_jax", "attu_jax")
    jm, variables, config = jax_load_capsule(str(root / "attu_jax" / "attu_jax"), False)
    assert config["arch"] == "AttU_Net"
    images = np.random.default_rng(3).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    ref = np.asarray(jax_make_predict_fn(jm, False)(variables["params"],
                                                    variables["batch_stats"], images))
    got = Predictor("AttU_Net", batch_size=3, weights=str(pth), device="cpu",
                    arch_kwargs=ATTU_KW).predict_u8(images)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
