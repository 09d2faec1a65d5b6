"""The port's reference protocol from image folders (train -> resume -> val ->
infer, the ISIC preset) held against the JAX package's CLIs from the same
weights, on the CPU at a narrow width (nb_filter 4..64, 32x32, batch 4)."""

import argparse
import csv
import json
import os

import cv2
import numpy as np
import pandas as pd
import pytest
import torch

import convert as jax_convert
import infer as jax_infer
import train as jax_train
import val as jax_val
from pytorch_nested_unet_tpu.utils.config import load_config as jax_load_config
from pytorch_nested_unet_tpu.utils.config import str2bool as jax_str2bool
from pytorch_nested_unet_tpu_torch import infer as pinfer
from pytorch_nested_unet_tpu_torch import train as ptrain
from pytorch_nested_unet_tpu_torch import train_isic as ptrain_isic
from pytorch_nested_unet_tpu_torch import val as pval
from pytorch_nested_unet_tpu_torch.infer import Predictor
from pytorch_nested_unet_tpu_torch.models import create_model
from pytorch_nested_unet_tpu_torch.utils.config import load_config, str2bool

KW = '{"nb_filter": [4, 8, 16, 32, 64]}'
NAME = "synth_NestedUNet_wDS"
# flags of the JAX CLI the port does not have (ROADMAP.md queue 1)
JAX_ONLY = {"fused_bn", "fused_bn_mode", "platform"}


def _write_set(root, n=14, size=32):
    rng = np.random.default_rng(7)
    img_dir, mask_dir = root / "images", root / "masks" / "0"
    img_dir.mkdir(parents=True)
    mask_dir.mkdir(parents=True)
    yy, xx = np.mgrid[0:size, 0:size]
    for i in range(n):
        img = rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
        cy, cx = rng.integers(size // 3, 2 * size // 3, 2)
        mask = (((yy - cy) ** 2 + (xx - cx) ** 2) < 25).astype(np.uint8) * 255
        img[mask > 0] = 220
        cv2.imwrite(str(img_dir / f"im{i:02d}.png"), img)
        cv2.imwrite(str(mask_dir / f"im{i:02d}.png"), mask)


def _common(root):
    return ["--dataset", "synth", "--data_dir", str(root / "inputs"), "--input_w", "32",
            "--input_h", "32", "-b", "4", "--precision", "fp32", "--arch", "NestedUNet",
            "--deep_supervision", "true", "--arch_kwargs", KW, "--augment", "none"]


def _import_to_jax(pth, output_dir, name):
    """convert.py --pth: a port model.pth into a JAX capsule."""
    return jax_convert.main(["--pth", str(pth), "--arch", "NestedUNet", "--deep_supervision",
                             "true", "--arch_kwargs", KW, "--input_w", "32", "--input_h", "32",
                             "--dataset", "synth", "--name", name, "--output_dir",
                             str(output_dir), "--platform", "cpu"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs trained 2 epochs on one folder from one init: the port's
    random init, written as model.pth and imported into a JAX capsule."""
    root = tmp_path_factory.mktemp("cli")
    _write_set(root / "inputs" / "synth")
    init = root / "init_port"
    init.mkdir()
    model = create_model("NestedUNet", 1, 3, True, nb_filter=(4, 8, 16, 32, 64),
                         generator=torch.Generator().manual_seed(3))
    with torch.no_grad():  # BN-fed conv biases at 0 (test_torch_training.py's reason)
        for name, p in model.named_parameters():
            if name.endswith(("conv1.bias", "conv2.bias")):
                p.zero_()
    torch.save(model.state_dict(), init / "model.pth")
    _import_to_jax(init / "model.pth", root / "jax_models", "init_jax")
    common = _common(root) + ["--epochs", "2"]
    jax_train.main(common + ["--output_dir", str(root / "jax_models"), "--init_from",
                             "init_jax", "--platform", "cpu"])
    port = ptrain.main(common + ["--output_dir", str(root / "port_models"), "--init_from",
                                 str(init), "--device", "cpu"])
    return root, port


def test_log_csv_matches_the_jax_cli(runs):
    """Same columns; loss, IoU and their val counterparts within 1e-4 after
    2 epochs (4 SGD steps and 2 validations; the BN-fed conv biases start at
    0, else the first BN's variance cancels ~1,000-fold and the IoU, which
    counts logits above 0, measures summation order: 1.4e-3 apart), lr
    exact. pandas and csv read the port's log.csv to the same floats."""
    root, _ = runs
    port = pd.read_csv(root / "port_models" / NAME / "log.csv")
    ref = pd.read_csv(root / "jax_models" / NAME / "log.csv")
    assert list(port.columns) == list(ref.columns) and len(port) == len(ref) == 2
    np.testing.assert_array_equal(port["epoch"], ref["epoch"])
    np.testing.assert_allclose(port["lr"], ref["lr"], rtol=1e-12)
    for col in ("loss", "iou", "val_loss", "val_iou"):
        np.testing.assert_allclose(port[col], ref[col], atol=1e-4, rtol=0, err_msg=col)
    # csv.DictReader (the JAX package's plot.py) reads the same values as pandas
    with open(root / "port_models" / NAME / "log.csv") as f:
        rows = list(csv.DictReader(f))
    for col in port.columns:
        assert [float(r[col]) for r in rows] == list(port[col].astype(float))


def test_config_yml_has_the_jax_cli_keys(runs):
    root, _ = runs
    port = load_config(str(root / "port_models" / NAME))
    ref = jax_load_config(str(root / "jax_models" / NAME))
    assert set(port) - set(ref) == {"device"}
    assert set(ref) - set(port) == JAX_ONLY
    for k in set(ref) - JAX_ONLY - {"output_dir", "init_from"}:
        assert port[k] == ref[k], k
    for f in ("config.yml", "log.csv", "model.pth", "last.pth"):
        assert (root / "port_models" / NAME / f).is_file()


def test_resume_keeps_rows_and_checks_the_optimizer(runs):
    root, _ = runs
    run_dir = root / "port_models" / NAME
    with open(run_dir / "log.csv") as f:
        before = list(csv.reader(f))
    argv = _common(root) + ["--output_dir", str(root / "port_models"), "--device", "cpu"]
    summary = ptrain.main(argv + ["--epochs", "3", "--resume", "true"])
    with open(run_dir / "log.csv") as f:
        after = list(csv.reader(f))
    assert after[:3] == before and len(after) == 4 and after[3][0] == "2"
    assert len(summary["train_s"]) == 1
    with pytest.raises(SystemExit, match="optimizer"):
        ptrain.main(argv + ["--epochs", "4", "--resume", "true", "--optimizer", "Adam"])
    with pytest.raises(SystemExit, match=r"final\d?\.weight: capsule \(1, 4, 1, 1\) vs model "
                                         r"\(2, 4, 1, 1\)"):
        ptrain.main(argv + ["--epochs", "1", "--num_classes", "2", "--name", "nc2",
                            "--init_from", NAME])


def test_profile_traces_the_first_epoch_only(runs, tmp_path, capsys):
    """--profile DIR: one chrome trace of the training part of the first
    epoch the run trains (epoch 0, or the resumed epoch), its host
    operators in it."""
    root, _ = runs
    argv = _common(root) + ["--output_dir", str(tmp_path), "--name", "prof", "--device", "cpu"]
    ptrain.main(argv + ["--epochs", "2", "--profile", str(tmp_path / "trace")])
    assert f"profiler trace written to {tmp_path / 'trace'}" in capsys.readouterr().out
    assert os.listdir(tmp_path / "trace") == ["epoch0.pt.trace.json"]
    with open(tmp_path / "trace" / "epoch0.pt.trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::convolution" in names and "BNReLUTrain" in names
    ptrain.main(argv + ["--epochs", "3", "--resume", "true", "--profile",
                        str(tmp_path / "resumed")])
    assert os.listdir(tmp_path / "resumed") == ["epoch2.pt.trace.json"]
    assert load_config(str(tmp_path / "prof"))["profile"] == str(tmp_path / "resumed")


def test_val_matches_jax_val(runs, capsys):
    root, _ = runs
    _import_to_jax(root / "port_models" / NAME / "model.pth", root / "jax_conv", "conv")
    iou = pval.main(["--name", NAME, "--data_dir", str(root / "inputs"), "--output_dir",
                     str(root / "port_models"), "--save_dir", str(root / "port_val"),
                     "-b", "4", "--device", "cpu"])
    assert f"IoU: {iou:.4f}" in capsys.readouterr().out
    ref = jax_val.main(["--name", "conv", "--data_dir", str(root / "inputs"), "--output_dir",
                        str(root / "jax_conv"), "--save_dir", str(root / "jax_val"),
                        "-b", "4", "--platform", "cpu"])
    assert abs(iou - ref) <= 1e-5
    written = sorted(os.listdir(root / "port_val" / NAME / "0"))
    assert written == sorted(os.listdir(root / "jax_val" / "conv" / "0"))
    assert len(written) == 3 and all(w.endswith(".jpg") for w in written)


def test_infer_matches_jax_infer(runs, capsys):
    """Masks within 1 LSB of the JAX CLI's from the same weights; thresholded
    masks equal but where either CLI's probability mask reads 127 (the
    probability lies within 1/255 of the 0.5 threshold). The served images
    are 64x64 (and one 32x32): an exact 2x downscale, which cv2 and the
    port's library compute alike."""
    root, _ = runs
    if not (root / "jax_conv" / "conv").is_dir():
        _import_to_jax(root / "port_models" / NAME / "model.pth", root / "jax_conv", "conv")
    serve = root / "serve"
    serve.mkdir()
    rng = np.random.default_rng(9)
    for i, size in enumerate((64, 64, 64, 32, 64)):
        cv2.imwrite(str(serve / f"x{i}.png"), rng.integers(0, 256, (size, size, 3), np.uint8))
    (serve / "broken.png").write_bytes(b"not an image")
    masks = {}
    for tag, extra in (("prob", []), ("full", ["--full_res", "true"]),
                       ("thr", ["--threshold", "0.5"]),
                       ("full_thr", ["--full_res", "true", "--threshold", "0.5"])):
        s = pinfer.main(["--name", NAME, "--input_dir", str(serve), "--output_dir",
                         str(root / "port_models"), "--save_dir", str(root / f"port_{tag}"),
                         "-b", "2", "--device", "cpu"] + extra)
        out = capsys.readouterr().out
        assert "unreadable image skipped" in out and "img/s end-to-end" in out
        assert s["written"] == 5 and s["unreadable"] == 1 and s["batches"] == 3
        jax_infer.main(["--name", "conv", "--input_dir", str(serve), "--output_dir",
                        str(root / "jax_conv"), "--save_dir", str(root / f"jax_{tag}"), "-b",
                        "2", "--platform", "cpu"] + extra)
        for i in range(5):
            got = cv2.imread(str(root / f"port_{tag}" / NAME / "0" / f"x{i}.png"), 0)
            want = cv2.imread(str(root / f"jax_{tag}" / "conv" / "0" / f"x{i}.png"), 0)
            masks[tag, i] = got, want
            assert got.shape == want.shape == ((64, 64) if "full" in tag and i != 3
                                               else (32, 32))
            if "thr" not in tag:
                assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, (tag, i)
    for tag in ("thr", "full_thr"):
        for i in range(5):
            got, want = masks[tag, i]
            prob = masks["prob" if tag == "thr" else "full", i]
            near = (prob[0] == 127) | (prob[1] == 127)
            assert set(np.unique(got)) <= {0, 255}
            np.testing.assert_array_equal(got[~near], want[~near], err_msg=f"{tag} {i}")


def test_predictor_from_capsule_serves_like_model_pth(runs):
    root, port = runs
    images = np.random.default_rng(2).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    pred, config = Predictor.from_capsule(str(root / "port_models" / NAME), batch_size=2,
                                          device="cpu")
    ref = Predictor("NestedUNet", 1, 3, True, batch_size=2, device="cpu", arch_kwargs=KW,
                    weights=str(root / "port_models" / NAME / "model.pth"))
    assert config["arch_kwargs"] == KW and pred.num_classes == 1
    np.testing.assert_array_equal(pred.predict_u8(images), ref.predict_u8(images))


def test_host_pipeline_trains_like_the_device_pipeline(runs):
    """--pipeline host decodes the same batches in the same order: the same
    log at one epoch."""
    root, _ = runs
    logs = []
    for pipeline in ("device", "host"):
        r = ptrain.main(_common(root) + ["--output_dir", str(root / "pipelines"), "--epochs",
                                         "1", "--pipeline", pipeline, "--name", pipeline,
                                         "--device", "cpu", "--augment", "full"])
        logs.append(r["log"])
    assert logs[0] == logs[1]


def test_folder_cli_exits_on_empty_or_small_sets(tmp_path):
    (tmp_path / "inputs" / "empty" / "images").mkdir(parents=True)
    base = ["--data_dir", str(tmp_path / "inputs"), "--output_dir", str(tmp_path / "m"),
            "--device", "cpu", "--arch_kwargs", KW, "--input_w", "32", "--input_h", "32"]
    with pytest.raises(SystemExit, match="no images found"):
        ptrain.main(base + ["--dataset", "empty"])
    _write_set(tmp_path / "inputs" / "small", n=5)
    with pytest.raises(SystemExit, match="batch_size 16 exceeds"):
        ptrain.main(base + ["--dataset", "small"])
    # what the JAX CLI refuses is refused with a message, never run on one
    # process in silence: an axis the JAX package does not have; under the
    # 'x'/'y' axes a height x does not divide; --spatial_partition on an odd
    # process count; and a 'model' axis the processes do not cover
    # (tests/test_torch_model_axis.py runs it). What the JAX CLI accepts, the
    # mesh check accepts: bands that the 4 pools split (32 rows over x=4),
    # ResNet50FCN, a CRDN UNet's coarsest band thinner than its 5x5 score
    # convs' halo (32 rows over x=2: 1 row)
    with pytest.raises(SystemExit, match="'pipe' mesh axis is not ported"):
        ptrain.main(base + ["--dataset", "small", "--mesh", "data=1,pipe=2"])
    for flags in (["--mesh", "x=4"], ["--mesh", "x=2", "--arch", "ResNet50FCN"],
                  ["--mesh", "x=2", "--arch", "UNetRNN"]):
        config = ptrain.parse_args(base + ["--dataset", "small"] + flags)
        assert ptrain._mesh_axes(config) == (("x",), (int(flags[1][2:]),))
    with pytest.raises(SystemExit, match="multiple of x = 3"):
        ptrain.main(base + ["--dataset", "small", "--mesh", "x=3"])
    with pytest.raises(SystemExit, match="--spatial_partition needs an even process count"):
        ptrain.main(base + ["--dataset", "small", "--spatial_partition", "true"])
    for spec in ("data=2", "data=1,model=2"):
        with pytest.raises(SystemExit, match="needs 2 processes, have 1"):
            ptrain.main(base + ["--dataset", "small", "--mesh", spec])
    with pytest.raises(SystemExit):  # nor --fused_bn: the port's BN always runs K1-K3
        ptrain.parse_args(base + ["--fused_bn", "true"])


def test_isic_preset_trains_on_a_jpeg_folder(tmp_path):
    rng = np.random.default_rng(11)
    for split, n in (("train", 6), ("test", 2)):
        img_dir = tmp_path / "inputs" / "ISIC" / split / "image"
        mask_dir = tmp_path / "inputs" / "ISIC" / split / "mask"
        img_dir.mkdir(parents=True)
        mask_dir.mkdir(parents=True)
        for i in range(n):
            cv2.imwrite(str(img_dir / f"ISIC_{split}{i}.jpg"),
                        rng.integers(0, 256, (40, 48, 3), dtype=np.uint8))
            cv2.imwrite(str(mask_dir / f"ISIC_{split}{i}_segmentation.png"),
                        (rng.random((40, 48)) > 0.5).astype(np.uint8) * 255)
    r = ptrain_isic.main(["--data_dir", str(tmp_path / "inputs"), "--output_dir",
                          str(tmp_path / "models"), "--epochs", "1", "-b", "2", "--input_w",
                          "32", "--input_h", "32", "--arch", "UNet", "--arch_kwargs", KW,
                          "--precision", "fp32", "--device", "cpu"])
    run_dir = tmp_path / "models" / "ISIC_UNet_woDS"
    config = load_config(str(run_dir))
    assert (config["dataset_layout"], config["img_ext"], config["augment"]) == (
        "isic", ".jpg", "none")
    assert len(r["log"]["loss"]) == 1 and np.isfinite(r["log"]["loss"][0])


STR2BOOL_INPUTS = ["yes", "true", "t", "y", "1", "no", "false", "f", "n", "0",
                   "Yes", "TRUE", "T", "Y", "No", "FALSE", "F", "N"]


def test_str2bool_matches_the_jax_cli():
    """Every string the JAX CLI's str2bool accepts, through the port's, and
    through the port's CLIs' boolean flags."""
    for v in STR2BOOL_INPUTS:
        assert str2bool(v) is jax_str2bool(v), v
        assert ptrain.parse_args(["--deep_supervision", v])["deep_supervision"] is \
            jax_str2bool(v), v
        assert pinfer.parse_args(["--full_res", v]).full_res is jax_str2bool(v), v
    assert str2bool(True) is True and str2bool(False) is False
    for bad in ("maybe", "2", ""):
        with pytest.raises(argparse.ArgumentTypeError):
            str2bool(bad)
        with pytest.raises(argparse.ArgumentTypeError):
            jax_str2bool(bad)


@pytest.mark.parametrize("value", [None, "false", "True", "t", "0", "full", "POLICY", "maybe"])
def test_remat_flag_parses_as_the_jax_cli(value):
    """--remat takes the JAX CLI's values (booleans plus full / policy, any
    case) to the same config value, defaults to the same False and refuses
    the same others."""
    argv = ["--dataset", "synth"] + ([] if value is None else ["--remat", value])
    if value == "maybe":
        for parse in (jax_train.parse_args, ptrain.parse_args):
            with pytest.raises(SystemExit):
                parse(argv)
        return
    assert ptrain.parse_args(argv)["remat"] == jax_train.parse_args(argv)["remat"]
