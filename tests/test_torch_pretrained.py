"""The port's torchvision-format ResNet trunk import (`utils/pretrained.py`)
and `train --pretrained_backbone`, against the JAX package's
`utils/pretrained.py`.

The torchvision state dicts are written from a numpy seed
(`test_pretrained_backbone.fake_torchvision_sd`: ResNet-50 names and shapes,
an `fc` head); nothing is downloaded. The graft is held against the JAX
package's graft of the same file into the same variables, key for key, and
the grafted models' eval forwards against each other; the CLI runs on the CPU
on a 32x32 folder the test writes.
"""

import numpy as np
import pytest
import torch

from pytorch_nested_unet_tpu.models import create_model as jax_create_model
from pytorch_nested_unet_tpu.utils import pretrained as jax_pretrained
from pytorch_nested_unet_tpu_torch import train as ptrain
from pytorch_nested_unet_tpu_torch.data import image_io
from pytorch_nested_unet_tpu_torch.models import create_model
from pytorch_nested_unet_tpu_torch.utils.config import load_config
from pytorch_nested_unet_tpu_torch.utils.convert import state_dict_from_jax
from pytorch_nested_unet_tpu_torch.utils.pretrained import (convert_torchvision_resnet,
                                                            find_trunk_scopes, graft_trunk,
                                                            load_pretrained_backbone)
from test_pretrained_backbone import fake_torchvision_sd
from test_torch_crdn import compare_eval, jax_variables

# a ResNet-50 trunk: 53 conv kernels + 53 BN layers x (weight, bias, running
# mean, running var) (tests/test_pretrained_backbone.py)
R50_TENSORS = 265


def _trunk_key(k):
    return k.split(".")[0] in ("conv1", "bn1", "layer1", "layer2", "layer3", "layer4")


def test_convert_drops_the_head_and_rejects_foreign_keys():
    sd = fake_torchvision_sd()
    sd["bn1.num_batches_tracked"] = np.asarray(7)
    trunk = convert_torchvision_resnet({"module." + k: v for k, v in sd.items()})
    assert len(trunk) == R50_TENSORS
    assert not any(k.startswith("fc.") or k.endswith("num_batches_tracked") for k in trunk)
    assert all(v.dtype == torch.float32 for v in trunk.values())
    np.testing.assert_array_equal(trunk["layer1.0.downsample.0.weight"].numpy(),
                                  sd["layer1.0.downsample.0.weight"])
    with pytest.raises(ValueError, match="unrecognized"):
        convert_torchvision_resnet({**sd, "layer5.0.conv1.weight": np.zeros((1, 1, 1, 1))})


def test_graft_matches_the_jax_graft_and_serves_the_same(tmp_path):
    """The port's graft of a ResNet-50 file into ResNet50RNN equals the JAX
    package's graft of the same file into the same variables, key for key;
    the rest of the model is left as it was, the model the state dict came
    from is untouched, and both grafted models serve the same."""
    path = tmp_path / "resnet50.pth"
    torch.save({k: torch.from_numpy(v) for k, v in fake_torchvision_sd(seed=3).items()}, path)
    jm = jax_create_model("ResNet50RNN", 1, 3, False)
    variables = jax_variables(jm, (2, 32, 32, 3), 0)
    grafted_j, n_j = jax_pretrained.graft_trunk(
        variables, jax_pretrained.load_pretrained_backbone(str(path)), ("encoder",))
    want = state_dict_from_jax(grafted_j, "ResNet50RNN")

    tm = create_model("ResNet50RNN")
    tm.load_state_dict(state_dict_from_jax(variables, "ResNet50RNN"), strict=True)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    assert find_trunk_scopes(tm) == [""]
    sd, n = graft_trunk(tm, load_pretrained_backbone(path))
    assert n == n_j == R50_TENSORS
    assert sorted(sd) == sorted(want)
    for k, v in want.items():
        assert torch.equal(sd[k], v), k
        assert torch.equal(v, before[k]) != _trunk_key(k), k  # grafted exactly the trunk
    assert all(torch.equal(v, before[k]) for k, v in tm.state_dict().items())
    tm.load_state_dict(sd, strict=True)
    x = np.random.default_rng(4).standard_normal((2, 32, 32, 3)).astype(np.float32)
    compare_eval(jm, grafted_j, tm.eval(), x)


def test_graft_zero_pads_a_wider_stem():
    """A 3-channel conv1 into a 6-channel stem: the extra input channels get
    zeros (reference extractors.py:22-29), as in the JAX package."""
    sd = fake_torchvision_sd()
    tm = create_model("ResNet50RNN", 1, 6, False)
    grafted, n = graft_trunk(tm.state_dict(), convert_torchvision_resnet(sd))
    assert n == R50_TENSORS
    w = grafted["conv1.weight"]
    assert tuple(w.shape) == (64, 6, 7, 7)
    np.testing.assert_array_equal(w[:, :3].numpy(), sd["conv1.weight"])
    assert not w[:, 3:].any()


@pytest.mark.parametrize("arch,kw,error,match", [
    ("ResNet18RNN", {}, ValueError, r"shape mismatch at layer1\.0\.conv1\.weight"),
    ("ResNet50RNN", {"layers": (3, 4, 5, 3)}, KeyError, r"model has no layer3\.5\.")])
def test_graft_into_another_trunk_raises(arch, kw, error, match):
    """ResNet-50 weights into a basic-block trunk or a shallower one fail
    loudly: ValueError on a shape, KeyError on a tensor the model lacks."""
    with pytest.raises(error, match=match):
        graft_trunk(create_model(arch, **kw), convert_torchvision_resnet(fake_torchvision_sd()))


@pytest.mark.parametrize("arch,scopes", [("ResNet50RNN", [""]), ("ResNet18RNN", [""]),
                                         ("ResNet50UNet", [""]), ("VGG16RNN", []),
                                         ("UNetRNN", [])])
def test_find_trunk_scopes(arch, scopes):
    """The ResNet backbones keep their trunk at the root of the state dict;
    the VGG and UNet encoders have none. A trunk under a prefix is found
    there (as a refinement net's would be)."""
    assert find_trunk_scopes(create_model(arch)) == scopes
    nested = {f"psp.feats.{k}": v for k, v in convert_torchvision_resnet(
        fake_torchvision_sd()).items()}
    assert find_trunk_scopes(nested) == ["psp.feats"]
    assert graft_trunk(nested, convert_torchvision_resnet(fake_torchvision_sd(seed=1)),
                       "psp.feats")[1] == R50_TENSORS


def _write_folder(root, n=6, size=32):
    rng = np.random.default_rng(0)
    (root / "images").mkdir(parents=True)
    (root / "masks" / "0").mkdir(parents=True)
    for i in range(n):
        image_io.write_png(str(root / "images" / f"im{i}.png"),
                           rng.integers(0, 255, (size, size, 3), dtype=np.uint8))
        image_io.write_png(str(root / "masks" / "0" / f"im{i}.png"),
                           (rng.random((size, size)) > 0.7).astype(np.uint8) * 255)


def test_train_main_pretrained_backbone(tmp_path, capsys):
    """--pretrained_backbone through train.main on a ResNet arch: the count
    printed, the flag in config.yml under the JAX package's key, the trunk
    in the trained weights (lr 0 keeps them); the npy path (`fit`) takes it
    too; a non-ResNet arch and a trunk of another depth exit."""
    _write_folder(tmp_path / "inputs" / "synth")
    pth = tmp_path / "resnet50_fake.pth"
    sd = fake_torchvision_sd()
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pth)
    argv = ["--data_dir", str(tmp_path / "inputs"), "--output_dir", str(tmp_path / "models"),
            "--dataset", "synth", "--input_w", "32", "--input_h", "32", "--epochs", "1",
            "-b", "4", "--precision", "fp32", "--lr", "0", "--min_lr", "0", "--device", "cpu",
            "--pretrained_backbone", str(pth)]
    summary = ptrain.main(argv + ["--arch", "ResNet50RNN"])
    out = capsys.readouterr().out
    assert f"pretrained backbone: {R50_TENSORS} tensors -> the model root" in out
    run_dir = tmp_path / "models" / "synth_ResNet50RNN_woDS"
    assert load_config(str(run_dir))["pretrained_backbone"] == str(pth)
    last = torch.load(run_dir / "last.pth", weights_only=True)["model"]
    for k in ("conv1.weight", "layer3.2.conv2.weight", "layer4.0.downsample.0.weight"):
        np.testing.assert_array_equal(last[k].numpy(), sd[k])
    assert summary["model"].decoder == "LSTM"

    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 255, (4, 32, 32, 3), dtype=np.uint8)
    masks = (rng.random((4, 32, 32, 1)) > 0.6).astype(np.uint8) * 255
    r = ptrain.fit(imgs, masks, imgs[:2], masks[:2], name="fit_pre",
                   output_dir=str(tmp_path / "models"), epochs=1, batch_size=4,
                   arch="ResNet50RNN", lr=0.0, min_lr=0.0, precision="fp32", device="cpu",
                   arch_kwargs={"decoder": "GRU"}, pretrained_backbone=str(pth))
    np.testing.assert_array_equal(r["model"].layer2[1].conv3.weight.detach().numpy(),
                                  sd["layer2.1.conv3.weight"])

    with pytest.raises(SystemExit, match="no ResNet trunk"):
        ptrain.main(argv + ["--arch", "UNet", "--arch_kwargs",
                            '{"nb_filter": [4, 8, 16, 32, 64]}', "--name", "bad_unet"])
    with pytest.raises(SystemExit, match="--pretrained_backbone: shape mismatch"):
        ptrain.main(argv + ["--arch", "ResNet18RNN", "--name", "bad_depth"])
