"""The port's PSP hybrids (UNetRNNPSP, UNetRNNCAttention_PSP), their weight
carriers and `--pretrained_backbone` graft, the `train_isic_ca` preset, and
`val --refine` / `infer --refine`, against the JAX package on the CPU.

The hybrids run at feature_scale 16 (the UNetRNN trunk's filters 4..64) and
32x32, with the full 67.7M-parameter refinement network. JAX variables are
drawn from a numpy seed (`test_torch_crdn.jax_variables`) and carried over
by `state_dict_from_jax`. The CLIs run on `test_torch_cli.py`'s 32x32
folder and NestedUNet capsule (nb_filter 4..64), the refinement weights
seeded JAX variables exported once to an `.npz` both CLIs read.
"""

import importlib

import cv2
import jax
import numpy as np
import pytest
import torch

import infer as jax_infer
import val as jax_val
from pytorch_nested_unet_tpu import refinement as jref
from pytorch_nested_unet_tpu.models import create_model as jax_create_model
from pytorch_nested_unet_tpu.utils import pretrained as jax_pretrained
from pytorch_nested_unet_tpu.utils.torch_convert import converters_for_arch
from pytorch_nested_unet_tpu_torch import infer as pinfer
from pytorch_nested_unet_tpu_torch import train as ptrain
from pytorch_nested_unet_tpu_torch import val as pval
from pytorch_nested_unet_tpu_torch.infer import Predictor
from pytorch_nested_unet_tpu_torch.models import arch_names, create_model
from pytorch_nested_unet_tpu_torch.utils.config import load_config
from pytorch_nested_unet_tpu_torch.utils.convert import load_reference_pth, state_dict_from_jax
from pytorch_nested_unet_tpu_torch.utils.pretrained import (find_trunk_scopes, graft_trunk,
                                                            load_pretrained_backbone)
from test_pretrained_backbone import fake_torchvision_sd
from test_torch_canet_cli import _write_isic
from test_torch_cli import NAME, _common, _import_to_jax, _write_set
from test_torch_crdn import jax_variables
from test_torch_pretrained import R50_TENSORS

ARCHS = ("UNetRNNPSP", "UNetRNNCAttention_PSP")
FS = 16
RM_PARAMS = 67_683_433


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


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(arch, the JAX model, its seeded variables, the port model loaded
    strict from them in eval mode)."""
    arch = request.param
    jm = jax_create_model(arch, 1, 3, False, feature_scale=FS)
    variables = jax_variables(jm, (2, 32, 32, 3), 1)
    tm = create_model(arch, 1, 3, False, feature_scale=FS)
    tm.load_state_dict(state_dict_from_jax(variables, arch), strict=True)
    return arch, jm, variables, tm.eval()


def test_eval_forward_matches_jax(pair):
    """The f32 eval forward (RDC decode, then the 3-pass cascade on the image
    and h5) equals the JAX package's within 1e-4 on a (2, 32, 32, 3) input."""
    arch, jm, variables, tm = pair
    x = np.random.default_rng(2).standard_normal((2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, x))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 32, 32, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_parameter_count_and_psp_keys(pair):
    """UNetRNN's parameters (plus CAM's 5 gammas) + the refinement
    network's 67,683,433, as in the JAX package; the `psp` subtree carries
    the released CascadePSP keys, the same that the JAX package's own
    exporter gives it."""
    arch, _, variables, tm = pair
    base = sum(p.numel() for p in create_model("UNetRNN", feature_scale=FS).parameters())
    n = sum(p.numel() for p in tm.parameters())
    assert n == base + RM_PARAMS + (5 if "CAttention" in arch else 0)
    assert n == sum(int(np.prod(p.shape)) for p in jax.tree.leaves(variables["params"]))
    want = jref.export_torch_style_state_dict(
        {c: variables[c]["psp"] for c in ("params", "batch_stats")})
    got = {k[len("psp."):]: v for k, v in state_dict_from_jax(variables, arch).items()
           if k.startswith("psp.")}
    assert sorted(got) == sorted(want) and len(got) == 361
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_multiclass_raises(arch):
    with pytest.raises(ValueError, match="num_classes=1"):
        create_model(arch, num_classes=2, feature_scale=FS)


def test_both_archs_are_registered():
    assert len(arch_names()) == 25 and set(ARCHS) <= set(arch_names())


def test_reference_pth_keeps_the_refinement_init(pair, tmp_path, capsys):
    """A reference checkpoint (the JAX package's export drops `psp`: the
    reference builds that net inside forward) loads with the trunk from the
    file and the refinement tensors from the model's own init, as the root
    convert.py synthesizes them, with its note printed; Predictor serves it."""
    arch, _, variables, tm = pair
    ref_sd = converters_for_arch(arch)[1](variables)
    assert not any(k.startswith("psp.") for k in ref_sd)
    path = tmp_path / "model.pth"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in ref_sd.items()}, path)
    fresh = create_model(arch, feature_scale=FS)
    sd = load_reference_pth(path, arch, init=fresh.state_dict())
    assert "synthesized 361 refinement tensors" in capsys.readouterr().out
    assert sorted(sd) == sorted(fresh.state_dict())
    trunk = state_dict_from_jax(variables, arch)
    for k, v in sd.items():
        want = fresh.state_dict()[k] if k.startswith("psp.") else trunk[k]
        assert torch.equal(v, want), k
    images = np.random.default_rng(3).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    probs = Predictor(arch, batch_size=2, weights=str(path), device="cpu",
                      arch_kwargs={"feature_scale": FS}).predict_u8(images)
    assert probs.shape == (2, 32, 32, 1) and np.isfinite(probs).all()


def test_pretrained_backbone_grafts_into_the_refinement_trunk(tmp_path):
    """The torchvision-format ResNet-50 into `psp.feats` equals the JAX
    package's graft into ('psp', 'feats') of the same variables, key for
    key: the 3-channel stem zero-padded to the refinement stem's 6."""
    arch = "UNetRNNPSP"
    path = tmp_path / "resnet50.pth"
    sd = fake_torchvision_sd(seed=4)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    jm = jax_create_model(arch, 1, 3, False, feature_scale=FS)
    variables = jax_variables(jm, (2, 32, 32, 3), 5)
    grafted_j, n_j = jax_pretrained.graft_trunk(
        variables, jax_pretrained.load_pretrained_backbone(str(path)), ("psp", "feats"))
    want = state_dict_from_jax(grafted_j, arch)
    tm = create_model(arch, feature_scale=FS)
    tm.load_state_dict(state_dict_from_jax(variables, arch), strict=True)
    assert find_trunk_scopes(tm) == ["psp.feats"]
    got, n = graft_trunk(tm, load_pretrained_backbone(path), "psp.feats")
    # the JAX package's count adds a line for the zero-padded stem
    assert n == R50_TENSORS == n_j - 1 and sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    w = got["psp.feats.conv1.weight"]
    np.testing.assert_array_equal(w[:, :3].numpy(), sd["conv1.weight"])
    assert w.shape == (64, 6, 7, 7) and not w[:, 3:].any()


def test_train_isic_ca_trains_a_hybrid_from_a_pretrained_trunk(tmp_path, capsys):
    """The train_isic_ca preset trains UNetRNNPSP (batch 2, 32x32, fp32) for
    one epoch on an ISIC-layout PNG folder with --pretrained_backbone: the
    trunk lands in the refinement net, the log is finite, config.yml holds
    the preset's layout and the flag."""
    _write_isic(tmp_path / "inputs")
    path = tmp_path / "resnet50.pth"
    torch.save({k: torch.from_numpy(v) for k, v in fake_torchvision_sd(seed=6).items()}, path)
    preset = importlib.import_module("pytorch_nested_unet_tpu_torch.train_isic_ca")
    r = preset.main(["--data_dir", str(tmp_path / "inputs"), "--output_dir",
                     str(tmp_path / "models"), "--img_ext", ".png", "--input_w", "32",
                     "--input_h", "32", "-b", "2", "--arch", "UNetRNNPSP", "--arch_kwargs",
                     '{"feature_scale": 16}', "--precision", "fp32", "--epochs", "1",
                     "--pretrained_backbone", str(path), "--device", "cpu"])
    assert f"pretrained backbone: {R50_TENSORS} tensors -> psp.feats" in capsys.readouterr().out
    assert len(r["log"]["loss"]) == 1 and np.isfinite(r["log"]["val_loss"]).all()
    config = load_config(str(tmp_path / "models" / "ISIC_UNetRNNPSP_woDS"))
    assert (config["arch"], config["dataset_layout"], config["pretrained_backbone"]) == (
        "UNetRNNPSP", "isic", str(path))


# ---------------------------------------------------------------- the CLIs


@pytest.fixture(scope="module")
def capsules(tmp_path_factory):
    """test_torch_cli's folder and NestedUNet capsule (1 epoch of the port's
    train.main), the capsule imported into a JAX capsule, and seeded
    refinement weights as an .npz."""
    root = tmp_path_factory.mktemp("refine_cli")
    _write_set(root / "inputs" / "synth")
    ptrain.main(_common(root) + ["--epochs", "1", "--output_dir", str(root / "port_models"),
                                 "--device", "cpu"])
    _import_to_jax(root / "port_models" / NAME / "model.pth", root / "jax_models", "conv")
    npz = root / "cascadepsp.npz"
    variables = jax_variables(jref.RefinementModule(), ((1, 32, 32, 3), (1, 32, 32, 1)), 7)
    np.savez(npz, **jref.export_torch_style_state_dict(variables))
    return root, npz


def _golden_rule(got, want, what):
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99, (what, diff.max(),
                                                            (diff == 0).mean())


@pytest.mark.parametrize("fast", [False, True])
def test_val_refine_matches_jax_val(capsules, capsys, fast):
    """`val --refine` (class 0 of each image refined before scoring) on the
    same capsule and weights: the IoU within 1e-4 of the JAX CLI's, the same
    warning without --refine_weights."""
    root, npz = capsules
    flags = ["--refine", "true", "--refine_weights", str(npz), "--refine_L", "32",
             "--refine_fast", str(fast).lower()]
    iou = pval.main(["--name", NAME, "--data_dir", str(root / "inputs"), "--output_dir",
                     str(root / "port_models"), "--save_dir", str(root / "port_val"),
                     "-b", "4", "--device", "cpu"] + flags)
    ref = jax_val.main(["--name", "conv", "--data_dir", str(root / "inputs"), "--output_dir",
                        str(root / "jax_models"), "--save_dir", str(root / "jax_val"),
                        "-b", "4", "--platform", "cpu"] + flags)
    assert abs(iou - ref) <= 1e-4
    assert "random-initialized" not in capsys.readouterr().out
    if fast:
        pval.main(["--name", NAME, "--data_dir", str(root / "inputs"), "--output_dir",
                   str(root / "port_models"), "--save_dir", str(root / "port_val_init"),
                   "--device", "cpu"] + flags[:2] + flags[4:])
        assert "warning: --refine without --refine_weights" in capsys.readouterr().out
    args = pval.parse_args(["--name", NAME, "--refine", "true"])
    assert (args["refine_L"], args["refine_fast"], args["refine_weights"]) == (900, False, None)


@pytest.mark.parametrize("extra", [[], ["--full_res", "true", "--threshold", "0.5"]])
def test_infer_refine_matches_jax_infer(capsules, extra):
    """`infer --refine` (fast by default) refines each mask before --full_res
    and --threshold: the masks agree with the JAX CLI's by the golden rule
    (within 1 gray level, >= 99% exact)."""
    root, npz = capsules
    serve = root / "serve"
    if not serve.is_dir():
        serve.mkdir()
        rng = np.random.default_rng(9)
        for i, size in enumerate((64, 32, 64)):
            img = rng.integers(0, 120, (size, size, 3), dtype=np.uint8)
            img[size // 4: size // 2, size // 4: 3 * size // 4] = 230
            cv2.imwrite(str(serve / f"x{i}.png"), img)
    tag = "thr" if extra else "prob"
    flags = ["--refine", "true", "--refine_weights", str(npz), "--refine_L", "32"] + extra
    s = pinfer.main(["--name", NAME, "--input_dir", str(serve), "--output_dir",
                     str(root / "port_models"), "--save_dir", str(root / f"port_{tag}"),
                     "-b", "2", "--device", "cpu"] + flags)
    jax_infer.main(["--name", "conv", "--input_dir", str(serve), "--output_dir",
                    str(root / "jax_models"), "--save_dir", str(root / f"jax_{tag}"), "-b", "2",
                    "--platform", "cpu"] + flags)
    assert s["written"] == 3
    for i in range(3):
        got = cv2.imread(str(root / f"port_{tag}" / NAME / "0" / f"x{i}.png"), 0)
        want = cv2.imread(str(root / f"jax_{tag}" / "conv" / "0" / f"x{i}.png"), 0)
        assert got.shape == want.shape
        _golden_rule(got, want, (tag, i))
    assert pinfer.parse_args(["--refine", "true"]).refine_fast is True
