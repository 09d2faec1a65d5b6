"""The port's serving artifact (serving.py, export, infer --artifact) against
the JAX package's (serving.py, export.py, infer.py --artifact) from the same
weights, and the registered K4 operator the artifact runs, on the CPU at a
narrow width (nb_filter 4..64, 32x32)."""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

import infer as jax_infer
from pytorch_nested_unet_tpu import serving as jax_serving
from pytorch_nested_unet_tpu.training import checkpoint as jax_checkpoint
from pytorch_nested_unet_tpu.utils import save_config as jax_save_config
from pytorch_nested_unet_tpu.utils.torch_convert import converters_for_arch
from pytorch_nested_unet_tpu_torch import export as pexport
from pytorch_nested_unet_tpu_torch import infer as pinfer
from pytorch_nested_unet_tpu_torch import serving
from pytorch_nested_unet_tpu_torch.infer import Predictor
from pytorch_nested_unet_tpu_torch.models import create_model
from pytorch_nested_unet_tpu_torch.ops import decoder_fusion as df
from pytorch_nested_unet_tpu_torch.utils.config import save_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = '{"nb_filter": [4, 8, 16, 32, 64]}'
NAME = "aot_run"  # NestedUNet wDS, 1 class
UNET = "aot_unet"  # UNet, 2 classes
K4 = torch.ops.nested_unet_torch.multipart_conv3x3.default


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _config(arch, num_classes, ds, name):
    return {"arch": arch, "num_classes": num_classes, "input_channels": 3,
            "deep_supervision": ds, "input_h": 32, "input_w": 32, "dataset": "synth",
            "img_ext": ".png", "mask_ext": ".png", "dataset_layout": "generic",
            "precision": "fp32", "name": name, "loss": "BCEDiceLoss", "arch_kwargs": KW}


@pytest.fixture(scope="module")
def capsules(tmp_path_factory):
    """The port's capsules of NestedUNet wDS and UNet from a seeded init, the
    JAX capsule of the same NestedUNet weights (the JAX package's import of
    the port's state dict) and a folder of 3 images."""
    root = tmp_path_factory.mktemp("aot")
    for arch, nc, ds, name in (("NestedUNet", 1, True, NAME), ("UNet", 2, False, UNET)):
        model = create_model(arch, nc, 3, ds, nb_filter=(4, 8, 16, 32, 64),
                             generator=torch.Generator().manual_seed(3))
        port_dir = root / "port_models" / name
        save_config(_config(arch, nc, ds, name), str(port_dir))
        torch.save(model.state_dict(), port_dir / "model.pth")
        if name == NAME:
            sd = {k: v.numpy() for k, v in model.state_dict().items()}
            variables = converters_for_arch(arch)[0](sd)
            jax_dir = root / "jax_models" / name
            jax_dir.mkdir(parents=True)
            jax_save_config(_config(arch, nc, ds, name), str(jax_dir))
            jax_checkpoint.save_model(str(jax_dir), variables["params"],
                                      variables["batch_stats"])
    raw = root / "raw"
    raw.mkdir()
    rng = np.random.default_rng(1)
    for i in range(3):
        cv2.imwrite(str(raw / f"im{i}.png"), rng.integers(0, 255, (32, 32, 3), np.uint8))
    return root


@pytest.fixture(scope="module")
def exported(capsules):
    """The port's export CLI on the NestedUNet capsule (dynamic batch, cuda
    and cpu, --check true against the live Predictor): (path, printed)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        path = pexport.main(["--name", NAME, "--output_dir", str(capsules / "port_models"),
                             "--device", "cpu", "--check", "true"])
    return path, out.getvalue()


@pytest.fixture(scope="module")
def artifact(exported):
    return exported[0]


@pytest.fixture(scope="module")
def jax_artifact(capsules):
    path, _ = jax_serving.export_capsule(str(capsules / "jax_models" / NAME),
                                         platforms=("cpu",))
    return path


def test_artifact_matches_the_jax_artifact(artifact, jax_artifact):
    """One dynamic artifact of each framework from the same weights: the
    probabilities within 1e-5 at batch 1, 2 and 3; the port's program holds
    the 10 decoder nodes as the registered K4 operator."""
    predict, manifest = serving.load_exported(artifact, "cpu")
    jax_predict, _ = jax_serving.load_exported(jax_artifact)
    rng = np.random.default_rng(0)
    for b in (1, 2, 3):
        images = rng.integers(0, 256, (b, 32, 32, 3), dtype=np.uint8)
        got = predict(images).numpy()
        want = np.asarray(jax_predict(images), np.float32)
        assert got.shape == want.shape == (b, 32, 32, 1)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    program = torch.export.load(artifact)
    assert sum(n.target is K4 for n in program.graph.nodes) == 10


def test_export_cli_roundtrip_and_manifest(capsules, exported, jax_artifact):
    """The CLI writes models/<name>/serving/<name>.pt2 and a manifest with
    the JAX manifest's keys (torch_version and schema_version in place of
    jax_version and calling_convention_version), and its round-trip check
    passes."""
    artifact, printed = exported
    assert "round-trip check ok (batch 2" in printed and "platforms cuda,cpu " in printed
    assert artifact == str(capsules / "port_models" / NAME / "serving" / f"{NAME}.pt2")
    with open(os.path.splitext(artifact)[0] + ".manifest.json") as f:
        manifest = json.load(f)
    with open(os.path.splitext(jax_artifact)[0] + ".manifest.json") as f:
        jax_manifest = json.load(f)
    assert set(manifest) == (set(jax_manifest) - {"jax_version", "calling_convention_version"}
                             | {"torch_version", "schema_version"})
    for k in ("name", "arch", "num_classes", "input_h", "input_w", "input_channels", "img_ext",
              "batch", "input_dtype", "output_dtype", "output"):
        assert manifest[k] == jax_manifest[k], k
    assert manifest["platforms"] == ["cuda", "cpu"]
    assert manifest["artifact_bytes"] == os.path.getsize(artifact)
    assert manifest["torch_version"] == torch.__version__


def test_pinned_batch_rejects_other_sizes(capsules, tmp_path, capsys):
    path, manifest = serving.export_capsule(str(capsules / "port_models" / UNET),
                                            out_path=str(tmp_path / "pinned.pt2"), batch=2,
                                            device="cpu")
    assert manifest["batch"] == 2
    predict, _ = serving.load_exported(path, "cpu")
    assert tuple(predict(np.zeros((2, 32, 32, 3), np.uint8)).shape) == (2, 32, 32, 2)
    with pytest.raises((AssertionError, RuntimeError)):
        predict(np.zeros((3, 32, 32, 3), np.uint8))
    # infer --artifact serves the pinned batch whatever -b says, and says so
    s = pinfer.main(["--artifact", path, "--input_dir", str(capsules / "raw"), "--save_dir",
                     str(tmp_path / "out"), "-b", "4", "--device", "cpu"])
    assert "artifact pins batch=2; overriding --batch_size 4" in capsys.readouterr().out
    assert s["batch_size"] == 2 and s["batches"] == 2 and s["written"] == 6  # 3 x 2 classes


def test_infer_artifact_without_the_capsule(capsules, artifact, jax_artifact, tmp_path,
                                            capsys):
    """infer --artifact from a directory holding the artifact alone (no
    config.yml, no model.pth): the probability masks within 1 LSB of the JAX
    CLI's --artifact masks, the name from the manifest."""
    bare = tmp_path / "bare"
    bare.mkdir()
    for f in (artifact, os.path.splitext(artifact)[0] + ".manifest.json"):
        shutil.copy(f, bare)
    s = pinfer.main(["--artifact", str(bare / f"{NAME}.pt2"), "--input_dir",
                     str(capsules / "raw"), "--save_dir", str(tmp_path / "port"), "-b", "2",
                     "--device", "cpu"])
    assert "img/s end-to-end" in capsys.readouterr().out
    assert s["written"] == 3 and s["batches"] == 2 and s["batch_size"] == 2
    jax_infer.main(["--artifact", jax_artifact, "--input_dir", str(capsules / "raw"),
                    "--save_dir", str(tmp_path / "jax"), "-b", "2", "--platform", "cpu"])
    for i in range(3):
        got = cv2.imread(str(tmp_path / "port" / NAME / "0" / f"im{i}.png"), 0)
        want = cv2.imread(str(tmp_path / "jax" / NAME / "0" / f"im{i}.png"), 0)
        assert got.shape == want.shape == (32, 32)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_manifest_recovered_from_the_artifact_alone(artifact, tmp_path):
    path = tmp_path / "bare.pt2"
    shutil.copy(artifact, path)
    predict, manifest = serving.load_exported(str(path), "cpu")
    assert manifest == {"batch": "dynamic", "input_h": 32, "input_w": 32,
                        "input_channels": 3, "num_classes": 1, "img_ext": ".png",
                        "platforms": ["cuda", "cpu"]}
    assert tuple(predict(np.zeros((1, 32, 32, 3), np.uint8)).shape) == (1, 32, 32, 1)
    # a device the artifact was not exported for is refused
    with open(tmp_path / "bare.manifest.json", "w") as f:
        json.dump({**manifest, "platforms": ["cuda"]}, f)
    with pytest.raises(ValueError, match="exported for"):
        serving.load_exported(str(path), "cpu")


BLOCKED = ("jax", "optax", "flax", "cv2", "sklearn", "yaml", "pandas", "PIL")


def test_a_fresh_process_loads_and_serves(artifact, tmp_path):
    """A process that imports the port's serving module alone (with JAX and
    the data libraries blocked) loads the artifact and answers a batch of 3
    as this process does; it imports no model code."""
    images = np.random.default_rng(5).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    np.save(tmp_path / "images.npy", images)
    predict, _ = serving.load_exported(artifact, "cpu")
    np.save(tmp_path / "want.npy", predict(images).numpy())
    code = (
        "import sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        "import numpy as np\n"
        "from pytorch_nested_unet_tpu_torch.serving import load_exported\n"
        f"predict, manifest = load_exported({artifact!r}, 'cpu')\n"
        f"got = predict(np.load({str(tmp_path / 'images.npy')!r})).numpy()\n"
        f"diff = float(np.abs(got - np.load({str(tmp_path / 'want.npy')!r})).max())\n"
        "loaded = sorted(n for n in sys.modules if n.startswith('pytorch_nested_unet_tpu'))\n"
        "print(diff, manifest['name'], ' '.join(loaded))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    diff, name, *loaded = r.stdout.split()
    assert float(diff) == 0.0 and name == NAME
    pkg = "pytorch_nested_unet_tpu_torch"
    assert not [m for m in loaded if m.startswith((f"{pkg}.models", f"{pkg}.training"))]
    assert f"{pkg}.ops.decoder_fusion" in loaded and "pytorch_nested_unet_tpu" not in loaded


@pytest.mark.parametrize("part_channels,bias", [((5,), True), ((3, 4, 2), True),
                                                ((6, 2), False)])
def test_k4_operator_passes_opcheck(part_channels, bias):
    """The registered K4 operator on CPU tensors: its schema, fake
    implementation and dispatch (torch.library.opcheck), and its CPU
    implementation equal to the plain version."""
    gen = torch.Generator().manual_seed(0)
    parts = [torch.randn(2, 7, 6, c, generator=gen) for c in part_channels]
    kernel = torch.randn(3, 3, sum(part_channels), 4, generator=gen)
    b = torch.randn(4, generator=gen) if bias else None
    torch.library.opcheck(K4, (parts, kernel, b))
    want = df.reference_multipart_conv3x3(parts, kernel, b)
    torch.testing.assert_close(df.multipart_conv3x3(parts, kernel, b), want, rtol=0, atol=0)
    with torch.device("meta"):  # the fake implementation: the shape from the inputs alone
        out = K4([p.to("meta") for p in parts], kernel.to("meta"), b)
    assert tuple(out.shape) == (2, 7, 6, 4) and out.dtype == torch.float32


def test_live_path_calls_k4_without_the_operator(capsules):
    """Outside torch.export the no-grad forward calls K4 below the
    dispatcher: a live Predictor's batch reaches no registered operator,
    while a direct call of the operator is seen by the same dispatch mode."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Seen(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(func)
            return func(*args, **(kwargs or {}))

    live, _ = Predictor.from_capsule(str(capsules / "port_models" / NAME), "fp32", 2, "cpu")
    images = np.random.default_rng(5).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    with Seen() as seen:
        live.predict_u8(images)
    assert seen.ops and K4 not in seen.ops
    parts, kernel = [torch.randn(1, 4, 4, 3)], torch.randn(3, 3, 3, 2)
    with Seen() as seen:
        K4(parts, kernel, None)
    assert seen.ops == [K4]


def test_bf16_artifact_matches_the_live_bf16_path(capsules, tmp_path):
    path, manifest = serving.export_capsule(str(capsules / "port_models" / UNET),
                                            out_path=str(tmp_path / "bf16.pt2"),
                                            precision="bf16", device="cpu")
    predict, _ = serving.load_exported(path, "cpu")
    live, _ = Predictor.from_capsule(str(capsules / "port_models" / UNET), "bf16", 3, "cpu")
    images = np.random.default_rng(4).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    got, want = predict(images).numpy(), live.predict_u8(images)
    assert manifest["output_dtype"] == "float32" and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)
    program = torch.export.load(path)
    packed = [program.constants[s.target] for s in program.graph_signature.input_specs
              if s.target and s.target.endswith("._packed")]
    assert len(packed) == 4 and all(t.dtype == torch.bfloat16 for t in packed)
