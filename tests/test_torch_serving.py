"""The port's serving path against the JAX package's predict step, and the
port's import and device rules."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_nested_unet_tpu.models import create_model as jax_create_model
from pytorch_nested_unet_tpu.training.loop import make_predict_fn as jax_make_predict_fn
from pytorch_nested_unet_tpu_torch import infer
from pytorch_nested_unet_tpu_torch.infer import Predictor
from pytorch_nested_unet_tpu_torch.utils.convert import state_dict_from_jax
from pytorch_nested_unet_tpu_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = (4, 8, 16, 32, 64)


@pytest.mark.parametrize("ds", [False, True])
def test_predictor_matches_jax_predict(ds):
    jm = jax_create_model("NestedUNet", 1, 3, ds, nb_filter=NARROW)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(1),
                                       np.zeros((1, 32, 32, 3), np.float32)))
    predict = jax_make_predict_fn(jm, ds)
    images = np.random.default_rng(0).integers(0, 256, (5, 32, 32, 3), dtype=np.uint8)
    ref = np.concatenate([
        np.asarray(predict(variables["params"], variables["batch_stats"],
                           jnp.asarray(images[s:s + 2]))) for s in range(0, 5, 2)])

    p = Predictor("NestedUNet", 1, 3, ds, batch_size=2, device="cpu",
                  weights=state_dict_from_jax(variables), arch_kwargs={"nb_filter": NARROW})
    out = p.predict_u8(images)  # 2 + 2 + a short batch of 1, padded to 2
    assert out.shape == (5, 32, 32, 1) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    s = p.summary()
    assert s["batches"] == 3 and s["batch_size"] == 2
    assert 0 < s["p50_ms"] <= s["p95_ms"] and s["img_per_s"] > 0


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="cuda"):
        Predictor()
    with pytest.raises(RuntimeError):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def test_predictor_rejects_bad_requests():
    p = Predictor(batch_size=2, device="cpu", arch_kwargs={"nb_filter": NARROW})
    with pytest.raises(ValueError):
        p.predict_u8(np.zeros((1, 16, 16, 3), np.float32))
    with pytest.raises(RuntimeError):
        p.summary()
    with pytest.raises(ValueError):
        Predictor(precision="fp16", device="cpu")


def test_main_reads_and_writes_npy(tmp_path, capsys):
    images = np.random.default_rng(1).integers(0, 256, (3, 16, 16, 3), dtype=np.uint8)
    src, dst = tmp_path / "in.npy", tmp_path / "out.npy"
    np.save(src, images)
    pth = tmp_path / "model.pth"
    torch.save(Predictor(device="cpu").model.state_dict(), pth)
    s = infer.main(["--input", str(src), "--output", str(dst), "--weights", str(pth),
                    "--batch_size", "2", "--device", "cpu"])
    probs = np.load(dst)
    assert probs.shape == (3, 16, 16, 1) and np.all((probs >= 0) & (probs <= 1))
    assert s["batches"] == 2
    assert "img/s" in capsys.readouterr().out


# what the port may not import: JAX and the JAX package, and the data
# libraries the card's machine may lack (the JAX data path's cv2, sklearn,
# yaml, pandas; PIL)
BLOCKED = ("jax", "optax", "flax", "cv2", "sklearn", "yaml", "pandas", "PIL")


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        "import pkgutil, importlib\n"
        "import pytorch_nested_unet_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [n for n, m in sys.modules.items() if m is not None and (\n"
        "       n == 'pytorch_nested_unet_tpu' or n.startswith('pytorch_nested_unet_tpu.')\n"
        f"       or n.split('.')[0] in {BLOCKED!r})]\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith(pkg.__name__)]))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 54  # every module of the slices so far was imported
