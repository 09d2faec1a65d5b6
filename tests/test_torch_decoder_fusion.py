"""The port's decoder-fusion op against the JAX package's Pallas kernel.

On CPU the port's `multipart_conv3x3` runs its plain version,
`reference_multipart_conv3x3` (torch.cat + F.conv2d); the JAX side runs
`fused_upcat_conv3x3` with the Pallas kernel in interpret mode. Same numpy
inputs, f32, atol = rtol = 1e-5 (summation order only). The CUDA kernel itself
is held against the plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_nested_unet_tpu.ops import decoder_fusion as jdf
from pytorch_nested_unet_tpu_torch.ops import _build
from pytorch_nested_unet_tpu_torch.ops import decoder_fusion as tdf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _enable_interpret():
    jdf.enable_decoder_fusion(True, interpret=True)
    yield
    jdf.enable_decoder_fusion(False)


def _inputs(seed, cps, co, hw, batch=2, with_bias=True):
    rng = np.random.default_rng(seed)
    h, w = hw
    parts = [rng.standard_normal((batch, h, w, c)).astype(np.float32) for c in cps]
    kernel = (rng.standard_normal((3, 3, sum(cps), co)) * 0.1).astype(np.float32)
    bias = rng.standard_normal((co,)).astype(np.float32) if with_bias else None
    return parts, kernel, bias


def _jax(parts, kernel, bias):
    assert jdf._supported([jnp.asarray(p) for p in parts], jnp.asarray(kernel)), \
        "shape must take the Pallas path, not the XLA fall-back"
    out = jdf.fused_upcat_conv3x3(tuple(jnp.asarray(p) for p in parts),
                                  jnp.asarray(kernel),
                                  None if bias is None else jnp.asarray(bias))
    return np.asarray(out)


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("cps,co,hw,with_bias", [
    ((5, 3, 8), 6, (16, 16), True),        # 3-part concat
    ((32, 64), 32, (12, 16), True),        # decoder-like channels, H % 8 != 0
    ((7,), 4, (8, 8), True),               # single part (no concat)
    ((4,), 3, (12, 16), False),            # no bias
    ((4, 4, 4, 4, 8), 8, (8, 16), True),   # 5 parts, as at node x0_4
])
def test_plain_matches_pallas(cps, co, hw, with_bias):
    parts, kernel, bias = _inputs(0, cps, co, hw, with_bias=with_bias)
    ref = _jax(parts, kernel, bias)
    before = tdf.LAUNCHES
    out = tdf.multipart_conv3x3([_t(p) for p in parts], _t(kernel), _t(bias))
    assert tdf.LAUNCHES == before, "a CPU call must not count a kernel launch"
    assert out.shape == ref.shape and out.is_contiguous()
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)
    plain = tdf.reference_multipart_conv3x3([_t(p) for p in parts], _t(kernel), _t(bias))
    np.testing.assert_array_equal(out.numpy(), plain.numpy())


def test_cpu_call_builds_nothing():
    parts, kernel, bias = _inputs(1, (3, 5), 4, (6, 7))
    tdf.multipart_conv3x3([_t(p) for p in parts], _t(kernel), _t(bias))
    assert "decoder_fusion" not in _build._LIBS


def test_pack_weight_is_hwio():
    w = torch.arange(2 * 5 * 9, dtype=torch.float32).reshape(2, 5, 3, 3)
    packed = tdf.pack_weight(w, torch.bfloat16)
    assert packed.shape == (3, 3, 5, 2) and packed.dtype == torch.bfloat16
    assert packed.is_contiguous()
    assert torch.equal(packed.float(), w.permute(2, 3, 1, 0))


def test_forward_only():
    parts, kernel, bias = _inputs(2, (3,), 2, (4, 4))
    k = _t(kernel).requires_grad_(True)
    with pytest.raises(NotImplementedError):
        tdf.multipart_conv3x3([_t(p) for p in parts], k, _t(bias))
    with torch.no_grad():
        tdf.multipart_conv3x3([_t(p) for p in parts], k, _t(bias))


def test_imports_without_nvcc():
    code = ("import torch\n"
            "from pytorch_nested_unet_tpu_torch.ops import decoder_fusion as d, _build\n"
            "x = torch.ones(1, 4, 4, 2)\n"
            "y = d.multipart_conv3x3([x], torch.ones(3, 3, 2, 1))\n"
            "assert y.shape == (1, 4, 4, 1) and d.LAUNCHES == 0\n"
            "try:\n"
            "    _build.nvcc_path()\n"
            "except RuntimeError:\n"
            "    print('no nvcc')\n")
    env = {k: v for k, v in os.environ.items() if k != "CUDA_HOME"}
    env["PATH"] = ""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
