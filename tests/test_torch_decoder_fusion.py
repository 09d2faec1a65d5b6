"""The port's decoder-fusion op against the JAX package's Pallas kernel.

On CPU the port's `multipart_conv3x3` runs its plain version,
`reference_multipart_conv3x3` (torch.cat + F.conv2d); the JAX side runs
`fused_upcat_conv3x3` with the Pallas kernel in interpret mode. Same numpy
inputs, f32, atol = rtol = 1e-5 (summation order only), for the forward and for
the gradients of the differentiable op (`conv3x3_parts`) against `jax.grad`
through the Pallas forward and its XLA conv VJP. The CUDA kernel itself is
held against the plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import os
import subprocess
import sys

import jax
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
    # edges of the CUDA kernel's tiling that the Pallas kernel also takes:
    ((8, 16, 8, 24, 8, 8, 32, 40), 48, (13, 8), True),  # 8 parts (MAX_PARTS)
    ((32, 5, 64), 64, (12, 16), True),     # a part with C % 8 != 0 between others
    ((16, 24), 70, (12, 24), True),        # co % 8 != 0; H, W off the pixel tiles
    ((40, 24), 120, (12, 8), False),       # co near 128, no bias
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


@pytest.mark.parametrize("cps,co,hw,batch", [
    ((5, 3, 8), 6, (12, 16), 1),           # batch 1 (Pallas)
    ((7,), 5, (13, 10), 2),                # W % 8 != 0: beyond the Pallas kernel
    ((32, 5, 64), 64, (12, 12), 2),        # 12x12, a part with C % 8 != 0
    ((96, 40), 136, (13, 10), 1),          # co > 128, batch 1
    ((256, 200), 136, (12, 12), 1),        # the shape of the kernel's split-K route
    ((32, 64), 32, (25, 25), 1),           # ragged 12x12 tiles in both directions
])
def test_plain_matches_jax_at_edges(cps, co, hw, batch):
    """The plain version at the other edges of the CUDA kernel's tiling,
    against the Pallas kernel where it takes the shape and JAX's reference
    conv where it does not (co > 128, W % 8 != 0). The weights are scaled to
    unit-variance outputs, so f32 summation order over K = 9*cin stays within
    the 1e-5 of the other cases."""
    parts, kernel, bias = _inputs(7, cps, co, hw, batch=batch)
    kernel = (kernel * (10 / np.sqrt(9 * sum(cps)))).astype(np.float32)
    if jdf._supported([jnp.asarray(p) for p in parts], jnp.asarray(kernel)):
        ref = _jax(parts, kernel, bias)
    else:
        ref = np.asarray(jdf.reference_multipart_conv3x3(
            [jnp.asarray(p) for p in parts], jnp.asarray(kernel), jnp.asarray(bias)))
    out = tdf.multipart_conv3x3([_t(p) for p in parts], _t(kernel), _t(bias))
    assert out.shape == ref.shape == (batch, *hw, co)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


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
    """Without grad the op is the plain forward; with grad it is differentiable
    and the kernel's HWIO weight gets its gradient through the OIHW view."""
    parts, kernel, bias = _inputs(2, (3,), 2, (4, 4))
    k = _t(kernel).requires_grad_(True)
    with torch.no_grad():
        out0 = tdf.multipart_conv3x3([_t(p) for p in parts], k, _t(bias))
    assert not out0.requires_grad
    out = tdf.multipart_conv3x3([_t(p) for p in parts], k, _t(bias))
    assert out.requires_grad
    np.testing.assert_array_equal(out.detach().numpy(), out0.numpy())
    out.sum().backward()
    assert k.grad is not None and k.grad.shape == k.shape
    np.testing.assert_allclose(k.grad.numpy(), np.asarray(jax.grad(
        lambda kk: jnp.sum(jdf.reference_multipart_conv3x3(
            [jnp.asarray(p) for p in parts], kk, jnp.asarray(bias))))(jnp.asarray(kernel))),
        atol=1e-5, rtol=1e-5)


def _jax_grads(parts, kernel, bias, ct):
    """jax.grad of sum(fused_upcat_conv3x3(...) * ct) through the Pallas path."""
    def f(ps, kk, bb):
        return jnp.sum(jdf.fused_upcat_conv3x3(ps, kk, bb) * ct)

    assert jdf._supported([jnp.asarray(p) for p in parts], jnp.asarray(kernel))
    return jax.grad(f, argnums=(0, 1, 2))(
        tuple(jnp.asarray(p) for p in parts), jnp.asarray(kernel), jnp.asarray(bias))


@pytest.mark.parametrize("cps,co,hw", [
    ((5, 3, 8), 6, (16, 16)), ((32, 64), 32, (12, 16)), ((7,), 4, (8, 8)),
    ((4, 4, 4, 4, 8), 8, (8, 16)),
])
def test_conv3x3_parts_grads_match_jax(cps, co, hw):
    parts, kernel, bias = _inputs(3, cps, co, hw)
    ct = np.random.default_rng(4).standard_normal((2, *hw, co)).astype(np.float32)
    dparts_ref, dkernel_ref, dbias_ref = _jax_grads(parts, kernel, bias, jnp.asarray(ct))

    tparts = [_t(p).requires_grad_(True) for p in parts]
    weight = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()).requires_grad_(True)
    tbias = _t(bias).requires_grad_(True)
    out = tdf.conv3x3_parts(tparts, weight, tbias)
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jdf.fused_upcat_conv3x3(
                                   tuple(jnp.asarray(p) for p in parts), jnp.asarray(kernel),
                                   jnp.asarray(bias))), atol=1e-5, rtol=1e-5)
    (out * torch.from_numpy(ct)).sum().backward()
    for p, ref in zip(tparts, dparts_ref):
        assert p.grad.shape == p.shape and p.grad.is_contiguous()
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    assert weight.grad.shape == (co, sum(cps), 3, 3) and weight.grad.dtype == torch.float32
    np.testing.assert_allclose(weight.grad.numpy(),
                               np.asarray(dkernel_ref).transpose(3, 2, 0, 1),
                               atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(tbias.grad.numpy(), np.asarray(dbias_ref), atol=1e-5,
                               rtol=1e-5)


def test_module_weight_gets_its_gradient():
    """MultipartConv3x3.weight receives the conv's weight gradient in OIHW (a
    detached packed copy would leave it None)."""
    from pytorch_nested_unet_tpu_torch.models.blocks import MultipartConv3x3

    parts, kernel, bias = _inputs(5, (4, 6), 5, (8, 8))
    ct = np.random.default_rng(6).standard_normal((2, 8, 8, 5)).astype(np.float32)
    _, dkernel_ref, dbias_ref = _jax_grads(parts, kernel, bias, jnp.asarray(ct))
    m = MultipartConv3x3(10, 5)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()))
        m.bias.copy_(_t(bias))
    (m(tuple(_t(p) for p in parts)) * torch.from_numpy(ct)).sum().backward()
    assert m.weight.grad is not None and m.bias.grad is not None
    np.testing.assert_allclose(m.weight.grad.numpy(),
                               np.asarray(dkernel_ref).transpose(3, 2, 0, 1),
                               atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(m.bias.grad.numpy(), np.asarray(dbias_ref), atol=1e-5,
                               rtol=1e-5)


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
