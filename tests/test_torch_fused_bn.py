"""The port's training-mode BN+ReLU against the JAX package's Pallas kernels.

On CPU the port's wrappers run their plain versions (`reference_bn_*`); the
JAX side runs `bn_stats` and the custom-VJP backward `_bwd_rule` with the
Pallas kernels in interpret mode. Same numpy inputs, float32. Tolerances: the
per-channel sums atol = rtol = 1e-5 (summation order over up to 2304 rows);
dx atol 2e-5; the module's forward 2e-5 and its gradients 2e-4, as the JAX
package's own tests/test_fused_bn.py holds its kernels. The CUDA kernels are
held against the plain versions on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import ctypes
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_nested_unet_tpu.ops import fused_bn as jbn
from pytorch_nested_unet_tpu_torch.ops import _build
from pytorch_nested_unet_tpu_torch.ops import fused_bn as tbn

SHAPES = [
    (4, 24, 24, 32),   # JAX packs lanes f=4
    (2, 16, 16, 64),   # f=2
    (2, 8, 8, 128),    # unpacked
    (2, 16, 16, 1),    # score-map channel count, f=128
    (2, 10, 10, 48),   # C that is no power of two
    (2, 6, 6, 256),    # wide C: several channel slices in the one-launch K2
    (1, 6, 6, 512),    # the deepest level's width
]


@pytest.fixture(autouse=True)
def _pallas_interpret():
    jbn.enable_fused_bn(True, interpret=True, mode="full")
    yield
    jbn.enable_fused_bn(False, interpret=False)


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.standard_normal(shape) * 1.5 + 0.3).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    beta = rng.uniform(-0.3, 0.3, c).astype(np.float32)
    return x, dy, gamma, beta


def _launch_counts():
    return dict(tbn.LAUNCHES)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_k1_matches_pallas_bn_stats(shape):
    x, _, _, _ = _inputs(shape)
    c = shape[-1]
    s_ref, ss_ref = (np.asarray(a) for a in jbn.bn_stats(jnp.asarray(x.reshape(-1, c))))
    before = _launch_counts()
    s, ss, mean, var, inv = tbn.bn_stats(torch.from_numpy(x.reshape(-1, c)))
    assert _launch_counts() == before, "a CPU call must not count a kernel launch"
    np.testing.assert_allclose(s.numpy(), s_ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ss.numpy(), ss_ref, atol=1e-5, rtol=1e-5)
    n = x.size // c
    m = s_ref / n
    np.testing.assert_allclose(mean.numpy(), m, atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(var.numpy(), np.maximum(ss_ref / n - m * m, 0), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(inv.numpy(), 1 / np.sqrt(var.numpy() + 1e-5), rtol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_k2_k3_match_pallas_bwd_rule(shape):
    x, dy, gamma, beta = _inputs(shape, seed=1)
    c = shape[-1]
    jx = jnp.asarray(x)
    _, mean, var = jbn.fused_bn_relu_train(jx, jnp.asarray(gamma), jnp.asarray(beta))
    inv = jax.lax.rsqrt(var + 1e-5)
    dx_ref, dgamma_ref, dbeta_ref = (np.asarray(a) for a in jbn._bwd_rule(
        1e-5, (jx, mean, inv, jnp.asarray(gamma), jnp.asarray(beta)),
        (jnp.asarray(dy), None, None)))

    t = torch.from_numpy
    x2d, dy2d = t(x.reshape(-1, c)), t(dy.reshape(-1, c))
    mean_t, inv_t = t(np.array(mean)), t(np.array(inv))
    before = _launch_counts()
    dbeta, dgamma = tbn.bn_bwd_reduce(x2d, dy2d, mean_t, inv_t, t(gamma), t(beta))
    dx = tbn.bn_bwd_dx(x2d, dy2d, mean_t, inv_t, t(gamma), t(beta), dbeta, dgamma)
    assert _launch_counts() == before
    np.testing.assert_allclose(dbeta.numpy(), dbeta_ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(dgamma.numpy(), dgamma_ref, atol=1e-5, rtol=1e-5)
    assert dx.dtype == torch.float32
    np.testing.assert_allclose(dx.numpy().reshape(shape), dx_ref, atol=2e-5)


def _jax_module_step(x, ct, gamma, beta, calls=2):
    """JAX FusedBatchNormReLU in train mode, `calls` times on x: y of the last
    call, the running stats after all, and the grads of sum(y*ct)."""
    m = jbn.FusedBatchNormReLU()
    variables = m.init(jax.random.PRNGKey(0), jnp.asarray(x), use_running_average=False)
    params = {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)}
    stats = variables["batch_stats"]
    for _ in range(calls):
        y, mut = m.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                         use_running_average=False, mutable=["batch_stats"])
        stats = mut["batch_stats"]

    def f(xx, pp):
        out, _ = m.apply({"params": pp, "batch_stats": variables["batch_stats"]}, xx,
                         use_running_average=False, mutable=["batch_stats"])
        return jnp.sum(out * ct)

    dx, dp = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), params)
    return y, stats, dx, dp


@pytest.mark.parametrize("shape", [(4, 8, 8, 32), (2, 6, 5, 64)])
def test_train_module_matches_jax_and_torch(shape):
    x, ct, gamma, beta = _inputs(shape, seed=2)
    c = shape[-1]
    assert jbn._use_pallas(jnp.asarray(x)), "the JAX side must take the Pallas path"
    y_ref, stats_ref, dx_ref, dp_ref = _jax_module_step(x, jnp.asarray(ct), gamma, beta)

    mod = tbn.FusedBatchNormReLU(c).train()
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(gamma))
        mod.bias.copy_(torch.from_numpy(beta))
    xt = torch.from_numpy(x).requires_grad_(True)
    mod(xt.detach())
    y = mod(xt)
    (y * torch.from_numpy(ct)).sum().backward()

    bn = torch.nn.BatchNorm2d(c)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(gamma))
        bn.bias.copy_(torch.from_numpy(beta))
    xn = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    bn(xn.detach())
    yn = torch.relu(bn(xn))
    (yn * torch.from_numpy(ct.transpose(0, 3, 1, 2).copy())).sum().backward()

    y_np = y.detach().numpy()
    np.testing.assert_allclose(y_np, np.asarray(y_ref), atol=2e-5)
    np.testing.assert_allclose(y_np, yn.detach().numpy().transpose(0, 2, 3, 1), atol=2e-5)
    for name, ref, torch_ref in (("running_mean", stats_ref["mean"], bn.running_mean),
                                 ("running_var", stats_ref["var"], bn.running_var)):
        got = getattr(mod, name).numpy()
        np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5, err_msg=name)
        np.testing.assert_allclose(got, torch_ref.numpy(), atol=1e-5, err_msg=name)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_ref), atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), xn.grad.numpy().transpose(0, 2, 3, 1),
                               atol=2e-4, rtol=1e-4)
    for got, ref, torch_ref in ((mod.weight.grad, dp_ref["scale"], bn.weight.grad),
                                (mod.bias.grad, dp_ref["bias"], bn.bias.grad)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4, rtol=1e-4)
        np.testing.assert_allclose(got.numpy(), torch_ref.numpy(), atol=2e-4, rtol=1e-4)


def test_function_outputs_and_bf16_dtypes():
    x, ct, gamma, beta = _inputs((2, 4, 4, 8), seed=3)
    xb = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    g = torch.from_numpy(gamma).requires_grad_(True)
    b = torch.from_numpy(beta).requires_grad_(True)
    y, mean, var = tbn.fused_bn_relu_train(xb, g, b)
    assert y.dtype == torch.bfloat16 and mean.dtype == var.dtype == torch.float32
    assert not mean.requires_grad and not var.requires_grad
    (y.float() * torch.from_numpy(ct)).sum().backward()
    assert xb.grad.dtype == torch.bfloat16
    assert g.grad.dtype == b.grad.dtype == torch.float32
    # bf16 forward against the f32 math on the same rounded input
    xf = xb.detach().float()
    y32, _, _ = tbn.fused_bn_relu_train(xf, g.detach(), b.detach())
    np.testing.assert_allclose(y.detach().float().numpy(), y32.numpy(), atol=2e-2, rtol=1e-2)


_C_KINDS = {ctypes.c_int: "int", ctypes.c_longlong: "long long", ctypes.c_double: "double",
            ctypes.c_void_p: "pointer"}


def _c_signatures():
    """{name: [kind of each parameter]} of the extern "C" functions in
    csrc/fused_bn.cu, parsed from the source (nothing is built)."""
    with open(os.path.join(_build.CSRC, "fused_bn.cu")) as f:
        src = f.read()
    sigs = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
        kinds = []
        for param in params.split(","):
            decl = " ".join(param.split())
            if "*" in decl:
                kinds.append("pointer")
            else:
                kinds.append(decl.removeprefix("const ").rsplit(" ", 1)[0])
        sigs[name] = kinds
    return sigs


@pytest.mark.parametrize("name", ["bn_stats", "bn_bwd_reduce", "bn_bwd_dx"])
def test_ctypes_table_matches_c_signature(name):
    """The wrapper's argtypes hold each parameter's kind of the C function, so
    a changed C interface fails here, without a card."""
    sig = _c_signatures()
    assert sorted(sig) == sorted(tbn.ARGTYPES)
    assert [_C_KINDS[t] for t in tbn.ARGTYPES[name]] == sig[name]
    assert "fused_bn" not in _build._LIBS


def test_eval_mode_uses_running_stats_and_cpu_builds_nothing():
    x = np.random.default_rng(4).standard_normal((2, 8, 8, 16)).astype(np.float32)
    mod = tbn.FusedBatchNormReLU(16).eval()
    mod.running_mean.fill_(0.5)
    mod.running_var.fill_(2.0)
    with torch.no_grad():
        y = mod(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.maximum((x - 0.5) / np.sqrt(2.0 + 1e-5), 0.0),
                               atol=2e-5)
    assert torch.equal(mod.running_mean, torch.full((16,), 0.5))  # eval leaves them
    mod.train()(torch.from_numpy(x))
    assert "fused_bn" not in _build._LIBS
    assert tbn.LAUNCHES == {"bn_stats": 0, "bn_bwd_reduce": 0, "bn_bwd_dx": 0}
