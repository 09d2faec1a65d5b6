"""The port's attention U-Nets (AttU_Net, R2U_Net, R2AttU_Net) against the JAX
package's, weights carried across.

Narrow models (filters 4..64) at 32x32, batch 2, JAX variables drawn from a
numpy seed (BN statistics and scales off their init values, conv biases
nonzero), exported by `state_dict_from_jax` and loaded strict: the eval
forward within atol = rtol = 1e-4; one train step of each against
`jax.value_and_grad` (loss, every gradient, every running statistic, the
recurrent blocks' shared BN moved 3 times per forward), with the BN-fed conv
biases at 0 (test_torch_crdn.py) and, for the recurrent nets, a floor of how
far f32 rounding moves the step; the gate and the recurrent block alone in
eval and train; the full-width parameter counts and the key layout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_nested_unet_tpu.models import attention_unet as jattn
from pytorch_nested_unet_tpu.models import create_model as jax_create_model
from pytorch_nested_unet_tpu.utils.torch_convert import converters_for_arch
from pytorch_nested_unet_tpu_torch.models import attention_unet as tattn
from pytorch_nested_unet_tpu_torch.models import create_model
from pytorch_nested_unet_tpu_torch.ops.layers import BatchNorm, TorchConv
from pytorch_nested_unet_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_crdn import check_train_step_against_jax, compare_eval, jax_variables, make_pair
from test_torch_crdn_backbones_training import f32_movement

ARCHS = ("AttU_Net", "R2U_Net", "R2AttU_Net")
# where the recurrent nets' f32 floor perturbs the step: every conv and BN output
NOISY = (TorchConv, BatchNorm)
FILTERS = (4, 8, 16, 32, 64)


@pytest.mark.parametrize("arch,kw", [(a, {}) for a in ARCHS] + [
    ("R2AttU_Net", {"t": 1}), ("AttU_Net", {"filters": (2, 4, 8, 16, 32), "num_classes": 2})])
def test_eval_forward_matches_jax(arch, kw):
    kw = {"filters": FILTERS, **kw}
    nc = kw.pop("num_classes", 1)
    compare_eval(*make_pair(arch, num_classes=nc, **kw))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    """One f32 train step from the same variables on the same batch, the
    port's convs on torch's direct CPU convolution (oneDNN's round 2-3x
    coarser, test_torch_crdn_backbones_training.py): AttU_Net at the plain
    tolerances of `check_train_step_against_jax`. The recurrent nets are
    chaotic in train mode: each level feeds x + x1 through one shared conv
    and BN three times, one channel of RRCNN1's first recurrent BN here has
    a batch variance of 2.8e-5 (1/sqrt(var + eps) = 162) and the deepest
    BNs normalize 8 values, so f32 rounding alone moves the port's own
    R2U_Net step by up to 8.4% from the same step in float64 (1-10% over
    other draws and sizes). Their gradients and statistics are held to
    1e-4 or to 4x how far f32 rounding moves the port's own step, whichever
    is larger (`f32_movement`, its noise on every conv and BN output: the
    JAX package rounds its BN too)."""
    kw = {"filters": FILTERS}
    floor = f32_movement(arch, kw, NOISY) if arch.startswith("R2") else None
    with torch.backends.mkldnn.flags(enabled=False):
        check_train_step_against_jax(arch, floor=floor, **kw)


def _nest(tree, scope):
    for name in reversed(scope):
        tree = {name: tree}
    return tree


def load_block(tm, variables, arch, scope):
    """Load the JAX block `variables` strict into the port's block `tm`,
    through `arch`'s key renames with the block at `scope` (a tuple of
    nested scope names); returns the reference key prefix of the block."""
    if not variables:  # a block without parameters or statistics
        return ""
    sd = state_dict_from_jax({c: _nest(variables[c], scope) for c in variables}, arch)
    own = sorted(tm.state_dict())
    prefix = next(k[:-len(own[0])] for k in sorted(sd) if k.endswith(own[0]))
    tm.load_state_dict({k[len(prefix):]: v for k, v in sd.items()}, strict=True)
    return prefix


def compare_block(jm, variables, tm, inputs, tol=1e-5, has_train=True):
    """Eval, then train mode: every output (a tensor or a tuple); returns the
    JAX package's batch statistics after the train-mode forward. A JAX block
    without a `train` argument (`has_train` False) runs the same way in
    both."""
    for train in (False, True):
        ref, mut = jm.apply(variables, *(jnp.asarray(a) for a in inputs),
                            **({"train": train} if has_train else {}),
                            mutable=["batch_stats"])
        out = tm.train(train)(*(torch.from_numpy(a) for a in inputs))
        for o, r in zip(*((out, ref) if isinstance(out, tuple) else ((out,), (ref,)))):
            np.testing.assert_allclose(o.detach().numpy(), np.asarray(r), atol=tol, rtol=tol)
    return mut.get("batch_stats", {})


def compare_stats(tm, stats, arch, scope, prefix, tol=1e-6):
    """The port block's running statistics against the JAX package's, within
    atol = rtol = `tol` (a running variance of 15 is 1 ulp from 1e-6 away)."""
    want = state_dict_from_jax({"params": {}, "batch_stats": _nest(stats, scope)}, arch)
    got = dict(tm.named_buffers())
    assert sorted(got) == sorted(k[len(prefix):] for k in want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k[len(prefix):]].numpy(), v.numpy(), atol=tol,
                                   rtol=tol, err_msg=k)


def test_attention_gate_matches_jax():
    """The additive gate in eval and train mode, its running statistics
    after the train forward (the psi BN at C = 1)."""
    rng = np.random.default_rng(5)
    g, x = (rng.standard_normal((2, 6, 5, 8)).astype(np.float32) for _ in range(2))
    jm, tm = jattn.AttentionGate(4), tattn.AttentionGate(8, 8, 4)
    variables = jax_variables(jm, (g.shape, x.shape), 6)
    prefix = load_block(tm, variables, "AttU_Net", ("Att5",))
    stats = compare_block(jm, variables, tm, (g, x))
    assert tuple(tm.psi[1].running_var.shape) == (1,)
    compare_stats(tm, stats, "AttU_Net", ("Att5",), prefix)


def test_recurrent_block_moves_its_bn_three_times():
    """The shared conv + BN applied t + 1 = 3 times: the output in eval and
    train mode, and the running statistics after one train forward equal
    the JAX package's, which moved them 3 times too."""
    x = np.random.default_rng(7).standard_normal((2, 6, 5, 4)).astype(np.float32)
    jm, tm = jattn.RecurrentBlock(4, t=2), tattn.RecurrentBlock(4, t=2)
    variables = jax_variables(jm, x.shape, 8)
    prefix = load_block(tm, variables, "R2U_Net", ("RRCNN1", "rcnn1"))
    calls = []
    tm.conv[1].register_forward_hook(lambda m, i, o: calls.append(m.training))
    stats = compare_block(jm, variables, tm, (x,))
    assert calls == [False] * 3 + [True] * 3
    compare_stats(tm, stats, "R2U_Net", ("RRCNN1", "rcnn1"), prefix)


@pytest.mark.parametrize("arch,count", [("AttU_Net", 34_878_573), ("R2U_Net", 39_091_393),
                                        ("R2AttU_Net", 39_442_925)])
def test_full_width_parameter_count(arch, count):
    m = create_model(arch)
    assert sum(p.numel() for p in m.parameters()) == count
    assert all(p.dtype == torch.float32 for p in m.parameters())
    shapes = jax.eval_shape(lambda: jax_create_model(arch).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    assert sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes["params"])) \
        == count


@pytest.mark.parametrize("arch", ARCHS)
def test_state_dict_from_jax_equals_jax_export(arch):
    jm = jax_create_model(arch, 1, 3, False, filters=FILTERS)
    variables = jax_variables(jm, (1, 32, 32, 3), 0)
    ref = converters_for_arch(arch)[1](variables)
    sd = state_dict_from_jax(variables, arch)
    assert sorted(sd) == sorted(ref) == sorted(
        create_model(arch, 1, 3, False, filters=FILTERS).state_dict())
    for k, v in ref.items():
        assert sd[k].dtype == torch.float32 and tuple(sd[k].shape) == v.shape, k
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    assert ("Att5.psi.1.running_var" in sd) == ("Att" in arch)
    assert ("RRCNN1.RCNN.1.conv.0.weight" in sd) == arch.startswith("R2")
