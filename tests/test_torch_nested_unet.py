"""The port's NestedUNet against the JAX package's, weights carried across.

A narrow NestedUNet (nb_filter (4,8,16,32,64), 32x32, batch 2) is initialized
in JAX with non-trivial BN running statistics, its variables go through
`state_dict_from_jax` and load strict into the port, and every head of the eval
forward is compared in f32 within atol = rtol = 1e-4 (ten nested convs of
summation-order differences).

The `remat` modes: one f32 train step of the port's NestedUNet with
remat True / "full" / "policy" against `jax.value_and_grad` of the JAX
package's NestedUNet with the same remat (narrow, 16x16, batch 2, deep
supervision, the BN-fed conv biases at 0), and against the port's own
remat=False step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_nested_unet_tpu.models import create_model as jax_create_model
from pytorch_nested_unet_tpu.ops import decoder_fusion as jdf
from pytorch_nested_unet_tpu_torch.models import create_model
from pytorch_nested_unet_tpu_torch.models.blocks import VGGBlock
from pytorch_nested_unet_tpu_torch.ops import fused_bn
from pytorch_nested_unet_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_crdn import jax_variables, train_batch, zero_bn_fed_biases

NARROW = (4, 8, 16, 32, 64)


def _randomize_stats(variables, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        name = path[-1].key
        if name == "mean":
            return jnp.asarray(rng.standard_normal(v.shape) * 0.1, v.dtype)
        if name == "var":
            return jnp.asarray(rng.uniform(0.5, 2.0, v.shape), v.dtype)
        return v

    return {"params": variables["params"],
            "batch_stats": jax.tree_util.tree_map_with_path(leaf, variables["batch_stats"])}


def _pair(ds, seed=0):
    jm = jax_create_model("NestedUNet", 1, 3, ds, nb_filter=NARROW)
    x = np.random.default_rng(seed).standard_normal((2, 32, 32, 3)).astype(np.float32)
    variables = _randomize_stats(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x)), seed)
    tm = create_model("NestedUNet", 1, 3, ds, nb_filter=NARROW)
    tm.load_state_dict(state_dict_from_jax(jax.device_get(variables)), strict=True)
    return jm, variables, tm.eval(), x


def _compare(jm, variables, tm, x):
    ref = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.inference_mode():
        out = tm(torch.from_numpy(x))
    refs = ref if isinstance(ref, (list, tuple)) else [ref]
    outs = out if isinstance(out, (list, tuple)) else [out]
    assert len(outs) == len(refs)
    for o, r in zip(outs, refs):
        assert o.dtype == torch.float32 and o.shape == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("ds", [False, True])
def test_heads_match_jax(ds):
    _compare(*_pair(ds))


def test_heads_match_jax_with_pallas_decoder_fusion():
    jm, variables, tm, x = _pair(True, seed=1)
    jdf.enable_decoder_fusion(True, interpret=True)
    try:
        _compare(jm, variables, tm, x)
    finally:
        jdf.enable_decoder_fusion(False)


@pytest.mark.parametrize("ds,count", [(False, 9_163_329), (True, 9_163_428)])
def test_full_width_parameter_count(ds, count):
    m = create_model("NestedUNet", 1, 3, ds)
    assert sum(p.numel() for p in m.parameters()) == count
    assert all(p.dtype == torch.float32 for p in m.parameters())


def test_bf16_forward_keeps_f32_params_and_heads():
    m = create_model("NestedUNet", 1, 3, True, nb_filter=NARROW,
                     dtype=torch.bfloat16).eval()
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 16, 16, 3))
                         .astype(np.float32))
    f32_model = create_model("NestedUNet", 1, 3, True, nb_filter=NARROW).eval()
    with torch.inference_mode():
        f32, heads = f32_model(x), m(x)
    assert len(heads) == 4 and all(h.dtype == torch.float32 for h in heads)
    assert all(p.dtype == torch.float32 for p in m.parameters())
    # same seed-0 init: bf16 drifts from f32 by rounding only
    np.testing.assert_allclose(heads[-1].numpy(), f32[-1].numpy(), atol=0.1)


def test_same_seed_same_weights_and_unknown_arch():
    a = create_model("NestedUNet", generator=torch.Generator().manual_seed(3))
    b = create_model("NestedUNet", generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(a.state_dict()[k], v) for k, v in b.state_dict().items())
    with pytest.raises(KeyError, match="not registered"):
        create_model("NoSuchArch")


def _remat_step(remat, variables, imgs, masks, monkeypatch):
    """The port's train-mode forward and backward (BCEDice averaged over the
    4 heads) from `variables`: (loss, {name: grad}, {name: buffer}, calls of
    K1's plain version, those of them that updated running statistics)."""
    from pytorch_nested_unet_tpu_torch.data.augment import eval_transform
    from pytorch_nested_unet_tpu_torch.losses import get_loss

    calls = {"k1": 0, "updates": 0}
    plain_k1 = fused_bn.reference_bn_stats

    def counted(x2d, eps=1e-5, running_mean=None, running_var=None, momentum=0.9):
        calls["k1"] += 1
        calls["updates"] += running_mean is not None
        return plain_k1(x2d, eps, running_mean, running_var, momentum)

    monkeypatch.setattr(fused_bn, "reference_bn_stats", counted)
    tm = create_model("NestedUNet", 1, 3, True, nb_filter=NARROW, remat=remat)
    tm.load_state_dict(state_dict_from_jax(variables), strict=True)
    x, m = eval_transform(torch.from_numpy(imgs), torch.from_numpy(masks))
    loss_fn = get_loss("BCEDiceLoss")
    heads = tm.train()(x)
    loss = sum(loss_fn(o, m) for o in heads) / len(heads)
    loss.backward()
    return (float(loss), {n: p.grad for n, p in tm.named_parameters()},
            dict(tm.named_buffers()), calls)


@pytest.mark.parametrize("remat", [True, "full", "policy"])
def test_remat_step_matches_jax_and_the_plain_step(remat, monkeypatch):
    """Against the JAX package's remat step: the loss within 1e-6, every
    gradient within 1e-4 relative L2 norm (of the larger of its own norm and
    its module's weight gradient norm: a BN-fed conv bias has a true
    gradient of 0) or 4x how far the port's gradient moves when the weights
    move by 1e-7 of themselves, where that is more (f32 rounding: the
    port's and the JAX package's plain steps differ by up to 6.6e-4 here,
    in the first conv's weight gradient; the JAX package's remat and plain
    steps are identical). Against the port's remat=False step the loss,
    every gradient and every running statistic are equal. K1's plain
    version runs 30 times with the running statistics per step (each BN's
    once), plus 30 times without them under "full" (the recompute)."""
    from pytorch_nested_unet_tpu.data.augment import eval_transform
    from pytorch_nested_unet_tpu.losses import get_loss

    jm = jax_create_model("NestedUNet", 1, 3, True, nb_filter=NARROW, remat=remat)
    imgs, masks = train_batch(0, hw=16)
    variables = zero_bn_fed_biases(jax_variables(jm, imgs.shape, 0))
    loss_fn = get_loss("BCEDiceLoss")

    def f(params):
        x, m = eval_transform(imgs, masks)
        heads, _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                            train=True, mutable=["batch_stats"])
        return sum(loss_fn(o, m) for o in heads) / len(heads)

    want_loss, want_grads = jax.device_get(jax.jit(jax.value_and_grad(f))(variables["params"]))
    want = state_dict_from_jax({"params": want_grads})
    loss, grads, bufs, calls = _remat_step(remat, variables, imgs, masks, monkeypatch)
    assert calls == {"k1": 60 if remat in (True, "full") else 30, "updates": 30}
    assert abs(loss - float(want_loss)) <= 1e-6

    rng = np.random.default_rng(1)
    moved_vars = jax.tree_util.tree_map(
        lambda v: v * (1 + 1e-7 * rng.standard_normal(v.shape)).astype(np.float32), variables)
    moved = _remat_step(remat, moved_vars, imgs, masks, monkeypatch)[1]

    def rel(a, name):
        return float((a[name] - grads[name]).norm() / max(
            a[name].norm(), a[name.rsplit(".", 1)[0] + ".weight"].norm()))

    for name in grads:
        assert rel(want, name) <= max(1e-4, 4 * rel(moved, name)), (name, rel(want, name))

    loss0, grads0, bufs0, calls0 = _remat_step(False, variables, imgs, masks, monkeypatch)
    assert calls0 == {"k1": 30, "updates": 30}
    assert loss == loss0
    for name, g in grads.items():
        assert torch.equal(g, grads0[name]), name
    for name, b in bufs.items():
        assert torch.equal(b, bufs0[name]), name


def test_remat_policy_keeps_no_bn1_output_and_invalid_modes_raise():
    """Under "policy" the activations autograd keeps for backward are those
    of the plain step less each VGGBlock's bn1 output (conv2's input, made
    again in backward), and the step's gradients are the same. An unknown
    mode raises a ValueError naming `remat`."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 16, 16, 3))
                         .astype(np.float32))

    def saved_bytes(remat):
        m = create_model("NestedUNet", 1, 3, True, nb_filter=NARROW, remat=remat,
                         generator=torch.Generator().manual_seed(0)).train()
        storages, mids = {}, []
        for block in m.modules():
            if isinstance(block, VGGBlock):
                block.bn1.register_forward_hook(lambda mod, args, y: mids.append(y.nbytes))

        weights = {p.untyped_storage().data_ptr() for p in m.parameters()}

        def pack(t):  # activations only (conv2's weight is saved under policy's own hooks)
            if t.untyped_storage().data_ptr() not in weights:
                storages[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = m(x)
        sum(o.sum() for o in out).backward()
        return sum(storages.values()), sum(mids), [p.grad for p in m.parameters()]

    plain, mid, grads = saved_bytes("none")
    policy, _, policy_grads = saved_bytes("policy")
    assert mid > 0 and plain - policy == mid
    for a, b in zip(grads, policy_grads):
        assert torch.equal(a, b)
    for bad in ("partial", 2, "Full"):
        with pytest.raises(ValueError, match="remat"):
            create_model("NestedUNet", nb_filter=NARROW, remat=bad)
