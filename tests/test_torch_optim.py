"""The port's optimizer wrappers and LR schedules against the JAX package's
optax chains, over 5 steps of seeded gradients (float32, atol 1e-6, rtol 1e-5:
the same update rules, rounded in another order)."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_nested_unet_tpu.training import optim as jo
from pytorch_nested_unet_tpu_torch.training import optim as to

TOL = dict(atol=1e-6, rtol=1e-5)


def _grads(steps=5, seed=0, nan_at=()):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(steps):
        g = {"a": rng.standard_normal(3).astype(np.float32),
             "b": rng.standard_normal((2, 2)).astype(np.float32)}
        if i in nan_at:
            g["b"][0, 1] = np.nan
        out.append(g)
    return out


def _run_both(grads, opt_name="SGD", lr=1e-2, lrs=None, **kw):
    """Apply the gradients with both optimizers; return the parameter paths."""
    w0 = {"a": np.array([1.5, -2.0, 0.5], np.float32),
          "b": np.array([[0.3, -0.1], [0.7, 2.0]], np.float32)}
    tx = jo.build_optimizer(opt_name, lr, **kw)
    params = {k: jnp.asarray(v) for k, v in w0.items()}
    st = tx.init(params)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in w0.items()}
    opt = to.build_optimizer(tparams.values(), opt_name, lr, **kw)
    for i, g in enumerate(grads):
        if lrs is not None:
            st = jo.set_learning_rate(st, lrs[i])
            to.set_learning_rate(opt, lrs[i])
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, params)
        params = optax.apply_updates(params, upd)
        opt.zero_grad()
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k in w0:
            np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(params[k]),
                                       err_msg=f"step {i} leaf {k}", **TOL)
    return st, opt


@pytest.mark.parametrize("opt_name,kw", [
    ("SGD", dict(momentum=0.9, weight_decay=1e-4, nesterov=False)),
    ("SGD", dict(momentum=0.9, weight_decay=1e-4, nesterov=True)),
    ("SGD", dict(momentum=0.0, weight_decay=0.0)),
    ("Adam", dict(weight_decay=1e-4)),
    ("Adam", dict(weight_decay=0.0)),
])
def test_optimizer_matches_optax(opt_name, kw):
    lr = 1e-3 if opt_name == "Adam" else 1e-2
    _run_both(_grads(), opt_name, lr, lrs=[lr, lr, lr / 2, lr / 2, lr / 4], **kw)


def test_skip_nonfinite_leaves_everything_and_counts():
    st, opt = _run_both(_grads(nan_at=(1, 3)), "SGD", 1e-2, momentum=0.9,
                        weight_decay=1e-4, skip_nonfinite=2)
    assert to.nonfinite_count(opt) == jo.nonfinite_count(st) == 2


def test_skip_nonfinite_gives_up_after_n_in_a_row():
    st, opt = _run_both(_grads(nan_at=(1, 2)), "Adam", 1e-3, weight_decay=0.0,
                        skip_nonfinite=1)
    assert to.nonfinite_count(opt) == jo.nonfinite_count(st) == 2
    assert not to.params_all_finite(p for g in opt.param_groups for p in g["params"])


def test_accum_steps_matches_multisteps():
    grads = _grads(steps=6, seed=1)
    _run_both(grads, "SGD", 1e-2, momentum=0.9, weight_decay=1e-4, accum_steps=2)
    _run_both(grads, "Adam", 1e-3, weight_decay=1e-4, accum_steps=3)


def test_learning_rate_and_guard_accessors():
    opt = to.build_optimizer([torch.nn.Parameter(torch.ones(2))], "Adam", 1e-3,
                             skip_nonfinite=3, accum_steps=2)
    assert to.get_learning_rate(opt) == pytest.approx(1e-3)
    to.set_learning_rate(opt, 5e-4)
    assert to.get_learning_rate(opt) == pytest.approx(5e-4)
    assert to.nonfinite_count(opt) == 0
    assert to.nonfinite_count(to.build_optimizer([torch.nn.Parameter(torch.ones(2))])) is None
    with pytest.raises(ValueError, match="unknown optimizer"):
        to.build_optimizer([torch.nn.Parameter(torch.ones(2))], "RMSprop")


@pytest.mark.parametrize("kind,kw", [
    ("CosineAnnealingLR", dict(min_lr=1e-5)),
    ("MultiStepLR", dict(milestones=[2, 4], gamma=0.5)),
    ("ConstantLR", {}),
    ("ReduceLROnPlateau", dict(factor=0.5, patience=1, min_lr=1e-4)),
])
def test_lr_schedules_match_jax(kind, kw):
    js = jo.LRSchedule(kind, 1e-2, 8, **kw)
    ts = to.LRSchedule(kind, 1e-2, 8, **kw)
    val_losses = [1.0, 0.9, 0.95, 0.93, 0.92, 0.5, 0.6, 0.7]
    for epoch, vl in enumerate(val_losses):
        assert ts.epoch_lr(epoch) == js.epoch_lr(epoch)
        ts.plateau_step(vl)
        js.plateau_step(vl)
    with pytest.raises(ValueError):
        to.LRSchedule("StepLR", 1e-2, 8)
