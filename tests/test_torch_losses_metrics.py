"""The port's losses and metrics against the JAX package's, on seeded logits.

Same numpy logits and targets (NHWC, float32) go through both; values and the
losses' gradients with respect to the logits agree within atol = rtol = 1e-6
(float32 summation order over at most 2*16*16 elements).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_nested_unet_tpu import losses as jl
from pytorch_nested_unet_tpu import metrics as jm
from pytorch_nested_unet_tpu_torch import losses as tl
from pytorch_nested_unet_tpu_torch import metrics as tm

TOL = dict(atol=1e-6, rtol=1e-6)


def _data(seed=0, shape=(3, 16, 16, 1)):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal(shape) * 2.0).astype(np.float32)
    targets = (rng.random(shape) > 0.6).astype(np.float32)
    weights = np.array([1.0, 1.0, 0.0], np.float32)[:shape[0]]
    return logits, targets, weights


def _check_loss(jfn, tfn, *args):
    """Values and d/dlogits of a loss, JAX against the port."""
    logits, rest = args[0], args[1:]
    ref_val, ref_grad = jax.value_and_grad(
        lambda x: jfn(x, *[jnp.asarray(a) for a in rest]))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    val = tfn(x, *[torch.from_numpy(a) for a in rest])
    val.backward()
    assert val.dim() == 0 and val.dtype == torch.float32
    np.testing.assert_allclose(val.item(), float(ref_val), **TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_grad), **TOL)


@pytest.mark.parametrize("name", ["BCEDiceLoss", "LovaszHingeLoss", "BCEWithLogitsLoss"])
@pytest.mark.parametrize("seed", [0, 1])
def test_losses_match_jax(name, seed):
    logits, targets, _ = _data(seed)
    _check_loss(jl.get_loss(name), tl.get_loss(name), logits, targets)


@pytest.mark.parametrize("name", ["BCEDiceLoss", "LovaszHingeLoss", "BCEWithLogitsLoss"])
def test_weighted_losses_match_jax(name):
    logits, targets, weights = _data(2)
    _check_loss(jl.get_weighted_loss(name), tl.get_weighted_loss(name),
                logits, targets, weights)
    # all-ones weights give the plain loss
    ones = np.ones(len(logits), np.float32)
    t = torch.from_numpy
    np.testing.assert_allclose(tl.get_weighted_loss(name)(t(logits), t(targets), t(ones)).item(),
                               tl.get_loss(name)(t(logits), t(targets)).item(), **TOL)


@pytest.mark.parametrize("per_image", [True, False])
def test_lovasz_hinge_with_ties_matches_jax(per_image):
    # logits with many equal values: the stable descending sort decides the order
    rng = np.random.default_rng(3)
    logits = rng.integers(-2, 3, (2, 8, 8)).astype(np.float32)
    labels = (rng.random((2, 8, 8)) > 0.5).astype(np.float32)
    _check_loss(lambda x, y: jl.lovasz_hinge(x, y, per_image=per_image),
                lambda x, y: tl.lovasz_hinge(x, y, per_image=per_image), logits, labels)


def test_metrics_match_jax():
    logits, targets, weights = _data(4, shape=(3, 12, 12, 1))
    t, j = torch.from_numpy, jnp.asarray
    pairs = [
        (tm.iou_score(t(logits), t(targets)), jm.iou_score(j(logits), j(targets))),
        (tm.iou_score_weighted(t(logits), t(targets), t(weights)),
         jm.iou_score_weighted(j(logits), j(targets), j(weights))),
        (tm.dice_coef(t(logits), t(targets)), jm.dice_coef(j(logits), j(targets))),
        (tm.pixel_accuracy(t(logits), t(targets)), jm.pixel_accuracy(j(logits), j(targets))),
    ]
    for got, ref in pairs:
        assert isinstance(got, torch.Tensor) and got.dim() == 0
        np.testing.assert_allclose(got.item(), float(ref), **TOL)
    pred, tgt = logits > 0, targets > 0.5
    counts = tm.numeric_score(t(pred), t(tgt))
    ref = jm.numeric_score(j(pred), j(tgt))
    assert [int(c) for c in counts] == [int(r) for r in ref]
    assert sum(int(c) for c in counts) == logits.size


def test_unknown_loss_names_raise():
    with pytest.raises(KeyError, match="available"):
        tl.get_loss("Dice")
    with pytest.raises(KeyError, match="available"):
        tl.get_weighted_loss("Dice")
    assert tl.LOSS_NAMES == jl.LOSS_NAMES
