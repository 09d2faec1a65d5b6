"""The port's data-parallel path (parallel/mesh.py and the BN sync through
K1-K3) against the JAX package over the global batch.

Two OS processes form a Gloo world on 127.0.0.1 (2 intra-op threads each)
and each runs every case below on its rows of a global batch (`_worker`,
this file run as a script); the test process holds their outputs against
the JAX package's single-device functions over the whole batch, float32:

- plain K1 sums -> all-reduce -> bn_finish against JAX `bn_stats` plus the
  finish over all the rows, the running statistics included (1e-6);
- `FusedBatchNormReLU` forward and backward against the JAX module with its
  Pallas kernels in interpret mode (y 2e-5, statistics 1e-5, gradients
  2e-4 as tests/test_torch_fused_bn.py holds the one-process module; the
  parameter gradients are each rank's own, summed here);
- `BatchNorm` (two-pass moments, as `_TorchBN` under an axis name) and
  `FlaxBatchNorm` (flax's `nn.BatchNorm`) likewise, and `BatchNorm` with one
  value per channel on each rank (N*H*W = 1 locally, 2 globally);
- a narrow NestedUNet train step (nb_filter 4..64, 32x32, global batch 4,
  augment none, the BN-fed conv biases at 0) against `jax.value_and_grad`:
  loss 1e-5, running statistics 1e-5, gradients 1e-4 relative L2; its eval
  step on a padded batch against the port's one-process eval step; under
  --remat full the same step with K1's recompute leaving the statistics;
- dropout masks drawn for the global batch; the optimizer averaging once per
  accumulated update and skipping a non-finite update on every rank; the
  ranks' rows gathered in rank order (`make_global_array`).
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_nested_unet_tpu.models import create_model as jax_create_model
from pytorch_nested_unet_tpu.ops import fused_bn as jbn
from pytorch_nested_unet_tpu.ops.layers import BatchNorm as JaxBatchNorm
from pytorch_nested_unet_tpu.parallel import mesh as jmesh
from pytorch_nested_unet_tpu.parallel import multihost as jmultihost
from pytorch_nested_unet_tpu_torch.models import create_model
from pytorch_nested_unet_tpu_torch.ops import fused_bn as tbn
from pytorch_nested_unet_tpu_torch.ops import layers as tlayers
from pytorch_nested_unet_tpu_torch.parallel import mesh as tmesh
from pytorch_nested_unet_tpu_torch.parallel import multihost as tmultihost
from pytorch_nested_unet_tpu_torch.training.loop import make_eval_step
from pytorch_nested_unet_tpu_torch.utils.convert import state_dict_from_jax

NARROW = (4, 8, 16, 32, 64)
WORLD = 2
BATCH = 4  # the global batch of the NestedUNet step
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


# ------------------------------------------------------------------ one process

@pytest.mark.parametrize("spec", ["data=4", "data=4,x=2", " data = 2 , model=2 ,", "y=1"])
def test_parse_mesh_spec_matches_jax(spec):
    assert tmesh.parse_mesh_spec(spec) == jmesh.parse_mesh_spec(spec)


@pytest.mark.parametrize("spec", ["", "data", "data=0", "data=x", "data=2,data=2"])
def test_parse_mesh_spec_refuses_as_jax(spec):
    with pytest.raises(ValueError) as want:
        jmesh.parse_mesh_spec(spec)
    with pytest.raises(ValueError) as got:
        tmesh.parse_mesh_spec(spec)
    assert str(got.value) == str(want.value)


def test_global_batch_slice_matches_jax(monkeypatch):
    assert tmultihost.global_batch_slice(16) == jmultihost.global_batch_slice(16) == (16, 0)
    monkeypatch.setattr(jax, "process_count", lambda: 4)
    monkeypatch.setattr(jax, "process_index", lambda: 2)
    monkeypatch.setattr(tmultihost, "process_count", lambda: 4)
    monkeypatch.setattr(tmultihost, "process_index", lambda: 2)
    assert tmultihost.global_batch_slice(16) == jmultihost.global_batch_slice(16) == (4, 8)
    for fn in (tmultihost.global_batch_slice, jmultihost.global_batch_slice):
        with pytest.raises(ValueError, match="not divisible"):
            fn(10)


def test_one_process_mesh_and_its_refusals():
    mesh = tmesh.make_mesh()
    assert mesh.shape == {"data": 1} and mesh.group is None and mesh.index == 0
    assert tmesh.batch_sharding(mesh, 6) == slice(0, 6)
    # the 'x'/'y' axes (tests/test_torch_spatial.py) and 'model'
    # (tests/test_torch_model_axis.py) are ported; an axis the JAX package
    # does not have is not
    spatial = tmesh.make_mesh((1, 1), ("data", "y"))
    assert spatial.spatial and tmesh.batch_sharding(spatial, 6) == slice(0, 6)
    for names in (("model",), ("data", "model")):
        tp = tmesh.make_mesh((1,) * len(names), names)
        assert tp.tensor_parallel and not tp.spatial and tp.model_group is None
    with pytest.raises(ValueError, match="'pipe' mesh axis is not ported"):
        tmesh.make_mesh((1, 1), ("data", "pipe"))
    # under x/y the JAX rule alone: bands that the 4 pools split (empty at
    # 1/16), ResNet50FCN, the levels of UNetRM7 at 96x96 (3 -> 1 rows) are
    # accepted; a height x does not divide is not
    tmesh.check_spatial("UNet", (32, 32), {"x": 4})
    tmesh.check_spatial("ResNet50FCN", (32, 32), {"x": 2})
    tmesh.check_spatial("UNetRM7", (96, 96), {"x": 2})
    with pytest.raises(ValueError, match="multiple of x = 3"):
        tmesh.check_spatial("UNet", (32, 32), {"x": 3})
    with pytest.raises(ValueError, match="needs 2 processes, have 1"):
        tmesh.make_mesh((2,))


@pytest.mark.parametrize("loss", ["BCEDiceLoss", "LovaszHingeLoss", "BCEWithLogitsLoss"])
def test_weighted_loss_sums_add_over_shards(loss):
    """Each eval loss is a finish over sums that add across the shards of a
    padded batch (the last shard all padding): one process's value."""
    from pytorch_nested_unet_tpu_torch.losses import get_weighted_loss, get_weighted_loss_sums

    rng = np.random.default_rng(5)
    logits = torch.from_numpy(rng.standard_normal((6, 8, 8, 1)).astype(np.float32))
    masks = torch.from_numpy((rng.random((6, 8, 8, 1)) > 0.5).astype(np.float32))
    w = torch.tensor([1.0, 1.0, 1.0, 1.0, 0.0, 0.0])
    sums, finish = get_weighted_loss_sums(loss)
    want = get_weighted_loss(loss)(logits, masks, w)
    assert torch.equal(finish(sums(logits, masks, w)), want)
    shards = sum(sums(logits[i:i + 2], masks[i:i + 2], w[i:i + 2]) for i in (0, 2, 4))
    assert abs(float(finish(shards)) - float(want)) <= 1e-6


# ------------------------------------------------------------------ the 2-rank worker

def _worker(rank, port, d):
    """Every multi-rank case on this rank's rows; writes out<rank>.pt."""
    import torch.distributed as dist

    from pytorch_nested_unet_tpu_torch.parallel import (batch_sharding, initialize_distributed,
                                                        make_global_array, make_mesh,
                                                        sync_batch_norm)
    from pytorch_nested_unet_tpu_torch.training import optim
    from pytorch_nested_unet_tpu_torch.training.loop import make_train_step

    torch.set_num_threads(2)
    initialize_distributed(backend="gloo", init_method=f"tcp://127.0.0.1:{port}",
                           world_size=WORLD, rank=rank)
    mesh = make_mesh()
    inp = torch.load(os.path.join(d, "in.pt"), weights_only=False)
    out = {}

    def mine(a):  # this rank's rows of a global array
        return torch.from_numpy(np.ascontiguousarray(a[batch_sharding(mesh, len(a))]))

    # plain K1 split: sums, all-reduce, finish over the global rows
    x = mine(inp["k1_x"])
    rm, rv = (torch.from_numpy(v.copy()) for v in inp["k1_run"])
    sums = tbn.bn_sums(x)
    dist.all_reduce(sums)
    out["k1"] = [t.numpy() for t in tbn.bn_finish(sums, len(inp["k1_x"]), 1e-5, rm, rv)]
    out["k1_run"] = [rm.numpy(), rv.numpy()]
    out["gathered"] = make_global_array(x).numpy()

    # the BN modules: two train calls (running stats), grads of sum(y * ct)
    for name, (cls, kw) in {"fused": (tbn.FusedBatchNormReLU, {}),
                            "plain": (tlayers.BatchNorm, {}),
                            "one_value": (tlayers.BatchNorm, {}),
                            "flax": (tlayers.FlaxBatchNorm, {"momentum": 0.1})}.items():
        x, ct, gamma, beta = inp[name]
        mod = cls(x.shape[-1], **kw).train()
        with torch.no_grad():
            mod.weight.copy_(torch.from_numpy(gamma))
            mod.bias.copy_(torch.from_numpy(beta))
        sync_batch_norm(mod, mesh)
        xt = mine(x).requires_grad_(True)
        mod(xt.detach())
        y = mod(xt)
        (y * mine(ct)).sum().backward()
        out[name] = {"y": y.detach().numpy(), "dx": xt.grad.numpy(),
                     "dgamma": mod.weight.grad.numpy(), "dbeta": mod.bias.grad.numpy(),
                     "mean": mod.running_mean.numpy(), "var": mod.running_var.numpy()}

    # dropout masks of the global batch
    drop = tlayers.Dropout(0.5, torch.Generator().manual_seed(5)).train()
    chan = tlayers.ChannelDropout(0.5, torch.Generator().manual_seed(6)).train()
    sync_batch_norm(drop, mesh)
    sync_batch_norm(chan, mesh)
    ones = torch.ones(BATCH // WORLD, 3, 3, 4)
    out["dropout"] = [drop(ones).numpy(), chan(ones).numpy()]

    # NestedUNet: one train step (plain and --remat full), the eval step
    imgs, masks = mine(inp["imgs"]), mine(inp["masks"])
    for remat in (False, "full"):
        finish_calls = {"with_stats": 0, "without": 0}
        plain_finish = tbn.reference_bn_finish

        def counted(s, ss, n, eps=1e-5, running_mean=None, running_var=None, momentum=0.9):
            finish_calls["with_stats" if running_mean is not None else "without"] += 1
            return plain_finish(s, ss, n, eps, running_mean, running_var, momentum)

        tbn.reference_bn_finish = counted
        m = create_model("NestedUNet", 1, 3, True, nb_filter=NARROW, remat=remat)
        m.load_state_dict(inp["state"], strict=True)
        opt = optim.build_optimizer(m.parameters(), "SGD", 1e-2, 0.9, 1e-4)
        step = make_train_step(m, opt, "BCEDiceLoss", True, "none", mesh)
        metrics = step(imgs, masks, torch.Generator().manual_seed(0))
        tbn.reference_bn_finish = plain_finish
        out[f"step_{remat}"] = {
            "metrics": {k: v.item() for k, v in metrics.items()},
            "grads": {n: p.grad.numpy().copy() for n, p in m.named_parameters()},
            "stats": {n: b.numpy().copy() for n, b in m.named_buffers()},
            "finish_calls": finish_calls}
    m = create_model("NestedUNet", 1, 3, True, nb_filter=NARROW)
    m.load_state_dict(inp["state"], strict=True)
    ev = make_eval_step(m, "BCEDiceLoss", True, mesh)
    out["eval"] = {k: v.item() for k, v in
                   ev(imgs, masks, mine(np.array([1, 1, 1, 0], np.float32))).items()}

    # the optimizer: one average per accumulated update; a non-finite
    # gradient on one rank skips the update on both
    calls = []
    real = optim.all_reduce_mean_
    optim.all_reduce_mean_ = lambda ts, mh: (calls.append(len(ts)), real(ts, mh))
    w = torch.nn.Parameter(torch.ones(3))
    acc = optim.build_optimizer([w], "SGD", 0.1, 0.0, 0.0, accum_steps=2)
    acc.mesh = mesh
    for k in range(2):
        acc.zero_grad()
        (w * torch.tensor([1.0, 2.0, 3.0]) * (rank + 1 + k)).sum().backward()
        acc.step()
    guard = optim.build_optimizer([w], "SGD", 0.1, 0.0, 0.0, skip_nonfinite=1)
    guard.mesh = mesh
    before = w.detach().clone()
    guard.zero_grad()
    (w * (float("nan") if rank == 1 else 1.0)).sum().backward()
    guard.step()
    optim.all_reduce_mean_ = real
    out["optim"] = {"calls": calls, "after_accum": before.numpy(),
                    "after_skip": w.detach().numpy(), "skipped": guard.total_notfinite}

    torch.save(out, os.path.join(d, f"out{rank}.pt"))
    dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _bn_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    return [(rng.standard_normal(shape) * 1.5 + 0.3).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32),
            rng.uniform(0.5, 1.5, c).astype(np.float32),
            rng.uniform(-0.3, 0.3, c).astype(np.float32)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Inputs (numpy, from seeds), the JAX variables of the NestedUNet step,
    and the two ranks' outputs."""
    from test_torch_crdn import jax_variables, train_batch, zero_bn_fed_biases

    d = tmp_path_factory.mktemp("dp")
    rng = np.random.default_rng(0)
    jm = jax_create_model("NestedUNet", 1, 3, True, nb_filter=NARROW)
    imgs, masks = train_batch(0, b=BATCH, hw=32)
    variables = zero_bn_fed_biases(jax_variables(jm, imgs.shape, 0))
    inp = {"k1_x": (rng.standard_normal((2 * 150, 24)) * 1.5 + 0.3).astype(np.float32),
           "k1_run": [rng.standard_normal(24).astype(np.float32) * 0.1,
                      rng.uniform(0.5, 2.0, 24).astype(np.float32)],
           "fused": _bn_inputs((4, 6, 5, 32), 1), "plain": _bn_inputs((4, 5, 6, 16), 2),
           "one_value": _bn_inputs((2, 1, 1, 8), 3), "flax": _bn_inputs((4, 5, 5, 16), 4),
           "imgs": imgs, "masks": masks,
           "state": state_dict_from_jax(jax.device_get(variables))}
    torch.save(inp, d / "in.pt")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, HERE]), OMP_NUM_THREADS="2",
               JAX_PLATFORMS="cpu")
    procs = []
    try:
        for rank in range(WORLD):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(rank), str(port), str(d)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        # a hung collective must not leave live workers behind
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log[-3000:]}"
    outs = [torch.load(d / f"out{r}.pt", weights_only=False) for r in range(WORLD)]
    return inp, outs, jm, variables


def _cat(outs, *keys):
    vals = []
    for o in outs:
        for k in keys:
            o = o[k]
        vals.append(o)
    return np.concatenate(vals)


def _both(outs, *keys):
    """The value every rank holds (asserted equal across ranks)."""
    vals = []
    for o in outs:
        for k in keys:
            o = o[k]
        vals.append(o)
    for v in vals[1:]:
        np.testing.assert_array_equal(v, vals[0])
    return vals[0]


def test_k1_sums_all_reduce_finish_matches_jax_bn_stats(ranks):
    inp, outs, _, _ = ranks
    x = inp["k1_x"]
    jbn.enable_fused_bn(True, interpret=True, mode="full")
    try:
        s, ss = (np.asarray(a) for a in jbn.bn_stats(jnp.asarray(x)))
    finally:
        jbn.enable_fused_bn(False, interpret=False)
    n = len(x)
    mean = s / n
    var = np.maximum(ss / n - mean * mean, 0.0)
    rm, rv = inp["k1_run"]
    want = [mean, var, 1 / np.sqrt(var + 1e-5), 0.9 * rm + 0.1 * mean,
            0.9 * rv + 0.1 * var * n / (n - 1)]
    got = [*_both(outs, "k1"), *_both(outs, "k1_run")]
    for name, g, w in zip(("mean", "var", "inv", "running_mean", "running_var"), got, want):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-6, err_msg=name)


def test_make_global_array_gathers_the_ranks_rows_in_order(ranks):
    inp, outs, _, _ = ranks
    np.testing.assert_array_equal(_both(outs, "gathered"), inp["k1_x"])


def test_fused_bn_relu_two_ranks_match_jax(ranks):
    from test_torch_fused_bn import _jax_module_step

    inp, outs, _, _ = ranks
    x, ct, gamma, beta = inp["fused"]
    jbn.enable_fused_bn(True, interpret=True, mode="full")
    try:
        assert jbn._use_pallas(jnp.asarray(x)), "the JAX side must take the Pallas path"
        y, stats, dx, dp = _jax_module_step(x, jnp.asarray(ct), gamma, beta)
    finally:
        jbn.enable_fused_bn(False, interpret=False)
    np.testing.assert_allclose(_cat(outs, "fused", "y"), np.asarray(y), atol=2e-5)
    np.testing.assert_allclose(_both(outs, "fused", "mean"), np.asarray(stats["mean"]),
                               atol=1e-5)
    np.testing.assert_allclose(_both(outs, "fused", "var"), np.asarray(stats["var"]),
                               atol=1e-5)
    np.testing.assert_allclose(_cat(outs, "fused", "dx"), np.asarray(dx), atol=2e-4, rtol=1e-4)
    for key, ref in (("dgamma", dp["scale"]), ("dbeta", dp["bias"])):
        got = sum(o["fused"][key] for o in outs)  # each rank's own: the optimizer adds them
        np.testing.assert_allclose(got, np.asarray(ref), atol=2e-4, rtol=1e-4, err_msg=key)


def _flax_bn_step(x, ct, gamma, beta, flax_bn):
    """JAX train-mode BN over the global batch, called twice: y, the
    running statistics, and the gradients of sum(y * ct)."""
    import flax.linen as nn

    m = (nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5) if flax_bn
         else JaxBatchNorm(use_running_average=False))
    variables = m.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = variables["params"]
    leaf = params if flax_bn else params["bn"]
    leaf["scale"], leaf["bias"] = jnp.asarray(gamma), jnp.asarray(beta)
    stats = variables["batch_stats"]
    for _ in range(2):
        y, mut = m.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                         mutable=["batch_stats"])
        stats = mut["batch_stats"]

    def f(xx, pp):
        out, _ = m.apply({"params": pp, "batch_stats": variables["batch_stats"]}, xx,
                         mutable=["batch_stats"])
        return jnp.sum(out * ct)

    dx, dp = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), params)
    stats = stats if flax_bn else stats["bn"]
    dp = dp if flax_bn else dp["bn"]
    return y, stats, dx, dp


@pytest.mark.parametrize("name", ["plain", "one_value", "flax"])
def test_plain_batch_norms_two_ranks_match_jax(ranks, name):
    """`BatchNorm` against the JAX package's (`_TorchBN`) and `FlaxBatchNorm`
    against flax's `nn.BatchNorm`, over the global batch; "one_value": each
    rank holds one value per channel, so the moments of 2 values are taken
    (the one-value branch of `BatchNorm` would give var 0)."""
    inp, outs, _, _ = ranks
    x, ct, gamma, beta = inp[name]
    y, stats, dx, dp = _flax_bn_step(x, ct, gamma, beta, name == "flax")
    np.testing.assert_allclose(_cat(outs, name, "y"), np.asarray(y), atol=1e-5)
    np.testing.assert_allclose(_both(outs, name, "mean"), np.asarray(stats["mean"]), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(_both(outs, name, "var"), np.asarray(stats["var"]), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(_cat(outs, name, "dx"), np.asarray(dx), atol=1e-4, rtol=1e-4)
    for key, ref in (("dgamma", dp["scale"]), ("dbeta", dp["bias"])):
        got = sum(o[name][key] for o in outs)
        np.testing.assert_allclose(got, np.asarray(ref), atol=1e-4, rtol=1e-4, err_msg=key)


def test_dropout_masks_are_the_global_batch_draws(ranks):
    _, outs, _, _ = ranks
    ones = torch.ones(BATCH, 3, 3, 4)
    drop = tlayers.Dropout(0.5, torch.Generator().manual_seed(5)).train()
    chan = tlayers.ChannelDropout(0.5, torch.Generator().manual_seed(6)).train()
    np.testing.assert_array_equal(np.concatenate([o["dropout"][0] for o in outs]),
                                  drop(ones).numpy())
    np.testing.assert_array_equal(np.concatenate([o["dropout"][1] for o in outs]),
                                  chan(ones).numpy())


def _jax_step(jm, variables, imgs, masks):
    from pytorch_nested_unet_tpu.data.augment import eval_transform
    from pytorch_nested_unet_tpu.losses import get_loss

    loss_fn = get_loss("BCEDiceLoss")

    def f(params):
        x, m = eval_transform(imgs, masks)
        heads, mut = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                              train=True, mutable=["batch_stats"])
        return sum(loss_fn(o, m) for o in heads) / len(heads), mut["batch_stats"]

    (loss, stats), grads = jax.device_get(
        jax.jit(jax.value_and_grad(f, has_aux=True))(variables["params"]))
    return float(loss), state_dict_from_jax({"params": grads, "batch_stats": stats})


@pytest.mark.parametrize("remat", [False, "full"])
def test_nested_unet_step_two_ranks_matches_jax(ranks, remat):
    """The 2-rank step over the global batch of 4 against the JAX package's
    single-device step: loss 1e-5, running statistics 1e-5, every gradient
    within 1e-4 relative L2 (of the larger of its own norm and its module's
    weight gradient norm: a BN-fed conv bias has a true gradient of 0); every
    rank holds the same values. Under --remat full the recompute runs K1's
    finish again without the running statistics (30 + 30 calls)."""
    inp, outs, jm, variables = ranks
    want_loss, want = _jax_step(jm, variables, inp["imgs"], inp["masks"])
    key = f"step_{remat}"
    loss = _both(outs, key, "metrics", "loss")
    assert abs(loss - want_loss) <= 1e-5
    for name in outs[0][key]["stats"]:
        np.testing.assert_allclose(_both(outs, key, "stats", name), want[name].numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
    grads = {n: _both(outs, key, "grads", n) for n in outs[0][key]["grads"]}
    for name, g in grads.items():
        w = want[name].numpy()
        den = max(np.linalg.norm(w), np.linalg.norm(want[name.rsplit(".", 1)[0] + ".weight"]))
        assert np.linalg.norm(g - w) / den <= 1e-4, name
    assert outs[0][key]["finish_calls"] == {"with_stats": 30,
                                            "without": 30 if remat else 0}
    if remat:  # the same step as without remat
        base = outs[0]["step_False"]
        assert outs[0][key]["metrics"] == base["metrics"]
        for name, s in outs[0][key]["stats"].items():
            np.testing.assert_array_equal(s, base["stats"][name])


def test_eval_step_two_ranks_matches_one_process(ranks):
    """The padded global batch (weights 1, 1, 1, 0) split over two ranks
    scores as one process scores it."""
    inp, outs, _, _ = ranks
    m = create_model("NestedUNet", 1, 3, True, nb_filter=NARROW)
    m.load_state_dict(inp["state"], strict=True)
    want = make_eval_step(m, "BCEDiceLoss", True)(
        torch.from_numpy(inp["imgs"]), torch.from_numpy(inp["masks"]),
        torch.tensor([1.0, 1.0, 1.0, 0.0]))
    got = _both(outs, "eval")
    assert abs(got["loss"] - want["loss"].item()) <= 1e-6
    assert got["iou"] == pytest.approx(want["iou"].item(), abs=1e-7)
    assert got["acc"] == want["acc"].item()


def test_optimizer_averages_once_per_update_and_skips_on_every_rank(ranks):
    _, outs, _, _ = ranks
    for o in outs:
        # accum_steps 2: one all-reduce for two micro-batches; then the NaN
        # of rank 1 reaches rank 0 through the average, and both skip
        assert o["optim"]["calls"] == [1, 1] and o["optim"]["skipped"] == 1
        np.testing.assert_array_equal(o["optim"]["after_skip"], o["optim"]["after_accum"])
    # the mean over 2 micro-batches and 2 ranks of g * (rank + 1 + k)
    np.testing.assert_allclose(outs[0]["optim"]["after_accum"],
                               1.0 - 0.1 * np.array([1.0, 2.0, 3.0]) * 2.0, rtol=1e-6)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
