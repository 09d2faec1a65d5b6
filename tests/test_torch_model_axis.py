"""The port's 'model' mesh axis (out-channel-sharded weights and optimizer
state: parallel/mesh.py's `tensor_parallel_spec`, `state_shardings` and
`TensorParallel`, training/optim.py's slices) and its checkpoints
(training/checkpoint.py: last.pth whole, the sharded `orbax_last/`
directory through torch.distributed.checkpoint).

One process: the spec's shape rules (the JAX package's
tests/test_parallel.py rule cases, in the port's layouts) and, leaf by leaf,
what the spec shards of NestedUNet wDS, UNet, CA-Net (dense and transposed
convs) and ResNet50UNet at full width against the JAX package's
`tensor_parallel_spec` on its abstract train state (`jax.eval_shape`,
nothing computed), at 'model' = 2 and 4, with SGD, Adam and SGD with
accum_steps 2 (the JAX count N takes in MultiSteps' accumulator, which the
port keeps whole); the other archs in the slow lane.

Four OS processes over Gloo on 127.0.0.1 (2 intra-op threads each; this
file run as a script is the worker), launched once for every case of the
world (the narrow widths, `min_shardable` lowered to 512 so the deeper
kernels shard):

- NestedUNet wDS under data=2,model=2 (global batch 4, 32x32, SGD, fp32;
  also under `--remat full`) bitwise the port's data=2 step (a 2-rank
  group of the same workers): the loss, the running statistics, every
  updated parameter after gathering;
  and against the JAX package's step on a ('data', 'model') = (2, 2) mesh
  of 4 of its virtual CPU devices with its state_shardings (loss 1e-5,
  running statistics 1e-5, parameters 1e-4 relative L2);
- each rank's slices and its bytes of parameters and optimizer state
  between steps: 1/M of every sharded weight and of its momentum;
- the 'model' peers bitwise alike after two steps and an eval step where
  the peers at coordinate 1 round otherwise (skewed gradients, running
  statistics and heads), under data=2,model=2 and under model=2 alone;
- UNet under x=2,model=2 bitwise the x=2 step;
- the gather of a transposed conv's [in, out, kh, kw] weight along dim 1
  and of a dense weight along dim 0 on a 'model' = 2 mesh of two ranks;
- elasticity (the counterpart of tests/test_mesh_elasticity.py): NestedUNet
  wDS from {x:2, model:2} to {data:4} and the reverse, through last.pth and
  through the sharded directory: the restored state is bitwise the saved
  one, the next step from the checkpoint is bitwise the next step from a
  direct reshard (the whole state loaded into the new layout), and the next
  step's loss across the layouts agrees within rtol 1e-5. The 8-rank
  {data:2, x:2, model:2} <-> {data:8} version is in the slow lane.

The CLI: `train --mesh data=2,model=2 --checkpoint_backend orbax` over 4
processes (one output directory: one machine) against `--mesh data=1` in
one, then `--resume` of its sharded directory under `--mesh data=4`; the
exits of an axis that shards nothing and of orbax across machines.
"""

import copy
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from pytorch_nested_unet_tpu_torch.models import arch_names, create_model
from pytorch_nested_unet_tpu_torch.ops.layers import TorchConvTranspose, TorchDense
from pytorch_nested_unet_tpu_torch.parallel import mesh as tmesh

NARROW = (4, 8, 16, 32, 64)
HW = 32
BATCH = 4  # the global batch of the world-4 steps
MIN = 512  # min_shardable at the narrow widths
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FAST_ARCHS = ("NestedUNet", "UNet", "Comprehensive_Atten_Unet", "ResNet50UNet")


# ------------------------------------------------------------------ one process

def test_tensor_parallel_spec_rules():
    """tests/test_parallel.py's rule cases in the port's layouts: only large
    enough kernels whose out-channels 'model' divides shard (an OIHW conv
    and an [out, in] dense weight along dim 0); biases, BN vectors and
    scalars stay whole. A transposed conv's [in, out, kh, kw] weight is the
    JAX kernel (kh, kw, out, in): the JAX rule splits its in-channels, dim
    0. Each case agrees with the JAX package's spec on the JAX leaf."""
    from jax.sharding import PartitionSpec as P

    from pytorch_nested_unet_tpu.parallel import tensor_parallel_spec as jax_spec

    perm = {4: (2, 3, 1, 0), 2: (1, 0)}  # port layout -> JAX layout
    cases = [((128, 64, 3, 3), 0), ((256, 512), 0), ((128,), None), ((126, 64, 3, 3), None),
             ((4, 4, 3, 3), None), ((), None), ((64, 126, 3, 3), 0), ((126, 128, 3, 3), None)]
    for shape, want in cases:
        t = torch.zeros(shape)
        assert tmesh.tensor_parallel_spec(t, 4) == want, shape
        leaf = np.zeros(t.numpy().transpose(perm[t.dim()]).shape if t.dim() in perm else shape)
        jax_want = P() if want is None else P(*([None] * (leaf.ndim - 1) + ["model"]))
        assert jax_spec(leaf, 4) == jax_want, shape
    ct = TorchConvTranspose(128, 64, 3)
    assert ct.weight.shape == (128, 64, 3, 3) and tmesh.tensor_parallel_spec(ct.weight, 4) == 0
    assert tmesh.tensor_parallel_spec(TorchDense(512, 256).weight, 4) == 0
    assert tmesh.tensor_parallel_spec(torch.zeros(128, 64, 3, 3), 4, min_shardable=10 ** 6) is None


_JAX_TREES = {}


def _jax_tree(arch, ds):
    """The JAX model's abstract variables at full width (jax.eval_shape)."""
    if arch not in _JAX_TREES:
        import jax
        import jax.numpy as jnp

        from pytorch_nested_unet_tpu.models import create_model as jax_create_model

        jm = jax_create_model(arch, 1, 3, ds)
        _JAX_TREES[arch] = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                          jnp.zeros((1, 128, 128, 3), jnp.float32))
    return _JAX_TREES[arch]


OPTIMIZERS = {"SGD": ("SGD", 1), "Adam": ("Adam", 1), "SGD accum 2": ("SGD", 2)}


def _spec_cases():
    for arch in arch_names():
        marks = () if arch in FAST_ARCHS else (pytest.mark.slow,)
        for tp in (2, 4):
            for opt in OPTIMIZERS:
                if opt == "SGD accum 2" and arch != "NestedUNet":
                    continue
                yield pytest.param(arch, tp, opt, marks=marks, id=f"{arch}-{tp}-{opt}")


@pytest.mark.parametrize("arch,tp,opt", _spec_cases())
def test_state_shardings_match_jax_leaf_by_leaf(arch, tp, opt):
    """Each weight of the port's model at full width is sharded (and along
    the dim that is the JAX leaf's last axis) exactly when the JAX package's
    `tensor_parallel_spec` shards the JAX leaf it is carried from
    (`state_dict_from_jax`, which names each leaf), and the port's count N
    is the JAX count over the whole abstract TrainState (parameters and the
    optimizer state's leaves)."""
    import jax

    from pytorch_nested_unet_tpu.parallel import tensor_parallel_spec as jax_spec
    from pytorch_nested_unet_tpu.training import TrainState
    from pytorch_nested_unet_tpu.training import build_optimizer as jax_build_optimizer
    from pytorch_nested_unet_tpu_torch.ops.layers import JAX_KERNEL_TO_PORT
    from pytorch_nested_unet_tpu_torch.training.optim import build_optimizer
    from pytorch_nested_unet_tpu_torch.utils.convert import state_dict_from_jax

    ds = arch == "NestedUNet"
    tree = _jax_tree(arch, ds)
    kind, accum = OPTIMIZERS[opt]
    state = jax.eval_shape(lambda v: TrainState.create(
        v, jax_build_optimizer(kind, 1e-3, 0.9, 1e-4, accum_steps=accum)), tree)
    jax_n = sum("model" in str(jax_spec(leaf, tp)) for leaf in jax.tree.leaves(state))
    leaves, treedef = jax.tree.flatten(tree["params"])
    # each JAX leaf filled with its index, carried across to the port's names
    ids = jax.tree.unflatten(treedef, [np.full(leaf.shape, i, np.float32)
                                       for i, leaf in enumerate(leaves)])
    stats = jax.tree.map(lambda leaf: np.zeros(leaf.shape, np.float32),
                         tree.get("batch_stats", {}))
    index = {k: int(v.reshape(-1)[0]) for k, v in
             state_dict_from_jax({"params": ids, "batch_stats": stats}, arch).items()
             if v.numel()}

    model = create_model(arch, 1, 3, ds)
    optimizer = build_optimizer(model.parameters(), kind, 1e-3, 0.9, 1e-4, accum_steps=accum)
    dims, n = tmesh.state_shardings(model, optimizer, tp)
    named = dict(model.named_parameters())
    assert set(named) <= set(index), sorted(set(named) - set(index))[:5]
    for name, p in named.items():
        leaf = leaves[index[name]]
        jax_sharded = "model" in str(jax_spec(leaf, tp))
        assert (name in dims) == jax_sharded, name
        if jax_sharded:
            perm = JAX_KERNEL_TO_PORT[p.dim()]
            assert dims[name] == perm.index(p.dim() - 1)
            assert p.shape[dims[name]] == leaf.shape[-1], name
    assert dims, f"{arch}: the 'model' axis shards nothing at full width"
    assert n == jax_n


# ------------------------------------------------------------------ the ranks' worker

def _build(inp, arch, ds, mesh, seed_state=True, **kw):
    from pytorch_nested_unet_tpu_torch.training import optim
    from pytorch_nested_unet_tpu_torch.training.loop import make_train_step

    m = create_model(arch, 1, 3, ds, nb_filter=NARROW, **kw)
    if seed_state:
        m.load_state_dict(inp[f"state_{arch}"], strict=True)
    opt = optim.build_optimizer(m.parameters(), "SGD", 1e-2, 0.9, 1e-4)
    if mesh is not None:
        mesh.min_shardable = MIN
    return m, opt, make_train_step(m, opt, "BCEDiceLoss", ds, "none", mesh)


def _whole(m, opt):
    """The model's and the optimizer's state in the whole layout, as numpy
    (a gather on the 'model' axis: every rank of the mesh calls it)."""
    with tmesh.full_weights(m):
        # copies: a numpy view would pin the weights' storage (not resizable)
        model = {k: v.detach().clone().numpy() for k, v in m.state_dict().items()}
    inner = opt.state_dict()["inner"]["state"]
    return {"model": model,
            "optim": {(i, k): v.numpy().copy() for i, st in inner.items()
                      for k, v in st.items() if torch.is_tensor(v)}}


def _step_case(inp, arch, ds, mesh, rows, **kw):
    from pytorch_nested_unet_tpu_torch.training.optim import state_bytes

    m, opt, step = _build(inp, arch, ds, mesh, **kw)
    imgs, masks = (torch.from_numpy(inp[k][rows]) for k in ("imgs", "masks"))
    metrics = step(imgs, masks, torch.Generator().manual_seed(0))
    tp = tmesh.tensor_parallel_of(m)
    out = {"loss": metrics["loss"].item(), "bytes": state_bytes(m, opt),
           "shapes": {n: tuple(p.shape) for n, p in m.named_parameters()},
           "shards": ({} if tp is None else {tp.names[p]: (tuple(s.shape), tp.dims[p])
                                             for p, s in tp.shards.items()}),
           "momentum": {tuple(t.shape) for st in opt.inner.state.values()
                        for t in st.values()},
           "freed": tp is not None and tp.freed}
    out.update(_whole(m, opt))
    return out


def _peer_case(inp, mesh):
    """NestedUNet wDS under data=2,model=2 for two train steps and an eval
    step, with the peers at 'model' coordinate 1 made to round otherwise
    (as a card's backward may): their gradients scaled by 1 + 2^-20, their
    heads moved by 1e-6 after each forward, and their running statistics
    after each train forward.
    Returns each step's metrics and the whole state after them."""
    from pytorch_nested_unet_tpu_torch.training.loop import make_eval_step

    m, opt, step = _build(inp, "NestedUNet", True, mesh)
    if mesh.coords["model"] == 1:
        for p in m.parameters():
            p.register_hook(lambda g: g * (1 + 2 ** -20))

        def skew(module, args, heads):
            with torch.no_grad():
                for b in module.buffers() if module.training else ():
                    b.add_(1e-6)
            return [h + 1e-6 for h in heads]

        m.register_forward_hook(skew)
    rows = tmesh.batch_sharding(mesh, BATCH)
    imgs, masks = (torch.from_numpy(inp[k][rows]) for k in ("imgs", "masks"))
    gen = torch.Generator().manual_seed(0)
    metrics = [step(imgs, masks, gen) for _ in range(2)]
    metrics.append(make_eval_step(m, "BCEDiceLoss", True, mesh)(
        imgs, masks, torch.ones(imgs.shape[0])))
    out = {"metrics": [{k: v.item() for k, v in d.items()} for d in metrics]}
    out.update(_whole(m, opt))
    return out


def _gather_case(group):
    """A transposed conv gathered along dim 1 and a dense weight along dim 0
    on a 'model' = 2 mesh of two ranks: free, gather, whole again."""
    torch.manual_seed(5)
    mod = torch.nn.Module()
    mod.ct = TorchConvTranspose(6, 8, 2)
    mod.fc = TorchDense(10, 4)
    with torch.no_grad():
        for p in mod.parameters():
            p.normal_()
    want = {n: p.detach().clone() for n, p in mod.named_parameters()}
    mesh = tmesh.make_mesh((2,), ("model",), group=group)
    tp = tmesh.TensorParallel(mod, mesh, {"ct.weight": 1, "fc.weight": 0})
    shards = {tp.names[p]: s.clone() for p, s in tp.shards.items()}
    tp.free()
    freed = [p.untyped_storage().nbytes() for p in tp.dims]
    tp.gather()
    return {"want": want, "got": {n: p.detach().clone() for n, p in mod.named_parameters()},
            "shards": shards, "freed": freed, "index": tp.index}


def _elastic(inp, d, rank, a, b, tag, batch):
    """NestedUNet wDS: two steps under mesh `a` ((sizes, names)), saved to
    last.pth and to the sharded directory, then restored under mesh `b` from
    each and from the whole state directly; each restored state whole and
    its next step."""
    from pytorch_nested_unet_tpu_torch.training import checkpoint

    def rows_of(mesh):
        r = tmesh.batch_sharding(mesh, batch)
        return (torch.from_numpy(inp["imgs8"][:batch][r]),
                torch.from_numpy(inp["masks8"][:batch][r]))

    gen = torch.Generator().manual_seed(0)
    mesh_a = tmesh.make_mesh(*a)
    m_a, opt_a, step_a = _build(inp, "NestedUNet", True, mesh_a)
    for _ in range(2):
        step_a(*rows_of(mesh_a), gen)
    saved = _whole(m_a, opt_a)
    whole = {"model": {k: torch.from_numpy(v) for k, v in saved["model"].items()},
             "optim": copy.deepcopy(opt_a.state_dict())}
    ck = os.path.join(d, f"ck_{tag}")
    os.makedirs(ck, exist_ok=True)
    checkpoint.save_training_state(ck, m_a, opt_a, 2, 0.5, 1, write=rank == 0)
    checkpoint.save_training_state_sharded(ck, m_a, opt_a, mesh_a, 2, 0.5, 1)
    out = {"saved": saved, "loss_a": step_a(*rows_of(mesh_a), gen)["loss"].item()}
    mesh_b = tmesh.make_mesh(*b)
    for how in ("pth", "orbax", "direct"):
        m_b, opt_b, step_b = _build(inp, "NestedUNet", True, mesh_b, seed_state=False)
        if how == "pth":
            meta = checkpoint.load_training_state(ck, m_b, opt_b, mesh_b)
        elif how == "orbax":
            meta = checkpoint.load_training_state_sharded(ck, m_b, opt_b, mesh_b)
        else:
            tmesh.load_full_state(m_b, whole["model"])
            opt_b.load_state_dict(whole["optim"])
            meta = (2, 0.5, 1)
        restored = _whole(m_b, opt_b)
        loss = step_b(*rows_of(mesh_b), gen)["loss"].item()
        out[how] = {"meta": meta, "restored": restored, "loss": loss,
                    "after": _whole(m_b, opt_b)}
    return out


# (key, arch, deep supervision, the 'model' mesh's axes, model options):
# each step under the mesh against the mesh without 'model'
CASES = [("NestedUNet", "NestedUNet", True, ("data", "model"), {}),
         ("NestedUNet_remat", "NestedUNet", True, ("data", "model"), {"remat": "full"}),
         ("UNet", "UNet", False, ("x", "model"), {})]


def _worker(world, rank, port, d):
    """Every case of a world of `world` ranks on this rank; writes
    out<world>_<rank>.pt."""
    import torch.distributed as dist

    from pytorch_nested_unet_tpu_torch.parallel import initialize_distributed

    torch.set_num_threads(2)
    initialize_distributed(backend="gloo", init_method=f"tcp://127.0.0.1:{port}",
                           world_size=world, rank=rank)
    inp = torch.load(os.path.join(d, "in.pt"), weights_only=False)
    out = {}
    if world == 4:
        pair = dist.new_group([0, 1])  # every rank creates every group
        for key, arch, ds, names, kw in CASES:
            mesh = tmesh.make_mesh((2, 2), names)
            out[f"{key}_tp"] = _step_case(inp, arch, ds, mesh, tmesh.batch_sharding(mesh, BATCH),
                                          **kw)
            if rank < 2:
                mesh = tmesh.make_mesh((2,), names[:1], group=pair)
                out[f"{key}_ref"] = _step_case(inp, arch, ds, mesh,
                                               tmesh.batch_sharding(mesh, BATCH), **kw)
        out["peers data=2,model=2"] = _peer_case(inp, tmesh.make_mesh((2, 2), ("data", "model")))
        if rank < 2:
            out["peers model=2"] = _peer_case(inp, tmesh.make_mesh((2,), ("model",), group=pair))
            out["gather"] = _gather_case(pair)
        a, b = ((2, 2), ("x", "model")), ((4,), ("data",))
    else:
        a, b = ((2, 2, 2), ("data", "x", "model")), ((8,), ("data",))
    out["shrink"] = _elastic(inp, d, rank, a, b, "shrink", world)
    out["grow"] = _elastic(inp, d, rank, b, a, "grow", world)
    torch.save(out, os.path.join(d, f"out{world}_{rank}.pt"))
    dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(world, d):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, HERE]), OMP_NUM_THREADS="2")
    procs = []
    try:
        for rank in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(world), str(rank), str(port),
                 str(d)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        # a hung collective must not leave live workers behind
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} of {world} failed:\n{log[-3000:]}"
    return [torch.load(d / f"out{world}_{r}.pt", weights_only=False) for r in range(world)]


def _inputs(d):
    """The ranks' inputs from numpy seeds; the weights from the JAX models'
    variables (the BN-fed conv biases at 0)."""
    import jax

    from pytorch_nested_unet_tpu.models import create_model as jax_create_model
    from pytorch_nested_unet_tpu_torch.utils.convert import state_dict_from_jax
    from test_torch_crdn import jax_variables, train_batch, zero_bn_fed_biases

    imgs, masks = train_batch(0, b=BATCH, hw=HW)
    imgs8, masks8 = train_batch(1, b=8, hw=HW)
    inp = {"imgs": imgs, "masks": masks, "imgs8": imgs8, "masks8": masks8}
    jax_side = {}
    for arch, ds in (("UNet", False), ("NestedUNet", True)):
        jm = jax_create_model(arch, 1, 3, ds, nb_filter=NARROW)
        variables = zero_bn_fed_biases(jax_variables(jm, imgs.shape, 0))
        inp[f"state_{arch}"] = state_dict_from_jax(jax.device_get(variables))
        jax_side[arch] = (jm, variables)
    torch.save(inp, d / "in.pt")
    return inp, jax_side


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("model4")
    inp, jax_side = _inputs(d)
    return inp, _launch(4, d), jax_side


def _same(outs, *keys):
    """The value every rank holds (asserted bitwise equal across ranks)."""
    vals = []
    for o in outs:
        for k in keys:
            o = o[k]
        vals.append(o)
    for v in vals[1:]:
        _assert_bitwise(v, vals[0], str(keys))
    return vals[0]


def _assert_bitwise(got, want, what):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), what
        for k in want:
            _assert_bitwise(got[k], want[k], f"{what} {k}")
    elif isinstance(want, (np.ndarray, torch.Tensor)):
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert got == want, what


@pytest.mark.parametrize("arch", [c[0] for c in CASES])
def test_model_axis_step_is_bitwise_the_step_without_it(arch, four_ranks):
    """NestedUNet wDS under data=2,model=2 against data=2 (also under
    `--remat full`, whose recompute in backward reads the gathered weights
    before the update frees them), UNet under x=2,model=2 against x=2 (the
    same weights, rows and bands): the loss, the running statistics, every
    parameter after the update (gathered) and every momentum buffer (whole)
    are bitwise equal, on every rank."""
    outs = four_ranks[1]
    got, want = (_same(outs[:2], f"{arch}_{k}") for k in ("tp", "ref"))
    _same(outs, f"{arch}_tp", "model")
    _same(outs, f"{arch}_tp", "optim")
    assert got["shards"] and not want["shards"]
    assert got["loss"] == want["loss"]
    _assert_bitwise(got["model"], want["model"], f"{arch} model")
    _assert_bitwise(got["optim"], want["optim"], f"{arch} momentum")


@pytest.mark.parametrize("spec,world", [("data=2,model=2", 4), ("model=2", 2)])
def test_model_peers_stay_bitwise_alike_where_they_round_otherwise(spec, world, four_ranks):
    """Where the 'model' peers' computations round differently (the peers
    at coordinate 1 skew their gradients, running statistics and heads),
    every peer still holds bitwise the same state after two steps (weights
    gathered, running statistics, momentum) and reads the same train and
    eval metrics, those of coordinate 0: the gradients, the statistics and
    the metrics are taken from that peer, so each peer's copy of the
    replicated weights and each decision taken from the metrics agree. Under
    data=2,model=2 the gradients are averaged over the batch group first;
    under model=2 alone the batch group is one rank."""
    outs = four_ranks[1][:world]
    for key in ("model", "optim", "metrics"):
        _same(outs, f"peers {spec}", key)


def test_each_rank_holds_its_slices_between_steps(four_ranks):
    """Between steps each rank holds 1/M of every sharded weight (the dim
    the spec names, a block per 'model' coordinate) and of its momentum,
    the whole weights freed: its bytes of parameters and optimizer state
    are the replicated ones less (M - 1)/M of the sharded ones."""
    outs = four_ranks[1]
    for arch in ("NestedUNet", "UNet"):
        ref = outs[0][f"{arch}_ref"]
        for o in outs:
            got = o[f"{arch}_tp"]
            assert got["freed"]
            whole = 0
            for name, shape in got["shapes"].items():
                n = int(np.prod(shape)) * 4
                if name in got["shards"]:
                    sshape, dim = got["shards"][name]
                    want = list(shape)
                    want[dim] //= 2
                    assert list(sshape) == want, name
                    n //= 2
                whole += 2 * n  # the weight and its momentum buffer
            assert got["bytes"] == whole
            assert ref["bytes"] == 2 * 4 * sum(int(np.prod(s)) for s in ref["shapes"].values())
            assert got["bytes"] < ref["bytes"]
            assert {s for s, _ in got["shards"].values()} <= got["momentum"]


def test_model_axis_step_matches_the_jax_model_mesh_step(four_ranks):
    """NestedUNet wDS under data=2,model=2 against the JAX package's step on
    a ('data', 'model') = (2, 2) mesh of 4 virtual CPU devices, its state
    laid out by `state_shardings` with the same min_shardable (so the same
    kernels shard): loss 1e-5, running statistics 1e-5, each updated
    parameter within 1e-4 relative L2 (of the larger of its own norm and
    its module's weight's)."""
    import jax
    import jax.numpy as jnp

    from pytorch_nested_unet_tpu.parallel import make_mesh, state_shardings
    from pytorch_nested_unet_tpu.training import TrainState, build_optimizer, make_train_step
    from pytorch_nested_unet_tpu_torch.utils.convert import state_dict_from_jax

    inp, outs, jax_side = four_ranks
    jm, variables = jax_side["NestedUNet"]
    tx = build_optimizer("SGD", 1e-2, 0.9, 1e-4)
    mesh = make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4])
    state = TrainState.create(variables, tx)
    shardings = state_shardings(mesh, state, min_shardable=MIN)
    step = make_train_step(jm, tx, "BCEDiceLoss", True, augment=False, donate=False, mesh=mesh,
                           state_shardings=shardings)
    new, metrics = step(jax.device_put(state, shardings), jnp.asarray(inp["imgs"]),
                        jnp.asarray(inp["masks"]), jax.random.PRNGKey(0))
    new = jax.device_get(new)
    want = state_dict_from_jax({"params": new.params, "batch_stats": new.batch_stats})
    got = _same(outs, "NestedUNet_tp")
    jax_sharded = sum("model" in str(s.spec) for s in jax.tree.leaves(shardings.params))
    assert jax_sharded == len(got["shards"])
    assert abs(got["loss"] - float(metrics["loss"])) <= 1e-5
    for name, v in got["model"].items():
        w = want[name].numpy()
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v, w, atol=1e-5, rtol=1e-5, err_msg=name)
            continue
        den = max(np.linalg.norm(w), np.linalg.norm(want[name.rsplit(".", 1)[0] + ".weight"]))
        assert np.linalg.norm(v - w) / den <= 1e-4, name


def test_gather_puts_each_block_back_along_its_dim(four_ranks):
    """A transposed conv's [in, out, kh, kw] weight sliced along dim 1 and a
    dense weight along dim 0 on a 'model' = 2 mesh of two ranks: each rank's
    slice is its block, a freed weight holds no bytes, and the gather gives
    the whole weights back bitwise."""
    outs = four_ranks[1]
    for o in outs[:2]:
        g = o["gather"]
        _assert_bitwise(g["got"], g["want"], "gathered")
        assert g["freed"] == [0, 0]
        i = g["index"]
        _assert_bitwise(g["shards"]["ct.weight"], g["want"]["ct.weight"][:, 4 * i:4 * i + 4],
                        "ct slice")
        _assert_bitwise(g["shards"]["fc.weight"], g["want"]["fc.weight"][2 * i:2 * i + 2],
                        "fc slice")


def _hold_elastic(outs, direction):
    got = _same(outs, direction)
    for how in ("pth", "orbax", "direct"):
        r = got[how]
        assert tuple(r["meta"]) == (2, 0.5, 1), how
        _assert_bitwise(r["restored"], got["saved"], f"{direction} {how}: restored != saved")
        np.testing.assert_allclose(r["loss"], got["loss_a"], rtol=1e-5, atol=1e-6,
                                   err_msg=f"{direction} {how}: next step across layouts")
    for how in ("pth", "orbax"):
        assert got[how]["loss"] == got["direct"]["loss"], how
        _assert_bitwise(got[how]["after"], got["direct"]["after"],
                        f"{direction} {how}: next step != the direct reshard's")


@pytest.mark.parametrize("direction", ["shrink", "grow"])
def test_checkpoints_restore_under_another_mesh(direction, four_ranks):
    """{x:2, model:2} -> {data:4} (shrink) and {data:4} -> {x:2, model:2}
    (grow) at world 4, through last.pth and the sharded directory: the
    restored state (weights, statistics, momentum; gathered whole) is
    bitwise the saved one, the next step from either checkpoint is bitwise
    the next step from the whole state loaded directly, and the next step's
    loss agrees with mesh A's next step within rtol 1e-5."""
    _hold_elastic(four_ranks[1], direction)


_EIGHT = {}  # the 8 ranks' outputs, launched once for both directions


@pytest.mark.slow
@pytest.mark.parametrize("direction", ["shrink", "grow"])
def test_checkpoints_restore_under_another_mesh_eight_ranks(direction, tmp_path_factory):
    """{data:2, x:2, model:2} <-> {data:8} at world 8 (global batch 8), as
    tests/test_mesh_elasticity.py runs the JAX package's."""
    key = "eight"
    if key not in _EIGHT:
        d = tmp_path_factory.mktemp("model8")
        _inputs(d)
        _EIGHT[key] = _launch(8, d)
    _hold_elastic(_EIGHT[key], direction)


# ------------------------------------------------------------------ the CLI

KW = '{"nb_filter": [4, 8, 16, 32, 64]}'


def _cli_args(tmp_path, out, extra):
    return ["--data_dir", str(tmp_path / "inputs"), "--output_dir", str(out),
            "--dataset", "synth", "--arch", "UNet", "--arch_kwargs", KW, "--name", "run",
            "--input_w", "32", "--input_h", "32", "--batch_size", "8", "--optimizer", "Adam",
            "--precision", "fp32", "--device", "cpu", *extra]


def _run_cli(tmp_path, world, extra):
    """train.main over `world` processes with torchrun's variables, all on
    one output directory (one machine); returns their outputs."""
    port = _free_port()
    procs = []
    try:
        for rank in range(world):
            env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                       LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "pytorch_nested_unet_tpu_torch.train",
                 *_cli_args(tmp_path, tmp_path / "shared", extra)],
                env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-3000:]}"
    return outs


def test_train_cli_model_axis_orbax_then_resume_under_data4(tmp_path):
    """`train --mesh data=2,model=2 --checkpoint_backend orbax` over 4
    processes for 2 epochs (the narrow UNet: 3 kernels of at least 16,384
    elements, with Adam's 2 moments the JAX count 9; every epoch's
    best-model save and resume state gather on every rank) writes the
    sharded directory and no last.pth, and its log.csv matches `--mesh
    data=1` in one process within tests/test_torch_multihost.py's bounds
    (loss rtol 2e-4 / atol 2e-5, IoU atol 0.02); `--resume` of that
    directory under `--mesh data=4` goes on to a third epoch on every
    rank."""
    import pandas as pd

    from pytorch_nested_unet_tpu_torch import train as ptrain
    from test_torch_multihost import _write_set

    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        _write_set(tmp_path / "inputs", seed=6)
        outs = _run_cli(tmp_path, 4, ["--mesh", "data=2,model=2", "--epochs", "2",
                                      "--checkpoint_backend", "orbax"])
        assert "tensor parallel: 9 kernels sharded over 'model'=2" in outs[0]
        run = tmp_path / "shared" / "run"
        assert (run / "orbax_last" / ".metadata").is_file() and not (run / "last.pth").exists()
        assert (run / "model.pth").is_file()
        ptrain.main(_cli_args(tmp_path, tmp_path / "one", ["--mesh", "data=1", "--epochs", "2"]))
        a = pd.read_csv(run / "log.csv")
        b = pd.read_csv(tmp_path / "one" / "run" / "log.csv")
        for col in ("loss", "val_loss"):
            np.testing.assert_allclose(a[col], b[col], rtol=2e-4, atol=2e-5, err_msg=col)
        for col in ("iou", "val_iou"):
            np.testing.assert_allclose(a[col], b[col], atol=0.02, err_msg=col)
        outs = _run_cli(tmp_path, 4, ["--mesh", "data=4", "--epochs", "3", "--resume", "true",
                                      "--checkpoint_backend", "orbax"])
        assert all("resumed from epoch 1" in out for out in outs)
        assert list(pd.read_csv(run / "log.csv")["epoch"]) == [0, 1, 2]
    finally:
        torch.set_num_threads(before)


def test_train_cli_model_axis_exits(tmp_path, monkeypatch):
    """The JAX CLI's exits: a 'model' axis that shards nothing (the
    narrowest UNet: no kernel reaches 16,384 elements), and orbax across
    machines (LOCAL_WORLD_SIZE below WORLD_SIZE), before any process group
    is formed."""
    from pytorch_nested_unet_tpu_torch import train as ptrain
    from test_torch_multihost import _write_set

    _write_set(tmp_path / "inputs", seed=7)
    args = _cli_args(tmp_path, tmp_path / "m", ["--epochs", "1"])
    args[args.index(KW)] = json.dumps({"nb_filter": [2, 4, 8, 16, 32]})
    with pytest.raises(SystemExit, match="the 'model' axis \\(size 1\\) shards nothing"):
        ptrain.main(args + ["--mesh", "model=1"])
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    with pytest.raises(SystemExit, match="orbax is single-host only"):
        ptrain.main(args + ["--checkpoint_backend", "orbax"])


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
