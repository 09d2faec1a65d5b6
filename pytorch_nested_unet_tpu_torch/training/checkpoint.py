"""Checkpoints and the capsule (counterpart of training/checkpoint.py).

  models/<name>/config.yml  the config capsule (utils/config.py)
  models/<name>/model.pth   best-IoU weights: the float32 CPU state dict in
                            the reference key layout (reference
                            trains.py:344-349); the JAX package imports it
                            with `convert.py --pth`
  models/<name>/last.pth    the resume state: model, optimizer (its buffers
                            and non-finite counters), epoch, best_iou, trigger
  models/<name>/orbax_last/ the same state with --checkpoint_backend orbax:
                            each rank's slices as DTensors, written by every
                            rank through torch.distributed.checkpoint (the
                            counterpart of the JAX package's orbax directory)

In data-parallel runs only rank 0 writes model.pth and last.pth, so only
rank 0's last.pth counts: `load_training_state` with a mesh reads it on rank 0
and broadcasts the outcome and the state to every rank. Both files hold the
whole (unsharded) state in every layout: under a 'model' axis every rank
joins the gather of the slices (`save_model` and `save_training_state` are
called on every rank, `write` on rank 0 alone), so they restore under any
mesh, each rank taking its slices of the mesh it runs under. The sharded
directory restores under any mesh too: its DTensors are read back into this
rank's slices of the mesh it runs under, whatever mesh wrote them.
"""

import json
import os
import shutil

import torch
import torch.distributed as dist

from ..models import PRECISIONS, create_model, parse_arch_kwargs, remat_kwargs
from ..parallel.mesh import full_weights, load_full_state, tensor_parallel_of
from ..parallel.multihost import broadcast_object
from ..utils.config import load_config
from ..utils.convert import load_reference_pth

SHARDED_DIR = "orbax_last"


def _whole_state(model: torch.nn.Module):
    """A copy of `model`'s state dict, whole, on the CPU (gathered on the
    'model' axis; a copy, so nothing outside holds the storage of a weight
    that is freed again)."""
    with full_weights(model):
        return {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}


def save_model(model_dir: str, model: torch.nn.Module, write: bool = True):
    """Write `model`'s weights as model.pth (reference layout, float32, CPU)
    where `write`; on the 'model' axis every rank must call it (the gather)."""
    if not write and tensor_parallel_of(model) is None:
        return
    state = {k: v.to(torch.float32) for k, v in _whole_state(model).items()}
    if write:
        torch.save(state, os.path.join(model_dir, "model.pth"))


def build_from_config(config: dict, precision=None, generator=None) -> torch.nn.Module:
    """The model a capsule's config describes, on the CPU; precision None
    takes the config's. The config's `remat` reaches the archs that have the
    option."""
    precision = precision or config.get("precision") or "fp32"
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {sorted(PRECISIONS)}, got {precision!r}")
    return create_model(config["arch"], config["num_classes"], config["input_channels"],
                        config["deep_supervision"], dtype=PRECISIONS[precision],
                        generator=generator,
                        **{**remat_kwargs(config["arch"], config.get("remat")),
                           **parse_arch_kwargs(config["arch"], config.get("arch_kwargs"))})


def load_capsule(model_dir: str, precision=None):
    """Rebuild a trained model from models/<name>/: read config.yml, build
    the arch (in `precision`, default the capsule's), load model.pth strict.
    Returns (model on the CPU in eval mode, config) — the loading path of
    val.py and infer.py (reference val.py:34-59)."""
    config = load_config(model_dir)
    model = build_from_config(config, precision)
    model.load_state_dict(load_reference_pth(os.path.join(model_dir, "model.pth"),
                                             config["arch"], getattr(model, "decoder", None),
                                             init=model.state_dict()), strict=True)
    return model.eval(), config


def save_training_state(model_dir: str, model, optimizer, epoch: int, best_iou: float,
                        trigger: int, write: bool = True):
    """Write last.pth (where `write`) through a temporary file, so a run cut
    while writing leaves the previous state whole; on the 'model' axis every
    rank must call it (the gathers)."""
    if not write and tensor_parallel_of(model) is None:
        return
    state = {"model": _whole_state(model), "optimizer": optimizer.state_dict(),
             "epoch": int(epoch), "best_iou": float(best_iou), "trigger": int(trigger)}
    if not write:
        return
    path = os.path.join(model_dir, "last.pth")
    torch.save(state, path + ".tmp")
    os.replace(path + ".tmp", path)


def _restore(state, path, model, optimizer):
    try:
        optimizer.load_state_dict(state["optimizer"])
    except (KeyError, ValueError) as e:
        raise ValueError(f"{path} does not match the current optimizer state layout: "
                         f"--optimizer/--skip_nonfinite/--accum_steps must match the "
                         f"original run ({e})") from e
    load_full_state(model, state["model"])
    return int(state["epoch"]), float(state["best_iou"]), int(state["trigger"])


def load_training_state(model_dir: str, model, optimizer, mesh=None):
    """Restore last.pth into `model` and `optimizer`; returns (epoch,
    best_iou, trigger), or None when there is no last.pth. Raises ValueError
    when the optimizer's layout (--optimizer, --skip_nonfinite,
    --accum_steps) differs from the saved one's.

    With a mesh over processes, rank 0 (the only writer) reads its last.pth
    and broadcasts whether it restored one (or its error, which every rank
    then raises) and then the state, which every rank restores: a rank
    without the file (no shared filesystem) resumes as rank 0 does. On a
    'model' axis each rank keeps its slices of the whole state."""
    path = os.path.join(model_dir, "last.pth")
    if mesh is None or mesh.group is None:
        if not os.path.exists(path):
            return None
        return _restore(torch.load(path, map_location="cpu", weights_only=True), path,
                        model, optimizer)
    state = err = None
    if mesh.rank == 0 and os.path.exists(path):
        state = torch.load(path, map_location="cpu", weights_only=True)
        try:
            _restore(state, path, model, optimizer)
        except ValueError as e:
            err = str(e)
    flag, err = broadcast_object((-1 if err else int(state is not None), err), group=mesh.group)
    if flag < 0:
        raise ValueError(err)
    if not flag:
        return None
    state = broadcast_object(state, group=mesh.group)
    if mesh.rank != 0:
        _restore(state, path, model, optimizer)
    return int(state["epoch"]), float(state["best_iou"]), int(state["trigger"])


def _sharded_entries(model, optimizer, mesh):
    """This rank's train state as flat {key: tensor}: `model.<name>` and
    `optim.<i>.<key>` (the inner optimizer's state of parameter i), each
    slice of a 'model' axis as a DTensor (Shard(dim) over 'model',
    replicated over the other axes of `mesh.device_mesh`), everything else
    whole; `acc.<i>` the gradient accumulator."""
    tp = tensor_parallel_of(model)
    entries = {f"model.{k}": v for k, v in model.state_dict().items()}
    if tp is not None:
        for p, shard in tp.shards.items():
            entries[f"model.{tp.names[p]}"] = _slice_of(shard, tp.dims[p], mesh)
    for i, (p, target) in enumerate(zip(optimizer.params, optimizer.targets)):
        for k, v in optimizer.inner.state.get(target, {}).items():
            if torch.is_tensor(v):
                sliced = target is not p and v.dim() and v.shape == target.shape
                entries[f"optim.{i}.{k}"] = _slice_of(v, tp.dims[p], mesh) if sliced else v
    for i, a in enumerate(optimizer._acc or ()):
        entries[f"acc.{i}"] = a
    return entries


def _slice_of(local, dim, mesh):
    """`local`, this rank's block of dim `dim` of a tensor sharded over the
    mesh's 'model' axis, as a DTensor (replicated over the other axes)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    placements = [Shard(dim) if a == "model" else Replicate() for a in mesh.axis_names]
    return DTensor.from_local(local, mesh.device_mesh(local.device.type), placements,
                              run_check=False)


def save_training_state_sharded(model_dir: str, model, optimizer, mesh, epoch: int,
                                best_iou: float, trigger: int):
    """--checkpoint_backend orbax: every rank writes its slices of the train
    state into models/<name>/orbax_last/ with torch.distributed.checkpoint
    (every rank calls it; the ranks share one filesystem: one machine).
    Written into orbax_last.tmp first, then renamed by rank 0, so a run cut
    while writing leaves the previous state whole."""
    import torch.distributed.checkpoint as dcp

    entries = _sharded_entries(model, optimizer, mesh)
    opt = optimizer.state_dict(full=False)
    entries["meta"] = json.dumps({
        "epoch": int(epoch), "best_iou": float(best_iou), "trigger": int(trigger),
        "layout": opt["layout"], "notfinite_run": opt["notfinite_run"],
        "total_notfinite": opt["total_notfinite"], "mini_step": opt["mini_step"],
        "acc": opt["acc"] is not None, "param_groups": opt["inner"]["param_groups"]})
    path = os.path.join(model_dir, SHARDED_DIR)
    main = not dist.is_initialized() or dist.get_rank() == 0
    if main:
        shutil.rmtree(path + ".tmp", ignore_errors=True)
    _barrier()
    dcp.save(entries, checkpoint_id=path + ".tmp", no_dist=not dist.is_initialized())
    if main:
        shutil.rmtree(path, ignore_errors=True)
        os.replace(path + ".tmp", path)
    _barrier()


def _barrier():
    if dist.is_initialized():
        dist.barrier()


def load_training_state_sharded(model_dir: str, model, optimizer, mesh=None):
    """Restore save_training_state_sharded's directory into `model` and
    `optimizer` as they are laid out now (sharded over this run's 'model'
    axis or whole), whatever mesh wrote it; returns (epoch, best_iou,
    trigger), or None when there is no directory. Every rank calls it.
    Raises ValueError when the optimizer's layout differs from the saved
    one's."""
    import torch.distributed.checkpoint as dcp

    path = os.path.join(model_dir, SHARDED_DIR)
    if not os.path.isdir(path):
        return None
    no_dist = not dist.is_initialized()
    saved = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    meta_box = {"meta": ""}
    dcp.load(meta_box, checkpoint_id=path, no_dist=no_dist)
    meta = json.loads(meta_box["meta"])
    if meta["layout"] != optimizer.layout():
        raise ValueError(f"{path} does not match the current optimizer state layout: "
                         f"--optimizer/--skip_nonfinite/--accum_steps must match the "
                         f"original run (optimizer state layout {meta['layout']} differs "
                         f"from this optimizer's {optimizer.layout()})")
    tp = tensor_parallel_of(model)
    if tp is not None:
        tp.materialize()
    # the model's entries as they are; the optimizer's as the checkpoint has
    # them (a fresh optimizer has made no state yet)
    targets = {k: v for k, v in _sharded_entries(model, optimizer, mesh).items()
               if k.startswith("model.") or k in saved}
    for key, md in saved.items():
        if key.startswith(("optim.", "acc.")) and key not in targets:
            targets[key] = _fresh_entry(key, md, model, optimizer, mesh)
    dcp.load(targets, checkpoint_id=path, no_dist=no_dist)
    local = {k: (v.to_local() if hasattr(v, "to_local") else v) for k, v in targets.items()}
    sharded = {} if tp is None else {f"model.{n}": tp.shards[p] for p, n in tp.names.items()}
    own = model.state_dict()
    with torch.no_grad():
        for k, v in local.items():
            if k.startswith("model."):
                dst = sharded.get(k, own[k[len("model."):]])
                if dst.data_ptr() != v.data_ptr():
                    dst.copy_(v)
    if tp is not None:
        tp.free()
    state = {}
    for k, v in local.items():
        if k.startswith("optim."):
            _, i, key = k.split(".", 2)
            state.setdefault(int(i), {})[key] = v
    optimizer.load_state_dict({
        "layout": meta["layout"], "sharded": True,
        "inner": {"state": state, "param_groups": meta["param_groups"]},
        "notfinite_run": meta["notfinite_run"], "total_notfinite": meta["total_notfinite"],
        "mini_step": meta["mini_step"],
        "acc": [local[f"acc.{i}"] for i in range(len(optimizer.params))] if meta["acc"]
        else None})
    return int(meta["epoch"]), float(meta["best_iou"]), int(meta["trigger"])


def _fresh_entry(key, md, model, optimizer, mesh):
    """A tensor to read the saved entry `key` (its metadata `md`) into, laid
    out as this run holds it: a slice of a sharded parameter's shape, else
    whole, on the parameter's device."""
    i = int(key.split(".")[1])
    p = optimizer.params[i]
    dtype = md.properties.dtype
    tp = tensor_parallel_of(model)
    if key.startswith("optim.") and tp is not None and p in tp.shards and \
            tuple(md.size) == tuple(p.shape):
        return _slice_of(torch.empty(tp.shards[p].shape, dtype=dtype, device=p.device),
                         tp.dims[p], mesh)
    # a scalar (Adam's step) stays on the host, where torch's Adam keeps it
    return torch.empty(tuple(md.size), dtype=dtype, device=p.device if len(md.size) else "cpu")
