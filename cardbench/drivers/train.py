"""Training mixes: epochs of the port's epoch runner back to back.

Set-up builds one training step (the port's model, `build_optimizer` and
`make_epoch_runner`, `fit`'s epoch path without the val pass or the saves)
from the seeded weights, drives its first `checked_steps` steps through the
epoch runner on the first rows of epoch 0's seeded order, reads what the
check compares (the losses, the first gradient from the momentum after one
step, every weight's and running statistic's change), runs the rest of epoch
0 as warm-up and hands the same object to the window. The window runs
whole epochs, reading each epoch's metrics to the host as `fit` does, until
`--seconds` have passed; the rate is every image trained over the window's
seconds. The plain reference then follows the checked steps in float64.

With `data_parallel` = N > 1 the run starts N rank processes, one a card
over NCCL (`--mesh data=N`), each taking its rows of every global batch; the
ranks agree at each epoch's end whether the window is over; their readings
and timings come back through files in TMPDIR, and the reference runs here,
on the first card, once they have ended.
"""

import gc
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import time

import torch

from cardbench import reference
from cardbench.lib import card, checks, inputs, trace
from cardbench.lib.spec import Cell
from cardbench.reference.common import Numerics, plain_math

RANK_TIMEOUT_S = 330


class Session:
    """The training step a run measures, built from `seed` on `device`:
    the port's model, optimizer and epoch runner, the seeded data, weights
    and batch orders."""

    def __init__(self, cell: Cell, seed: int, device, mesh=None):
        from pytorch_nested_unet_tpu_torch.models import PRECISIONS, create_model
        from pytorch_nested_unet_tpu_torch.training.loop import make_epoch_runner
        from pytorch_nested_unet_tpu_torch.training.optim import build_optimizer

        cfg, tr = cell.config, cell.traffic
        self.tr, self.device, self.mesh = tr, device, mesh
        self.world = int(tr["data_parallel"])
        self.global_batch = tr["batch"] * self.world
        self.sd0, self.images, self.masks, self.orders = make_inputs(cfg, tr, seed, device)
        model = create_model(cfg["arch"], cfg["num_classes"], cfg["input_channels"],
                             cfg["deep_supervision"], dtype=PRECISIONS[cfg["precision"]],
                             **{k: tuple(cfg[k]) for k in cfg["arch_kwargs"]})
        self.model = model.to(device)
        self.model.load_state_dict(self.sd0, strict=True)
        o = tr["optimizer"]
        self.opt = build_optimizer(self.model.parameters(), o["name"], o["lr"], o["momentum"],
                                   o["weight_decay"], o["nesterov"])
        self.run_epoch = make_epoch_runner(self.model, self.opt, tr["loss"],
                                           cfg["deep_supervision"], tr["augment"], mesh)
        self.augment_gen = torch.Generator(device=device).manual_seed(seed + 2)

    def epoch(self, idx):
        """Run the steps of `idx` (steps, global batch) and read their metrics
        to the host, as `fit` reads an epoch's."""
        m = self.run_epoch(self.images, self.masks, idx, self.augment_gen)
        return {k: v.tolist() for k, v in m.items()}

    def checked_steps(self):
        """Run epoch 0's first checked steps, then the rest of it as warm-up.
        Returns (the program's readings, the checked steps' global batch
        indices)."""
        k = int(self.tr["checked_steps"])
        idx = next(self.orders)
        named = dict(self.model.named_parameters())
        wd = self.tr["optimizer"]["weight_decay"]
        losses = self.epoch(idx[:1])["loss"]
        state = self.opt.inner.state  # no momentum: the optimizer got no gradient
        grad = {key: state[p].get("momentum_buffer", torch.zeros_like(p)) - wd * self.sd0[key]
                for key, p in named.items()}
        losses += self.epoch(idx[1:k])["loss"]
        now = self.model.state_dict()
        change = {key: (now[key] - self.sd0[key]).float().cpu() for key in self.sd0}
        self.epoch(idx[k:])
        return side_readings(losses, grad, change), idx[:k]

    def agree(self, done: bool) -> bool:
        """Whether every rank is done (one all-reduce under a mesh)."""
        if self.mesh is None:
            return done
        import torch.distributed as dist

        flag = torch.tensor([float(done)], device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item() > 0)

    def epochs_for(self, seconds: float):
        """Whole epochs until `seconds` have passed; (steps, failed, seconds)."""
        t0 = time.perf_counter()
        steps = failed = 0
        while True:
            losses = self.epoch(next(self.orders))["loss"]
            steps += len(losses)
            failed += sum(not math.isfinite(v) for v in losses)
            if self.agree(time.perf_counter() - t0 >= seconds):
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return steps, failed, time.perf_counter() - t0

    def close(self):
        for name in ("model", "opt", "run_epoch", "images", "masks"):
            setattr(self, name, None)


def make_inputs(cfg, tr, seed, device):
    """The seeded weights, data set and batch orders (the same on every rank
    and in the reference)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    sd0 = inputs.state_dict(cfg, gen)
    images, masks = inputs.synthetic_set(tr["set_size"], cfg["input_hw"], gen)
    global_batch = tr["batch"] * int(tr["data_parallel"])
    orders = inputs.epoch_orders(tr["set_size"], tr["set_size"] // global_batch, global_batch,
                                 torch.Generator(device=device).manual_seed(seed + 1))
    return sd0, images, masks, orders


def side_readings(losses, grad, change):
    """What the check compares of one side: the losses, the first gradient's
    leaf norms, and the change (its leaf norms and its tensors)."""
    return {"losses": losses, "grad": checks.leaf_norms(grad), "change": checks.leaf_norms(change),
            "change_t": change}


def reference_readings(cfg, tr, sd0, batches, numerics="exact", rows=None):
    """The plain reference over the checked batches ([(images, masks)], each
    a global batch), in `numerics`; with `rows` (a slice) over those rows of
    each batch only."""
    if rows is not None:
        batches = [(x[rows], y[rows]) for x, y in batches]
    with plain_math():
        losses, first, sd = reference.sgd_steps(cfg, sd0, batches, tr["optimizer"],
                                                Numerics(numerics))
    return side_readings(losses, first, {k: sd[k] - sd0[k] for k in sd0})


def _free(device):
    """Return what the program held to the device before the reference runs."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _context(cell, tr_obj, steps, rate, chips):
    return trace.Context(trace=tr_obj, cell=cell, steps=steps,
                         images=steps * cell.traffic["batch"], rate=rate, chips=chips)


def _run_here(cell, opts, t0, device, mesh=None):
    """Set-up, window and (with --trace 1) the traced stretch on this
    process's card. Returns the rank's record (no reference check)."""
    stages = {"started": time.perf_counter() - t0}
    s = Session(cell, opts["seed"], device, mesh)
    stages["built"] = time.perf_counter() - t0
    prog, checked = s.checked_steps()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stages["warmed"] = time.perf_counter() - t0
    if mesh is not None:
        import torch.distributed as dist
        dist.barrier()
    window_start = time.time()
    setup_s = time.perf_counter() - t0
    steps, failed, seconds = s.epochs_for(opts["seconds"])
    rec = {"prog": prog, "checked": checked.cpu().tolist(), "setup_s": setup_s, "stages": stages,
           "window_start": window_start, "steps": steps, "failed": failed, "seconds": seconds,
           "images": steps * s.global_batch}
    if opts["trace"]:
        rate = rec["images"] / seconds
        with trace.profiled() as held:
            s.epoch(next(s.orders))  # the profiler's own warm-up, outside the window
            with trace.window():
                t_steps, _, _ = s.epochs_for(cell.traffic["trace_seconds"])
        ctx = _context(cell, held.trace, t_steps, rate, s.world)
        rec["layers"] = trace.read_layers(cell, ctx)
        rec["busy_s"], rec["window_s"] = held.trace.busy_s, held.trace.window_s
        rec["breakdown"] = {"device_ops": held.trace.top_ops(), "idle_gaps": held.trace.top_gaps()}
    rec["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)
    rec["forbidden"] = card.forbidden_modules()
    s.close()
    return rec


def _check(cell, seed, device, checked, prog_records):
    """The reference over the checked steps, against every rank's readings.
    Returns (numbers, limits rows, correct)."""
    cfg, tr = cell.config, cell.traffic
    sd0, images, masks, _ = make_inputs(cfg, tr, seed, device)
    batches = [(images[torch.tensor(i, device=device)], masks[torch.tensor(i, device=device)])
               for i in checked]
    del images, masks
    ref = reference_readings(cfg, tr, sd0, batches)
    per_rank = [checks.train_numbers(prog, ref) for prog in prog_records]
    worst = max(per_rank, key=lambda n: max(n[k] / cell.limits[k] for k in cell.limits))
    ok, rows = checks.verdict(worst, cell.limits)
    return worst, rows, ok


def run(cell: Cell, opts: dict, t0: float, device=None):
    """One run of a training cell: opts = {seed, seconds, trace}."""
    world = int(cell.traffic["data_parallel"])
    if world > 1:
        return _run_ranks(cell, opts, t0, device)
    device = device or torch.device("cuda", 0)
    rec = _run_here(cell, opts, t0, device)
    _free(device)
    t_check = time.perf_counter()
    nums, rows, ok = _check(cell, opts["seed"], device, rec["checked"], [rec["prog"]])
    out = _result(cell, opts, [rec], nums, rows, ok)
    out["phases"] = {"setup_s": rec["setup_s"], "setup_stages": rec["stages"],
                     "window_s": rec["seconds"], "check_s": time.perf_counter() - t_check}
    return out


def _result(cell, opts, recs, nums, rows, ok):
    r0 = recs[0]
    out = {"correct": bool(ok and r0["failed"] == 0), "attempted": r0["steps"],
           "failed": r0["failed"], "numbers": nums, "rows": rows,
           "forbidden": sorted({m for r in recs for m in r["forbidden"]}),
           "memory_peak_bytes": max(r["memory_peak_bytes"] for r in recs)}
    if not opts["trace"]:
        out["metrics"] = {"train_img_per_s": r0["images"] / r0["seconds"],
                          "setup_s": r0["setup_s"]}
        return out
    out["metrics"] = trace.mean_layers([r["layers"] for r in recs])
    out["busy_s"] = sum(r["busy_s"] for r in recs) / len(recs)
    out["window_s"] = sum(r["window_s"] for r in recs) / len(recs)
    out["breakdown"] = r0["breakdown"]
    return out


# --- several cards: one rank process a card --------------------------------

def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _spawn(cell, job, device):
    """Start one process per rank on `job` (written to a directory under
    TMPDIR), wait for all, and return their records; every process is ended
    before this returns."""
    world = int(cell.traffic["data_parallel"])
    run_py = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "run.py")
    with tempfile.TemporaryDirectory(prefix="cardbench-") as tmp:
        with open(os.path.join(tmp, "job.json"), "w") as f:
            json.dump({"cell": cell.__dict__, "job": job, "port": _free_port(),
                       "device": "cpu" if device is not None and device.type == "cpu"
                       else "cuda"}, f)
        procs = [subprocess.Popen([sys.executable, run_py, "--rank", str(r), "--job", tmp],
                                  stdout=2)
                 for r in range(world)]
        try:
            deadline = time.monotonic() + RANK_TIMEOUT_S
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        codes = [p.returncode for p in procs]
        if any(codes):
            raise RuntimeError(f"rank processes exited with {codes}")
        recs = []
        for r in range(world):
            recs.append(torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=True))
    return recs


def rank_main(rank: int, job_dir: str, t0: float):
    """Entry of one rank process (`run.py --rank R --job DIR`)."""
    from pytorch_nested_unet_tpu_torch.parallel import initialize_distributed, make_mesh
    import torch.distributed as dist

    with open(os.path.join(job_dir, "job.json")) as f:
        spec = json.load(f)
    cell = Cell(**spec["cell"])
    world = int(cell.traffic["data_parallel"])
    if spec["device"] == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        device, backend = torch.device("cpu"), "gloo"
    initialize_distributed(backend=backend, device=device, world_size=world, rank=rank,
                           init_method=f"tcp://127.0.0.1:{spec['port']}")
    try:
        mesh = make_mesh()
        job = spec["job"]
        if job["mode"] == "run":
            rec = _run_here(cell, job["opts"], t0, device, mesh)
        else:
            rec = {"seeds": {}}
            for seed in job["seeds"]:
                s = Session(cell, seed, device, mesh)
                prog, checked = s.checked_steps()
                s.close()
                rec["seeds"][str(seed)] = {"prog": prog, "checked": checked.cpu().tolist()}
        rec["forbidden"] = card.forbidden_modules()
        torch.save(rec, os.path.join(job_dir, f"rank{rank}.pt.tmp"))
        os.replace(os.path.join(job_dir, f"rank{rank}.pt.tmp"),
                   os.path.join(job_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def _run_ranks(cell, opts, t0, device):
    t_parent = time.time() - (time.perf_counter() - t0)  # the wall clock at t0
    recs = _spawn(cell, {"mode": "run", "opts": opts}, device)
    for r in recs:
        r["setup_s"] = recs[0]["window_start"] - t_parent
    device = device or torch.device("cuda", 0)
    t_check = time.perf_counter()
    nums, rows, ok = _check(cell, opts["seed"], device, recs[0]["checked"],
                            [r["prog"] for r in recs])
    out = _result(cell, opts, recs, nums, rows, ok)
    out["phases"] = {"setup_s": recs[0]["setup_s"], "setup_stages": recs[0]["stages"],
                     "window_s": recs[0]["seconds"], "check_s": time.perf_counter() - t_check}
    return out


# --- readings for the limits (cardbench/control.py) -------------------------

def program_readings(cell: Cell, seeds, device=None):
    """{seed: (the program's readings, the checked batches' indices)} over
    the checked steps alone (no window), one rank a card under a mesh."""
    if int(cell.traffic["data_parallel"]) > 1:
        recs = _spawn(cell, {"mode": "readings", "seeds": list(seeds)}, device)
        return {seed: ([r["seeds"][str(seed)]["prog"] for r in recs],
                       recs[0]["seeds"][str(seed)]["checked"]) for seed in seeds}
    device = device or torch.device("cuda", 0)
    out = {}
    for seed in seeds:
        s = Session(cell, seed, device)
        prog, checked = s.checked_steps()
        s.close()
        out[seed] = ([prog], checked.cpu().tolist())
    return out


def readings(cell: Cell, seeds, device=None, faults=True):
    """Per seed, each number of the check for the program and, in its place,
    for the control (the reference in fp8) and the faults a training cell can
    have: half of each batch left out; under a mesh the exchange between
    cards left out (each rank's step over its own rows alone). A state left
    unchanged reads 1 by the change's measure and needs no run."""
    cfg, tr = cell.config, cell.traffic
    world = int(tr["data_parallel"])
    progs = program_readings(cell, seeds, device)
    device = device or torch.device("cuda", 0)
    out = {}
    for seed in seeds:
        prog_recs, checked = progs[seed]
        sd0, images, masks, _ = make_inputs(cfg, tr, seed, device)
        batches = [(images[torch.tensor(i, device=device)], masks[torch.tensor(i, device=device)])
                   for i in checked]
        del images, masks
        ref = reference_readings(cfg, tr, sd0, batches)
        row = {"program": [checks.train_numbers(p, ref) for p in prog_recs]}
        if faults:
            row["control_fp8"] = checks.train_numbers(
                reference_readings(cfg, tr, sd0, batches, "fp8"), ref)
            half = slice(0, tr["batch"] * world // 2)
            row["half_batch"] = checks.train_numbers(
                reference_readings(cfg, tr, sd0, batches, rows=half), ref)
            if world > 1:
                row["no_exchange"] = checks.train_numbers(
                    reference_readings(cfg, tr, sd0, batches, rows=slice(0, tr["batch"])), ref)
        out[seed] = row
        _free(device)
    return out
