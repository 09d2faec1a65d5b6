#!/usr/bin/env python
"""The train-step time of `chip_smoke.py`'s band runs, each run alone on one
CUDA card.

    python3 band_step_time.py [--trees DIR ...]

`chip_smoke.py`'s spatial phase runs its 2-rank band runs two at a time on
one card (`_lanes`) and times one step of each, so its band p50s are
contended. This script runs RUNS, three of `chip_smoke.SPATIAL_RUNS`, each
with nothing beside it: its ranks over Gloo on the first card, as
`spatial_worker` runs them (full width, fp32, TF32 off, global batch 16 at
96x96, augment none, the model from `_dp_build`), WARM untimed steps, then
STEPS steps timed on the host's clock around the step and a synchronize.

`--trees`: checkouts of the repo (a parent unpacked with `git archive` into
a directory that .gitignore lists, say), each run with its own package and
`chip_smoke.py`, in the order given, so `--trees PARENT . . PARENT` compares
two commits on one card. Prints, per (tree, run), one JSON line: rank 0's
p10, p50 and p90 ms, the halo MB and host ms a step, and the card's name and
power limit. Exits non-zero without a CUDA card.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

RUNS = ("NestedUNet x=2", "UNet x=2,y=2", "ResNet50RNN x=2")
WARM, STEPS = 2, 10
OUT_DIR = os.path.join("outputs", "band_step_time")


def worker(tree, run, rank, world, port, out):
    """One rank of `run` from `tree`'s package and chip_smoke.py."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch.distributed as dist

    import chip_smoke as cs
    from pytorch_nested_unet_tpu_torch.parallel import (batch_sharding, halo,
                                                        initialize_distributed, make_mesh,
                                                        parse_mesh_spec)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    initialize_distributed(backend="gloo", device=dev, world_size=world, rank=rank,
                           init_method=f"tcp://127.0.0.1:{port}")
    try:
        arch, spec = cs.SPATIAL_RUNS[run][:2]
        names, sizes = parse_mesh_spec(spec)
        mesh = make_mesh(sizes, names)
        x, y = cs._dp_batch()
        rows = batch_sharding(mesh, cs.BATCH)
        batch = (torch.from_numpy(x[rows]).to(dev), torch.from_numpy(y[rows]).to(dev))
        m, step = cs._dp_build(mesh, device=dev, arch=arch)
        times = []
        for k in range(WARM + STEPS):
            if k == WARM:
                halo.reset_stats()
            t0 = time.perf_counter()
            step(*batch, torch.Generator(dev).manual_seed(0))
            torch.cuda.synchronize()
            if k >= WARM:
                times.append((time.perf_counter() - t0) * 1e3)
        if rank == 0:
            with open(out, "w") as f:
                json.dump({"times_ms": times,
                           "per_step": {k: v / STEPS for k, v in halo.STATS.items()}}, f)
    finally:
        dist.destroy_process_group()
    return 0


def _build(tree):
    """Build `tree`'s kernels (its own _build/), in a process of its own."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from pytorch_nested_unet_tpu_torch.ops import _build; _build.build_all()")
    subprocess.run([sys.executable, "-c", code, os.path.abspath(tree)], check=True,
                   timeout=600)


def _time_run(tree, run):
    import chip_smoke as cs

    world = cs.SPATIAL_RUNS[run][2]
    port = cs._free_port()
    out = os.path.join(OUT_DIR, "band_step_time.json")
    if os.path.exists(out):
        os.remove(out)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker", tree, run,
                               str(rank), str(world), str(port), out],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(world)]
    try:
        logs = [p.communicate(timeout=900)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"{tree} {run} rank {rank} failed:\n{log[-3000:]}")
    with open(out) as f:
        got = json.load(f)
    t = np.asarray(got["times_ms"])
    st = got["per_step"]
    return {"tree": tree, "run": run, "ranks": world, "steps": len(t),
            "p10_ms": float(np.percentile(t, 10)), "p50_ms": float(np.median(t)),
            "p90_ms": float(np.percentile(t, 90)),
            "halo_mb": st["halo_bytes"] / 1e6, "halo_host_ms": st["halo_s"] * 1e3,
            "gather_host_ms": st["gather_s"] * 1e3}


def main():
    if sys.argv[1:2] == ["--worker"]:
        tree, run, rank, world, port, out = sys.argv[2:8]
        return worker(tree, run, int(rank), int(world), int(port), out)
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--trees", nargs="+", default=["."])
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("band_step_time: torch.cuda.is_available() is False; this script needs a CUDA "
              "card", file=sys.stderr)
        return 2
    import chip_smoke as cs

    card = cs.card_line()
    os.makedirs(OUT_DIR, exist_ok=True)
    for tree in dict.fromkeys(args.trees):
        _build(tree)
    for tree in args.trees:
        for run in RUNS:
            print(json.dumps({**_time_run(tree, run), "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
