#!/usr/bin/env python
"""Write the golden curves that `chip_smoke.py::trajectory_phase` holds the
card's whole training run to.

    python trajectory_golden.py [--out tests/data/trajectory_NestedUNet_wDS.json]

Runs the JAX package's side of `PARITY_RUN.json`'s protocol (NestedUNet wDS,
BCEDice, 48x48, 64 / 16 images, batch 8, 15 epochs, lr 1e-3, min_lr 1e-5,
seed 41) on the CPU in float32, from the port's own seed-41 init, on
parity.py's data and batch schedule: `jax_trajectory` of
tests/test_torch_trajectory.py, whose slow NestedUNet case recomputes the
curves and holds this file to them within 1e-5. Writes the protocol, then
per epoch the train loss and IoU and the val loss and IoU (the val pass in
padded, weighted batches of 8, as the port's `fit` scores it). Takes a few
minutes on the CPU; needs JAX and torch.
"""

import argparse
import json
import os
import sys

import jax

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import test_torch_trajectory as trajectory  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=trajectory.GOLDEN)
    args = p.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    proto = trajectory.protocol("PARITY_RUN.json")
    images, masks, schedule = trajectory.dataset(proto)
    _, _, curves = trajectory.jax_trajectory(proto, trajectory.port_init(proto), images, masks,
                                             schedule)
    golden = {"protocol": proto,
              "epochs": [{k: curves[k][e] for k in trajectory.CURVES}
                         for e in range(proto["epochs"])]}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(golden, f, indent=1)
        f.write("\n")
    for e, row in enumerate(golden["epochs"]):
        print(f"epoch {e}: " + ", ".join(f"{k} {v:.6f}" for k, v in row.items()))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
