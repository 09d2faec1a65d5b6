"""Readings that the limits of `correct` are set from, for one cell:

    python3 cardbench/control.py --workload <cell> --seeds 1,2,3 [--program-only]

For every seed: each number of the check for the program (its set-up's
checked steps for training, a short window at the cell's load for serving)
and, in the program's place, for the control (the plain reference in fp8)
and the faults the cell can have (training: half of each batch left out;
under a mesh, the exchange between cards left out). One JSON line a seed;
the benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cardbench.lib import card, spec  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--program-only", action="store_true",
                   help="the program's readings alone, without the control and faults")
    args = p.parse_args(argv)
    cell = spec.resolve(args.workload)
    missing = card.cards_ready(cell.chips)
    if missing:
        print(f"control: {missing}", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    drv = spec.driver(cell.kind)
    if cell.kind == "train":
        rows = drv.readings(cell, seeds, faults=not args.program_only)
    else:
        rows = drv.readings(cell, seeds)
    for seed, row in rows.items():
        print(json.dumps({"workload": cell.name, "seed": seed, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
