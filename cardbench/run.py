"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python3 cardbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs from the root of a checkout on a machine with the cards the cell asks
for (it exits non-zero, printing no result, without them). Set-up makes the
weights and data from --seed on the card and warms the cell's shapes; the
window measures for --seconds; the outputs of the timed path are then held
to the plain reference (cardbench/reference); the last line of standard
output is one JSON object: correct, attempted, failed, metrics (the cell's
end-to-end metrics, or with --trace 1 its per-layer metrics), device and,
traced, breakdown; its last key, checks, gives each number compared beside
its limit, as do the last lines of standard error.

The cell's configuration, traffic mix, limits and per-layer readers are
files of their own, found by name (cardbench/lib/spec.py).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from cardbench.lib import card, spec  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    p.add_argument("--job", help=argparse.SUPPRESS)
    return p.parse_args(argv)


def line(cell, result):
    """The result's last line: the driver's keys, then `checks` last."""
    dev = {"platform": "gpu" if result["device_type"] == "cuda" else result["device_type"],
           "kind": result["device_kind"], "count": cell.chips,
           "memory_peak_bytes": int(result["memory_peak_bytes"])}
    if "busy_s" in result:
        dev.update(busy_s=result["busy_s"], window_s=result["window_s"])
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics = {k: {"value": float(v), "unit": units[k]} for k, v in result["metrics"].items()}
    out = {"correct": result["correct"], "attempted": int(result["attempted"]),
           "failed": int(result["failed"]), "metrics": metrics, "device": dev}
    if "breakdown" in result:
        out["breakdown"] = result["breakdown"]
    out["checks"] = {name: {"value": value, "limit": limit}
                     for name, value, limit in result["rows"]}
    return out


def main(argv=None, device=None, t0=T0, cell=None):
    """Run one cell; returns the exit code. `device` and `cell` (tests only)
    run the given cell on that device without looking for a card."""
    args = parse(argv)
    if args.rank is not None:
        return spec.driver("train").rank_main(args.rank, args.job, t0)
    cell = cell or spec.resolve(args.workload)
    if device is None:
        missing = card.cards_ready(cell.chips)
        if missing:
            print(f"cardbench: no run: {missing}", file=sys.stderr)
            return 2
    print("switches: " + json.dumps(card.switches()), flush=True)
    if device is None:
        print("cards: " + " | ".join(card.power_limits()), flush=True)
    opts = {"seed": args.seed, "seconds": args.seconds, "trace": bool(args.trace)}
    result = spec.driver(cell.kind).run(cell, opts, t0, device)
    bad = sorted(set(result["forbidden"]) | set(card.forbidden_modules()))
    if bad:
        print(f"cardbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    dev = device or torch.device("cuda", 0)
    result["device_type"] = dev.type
    result["device_kind"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                             else "cpu")
    print("phases: " + json.dumps(result["phases"]), file=sys.stderr)
    print("numbers: " + json.dumps(result["numbers"]), file=sys.stderr)
    for name, value, limit in result["rows"]:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr, flush=True)
    print(json.dumps(line(cell, result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
