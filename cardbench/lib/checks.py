"""The numbers that decide `correct`, each held to its limit.

Training compares, over the checked steps: each step's loss; the first
gradient as the optimizer got it (worked out from its momentum after one
step: buffer - weight_decay * initial weight); the change of every weight
and BN running statistic after the checked steps. A gradient or change is
compared leaf by leaf as the gap between the two sides' norms, over the
larger of the reference's norm of that leaf and of the median leaf; the
worst leaf is the number. Leaves whose reference gradient is under a
thousandth of the median leaf's (the conv biases that feed a BN, whose
gradient is nought but for rounding) are left out of both.

A gap of norms is one signed reading of the rounding, which may come out near
nought on any seed. Beside them, `change_diff`: the norm of the difference of
the whole change (every compared leaf at once) over the reference's, which
reads every element's rounding and is steady from seed to seed.
"""

import math
import statistics

import torch

DEAD_GRADIENT = 1e-3  # of the median leaf's gradient norm


def leaf_norms(tensors: dict) -> dict:
    """{key: float64 norm} of a dict of tensors, read to the host at once."""
    keys = list(tensors)
    if not keys:
        return {}
    norms = torch.stack([tensors[k].detach().double().norm() for k in keys]).cpu().tolist()
    return dict(zip(keys, norms))


def live_leaves(ref_grad_norms: dict):
    med = statistics.median(ref_grad_norms.values())
    return [k for k, v in ref_grad_norms.items() if v >= DEAD_GRADIENT * med]


def leaf_gaps(prog: dict, ref: dict, keys) -> dict:
    """{key: |prog - ref| norm gap over max(ref[key], the median of ref over
    keys)}."""
    med = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys}


def whole_diff(prog: dict, ref: dict, keys) -> float:
    """|prog - ref| over |ref|, the tensors of `keys` taken as one vector."""
    diff = norm = 0.0
    for k in keys:
        r = ref[k].double()
        diff += (prog[k].to(r.device, torch.float64) - r).square().sum().item()
        norm += r.square().sum().item()
    return math.sqrt(diff / max(norm, 1e-60))


def train_numbers(prog: dict, ref: dict) -> dict:
    """prog, ref: {"losses": [...], "grad": {key: norm}, "change": {key: norm},
    "change_t": {key: tensor}} -> {"loss_gap", "grad_gap", "change_gap",
    "change_diff"}, the worst leaves' names and how many leaves were left out."""
    live = live_leaves(ref["grad"])
    change_keys = [k for k in ref["change"] if k in live or k not in ref["grad"]]
    grad = leaf_gaps(prog["grad"], ref["grad"], live)
    change = leaf_gaps(prog["change"], ref["change"], change_keys)
    worst_grad, worst_change = max(grad, key=grad.get), max(change, key=change.get)
    return {"loss_gap": max(abs(a - b) for a, b in zip(prog["losses"], ref["losses"])),
            "grad_gap": grad[worst_grad], "change_gap": change[worst_change],
            "change_diff": whole_diff(prog["change_t"], ref["change_t"], change_keys),
            "worst": {"grad": worst_grad, "change": worst_change},
            "left_out": len(ref["grad"]) - len(live)}


def verdict(numbers: dict, limits: dict):
    """(correct, [(name, value, limit)]) over the numbers that have a limit;
    a number that is not finite fails."""
    rows = [(k, float(numbers[k]), float(limits[k])) for k in limits]
    ok = all(v == v and v <= lim for _, v, lim in rows)
    return ok, rows
