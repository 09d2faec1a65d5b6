"""Shared pieces of the benchmark's CPU tests: the repository root on
sys.path, and cells of BENCHMARK.json cut to a size the CPU runs in
seconds (narrow widths where the arch has them, 32x32, small batches)."""

import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

# what each mix is cut to on the CPU
TINY_TRAFFIC = {
    "train": {"batch": 4, "set_size": 40, "trace_seconds": 0.3},
    "serve": {"batch": 4, "pool_requests": 3, "calibration_images": 4,
              "warmup_requests": 1, "trace_seconds": 0.3},
}

# limits of `correct` at that size, set from the CPU's own readings: a narrow
# NestedUNet's bf16 step reads loss gaps ~1e-4, worst-leaf gradient and
# change gaps ~0.1-0.4, the whole change's difference ~1e-3, served
# probability gaps ~0.02 (its fp8 control: ~1e-3, 0.3-1.1, ~1.3e-2, 0.2-4);
# VGG16RNN's step reads ~3e-5, ~0.1, ~1.4e-3 (its control ~1.5e-4, ~0.2,
# ~1.5e-2: only the whole change's difference separates them)
CPU_LIMITS = {"train": {"loss_gap": 4e-4, "grad_gap": 0.8, "change_gap": 0.5,
                        "change_diff": 5e-3},
              "serve": {"prob_gap": 0.1}}


def tiny(name, **traffic):
    """Cell `name` of BENCHMARK.json cut to a CPU size; `traffic` overrides."""
    from cardbench.lib import spec

    cell = spec.resolve(name)
    cell.config = dict(cell.config, input_hw=[32, 32])
    if "nb_filter" in cell.config:
        cell.config["nb_filter"] = [4, 8, 16, 32, 64]
    cell.traffic = {**cell.traffic, **TINY_TRAFFIC[cell.kind], **traffic}
    return cell


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 4))
    yield
    torch.set_num_threads(before)
