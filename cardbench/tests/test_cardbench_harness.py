"""The harness without a card: it refuses to run; on the CPU (the tests'
rehearsal, which skips the look for a card, held to the CPU size's limits)
a run goes through set-up, window, trace and check, prints the last line
the contract asks for, and loads no module of JAX or of the JAX package."""

import json
import os
import subprocess
import sys

import pytest

from cardbench.lib import card, spec

RUN = os.path.join(spec.BENCH_DIR, "run.py")


def test_no_card_exits_non_zero_and_prints_no_result():
    if card.cards_ready(1) is None:
        pytest.skip("a card is visible: the no-card path cannot run here")
    out = subprocess.run([sys.executable, RUN, "--workload", "NestedUNet_wDS.train.b128",
                          "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=spec.REPO)
    assert out.returncode != 0
    assert "metrics" not in out.stdout and "{" not in out.stdout
    assert "no run" in out.stderr


def test_forbidden_modules_compare_whole_top_level_names():
    assert card.forbidden_modules(["pytorch_nested_unet_tpu_torch.models", "numpy"]) == []
    assert card.forbidden_modules(["pytorch_nested_unet_tpu.models.blocks"]) == [
        "pytorch_nested_unet_tpu"]
    assert card.forbidden_modules(["jax.numpy", "jaxlib", "flax.linen", "jaxtyping"]) == [
        "flax", "jax", "jaxlib"]


REHEARSAL = """
import json, sys
sys.path.insert(0, {repo!r}); sys.path.insert(0, {tests!r})
import torch
torch.set_num_threads(2)
from conftest import CPU_LIMITS, tiny
from cardbench import run
cell = tiny({cell!r})
cell.limits = CPU_LIMITS[cell.kind]
rc = run.main(["--workload", cell.name, "--seed", "3000000019", "--seconds", "0.3",
               "--trace", {trace!r}], device=torch.device("cpu"), cell=cell)
from cardbench.lib import card
print("FORBIDDEN " + json.dumps(card.forbidden_modules()))
sys.exit(rc)
"""


@pytest.mark.parametrize("cell,trace", [("NestedUNet_wDS.train.b128", "0"),
                                        ("NestedUNet_wDS.serve.b128", "1"),
                                        ("VGG16RNN.train.b128", "1")])
def test_cpu_rehearsal_prints_the_last_line_and_loads_no_jax(cell, trace):
    code = REHEARSAL.format(repo=spec.REPO, tests=os.path.dirname(__file__), cell=cell,
                            trace=trace)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=spec.REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "FORBIDDEN []"
    result = json.loads(lines[-2])
    assert list(result)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    names = {m["name"] for m in spec.resolve(cell).end_to_end}
    if trace == "0":
        assert set(result["metrics"]) == names
    else:
        assert set(result["metrics"]) <= {m["name"] for m in spec.resolve(cell).per_layer}
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert all(len(v) <= 10 for v in result["breakdown"].values())
    assert all(set(c) == {"value", "limit"} for c in result["checks"].values())
    assert any(line.startswith("switches: ") for line in lines)
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
