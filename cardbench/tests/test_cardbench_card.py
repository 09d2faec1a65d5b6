"""On the card (marker `cuda`; skipped without one): each one-card cell runs
at its own size for a short window and comes out correct; at the cell's own
size the program passes every limit while the control (the plain reference
in fp8, in the program's place) fails one, and for training so does half of
each batch left out.

    python -m pytest -q cardbench/tests/test_cardbench_card.py
"""

import json
import os
import subprocess
import sys

import pytest

from cardbench.lib import card, checks, spec

ONE_CARD = [w["name"] for w in spec.benchmark()["workloads"] if w["chips"] == 1]


@pytest.fixture
def cards():
    missing = card.cards_ready(1)
    if missing:
        pytest.skip(f"needs a CUDA card: {missing}")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ONE_CARD)
def test_cell_runs_correct_on_the_card(cards, cell):
    out = subprocess.run([sys.executable, os.path.join(spec.BENCH_DIR, "run.py"),
                          "--workload", cell, "--seed", "2305843009", "--seconds", "2",
                          "--trace", "0"], capture_output=True, text=True, timeout=600,
                         cwd=spec.REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ONE_CARD)
def test_control_and_faults_fail_where_the_program_passes(cards, cell):
    c = spec.resolve(cell)
    row = spec.driver(c.kind).readings(c, [4294967311])[4294967311]
    programs = row["program"] if isinstance(row["program"], list) else [row["program"]]
    assert all(checks.verdict(p, c.limits)[0] for p in programs)
    assert not checks.verdict(row["control_fp8"], c.limits)[0]
    if c.kind == "train":
        assert not checks.verdict(row["half_batch"], c.limits)[0]
