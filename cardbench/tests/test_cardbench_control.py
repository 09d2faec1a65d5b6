"""The control at a size a test run holds: the plain reference in fp8, put in
the program's place, fails the limits of `correct` where the program (bf16)
passes them (conftest.CPU_LIMITS; the cells' own limits are held on the card
by test_cardbench_card.py). The half-batch fault reads far outside them too."""

import pytest
import torch

from cardbench.lib import checks, spec
from conftest import CPU_LIMITS, tiny


@pytest.mark.parametrize("cell", ["NestedUNet_wDS.train.b128", "NestedUNet_wDS.serve.b128",
                                  "VGG16RNN.train.b128"])
def test_control_fails_where_the_program_passes(cell):
    c = tiny(cell)
    limits = CPU_LIMITS[c.kind]
    rows = spec.driver(c.kind).readings(c, [3000000037, 3000000041], torch.device("cpu"))
    for row in rows.values():
        programs = row["program"] if isinstance(row["program"], list) else [row["program"]]
        assert all(checks.verdict(p, limits)[0] for p in programs), row
        assert not checks.verdict(row["control_fp8"], limits)[0], row
        if "half_batch" in row:
            assert not checks.verdict(row["half_batch"], limits)[0], row
