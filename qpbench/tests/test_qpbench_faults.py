"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven at a tiny size
on the CPU with each fault the cell can have (``qpbench/faults.py``), held
to the cell's own limits.  The exchange between chips is not among them:
no cell here spans chips."""

import pytest

from qpbench import faults
from qpbench.lib import spec
from qpbench.tests import tiny

CASES = [(c, f) for c in tiny.CELL
         for f in ("unchanged", "half_batch", "altered")]


@pytest.mark.parametrize("cell", list(tiny.CELL))
def test_sound_run_is_correct(capsys, cell):
    _, line, _ = tiny.run(capsys, cell, seed=21)
    assert line["correct"] is True


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_makes_the_run_not_correct(capsys, cell, fault):
    kind = spec.cell(tiny.BENCH, cell)["kind"]
    with faults.planted(kind, fault):
        rc, line, err = tiny.run(capsys, cell, seed=21)
    assert rc == 0
    assert line["correct"] is False, err
