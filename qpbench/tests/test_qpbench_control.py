"""The control: the reference one precision step lower (fp8 for the bf16
products, TF32 for float32) put in the program's place.  On the card at
the cell's own size and its limits it has to come out not correct, on
three seeds (``-m cuda``, on the card; the readings the limits were set
from are in PERF.md).  On the CPU, at a tiny size, its readings stand
clear of the program's."""

import json

import pytest

from qpbench.tests import tiny

SEEDS = (2300000001, 2300000002, 2300000003)


@pytest.mark.parametrize("cell", list(tiny.CELL))
def test_control_reads_above_the_program_tiny(capsys, cell):
    _, prog, _ = tiny.run(capsys, cell, seed=31)
    _, ctrl, _ = tiny.run(capsys, cell, seed=31, program="control")
    assert any(ctrl["checks"][k]["value"] >= 3 * prog["checks"][k]["value"]
               for k in prog["checks"])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(tiny.CELL))
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_at_the_cell_size(card, capsys, cell, seed):
    from qpbench import run
    assert run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                     "3"], program="control", bench=tiny.BENCH) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is False
