"""The result line's keys, and the guard against JAX in the process."""

import ast
import json
import subprocess
import sys

import pytest

from qpbench.lib import result, spec
from qpbench.tests import tiny

CELLS = list(tiny.CELL)


@pytest.mark.parametrize("cell", CELLS)
def test_last_line_has_the_contract_keys(capsys, cell):
    rc, line, err = tiny.run(capsys, cell)
    assert rc == 0
    assert set(line) == {"correct", "attempted", "failed", "metrics",
                         "device", "checks"}
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    e2e = {m["name"] for m in spec.end_to_end(tiny.BENCH, cell)}
    assert set(line["metrics"]) == e2e
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    limits = spec.cell(tiny.BENCH, cell)["limits"]
    assert set(line["checks"]) == set(limits)
    tail = err.strip().splitlines()[-len(limits):]
    assert all(t.startswith("check ") for t in tail)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_line_has_busy_window_and_breakdown(capsys, cell):
    rc, line, _ = tiny.run(capsys, cell, trace=1)
    assert rc == 0
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["device"]["window_s"] > 0


def test_unknown_cell_prints_no_result(capsys):
    from qpbench import run
    assert run.main(["--workload", "no-such-cell", "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_no_card_prints_no_result(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from qpbench import run
    assert run.main(["--workload", CELLS[0], "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_forbidden_names_are_compared_whole():
    assert result.forbidden_loaded({"iadmm_tpu_torch.api": 1,
                                    "jaxtyping": 1}) == []
    assert result.forbidden_loaded({"iadmm_tpu.api": 1, "jax.numpy": 1,
                                    "flax": 1}) == ["flax", "iadmm_tpu",
                                                    "jax"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module


def test_no_module_of_the_benchmark_imports_jax():
    for p in spec.PKG.rglob("*.py"):
        for name in _imports(p):
            assert name.split(".")[0] not in result.FORBIDDEN, (p, name)


def test_the_reference_and_counts_import_nothing_of_the_program():
    for sub in ("reference", "counts", "gen", "metrics"):
        for p in (spec.PKG / sub).rglob("*.py"):
            for name in _imports(p):
                assert name.split(".")[0] != "iadmm_tpu_torch", (p, name)


def test_a_cpu_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from qpbench.tests import tiny\n"
            "from qpbench import run\n"
            "from qpbench.lib import result\n"
            "run.main(['--workload', 'qp1000-serve-polish', '--seed', '3', "
            "'--seconds', '0.2'], device='cpu', config_override=tiny.CONFIG,"
            " cell_override=tiny.CELL['qp1000-serve-polish'])\n"
            "print(result.forbidden_loaded())\n") % str(spec.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=spec.ROOT)
    assert out.stdout.strip().splitlines()[-1] == "[]"
    line = json.loads(out.stdout.strip().splitlines()[-2])
    assert line["correct"] is True
