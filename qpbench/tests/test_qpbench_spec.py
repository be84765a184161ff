"""``BENCHMARK.json`` against the contract's shape, and the harness finding
every cell, configuration, traffic mix and metric by name."""

import json
import re

import pytest

from qpbench.lib import spec
from qpbench.tests import tiny

# BENCHMARK.json with the entries of the cells built but left out of it:
# each file of the benchmark is held to the same rules
B = tiny.BENCH
CELLS = [w["name"] for w in B["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys_and_size():
    assert set(spec.benchmark()) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert (spec.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert B["command"] == ["python3", "qpbench/run.py"]
    assert B["paths"] == ["qpbench"]
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51


def test_entries_have_exactly_the_contract_keys():
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_names_units_and_texts():
    names = ([c["name"] for c in B["configs"]] + CELLS
             + [m["name"] for m in B["end_to_end"] + B["per_layer"]])
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in B["workloads"]]:
        assert NAME.match(n), n
    for c in B["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
    for w in B["workloads"]:
        assert TEXT.match(w["why"])
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in B["per_layer"]:
        assert TEXT.match(m["layer"])


def test_setup_and_four_chip_share():
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25
               for m in B["end_to_end"])
    four = sum(w["chips"] == 4 for w in B["workloads"])
    assert four <= max(1, len(CELLS) // 4)
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    cell = spec.cell(B, name)
    cfg = spec.config(B, cell["config"])
    assert (spec.PKG / "traffic" / f"{cell['kind']}.py").exists()
    for k in ("num_var", "hidden_dim", "outer_T", "sigma"):
        assert k in cfg
    assert cell["limits"], "every cell compares some number"
    e2e = [m["name"] for m in spec.end_to_end(B, name)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.per_layer(B, name)


def test_configs_are_used_and_state_their_cuts():
    used = {w["config"] for w in B["workloads"]}
    files = [c["file"] for c in B["configs"]]
    assert len(files) == len(set(files))
    for c in B["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("qpbench/")
        body = json.loads((spec.ROOT / c["file"]).read_text())
        assert all(k in body for k in c["reduced"])


@pytest.mark.parametrize("m", B["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found_by_name(m):
    reader = spec.metric_reader(m["name"])
    assert callable(reader.read)
    moves = {e["name"]: e for e in B["end_to_end"]}[m["moves"]]
    for c in m.get("workloads", CELLS):
        assert c in CELLS
        assert c in moves.get("workloads", CELLS)


def test_file_names_use_name_characters():
    for p in spec.PKG.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(spec.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", rel), rel
