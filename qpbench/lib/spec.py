"""Finds the benchmark's pieces by the names ``BENCHMARK.json`` gives them.

- a cell ``<name>`` is ``qpbench/workloads/<name>.json``: the limits of
  its comparison (its config, traffic and chips are its entry in
  ``BENCHMARK.json``);
- a configuration ``<config>`` is the file the ``configs`` entry names
  (``qpbench/configs/<config>.json``);
- a traffic mix ``<traffic>`` is ``qpbench/traffic/<traffic>.json``: its
  kind and the kind's parameters;
- a traffic kind ``<kind>`` is ``qpbench/traffic/<kind>.py`` with
  ``run(ctx)``;
- a per-layer metric ``<metric>`` is ``qpbench/metrics/<metric>.py`` with
  ``read(run)``;
- a kernel's work count ``<kernel>`` is ``qpbench/counts/<kernel>.py``
  with ``work(shape)``.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]   # qpbench/
ROOT = PKG.parent                             # the checkout

def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    """The ``workloads`` entry of cell ``name`` merged with its traffic
    mix's parameters and its own file."""
    for w in bench["workloads"]:
        if w["name"] == name:
            mix = load_json(PKG / "traffic" / f"{w['traffic']}.json")
            own = load_json(PKG / "workloads" / f"{name}.json")
            return {**mix, **own, **w}
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(root / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def _applies(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def end_to_end(bench: dict, cell_name: str) -> list:
    return [m for m in bench["end_to_end"] if _applies(m, cell_name)]


def per_layer(bench: dict, cell_name: str) -> list:
    return [m for m in bench["per_layer"] if _applies(m, cell_name)]


def _module(path: Path, label: str):
    spec = importlib.util.spec_from_file_location(label, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traffic(kind: str):
    return _module(PKG / "traffic" / f"{kind}.py", f"qpbench_traffic_{kind}")


def metric_reader(name: str):
    return _module(PKG / "metrics" / f"{name}.py",
                   "qpbench_metric_" + name.replace(".", "_").replace("-", "_"))


def count(kernel: str, shape: dict) -> dict:
    """``{"bytes", "bf16_ops", "f32_ops"}`` of ``kernel`` at ``shape``."""
    mod = _module(PKG / "counts" / f"{kernel}.py", f"qpbench_count_{kernel}")
    return mod.work(shape)
