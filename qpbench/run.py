"""Run one cell of the benchmark once and print its result line.

    python3 qpbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell, its configuration, its traffic
kind and its per-layer readers are found by name (``qpbench/README.md``).
``--trace 0`` measures the cell's end-to-end metrics over ``--seconds``;
``--trace 1`` profiles a short window and reads its per-layer metrics.
Both compare what the timed path produced with the plain reference and
print each number compared beside its limit, on standard error and under
``checks`` in the result, the last line of standard output.
"""

import time

T_START = time.perf_counter()   # set-up is timed from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Every build and kernel cache inside the checkout, at fixed paths (the
# port builds its own kernels into iadmm_tpu_torch/_build/).
_CACHE = ROOT / "iadmm_tpu_torch" / "_build"
os.environ["TORCH_EXTENSIONS_DIR"] = str(_CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(_CACHE / "triton")
os.environ["USE_FLAX"] = "0"

from qpbench.lib import result, spec  # noqa: E402
from qpbench.lib.context import RunContext  # noqa: E402


def _say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, *, device=None, program="port", config_override=None,
         cell_override=None, bench=None, root=ROOT) -> int:
    """Returns the exit code.  ``device`` (tests: 'cpu') skips the look
    for a card; ``program='control'`` puts the reference at the control
    precision in the program's place; the overrides replace entries of the
    configuration and the cell (tests run tiny sizes); ``bench`` replaces
    ``BENCHMARK.json`` (tests add cells that are not in it)."""
    a = _args(argv)
    bench = spec.benchmark(root) if bench is None else bench
    try:
        cell = spec.cell(bench, a.workload)
        cfg = spec.config(bench, cell["config"], root)
    except (KeyError, FileNotFoundError) as e:
        _say(f"qpbench: {e}")
        return 2
    cfg = {**cfg, **(config_override or {})}
    cell = {**cell, **(cell_override or {})}
    if device is None:
        import torch
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell["chips"]:
            _say(f"qpbench: cell {a.workload} needs {cell['chips']} CUDA "
                 f"device(s), found {have}")
            return 3
        device = "cuda"
    ctx = RunContext(config=cfg, cell=cell, seed=a.seed, seconds=a.seconds,
                     trace=bool(a.trace), device=device, t_start=T_START,
                     program=program)
    out = spec.traffic(cell["kind"]).run(ctx)

    metrics = {}
    if not a.trace:
        e2e = {**out["e2e"], "setup_s": ctx.setup_s}
        for m in spec.end_to_end(bench, a.workload):
            metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                  "unit": m["unit"]}
    else:
        for m in spec.per_layer(bench, a.workload):
            if m["source"] == "device_trace" and not ctx.cuda:
                continue   # no device, no device number
            v = spec.metric_reader(m["name"]).read(out["trace"])
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if ctx.cuda else "cpu",
           "kind": _device_name(ctx), "count": int(cell["chips"]),
           "memory_peak_bytes": int(out["memory_peak_bytes"])}
    breakdown = None
    if a.trace:
        tr = out["trace"]
        dev.update(busy_s=tr.busy_s(), window_s=tr.window_s)
        breakdown = tr.breakdown()

    bad = result.forbidden_loaded()
    if bad:
        _say(f"qpbench: modules of JAX or the JAX package are loaded: {bad}")
        return 4
    checks = result.judge(out["numbers"], cell["limits"])
    correct = out["failed"] == 0 and all(c.ok for c in checks)
    for k, v in sorted(out["numbers"].items()):
        if k not in cell["limits"]:
            _say(f"reading {k}: {v!r} (no limit)")
    _say(f"answers failed: {out['failed']} of {out['attempted']}")
    for c in checks:
        _say(c.line())
    print(result.line(correct, out["attempted"], out["failed"], metrics, dev,
                      checks, breakdown), flush=True)
    return 0


def _device_name(ctx) -> str:
    if not ctx.cuda:
        return "cpu"
    import torch
    return torch.cuda.get_device_name(ctx.device)


if __name__ == "__main__":
    sys.exit(main())
