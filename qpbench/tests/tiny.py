"""Tiny sizes of the cells, for runs on the CPU."""

from qpbench.lib import spec

BENCH = spec.benchmark()

CONFIG = dict(num_var=12, num_ineq=6, num_eq=6, hidden_dim=16, outer_T=6,
              truncated_length=6, batch_size=2)
CELL = {
    "qp1000-serve-polish": dict(pool=8, batch=2, feas_rest_num=4, warmup=1,
                                trace_solves=2, check_solves=2),
    "qp1000-train-fused": dict(data_size=10, first_steps=3, trace_updates=2),
}


def run(capsys, cell, seed=5, trace=0, program="port", seconds="0.3"):
    """Run ``cell`` tiny on the CPU; returns (exit code, the last line of
    standard output parsed, standard error)."""
    import json
    from qpbench import run as R
    rc = R.main(["--workload", cell, "--seed", str(seed), "--seconds",
                 seconds, "--trace", str(trace)], device="cpu",
                program=program, config_override=CONFIG,
                cell_override=CELL[cell], bench=BENCH)
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), out.err
