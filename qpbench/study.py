"""Readings for the limits: one cell on several seeds in one process.

    python3 qpbench/study.py --workload <cell> --seeds 11,12,13 \\
        --seconds 5 [--program port|control] [--fault none|unchanged|...]

Runs the cell once a seed (``run.main``) with the program, or with the
reference at the control precision in its place (``--program control``),
or with a fault planted under the timed path (``faults.py``), and prints
each run's result line.  Not run by the benchmark's own runs.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from qpbench import faults, run  # noqa: E402
from qpbench.lib import spec  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", default="5")
    ap.add_argument("--program", default="port")
    ap.add_argument("--fault", default="none")
    ap.add_argument("--trace", default="0")
    ap.add_argument("--own-gap", action="store_true",
                    help="serving: also read the reference against itself "
                         "with its hidden units permuted")
    a = ap.parse_args(argv)
    kind = spec.cell(spec.benchmark(), a.workload)["kind"]
    rc = 0
    for seed in a.seeds.split(","):
        print(f"== {a.workload} seed {seed} program {a.program} "
              f"fault {a.fault}", flush=True)
        with faults.planted(kind, a.fault):
            rc |= run.main(["--workload", a.workload, "--seed", seed,
                            "--seconds", a.seconds, "--trace", a.trace],
                           program=a.program,
                           cell_override={"own_gap": True} if a.own_gap
                           else None)
    return rc


if __name__ == "__main__":
    sys.exit(main())
