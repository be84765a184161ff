"""Test / inference CLI of the port.

Loads the dataset (``<data_root>/<run-keyed name>.npz``, or the
reference's gz-pickle layout) and the run-keyed ``.pkl`` checkpoint (either
package's), evaluates the test split with per-iteration traces
(:func:`iadmm_tpu_torch.evaluation.driver.run_test`), with the Stage-II
polish under ``--feas_rest``, exports the traces with ``--export`` (or
``--save_sol``) and, with ``--baseline osqp``, solves the same test split
with the QP oracle on the host (``run_osqp_baseline``):

    python -m iadmm_tpu_torch.cli.test --config configs/qp_small.yaml \\
        --data_root <dir> --export traces.mat

Runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import os
import sys

from . import config_parser, parse_config
from ..evaluation.driver import export_traces, run_osqp_baseline, run_test
from ..problems.io import load_dataset
from ..train import checkpoint as ckpt


def main(argv=None) -> int:
    p = config_parser(__doc__)
    p.add_argument("--load_path", default=None,
                   help="explicit checkpoint path (default: run-keyed)")
    p.add_argument("--baseline", choices=["none", "osqp"], default="none")
    p.add_argument("--export", default=None,
                   help="trace export path (.mat or .npz); implies save_sol")
    p.add_argument("--device", default="cuda",
                   help="torch device to evaluate on (default cuda)")
    args = p.parse_args(argv)
    cfg = parse_config(args)

    ds = load_dataset(cfg.data_root, cfg.prob_type, cfg.num_var,
                      cfg.num_ineq, cfg.num_eq, cfg.qplib_num,
                      cfg.data_size)
    cfg.data_size = min(cfg.data_size, ds.size)

    load_path = args.load_path or ckpt.checkpoint_path(
        cfg.save_dir, cfg.model_name, cfg.run_name())
    payload = ckpt.load_checkpoint(load_path)
    params = payload["params"] if "params" in payload else payload

    report = run_test(cfg, ds, params, verbose=True, device=args.device)
    if args.export or cfg.save_sol:
        out = args.export or os.path.join(
            cfg.save_dir, cfg.model_name, cfg.run_name() + ".mat")
        export_traces(report, out)
        print(f"traces -> {out}")
    if args.baseline == "osqp":
        run_osqp_baseline(cfg, ds, verbose=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
