"""Training CLI of the port.

Loads the dataset (``<data_root>/<run-keyed name>.npz``, or the
reference's gz-pickle layout; with ``--generate``, a missing ``.npz`` is
generated and labelled first by :mod:`iadmm_tpu_torch.cli.generate_data`),
trains with :func:`iadmm_tpu_torch.train.harness.train` and writes the
tolerance-gated best checkpoint (``.pkl``, the JAX package's format):

    python -m iadmm_tpu_torch.cli.train --config configs/qp_small.yaml \\
        --train_backend fused --gate_dtype bfloat16 --matvec_mode bf16 \\
        --data_root <dir>

Runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import os
import sys

from . import config_parser, parse_config
from ..problems.io import dataset_path, load_dataset
from ..train.harness import train


def main(argv=None) -> int:
    p = config_parser(__doc__)
    p.add_argument("--generate", action="store_true",
                   help="generate+label the dataset if the .npz is missing")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda)")
    args = p.parse_args(argv)
    cfg = parse_config(args)

    path = dataset_path(cfg.data_root, cfg.prob_type, cfg.num_var,
                        cfg.num_ineq, cfg.num_eq)
    if cfg.prob_type != "QPLIB" and not os.path.exists(path) \
            and args.generate:
        from .generate_data import main as gen_main
        gen_main(["--prob_type", cfg.prob_type,
                  "--num_var", str(cfg.num_var),
                  "--num_ineq", str(cfg.num_ineq),
                  "--num_eq", str(cfg.num_eq),
                  "--data_size", str(cfg.data_size),
                  "--seed", str(cfg.seed),
                  "--data_root", cfg.data_root])
    ds = load_dataset(cfg.data_root, cfg.prob_type, cfg.num_var,
                      cfg.num_ineq, cfg.num_eq, cfg.qplib_num, cfg.data_size)
    if ds.size < cfg.data_size:
        print(f"note: dataset has {ds.size} < data_size={cfg.data_size}; "
              f"using {ds.size}")
        cfg.data_size = ds.size
    result = train(cfg, ds, verbose=True, device=args.device)
    print(f"done: {result.epochs_run} epochs, best val obj "
          f"{result.best_val_obj}, checkpoint {result.checkpoint_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
