"""Training CLI of the port.

Loads the ``.npz`` dataset at ``<data_root>/<run-keyed name>.npz``, trains
with :func:`iadmm_tpu_torch.train.harness.train` and writes the
tolerance-gated best checkpoint (``.pkl``, the JAX package's format):

    python -m iadmm_tpu_torch.cli.train --config configs/qp_small.yaml \\
        --train_backend fused --gate_dtype bfloat16 --matvec_mode bf16 \\
        --data_root <dir>

Runs on the GPU unless ``--device cpu`` is given.  ``--generate`` is not
ported: labelling a new dataset needs the QP oracle (see ROADMAP.md).
"""

from __future__ import annotations

import sys

from . import config_parser, parse_config
from ..problems.io import load_dataset
from ..train.harness import train


def main(argv=None) -> int:
    p = config_parser(__doc__)
    p.add_argument("--generate", action="store_true",
                   help="not ported: generate and label the dataset")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda)")
    args = p.parse_args(argv)
    if args.generate:
        raise NotImplementedError(
            "--generate needs the QP oracle to label the dataset, which is "
            "not ported to PyTorch yet; see ROADMAP.md (Queue 1, data "
            "layer).  Generate it with the JAX package's "
            "iadmm_tpu.cli.generate_data")
    cfg = parse_config(args)
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
