"""Dataset generation CLI of the port.

Counterpart of ``iadmm_tpu/cli/generate_data.py``: generates a synthetic
family, labels every instance with the QP oracle at the reference's 1e-4
tolerance (the native C++ solver where it builds), drops the unsolved
instances and writes one stacked ``.npz`` that both packages read:

    python -m iadmm_tpu_torch.cli.generate_data --prob_type QP \\
        --num_var 1000 --num_ineq 500 --num_eq 500 --data_size 1000 \\
        --data_root ./datasets

Runs on the host only (numpy and the oracle).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..problems.generators import FAMILIES, generate
from ..problems.io import dataset_path, save_npz
from ..problems.oracle import label_dataset


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--prob_type", choices=FAMILIES, default="QP")
    p.add_argument("--num_var", type=int, default=100)
    p.add_argument("--num_ineq", type=int, default=50)
    p.add_argument("--num_eq", type=int, default=50)
    p.add_argument("--data_size", type=int, default=1000)
    p.add_argument("--seed", type=int, default=17)
    p.add_argument("--data_root", default="./datasets")
    p.add_argument("--eps", type=float, default=1e-4,
                   help="oracle tolerance (the reference's 1e-4)")
    args = p.parse_args(argv)

    ds = generate(args.prob_type, num_var=args.num_var,
                  num_ineq=args.num_ineq, num_eq=args.num_eq,
                  data_size=args.data_size, seed=args.seed)
    solved = label_dataset(ds, eps=args.eps, verbose=True)
    if len(solved) < ds.size:
        print(f"dropping {ds.size - len(solved)} unsolved instances")
        ds = ds.slice(np.asarray(solved))
    path = dataset_path(args.data_root, args.prob_type, args.num_var,
                        args.num_ineq, args.num_eq)
    save_npz(ds, path)
    print(f"wrote {ds.size} instances -> {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
