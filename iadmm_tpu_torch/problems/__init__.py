"""Problem families, the QP oracle, dataset files and conversion to device
batches."""

from .generators import FAMILIES, RawDataset, generate
from .io import (dataset_path, load_dataset, load_npz,
                 load_reference_gz_dir, save_npz, save_reference_gz_dir,
                 split_ids, to_qp_batch)
from .oracle import HAVE_OSQP, OracleResult, label_dataset, solve_qp

__all__ = ["FAMILIES", "RawDataset", "generate", "to_qp_batch", "save_npz",
           "load_npz", "dataset_path", "load_dataset",
           "load_reference_gz_dir", "save_reference_gz_dir", "split_ids",
           "OracleResult", "label_dataset", "solve_qp", "HAVE_OSQP"]
