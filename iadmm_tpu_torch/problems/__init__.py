"""Problem families, dataset files and conversion to device batches."""

from .generators import FAMILIES, RawDataset, generate
from .io import (dataset_path, load_dataset, load_npz, save_npz, split_ids,
                 to_qp_batch)

__all__ = ["FAMILIES", "RawDataset", "generate", "to_qp_batch", "save_npz",
           "load_npz", "dataset_path", "load_dataset", "split_ids"]
