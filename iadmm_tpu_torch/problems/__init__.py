"""Problem families and their conversion to device batches."""

from .generators import FAMILIES, RawDataset, generate
from .io import to_qp_batch

__all__ = ["FAMILIES", "RawDataset", "generate", "to_qp_batch"]
