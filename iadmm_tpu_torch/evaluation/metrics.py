"""Residuals and objective.

Counterpart of ``obj_fn``, ``primal_dual_residual`` and
``primal_dual_loss`` in ``iadmm_tpu/evaluation/metrics.py``.  The
violation statistics and ``aug_lagr`` are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..types import QPBatch
from ..solvers.step import bmv, bmv_t


def obj_fn(x, Q, p, mode: Optional[str] = None) -> torch.Tensor:
    """0.5 xᵀQx + pᵀx per instance (Q is the doubled Hessian)."""
    return 0.5 * (x * bmv(Q, x, mode)).sum(-1) + (p * x).sum(-1)


def primal_dual_residual(x, y, z, Q, p, A0, mode: Optional[str] = None):
    """(‖A0x − z‖₂, ‖Qx + p + A0ᵀy‖₂) per instance."""
    pr = torch.linalg.vector_norm(bmv(A0, x, mode) - z, dim=-1)
    dr = torch.linalg.vector_norm(bmv(Q, x, mode) + p + bmv_t(A0, y, mode),
                                  dim=-1)
    return pr, dr


def primal_dual_loss(x, y, z, data: QPBatch):
    """Unsupervised training loss: primal + dual residual per instance."""
    pr, dr = primal_dual_residual(x, y, z, data.Q, data.p, data.A0)
    return pr, dr, pr + dr
