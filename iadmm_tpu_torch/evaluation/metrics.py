"""Residuals and objective.

Counterpart of ``obj_fn``, ``primal_dual_residual``, ``primal_dual_loss``,
the distance functions and ``violation_stats`` in
``iadmm_tpu/evaluation/metrics.py``.  ``aug_lagr`` is not ported yet.
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


def ineq_dist(x, G, c, mode: Optional[str] = None):
    """relu(Gx − c)."""
    return torch.clamp(bmv(G, x, mode) - c, min=0.0)


def eq_dist(x, A, b, mode: Optional[str] = None):
    """|b − Ax|."""
    return (b - bmv(A, x, mode)).abs()


def lb_dist(x, lb):
    return torch.clamp(lb - x, min=0.0)


def ub_dist(x, ub):
    return torch.clamp(x - ub, min=0.0)


def violation_stats(x, data: QPBatch, mode: Optional[str] = None):
    """Dict of (max over rows, mean over the batch) and mean per constraint
    class; only the classes the problem family has appear."""
    out = {}
    for name, view in (("ineq", data.G), ("eq", data.A), ("lb", data.lb),
                       ("ub", data.ub)):
        if view is None:
            continue
        if name == "ineq":
            d = ineq_dist(x, data.G, data.c, mode)
        elif name == "eq":
            d = eq_dist(x, data.A, data.b, mode)
        elif name == "lb":
            d = lb_dist(x, data.lb)
        else:
            d = ub_dist(x, data.ub)
        out[f"{name}_max"] = d.max(dim=-1).values.mean()
        out[f"{name}_mean"] = d.mean()
    return out
