"""Residuals and objective of a QP answer: ‖A0x − z‖₂, ‖Qx + p + A0ᵀy‖₂
and ½xᵀQx + pᵀx (Q the doubled Hessian).  The arithmetic of
``iadmm_tpu_torch/evaluation/metrics.py`` (commit cc8fe97), written anew;
``f32`` rounds the operands (TF32 in the control), ``dtype`` sets the
precision (float64 to judge what an answer says)."""

from __future__ import annotations

import torch


def residuals(x, y, z, Q, p, A0, f32=lambda a: a, dtype=torch.float32):
    x, y, z, Q, p, A0 = (t.to(dtype) for t in (x, y, z, Q, p, A0))
    Qx = torch.einsum("bij,bj->bi", f32(Q), f32(x))
    pr = torch.linalg.vector_norm(
        torch.einsum("bij,bj->bi", f32(A0), f32(x)) - z, dim=1)
    dr = torch.linalg.vector_norm(
        Qx + p + torch.einsum("bji,bj->bi", f32(A0), f32(y)), dim=1)
    obj = 0.5 * (x * Qx).sum(1) + (p * x).sum(1)
    return pr, dr, obj
