"""The ``QP`` family (diagonal Q, Gaussian rows, feasible inequality bounds)
made on the device from a ``torch.Generator``.

The distributions of ``iadmm_tpu_torch/problems/generators.py::
generate_qp`` (commit cc8fe97; the reference's generate_data.py:63-94),
rewritten in torch: half-Hessian diagonal 0.5·U(0,1) (the solver form Q is
twice it), p ~ U(0,1), equality rows A ~ N(0,1) with b ~ U(−1,1),
inequality rows G ~ N(0,1) with c = Σ_cols |G·pinv(A)| (the feasibility
trick; pinv(A) = Aᵀ(AAᵀ)⁻¹ by a float64 solve on the device instead of a
host SVD), A0 = [G; A], zl = [−∞; b], zu = [c; b].  Each tensor is one
draw over the whole pool, in a fixed order.
"""

from __future__ import annotations

import torch


def pool(n: int, mi: int, me: int, count: int, g: torch.Generator,
         device, chunk: int = 64) -> dict:
    """``count`` instances: Q (count, n, n) (solver form, dense), p, A0
    (count, mi+me, n), zl, zu, eq_mask; float32."""
    kw = dict(generator=g, device=device, dtype=torch.float32)
    qh = 0.5 * torch.rand((count, n), **kw)
    p = torch.rand((count, n), **kw)
    A0 = torch.empty((count, mi + me, n), device=device)
    A0[:, mi:].normal_(generator=g)
    b = 2.0 * torch.rand((count, me), **kw) - 1.0
    A0[:, :mi].normal_(generator=g)
    c = torch.empty((count, mi), device=device)
    for s in range(0, count, chunk):
        G = A0[s:s + chunk, :mi].double()
        A = A0[s:s + chunk, mi:].double()
        X = torch.linalg.solve(A @ A.transpose(1, 2),
                               A @ G.transpose(1, 2))      # (me, mi)
        c[s:s + chunk] = X.abs().sum(1).float()
    zl = torch.cat([torch.full((count, mi), -torch.inf, device=device), b], 1)
    zu = torch.cat([c, b], 1)
    Q = torch.diag_embed(2.0 * qh)
    return dict(Q=Q, p=p, A0=A0, zl=zl, zu=zu,
                eq_mask=(zl == zu) & torch.isfinite(zl))
