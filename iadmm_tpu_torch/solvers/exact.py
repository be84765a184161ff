"""Stage-II exact ADMM step (feasibility restoration), LU route.

Counterpart of ``iadmm_tpu/solvers/exact.py``: the KKT matrix is built and
LU-factorised once (``torch.linalg.lu_factor``), and the factors serve every
polish step.  Fixed relaxation α = 1.6 with z-relaxation on; ρ is the last
learned iteration's.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..types import IterState, QPBatch
from .step import admm_update, kkt_rhs

ALPHA_STAGE2 = 1.6


def build_kkt(data: QPBatch, sigma, rho_vec: torch.Tensor) -> torch.Tensor:
    """Ã = [[Q+σI, A0ᵀ], [A0, −diag(1/ρ)]] as a dense (B, n+m, n+m) batch."""
    n = data.num_var
    m = data.num_constr
    kw = dict(dtype=data.Q.dtype, device=data.Q.device)
    top = torch.cat([data.Q + sigma * torch.eye(n, **kw),
                     data.A0.transpose(-1, -2)], dim=-1)
    rho = rho_vec.to(data.Q.dtype).expand(data.batch, m)
    bottom = torch.cat([data.A0, torch.diag_embed(-1.0 / rho)], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def lu_factorize(data: QPBatch, sigma,
                 rho_vec: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched LU of the KKT matrix (factor once)."""
    return torch.linalg.lu_factor(build_kkt(data, sigma, rho_vec))


def exact_step(lu, piv, rho_vec, state: IterState, data: QPBatch, sigma,
               alpha: float = ALPHA_STAGE2) -> IterState:
    """One exact OSQP-style iteration via cached LU factors."""
    b1, b2 = kkt_rhs(data, state.x, state.y, state.z, sigma, rho_vec)
    rhs = torch.cat([b1, b2], dim=-1).to(lu.dtype)
    xv = torch.linalg.lu_solve(lu, piv, rhs[..., None])[..., 0]
    x, y, z = admm_update(data, xv, state.x, state.y, state.z,
                          rho_vec, alpha, relax_z=True)
    return IterState(x=x, y=y, z=z, xv=xv, H=state.H, C=state.C)


def feasibility_restoration(state: IterState, data: QPBatch, sigma,
                            rho_vec: torch.Tensor, num_iters: int,
                            alpha: float = ALPHA_STAGE2) -> IterState:
    """``num_iters`` exact polish steps with a single factorisation."""
    lu, piv = lu_factorize(data, sigma, rho_vec)
    for _ in range(num_iters):
        state = exact_step(lu, piv, rho_vec, state, data, sigma, alpha)
    return state
