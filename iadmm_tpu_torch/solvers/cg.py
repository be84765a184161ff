"""Matrix-free Stage-II solver: batched conjugate gradient on the condensed
KKT system.

Counterpart of ``iadmm_tpu/solvers/cg.py``.  Instead of factoring the dense
(n+m)² KKT matrix (:mod:`.exact`), each polish step solves the equivalent
condensed SPD system

    M x̃ = b,   M = Q + σI + A0ᵀ diag(ρ) A0
    b = σx − p + A0ᵀ(ρ∘z − y)
    ν = ρ∘(A0 x̃ − z) + y            (implied KKT dual block)

without forming M: each CG iteration is one Q matvec and two A0 matvecs.
All instances iterate in lockstep with per-instance step sizes held as
tensors; a converged instance is masked and stops updating, so the loop
never reads a value back to the host.  Jacobi preconditioning uses
diag(M) = diag(Q) + σ + Σ_k ρ_k A0[k,:]².  Plain PyTorch: the JAX package
runs this route in XLA, outside its kernels.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..types import IterState, QPBatch
from ..utils.profiling import span
from .exact import ALPHA_STAGE2
from .step import admm_update, bmv, bmv_t


def condensed_matvec(data: QPBatch, v: torch.Tensor, sigma,
                     rho_vec: torch.Tensor, mode=None) -> torch.Tensor:
    """M·v = Qv + σv + A0ᵀ(ρ∘(A0 v)) without materialising M."""
    return (bmv(data.Q, v, mode) + sigma * v
            + bmv_t(data.A0, rho_vec * bmv(data.A0, v, mode), mode))


def condensed_rhs(data: QPBatch, x, y, z, sigma, rho_vec) -> torch.Tensor:
    """b = σx − p + A0ᵀ(ρ∘z − y)."""
    return sigma * x - data.p + bmv_t(data.A0, rho_vec * z - y)


def jacobi_diag(data: QPBatch, sigma, rho_vec) -> torch.Tensor:
    """diag(M) exactly: (B, n)."""
    qd = torch.diagonal(data.Q, dim1=-2, dim2=-1)
    ad = torch.einsum("bmn,bm->bn", data.A0 ** 2, rho_vec)
    return qd + sigma + ad


def batched_cg(matvec: Callable, b: torch.Tensor, x0: torch.Tensor,
               diag: torch.Tensor, maxiter: int, tol: float = 1e-8
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Jacobi-preconditioned CG over a batch with per-instance α and β.

    Runs ``maxiter`` iterations; an instance whose ‖r‖/‖b‖ ≤ ``tol`` or
    whose pᵀMp ≤ 0 is masked and stops updating.  Returns (x, final
    residual norms, (B,) int32 count of the iterations each instance ran
    unmasked)."""
    def dot(a, c):
        return torch.einsum("bi,bi->b", a, c)

    r = b - matvec(x0)
    zp = r / diag
    p = zp
    rz = dot(r, zp)
    bnorm = torch.sqrt(dot(b, b)) + 1e-30
    x = x0
    iters = torch.zeros(b.shape[0], dtype=torch.int32, device=b.device)
    for _ in range(maxiter):
        Ap = matvec(p)
        denom = dot(p, Ap)
        active = (torch.sqrt(dot(r, r)) / bnorm > tol) & (denom > 0)
        alpha = torch.where(
            active, rz / torch.where(denom == 0, torch.ones_like(denom),
                                     denom), torch.zeros_like(denom))
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * Ap
        zp = r / diag
        rz_new = dot(r, zp)
        beta = torch.where(
            active, rz_new / torch.where(rz == 0, torch.ones_like(rz), rz),
            torch.zeros_like(rz))
        p = zp + beta[:, None] * p
        rz = torch.where(active, rz_new, rz)
        iters += active.to(torch.int32)
    return x, torch.sqrt(dot(r, r)), iters


def exact_step_cg(rho_vec: torch.Tensor, state: IterState, data: QPBatch,
                  sigma, maxiter: int = 100, tol: float = 1e-8,
                  alpha: float = ALPHA_STAGE2) -> IterState:
    """One exact ADMM iteration with the KKT solve done by batched CG, the
    LU Stage II's update semantics; xv carries [x̃; ν]."""
    n = data.num_var
    b = condensed_rhs(data, state.x, state.y, state.z, sigma, rho_vec)
    diag = jacobi_diag(data, sigma, rho_vec)
    x_t, _, _ = batched_cg(
        lambda v: condensed_matvec(data, v, sigma, rho_vec),
        b, state.xv[:, :n], diag, maxiter, tol)
    nu = rho_vec * (bmv(data.A0, x_t) - state.z) + state.y
    xv = torch.cat([x_t, nu], dim=-1)
    x, y, z = admm_update(data, xv, state.x, state.y, state.z, rho_vec,
                          alpha, relax_z=True)
    return IterState(x=x, y=y, z=z, xv=xv, H=state.H, C=state.C)


def feasibility_restoration_cg(state: IterState, data: QPBatch, sigma,
                               rho_vec: torch.Tensor, num_iters: int,
                               cg_iters: int = 100,
                               alpha: float = ALPHA_STAGE2) -> IterState:
    """Stage-II polish loop, matrix-free; CG warm-starts from the previous
    x̃ carried in xv.  Nothing is factorised: the loop is the span
    ``stage2/polish`` alone."""
    with span("stage2/polish") as box:
        for _ in range(num_iters):
            state = exact_step_cg(rho_vec, state, data, sigma, cg_iters,
                                  alpha=alpha)
        box["result"] = state.x
    return state
