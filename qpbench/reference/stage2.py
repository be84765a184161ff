"""Stage II: N exact ADMM polish steps by one factorization.

The mathematics of ``iadmm_tpu_torch/solvers/exact.py`` (commit cc8fe97),
written anew: Ã = [[Q + σI, A0ᵀ], [A0, −diag(1/ρ)]] in the original space
with the last learned ρ, factored once by LU (float32, ``torch.linalg``);
each step solves Ã·xv = b̃, b̃ = [σx − p ; z − y/ρ], and applies the
z-relaxed update with α = 1.6.  ``f32`` rounds the float32 operands (the
identity in the reference, TF32 in the control).
"""

from __future__ import annotations

import torch

ALPHA = 1.6


def polish(x, y, z, Q, p, A0, zl, zu, rho, *, N: int, sigma: float,
           f32=lambda a: a):
    B, n = p.shape
    eye = torch.eye(n, device=p.device)
    top = torch.cat([Q + sigma * eye, A0.transpose(1, 2)], 2)
    bot = torch.cat([A0, torch.diag_embed(-1.0 / rho)], 2)
    lu, piv = torch.linalg.lu_factor(f32(torch.cat([top, bot], 1)))
    for _ in range(N):
        bt = torch.cat([sigma * x - p, z - y / rho], 1)
        xv = torch.linalg.lu_solve(lu, piv, f32(bt)[..., None])[..., 0]
        xt, v = xv[:, :n], xv[:, n:]
        zt = z + (v - y) / rho
        x = ALPHA * xt + (1.0 - ALPHA) * x
        zr = ALPHA * zt + (1.0 - ALPHA) * z
        zn = torch.minimum(torch.maximum(zr + y / rho, zl), zu)
        y = y + rho * (zr - zn)
        z = zn
    return x, y, z
