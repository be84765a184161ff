"""The learned rollout: K LSTM-driven inexact ADMM iterations from zero.

The mathematics of ``iadmm_tpu_torch/kernels/rollout_kernel.py::
rollout_plain`` (commit cc8fe97), which is the TPU kernel's, written anew
with the rounding points of the bf16 profile made explicit (``low``):

    ρ_t = σ(rho[t])·(1e3 on equality rows), α_t = 2σ(alpha[t])
    r   = Ã·xv − b̃,   b̃ = [σx − p ; z − y/ρ],   Ã = [[Q+σI, A0ᵀ], [A0, −1/ρ]]
    g   = Ã·r                                 (Q, A0, xv, r rounded by low)
    gates = low(H)·low(U) + xv·low(W0) + g·low(W1) + b     ([i, f, o, u])
    C' = σ(i)·tanh(u) + σ(f)·C,  H' = σ(o)·tanh(C')        (C float32)
    xv ← xv − (low(H')·low(W_h) + b_h),  H ← low(H')
    x ← α x̃ + (1−α)x,  z ← Π[zl,zu](z̃ + y/ρ),  y ← y + ρ(z̃ − z)

All sums float32; products of the float32 operands with no TF32.
"""

from __future__ import annotations

import torch


def rollout(params, Q, p, A0, zl, zu, eq_mask, *, K: int, sigma: float,
            low):
    B, n = p.shape
    m = A0.shape[1]
    h = params["U"].shape[0]
    dev = p.device
    Qr, A0r = low(Q), low(A0)
    W, U, Wh = low(params["W"]), low(params["U"]), low(params["W_h"])
    b, bh = params["b"].float(), params["b_h"].float()
    mult = torch.where(eq_mask, 1e3, 1.0).to(torch.float32)
    xv = torch.zeros((B, n + m), device=dev)
    x = torch.zeros((B, n), device=dev)
    y = torch.zeros((B, m), device=dev)
    z = torch.zeros((B, m), device=dev)
    H = torch.zeros((B, n + m, h), device=dev)
    C = torch.zeros((B, n + m, h), device=dev)

    def kkt(u, nu, rho):
        """Ã·[u; ν]: the matvecs on rounded operands, σu and ν/ρ not."""
        ur, nur = low(u), low(nu)
        top = (torch.einsum("bij,bj->bi", Qr, ur) + sigma * u
               + torch.einsum("bji,bj->bi", A0r, nur))
        return top, torch.einsum("bij,bj->bi", A0r, ur) - nu / rho

    for t in range(K):
        rho = torch.sigmoid(params["rho"][t].float()) * mult
        alpha = 2.0 * torch.sigmoid(params["alpha"][t].float())
        t1, t2 = kkt(xv[:, :n], xv[:, n:], rho)
        r1, r2 = t1 - (sigma * x - p), t2 - (z - y / rho)
        g1, g2 = kkt(r1, r2, rho)
        g = torch.cat([g1, g2], 1)
        gates = (H @ U + xv[..., None] * W[0] + g[..., None] * W[1] + b)
        i, f, o = (torch.sigmoid(gates[..., k * h:(k + 1) * h])
                   for k in range(3))
        u_ = torch.tanh(gates[..., 3 * h:])
        C = i * u_ + f * C
        Hn = low(o * torch.tanh(C))
        xv = xv - ((Hn @ Wh)[..., 0] + bh)
        H = Hn
        xt, v = xv[:, :n], xv[:, n:]
        zt = z + (v - y) / rho
        x = alpha * xt + (1.0 - alpha) * x
        zn = torch.minimum(torch.maximum(zt + y / rho, zl), zu)
        y = y + rho * (zt - zn)
        z = zn
    return x, y, z


def permute_hidden(params, perm):
    """The same function with its hidden units in the order ``perm``: the
    gate columns of W, U and b and the rows of U and W_h permuted.  Its
    rollout differs from the original's by rounding alone (sums over the
    units in another order)."""
    h = params["U"].shape[0]
    cols = torch.cat([perm + k * h for k in range(4)])
    out = dict(params)
    out["W"] = params["W"][:, cols]
    out["U"] = params["U"][perm][:, cols]
    out["b"] = params["b"][cols]
    out["W_h"] = params["W_h"][perm]
    return out
