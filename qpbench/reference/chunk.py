"""The TBPTT chunk loss of the training route, differentiable by autograd.

The mathematics of ``iadmm_tpu_torch/kernels/train_rollout.py::
train_fwd_plain`` (commit cc8fe97), the TPU kernel's step, written anew
with the profile's rounding points: Q, A0 and every vector rounded before
each matvec, and each cotangent before the matvec of the backward
(``low``), W, U, W_h and H rounded before the cell's products
(``cell``, by default ``low``; a float32 cell leaves them be), float32
sums, H carried in float32, C float32.  From the zero state,
J steps at schedule index t0..t0+J−1; the loss is
Σ_steps mean_batch(‖A0x − z‖ + ‖Qx + p + A0ᵀy‖) / K.
"""

from __future__ import annotations

import torch


class _Matvec(torch.autograd.Function):
    """M·v (or Mᵀ·v) of a problem matrix with the vector rounded by
    ``low``, and in the backward the transposed product with the cotangent
    rounded by ``low``: every matvec's vector operand is rounded, forward
    and backward, as the kernels round theirs."""

    @staticmethod
    def forward(ctx, M, v, low, transpose):
        ctx.save_for_backward(M)
        ctx.low, ctx.transpose = low, transpose
        spec = "bi,bij->bj" if transpose else "bij,bj->bi"
        return torch.einsum(spec, *((low(v), M) if transpose
                                    else (M, low(v))))

    @staticmethod
    def backward(ctx, g):
        M, = ctx.saved_tensors
        gr = ctx.low(g)
        dv = (torch.einsum("bij,bj->bi", M, gr) if ctx.transpose
              else torch.einsum("bi,bij->bj", gr, M))
        return None, dv, None, None


def loss(params, Q, p, A0, zl, zu, eq_mask, *, J: int, K: int, t0: int,
         sigma: float, low, cell=None):
    B, n = p.shape
    m = A0.shape[1]
    h = params["U"].shape[0]
    dev = p.device
    cell = low if cell is None else cell
    Qr, A0r = low(Q), low(A0)
    W, U, Wh = cell(params["W"]), cell(params["U"]), cell(params["W_h"])
    b, bh = params["b"], params["b_h"]
    mult = torch.where(eq_mask, 1e3, 1.0).to(torch.float32)

    def mv_q(v):
        return _Matvec.apply(Qr, v, low, True)

    def mv_a0(v):
        return _Matvec.apply(A0r, v, low, False)

    def mv_a0t(v):
        return _Matvec.apply(A0r, v, low, True)

    x = torch.zeros((B, n), device=dev)
    y = torch.zeros((B, m), device=dev)
    z = torch.zeros((B, m), device=dev)
    xv = torch.zeros((B, n + m), device=dev)
    H = torch.zeros((B, n + m, h), device=dev)
    C = torch.zeros((B, n + m, h), device=dev)
    total = 0.0
    for k in range(J):
        rho = torch.sigmoid(params["rho"][t0 + k]) * mult
        alpha = 2.0 * torch.sigmoid(params["alpha"][t0 + k])
        u, nu = xv[:, :n], xv[:, n:]
        r1 = mv_q(u) + sigma * u + mv_a0t(nu) - (sigma * x - p)
        r2 = mv_a0(u) - (nu - y) / rho - z
        g = torch.cat([mv_q(r1) + sigma * r1 + mv_a0t(r2),
                       mv_a0(r1) - r2 / rho], 1)
        pre = xv[..., None] * W[0] + g[..., None] * W[1] + cell(H) @ U + b
        i, f, o = (torch.sigmoid(pre[..., j * h:(j + 1) * h])
                   for j in range(3))
        C = i * torch.tanh(pre[..., 3 * h:]) + f * C
        H = o * torch.tanh(C)
        xv = xv - ((cell(H) @ Wh)[..., 0] + bh)
        xt, v = xv[:, :n], xv[:, n:]
        zt = z + (v - y) / rho
        x = alpha * xt + (1.0 - alpha) * x
        zn = torch.minimum(torch.maximum(zt + y / rho, zl), zu)
        y = y + rho * (zt - zn)
        z = zn
        pr = torch.linalg.vector_norm(mv_a0(x) - z, dim=1)
        dr = torch.linalg.vector_norm(mv_q(x) + p + mv_a0t(y), dim=1)
        total = total + (pr + dr).mean()
    return total / K
