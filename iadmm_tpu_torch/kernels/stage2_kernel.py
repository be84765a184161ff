"""Fused Stage-II polish, solver 'kkt'.

Replaces ``iadmm_tpu/kernels/stage2_kernel.py::_stage2_kernel`` in its
'kkt' mode.  ρ is fixed across the polish loop, so the full saddle-point
matrix Ã = [[Q+σI, A0ᵀ], [A0, −diag(1/ρ)]] is built in float32 and inverted
once outside the kernel (``torch.linalg.inv``, as the JAX package calls
``jnp.linalg.inv`` outside its Pallas call).  Each polish step is then one
call into ``csrc/stage2.cu``: xv = Ã⁻¹·b̃, ``refine`` optional passes, the
z-relaxed update with α = 1.6 and the per-step primal/dual residuals, all
in float32 FMA.  Its bound is bytes (see the header of ``csrc/stage2.cu``).

The 'direct' and 'cg' solvers are not ported yet (ROADMAP.md, Queue 2).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..solvers.exact import ALPHA_STAGE2
from ..types import IterState, QPBatch
from . import _build


def kkt_inverse(data: QPBatch, rho: torch.Tensor, sigma: float):
    """Float32 Ã⁻¹ of the full saddle-point matrix, (B, n+m, n+m)."""
    f32 = torch.float32
    n = data.num_var
    Q, A0 = data.Q.to(f32), data.A0.to(f32)
    eye = torch.eye(n, dtype=f32, device=Q.device)
    top = torch.cat([Q + sigma * eye, A0.transpose(1, 2)], dim=-1)
    bot = torch.cat([A0, torch.diag_embed(-1.0 / rho)], dim=-1)
    return torch.linalg.inv(torch.cat([top, bot], dim=1))


def finish_state(state: IterState, data: QPBatch, rho, x, y, z,
                 xt) -> IterState:
    """ν = ρ∘(A0·xt − z) + y and the output state, as the JAX wrapper
    rebuilds xv after its kernel."""
    A0 = data.A0.to(torch.float32)
    nu = rho * (torch.einsum("bmn,bn->bm", A0, xt) - z) + y
    return IterState(x=x, y=y, z=z, xv=torch.cat([xt, nu], dim=-1),
                     H=state.H, C=state.C)


def stage2_plain(state: IterState, data: QPBatch, rho: torch.Tensor,
                 Ainv: torch.Tensor, *, num_iters: int, sigma: float,
                 refine: int):
    """Plain PyTorch version of the kernel's N polish steps."""
    f32 = torch.float32
    n = data.num_var
    Q, A0 = data.Q.to(f32), data.A0.to(f32)
    p, zl, zu = (t.to(f32) for t in (data.p, data.zl, data.zu))
    x, y, z = (t.to(f32) for t in (state.x, state.y, state.z))
    xt = state.xv[:, :n].to(f32)
    alpha = ALPHA_STAGE2
    prs, drs = [], []

    def mv_ainv(v):
        return torch.einsum("bij,bj->bi", Ainv, v)

    def col(v, M):  # vᵀM, the column sum the kernel forms (Q symmetric)
        return torch.einsum("bi,bij->bj", v, M)

    for _ in range(num_iters):
        bt = torch.cat([sigma * x - p, z - y / rho], dim=-1)
        xv = mv_ainv(bt)
        for _ in range(refine):
            xt_k, nu_k = xv[:, :n], xv[:, n:]
            ax = torch.cat([col(xt_k, Q) + col(nu_k, A0) + sigma * xt_k,
                            torch.einsum("bij,bj->bi", A0, xt_k)
                            - nu_k / rho], dim=-1)
            xv = xv + mv_ainv(bt - ax)
        xt, nu = xv[:, :n], xv[:, n:]
        z_t = z + (nu - y) / rho
        x = alpha * xt + (1.0 - alpha) * x
        z_tmp = alpha * z_t + (1.0 - alpha) * z
        z_new = torch.minimum(torch.maximum(z_tmp + y / rho, zl), zu)
        y = y + rho * (z_tmp - z_new)
        z = z_new
        prs.append(torch.linalg.vector_norm(
            torch.einsum("bij,bj->bi", A0, x) - z, dim=-1))
        drs.append(torch.linalg.vector_norm(
            col(x, Q) + p + col(y, A0), dim=-1))
    empty = x.new_zeros((x.shape[0], 0))
    pr = torch.stack(prs, dim=1) if prs else empty
    dr = torch.stack(drs, dim=1) if drs else empty
    return x, y, z, xt, pr, dr


_STAGE2_ARGS = ([_build.I] * 3 + [_build.P] * 17 + [_build.I] * 3
                + [_build.F] * 2 + [_build.P])


def stage2_cuda(state: IterState, data: QPBatch, rho: torch.Tensor,
                Ainv: torch.Tensor, *, num_iters: int, sigma: float,
                refine: int):
    """The kernel's N polish steps on CUDA tensors; same contract as
    :func:`stage2_plain`."""
    dev = data.p.device
    f32 = torch.float32
    B, n = data.p.shape
    m = data.num_constr
    S, N = n + m, num_iters
    if tuple(Ainv.shape) != (B, S, S) or tuple(rho.shape) != (B, m):
        raise ValueError(f"Ainv {tuple(Ainv.shape)} / rho "
                         f"{tuple(rho.shape)} do not fit B={B}, n={n}, m={m}")

    def vec(t):
        return _build.aligned(t.to(f32))

    Q, A0, A = vec(data.Q), vec(data.A0), vec(Ainv)
    p, zl, zu, rho_c = vec(data.p), vec(data.zl), vec(data.zu), vec(rho)
    # clone: the kernel updates x, y, z in place
    x, y, z = (t.to(f32).clone().contiguous()
               for t in (state.x, state.y, state.z))
    xv = torch.cat([state.xv[:, :n].to(f32),
                    torch.zeros((B, m), dtype=f32, device=dev)], dim=-1)
    bt = torch.empty((B, S), dtype=f32, device=dev)
    r = torch.empty_like(bt)
    mv_partial = torch.empty(
        (B, (S + _build.KKT_ROWS - 1) // _build.KKT_ROWS, n), dtype=f32,
        device=dev)
    rowdot = torch.empty((B, m), dtype=f32, device=dev)
    pr = torch.empty((B, N), dtype=f32, device=dev)
    dr = torch.empty((B, N), dtype=f32, device=dev)
    fn = _build.function("stage2", "iadmm_stage2_step", _STAGE2_ARGS)
    stream = _build.stream_ptr(dev)
    ptrs = [t.data_ptr() for t in (Q, A0, A, p, zl, zu, rho_c, x, y, z, xv,
                                   bt, r, mv_partial, rowdot, pr, dr)]
    for i in range(N):
        code = fn(i, N, refine, *ptrs, B, n, m, float(sigma),
                  float(ALPHA_STAGE2), stream)
        _build.check(code, "iadmm_stage2_step")
        fused_stage2.launches += 1
    return x, y, z, xv[:, :n], pr, dr


def fused_stage2(state: IterState, data: QPBatch, rho_vec: torch.Tensor,
                 *, num_iters: int, sigma: float = 6e-6,
                 solver: str = "kkt", refine: int = None
                 ) -> Tuple[IterState, torch.Tensor, torch.Tensor]:
    """Run ``num_iters`` polish steps; returns (state', pr, dr) with
    per-step primal/dual residual traces of shape (B, num_iters).

    Operates in whatever space ``data`` lives in; the serving path passes
    the original data and unscaled iterates.  On CUDA data each step
    launches the kernels of ``csrc/stage2.cu``; on CPU data it runs
    :func:`stage2_plain`."""
    if solver in ("direct", "cg"):
        raise NotImplementedError(
            f"stage2 solver {solver!r} is not ported to CUDA yet; see "
            f"ROADMAP.md (Queue 2)")
    if solver != "kkt":
        raise ValueError(f"unknown stage2 solver {solver!r}")
    refine = 0 if refine is None else int(refine)
    B, m = data.p.shape[0], data.num_constr
    rho = (rho_vec.to(torch.float32)
           * torch.ones((B, m), dtype=torch.float32, device=data.p.device))
    Ainv = kkt_inverse(data, rho, sigma)
    run = stage2_cuda if data.p.is_cuda else stage2_plain
    x, y, z, xt, pr, dr = run(state, data, rho, Ainv, num_iters=num_iters,
                              sigma=sigma, refine=refine)
    return finish_state(state, data, rho, x, y, z, xt), pr, dr


fused_stage2.launches = 0  # polish steps launched, counted by stage2_cuda
