"""Fused Stage-II polish: the solvers 'kkt', 'direct' and 'cg'.

Replaces ``iadmm_tpu/kernels/stage2_kernel.py::_stage2_kernel``.  ρ is
fixed across the polish loop, so each solver's operand is formed once
outside the kernel, as the JAX package forms it outside its Pallas call:

- ``'kkt'``: the float32 inverse Ã⁻¹ of the full saddle-point matrix
  Ã = [[Q+σI, A0ᵀ], [A0, −diag(1/ρ)]] (on CUDA data formed and inverted by
  ``csrc/kkt_inverse.cu``, blocked Gauss–Jordan with row pivoting; on CPU
  data ``torch.linalg.inv``); a step is xv = Ã⁻¹·b̃ and ``refine`` optional
  passes.
- ``'direct'``: the explicit inverse of the condensed SPD matrix
  M = Q + σI + A0ᵀdiag(ρ)A0 (float32 products with no TF32, then
  ``torch.linalg.cholesky`` and ``torch.cholesky_solve``); a step is
  xt = b·M⁻¹ with b = σx − p + A0ᵀ(ρz − y), then ``refine`` passes of
  r = b − M·xt, xt += r·M⁻¹.
- ``'cg'``: the Jacobi diagonal diag(Q) + σ + Σ ρ·A0²; a step runs
  ``cg_iters`` iterations of preconditioned CG on M, warm-started from the
  previous step's xt, each instance masked once ‖r‖/‖b‖ ≤ ``tol`` or
  pᵀMp ≤ 0.

Each step then sets ν (from the solve for 'kkt', ν = ρ(A0·xt − z) + y
otherwise), applies the z-relaxed update with α = 1.6 and records the
primal/dual residuals.  On CUDA data every polish step is one call into
``csrc/stage2.cu`` (all float32 FMA; bound by bytes for 'kkt', by
operations for the other two: see ``bounds.stage2``); on CPU data the
plain twins below run the same steps.  :func:`fused_stage2` forms the
operand inside the span ``stage2/factor`` and runs the N steps inside
``stage2/polish`` (:func:`~iadmm_tpu_torch.utils.profiling.span`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Tuple

import torch

from ..solvers.cg import (batched_cg, condensed_matvec, condensed_rhs,
                          jacobi_diag)
from ..solvers.exact import ALPHA_STAGE2
from ..solvers.step import admm_update
from ..types import IterState, QPBatch
from ..utils.profiling import span
from . import _build


@contextlib.contextmanager
def _full_float32():
    """Float32 products without TF32 whatever the caller enabled: the JAX
    package forms these operands at ``Precision.HIGHEST``."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _kkt_matrix(data: QPBatch, rho: torch.Tensor, sigma: float):
    """Ã in float32, (B, n+m, n+m)."""
    f32 = torch.float32
    n = data.num_var
    Q, A0 = data.Q.to(f32), data.A0.to(f32)
    eye = torch.eye(n, dtype=f32, device=Q.device)
    top = torch.cat([Q + sigma * eye, A0.transpose(1, 2)], dim=-1)
    bot = torch.cat([A0, torch.diag_embed(-1.0 / rho)], dim=-1)
    return torch.cat([top, bot], dim=1)


def kkt_inverse(data: QPBatch, rho: torch.Tensor, sigma: float):
    """Float32 Ã⁻¹ of the full saddle-point matrix, (B, n+m, n+m), stored
    row-major, as the 'kkt' kernel reads it.  On CUDA data one launch of
    ``csrc/kkt_inverse.cu`` forms Ã and writes its inverse
    (:func:`kkt_inverse_cuda`; counted in ``kkt_inverse.launches``); on CPU
    data ``torch.linalg.inv``'s result, copied row-major."""
    if data.p.is_cuda:
        return kkt_inverse_cuda(data, rho, sigma)[0]
    return torch.linalg.inv(_kkt_matrix(data, rho, sigma)).contiguous()


kkt_inverse.launches = 0   # launches of csrc/kkt_inverse.cu

# The widest panel of csrc/kkt_inverse.cu (its scratch is sized for it) and
# its flags an instance
KINV_NB_MAX = _build.header_int("kkt_inverse.cu", "NB_MAX")
KINV_FLAGS = _build.header_int("kkt_inverse.cu", "FLAGS")
KINV_SB = _build.header_int("kkt_inverse.cu", "SB")   # a sub-panel's width
_KINV_ARGS = ([_build.P] * 3 + [_build.F] + [_build.P] * 7 + [_build.I] * 3
              + [_build.P])


def kkt_inverse_nb(S: int, dev) -> int:
    """The panel width the kernel takes at S = n + m on ``dev`` (the
    widest of 128, 64, 32 whose panel fits a cluster's shared memory; 0
    where none does)."""
    with torch.cuda.device(dev):
        return _build.function("kkt_inverse", "iadmm_kkt_inverse_nb",
                               [_build.I])(S)


def kkt_inverse_cuda(data: QPBatch, rho: torch.Tensor, sigma: float):
    """(Ã⁻¹, info) on CUDA tensors: Ã⁻¹ (B, S, S) row-major, S = n + m;
    info (B,) int32, each instance's first zero pivot's row + 1, else 0
    (nothing on the hot path reads it).  One launch, no host sync."""
    dev = data.p.device
    B, n = data.p.shape
    m = data.num_constr
    S = n + m
    if (tuple(data.Q.shape) != (B, n, n) or tuple(data.A0.shape) != (B, m, n)
            or tuple(rho.shape) != (B, m)):
        raise ValueError(f"kkt_inverse: Q {tuple(data.Q.shape)}, A0 "
                         f"{tuple(data.A0.shape)}, rho {tuple(rho.shape)} do "
                         f"not fit B={B}, n={n}, m={m}")
    if kkt_inverse_nb(S, dev) == 0:
        raise ValueError(f"kkt_inverse: S={S} is above what a cluster's "
                         f"shared memory takes on this device")
    f32, i32 = torch.float32, torch.int32
    Q, A0, r = (_build.aligned(t.to(f32)) for t in (data.Q, data.A0, rho))
    ldw = -(-S // 4) * 4
    out = torch.empty((B, S, S), dtype=f32, device=dev)
    W = torch.empty((B, S, ldw), dtype=f32, device=dev)
    Pb, Rb = (torch.empty((B, 2, KINV_NB_MAX, ldw), dtype=f32, device=dev)
              for _ in range(2))
    physb = torch.empty((B, 2, S), dtype=i32, device=dev)
    flags = torch.zeros((B, KINV_FLAGS), dtype=i32, device=dev)
    info = torch.zeros((B,), dtype=i32, device=dev)
    fn = _build.function("kkt_inverse", "iadmm_kkt_inverse", _KINV_ARGS)
    _build.check(fn(*(t.data_ptr() for t in (Q, A0, r)), float(sigma),
                    *(t.data_ptr() for t in (out, W, Pb, Rb, physb, flags,
                                             info)),
                    B, n, m, _build.stream_ptr(dev)), "iadmm_kkt_inverse")
    with _COUNT_LOCK:
        kkt_inverse.launches += 1
    return out, info


def kkt_inverse_plain(data: QPBatch, rho: torch.Tensor, sigma: float,
                      nb: int = KINV_NB_MAX, sb: int = KINV_SB):
    """Plain PyTorch version of ``csrc/kkt_inverse.cu`` in its panel order,
    float32: blocked Gauss–Jordan with row pivoting over panels of ``nb``
    columns, each factored in sub-panels of ``sb`` (the largest |value|
    among the rows at and below the pivot's, ties to the lowest row; a
    pivot step updates its sub-panel's columns, the sub-panel's end the
    panel's others, the panel's end the other columns).  Rows stay where
    they lie in W: ``phys`` maps each logical row to its row of W.  Returns
    Ã⁻¹, (B, S, S) row-major."""
    W = _kkt_matrix(data, rho, sigma).clone()
    B, S, _ = W.shape
    dev = W.device
    bi = torch.arange(B, device=dev)
    phys = torch.arange(S, device=dev).repeat(B, 1)

    def at(rows, cols):   # W's entries of logical rows x columns
        return bi[:, None, None], phys[:, rows, None], cols[None, None, :]

    def rank_update(M, rows, cols, other):
        """M's columns ``other`` take the rank update of its columns
        ``cols`` (factored) with the rows ``rows``' values before it."""
        R = M[:, rows][:, :, other]
        base = M[:, :, other].clone()
        base[:, rows] = 0
        M[:, :, other] = base + M[:, :, cols] @ R

    with _full_float32():
        for k in range(0, S, nb):
            nbw = min(nb, S - k)
            panel = torch.arange(k, k + nbw, device=dev)
            P = W[at(slice(None), panel)].clone()
            for s0 in range(0, nbw, sb):
                sw = min(sb, nbw - s0)
                cols = torch.arange(s0, s0 + sw, device=dev)
                for jj in range(s0, s0 + sw):
                    g = k + jj
                    p = g + P[:, g:, jj].abs().argmax(dim=1)
                    P[bi, g], P[bi, p] = P[bi, p].clone(), P[bi, g].clone()
                    phys[bi, g], phys[bi, p] = phys[bi, p].clone(), phys[bi, g]
                    inv = 1.0 / P[:, g, jj]
                    r = P[:, g, s0:s0 + sw] * inv[:, None]
                    r[:, jj - s0] = inv
                    f = P[:, :, jj].clone()
                    Ps = P[:, :, s0:s0 + sw]
                    Ps[:, :, jj - s0] = 0
                    Ps = Ps - f[:, :, None] * r[:, None, :]
                    Ps[:, g, :] = r
                    P[:, :, s0:s0 + sw] = Ps
                rest = torch.cat([torch.arange(0, s0, device=dev),
                                  torch.arange(s0 + sw, nbw, device=dev)])
                if rest.numel():
                    rank_update(P, slice(k + s0, k + s0 + sw), cols, rest)
            other = torch.cat([torch.arange(0, k, device=dev),
                               torch.arange(k + nbw, S, device=dev)])
            if other.numel():
                R = W[at(panel, other)]
                base = W[at(slice(None), other)].clone()
                base[:, k:k + nbw] = 0
                W[at(slice(None), other)] = base + P @ R
            W[at(slice(None), panel)] = P
    pinv = torch.argsort(phys, dim=1)
    return W[bi[:, None, None], phys[:, :, None], pinv[:, None, :]]


def direct_inverse(data: QPBatch, rho: torch.Tensor, sigma: float):
    """The 'direct' operand, (B, n, n): the transpose of the float32 M⁻¹,
    so that its row-major product P·b is the TPU kernel's b·M⁻¹ (M⁻¹ from
    a float32 Cholesky solve is symmetric only to rounding)."""
    f32 = torch.float32
    n = data.num_var
    Q, A0 = data.Q.to(f32), data.A0.to(f32)
    eye = torch.eye(n, dtype=f32, device=Q.device)
    with _full_float32():
        M = Q + sigma * eye + A0.transpose(1, 2) @ (rho[..., None] * A0)
    L = torch.linalg.cholesky(M)
    Minv = torch.cholesky_solve(eye.expand_as(M), L)
    return Minv.transpose(1, 2).contiguous()


def cg_diag(data: QPBatch, rho: torch.Tensor, sigma: float):
    """The 'cg' operand: the Jacobi diagonal of M in float32, (B, n)."""
    with _full_float32():
        return jacobi_diag(data, sigma, rho).to(torch.float32)


def finish_state(state: IterState, data: QPBatch, rho, x, y, z,
                 xt) -> IterState:
    """ν = ρ∘(A0·xt − z) + y and the output state, as the JAX wrapper
    rebuilds xv after its kernel."""
    A0 = data.A0.to(torch.float32)
    nu = rho * (torch.einsum("bmn,bn->bm", A0, xt) - z) + y
    return IterState(x=x, y=y, z=z, xv=torch.cat([xt, nu], dim=-1),
                     H=state.H, C=state.C)


class _Plain:
    """Float32 operands of the plain twins and the kernel's step pieces."""

    def __init__(self, state: IterState, data: QPBatch, rho, sigma):
        f32 = torch.float32
        self.n = data.num_var
        self.d = dataclasses.replace(data, **{
            k: getattr(data, k).to(f32)
            for k in ("Q", "A0", "p", "zl", "zu")})
        self.Q, self.A0, self.p = self.d.Q, self.d.A0, self.d.p
        self.rho, self.sigma = rho, sigma
        self.x, self.y, self.z = (t.to(f32)
                                  for t in (state.x, state.y, state.z))
        self.xt = state.xv[:, :self.n].to(f32)
        self.prs, self.drs = [], []

    @staticmethod
    def col(v, M):  # vᵀM, the column sum the kernels form (Q symmetric)
        return torch.einsum("bi,bij->bj", v, M)

    @staticmethod
    def row(M, v):  # M·v
        return torch.einsum("bij,bj->bi", M, v)

    def mv_M(self, v):
        return condensed_matvec(self.d, v, self.sigma, self.rho)

    def rhs(self):
        return condensed_rhs(self.d, self.x, self.y, self.z, self.sigma,
                             self.rho)

    def update(self, xt, nu):
        """The z-relaxed ADMM update and the step's residuals."""
        self.x, self.y, self.z = admm_update(
            self.d, torch.cat([xt, nu], dim=-1), self.x, self.y, self.z,
            self.rho, ALPHA_STAGE2, relax_z=True)
        self.xt = xt
        self.prs.append(torch.linalg.vector_norm(
            self.row(self.A0, self.x) - self.z, dim=-1))
        self.drs.append(torch.linalg.vector_norm(
            self.col(self.x, self.Q) + self.p + self.col(self.y, self.A0),
            dim=-1))

    def condensed_update(self, xt):
        self.update(xt, self.rho * (self.row(self.A0, xt) - self.z) + self.y)

    def result(self):
        empty = self.x.new_zeros((self.x.shape[0], 0))
        pr = torch.stack(self.prs, dim=1) if self.prs else empty
        dr = torch.stack(self.drs, dim=1) if self.drs else empty
        return self.x, self.y, self.z, self.xt, pr, dr


def stage2_plain(state: IterState, data: QPBatch, rho: torch.Tensor,
                 Ainv: torch.Tensor, *, num_iters: int, sigma: float,
                 refine: int):
    """Plain PyTorch version of the 'kkt' kernel's N polish steps; returns
    (x, y, z, xt, pr, dr)."""
    s = _Plain(state, data, rho, sigma)
    n = s.n
    for _ in range(num_iters):
        bt = torch.cat([sigma * s.x - s.p, s.z - s.y / rho], dim=-1)
        xv = s.row(Ainv, bt)
        for _ in range(refine):
            xt_k, nu_k = xv[:, :n], xv[:, n:]
            ax = torch.cat([s.col(xt_k, s.Q) + s.col(nu_k, s.A0)
                            + sigma * xt_k,
                            s.row(s.A0, xt_k) - nu_k / rho], dim=-1)
            xv = xv + s.row(Ainv, bt - ax)
        s.update(xv[:, :n], xv[:, n:])
    return s.result()


def stage2_direct_plain(state: IterState, data: QPBatch, rho: torch.Tensor,
                        P: torch.Tensor, *, num_iters: int, sigma: float,
                        refine: int):
    """Plain PyTorch version of the 'direct' kernel's N polish steps; ``P``
    is :func:`direct_inverse`.  Returns (x, y, z, xt, pr, dr)."""
    s = _Plain(state, data, rho, sigma)
    for _ in range(num_iters):
        b = s.rhs()
        xt = s.row(P, b)
        for _ in range(refine):
            xt = xt + s.row(P, b - s.mv_M(xt))
        s.condensed_update(xt)
    return s.result()


def stage2_cg_plain(state: IterState, data: QPBatch, rho: torch.Tensor,
                    diag: torch.Tensor, *, num_iters: int, sigma: float,
                    cg_iters: int, tol: float):
    """Plain PyTorch version of the 'cg' kernel's N polish steps
    (``solvers.cg.batched_cg`` warm-started from the last xt); ``diag`` is
    :func:`cg_diag`.  Returns (x, y, z, xt, pr, dr, iters): ``iters`` (B,)
    int32 counts the CG iterations each instance ran unmasked."""
    s = _Plain(state, data, rho, sigma)
    iters = torch.zeros(s.x.shape[0], dtype=torch.int32, device=s.x.device)
    for _ in range(num_iters):
        xt, _, it = batched_cg(s.mv_M, s.rhs(), s.xt, diag, cg_iters, tol)
        iters += it
        s.condensed_update(xt)
    return (*s.result(), iters)


_STAGE2_ARGS = ([_build.I] * 3 + [_build.P] * 17 + [_build.I] * 3
                + [_build.F] * 2 + [_build.P])
_DIRECT_ARGS = ([_build.I] * 3 + [_build.P] * 18 + [_build.I] * 3
                + [_build.F] * 2 + [_build.P])
_CG_ARGS = ([_build.I] * 3 + [_build.P] * 23 + [_build.I] * 3
            + [_build.F] * 3 + [_build.P])

# columns of a partial sum of pᵀAp and rᵀr in csrc/stage2.cu
CG_COLUMNS = _build.header_int("stage2.cu", "CG_THREADS")


def condensed_max_n(dev) -> int:
    """The largest n that 'direct' and 'cg' take on ``dev``: an A0 item of
    csrc/stage2.cu's M·v holds at least two rows of A0 and v in shared
    memory, the CG update p, r and d (about 16·n and 12·n bytes)."""
    with torch.cuda.device(dev):
        return _build.function("stage2", "iadmm_stage2_max_n", [])()


def _check_condensed_n(n: int, dev, solver: str) -> None:
    limit = condensed_max_n(dev)
    if n > limit:
        raise ValueError(f"stage2 solver {solver!r}: n={n} is above the "
                         f"largest n this device takes, {limit} (shared "
                         f"memory); use 'kkt'")


def _cuda_operands(state: IterState, data: QPBatch, rho: torch.Tensor,
                   operand: torch.Tensor, op_shape, what: str):
    """Float32, aligned copies of the data, the operand and a fresh state
    (x, y, z, xt: the kernels update them in place)."""
    B, n = data.p.shape
    m = data.num_constr
    if tuple(operand.shape) != op_shape or tuple(rho.shape) != (B, m):
        raise ValueError(f"{what} {tuple(operand.shape)} / rho "
                         f"{tuple(rho.shape)} do not fit B={B}, n={n}, "
                         f"m={m}")
    f32 = torch.float32

    def vec(t):
        return _build.aligned(t.to(f32))

    consts = [vec(t) for t in (data.Q, data.A0, operand, data.p, data.zl,
                               data.zu, rho)]
    state = [t.to(f32).clone().contiguous()
             for t in (state.x, state.y, state.z, state.xv[:, :n])]
    return consts, state


def _scratch(dev, *shapes):
    return [torch.empty(s, dtype=torch.float32, device=dev) for s in shapes]


_COUNT_LOCK = threading.Lock()   # callers may polish from several threads


def _run_steps(fn, what, counter, N, head, tensors, tail):
    """The N polish steps, one call of ``fn`` a step: (i, N, *head,
    pointers of ``tensors``, *tail); each step launched counts once in
    ``counter``, added under the lock once a call."""
    ptrs = [t.data_ptr() for t in tensors]
    done = 0
    try:
        for i in range(N):
            _build.check(fn(i, N, *head, *ptrs, *tail), what)
            done += 1
    finally:
        with _COUNT_LOCK:
            setattr(fused_stage2, counter,
                    getattr(fused_stage2, counter) + done)


def stage2_cuda(state: IterState, data: QPBatch, rho: torch.Tensor,
                Ainv: torch.Tensor, *, num_iters: int, sigma: float,
                refine: int):
    """The 'kkt' kernel's N polish steps on CUDA tensors; same contract as
    :func:`stage2_plain`.  The kernel reads Ã⁻¹ by rows; on CUDA data
    ``fused_stage2`` passes :func:`kkt_inverse_cuda`'s output, which is
    row-major already."""
    dev = data.p.device
    B, n = data.p.shape
    m = data.num_constr
    S, N = n + m, num_iters
    consts, (x, y, z, xt) = _cuda_operands(state, data, rho, Ainv,
                                           (B, S, S), "Ainv")
    xv = torch.cat([xt, torch.zeros((B, m), dtype=xt.dtype, device=dev)],
                   dim=-1)
    scratch = _scratch(dev, (B, S), (B, S), (B, -(-S // _build.KKT_ROWS), n),
                       (B, m), (B, N), (B, N))
    _run_steps(_build.function("stage2", "iadmm_stage2_step", _STAGE2_ARGS),
               "iadmm_stage2_step", "launches", N, (refine,),
               [*consts, x, y, z, xv, *scratch],
               (B, n, m, float(sigma), float(ALPHA_STAGE2),
                _build.stream_ptr(dev)))
    pr, dr = scratch[-2:]
    return x, y, z, xv[:, :n], pr, dr


def _condensed_scratch(dev, B, n, m):
    """bvec, r (B, n); the partials of [Q; A0] (B, ceil((n+m)/32), n), of
    A0 (B, ceil(m/32), n) and rowdot (B, m)."""
    rows = _build.KKT_ROWS
    return _scratch(dev, (B, n), (B, n), (B, -(-(n + m) // rows), n),
                    (B, -(-m // rows), n), (B, m))


def stage2_direct_cuda(state: IterState, data: QPBatch, rho: torch.Tensor,
                       P: torch.Tensor, *, num_iters: int, sigma: float,
                       refine: int):
    """The 'direct' kernel's N polish steps on CUDA tensors; same contract
    as :func:`stage2_direct_plain`."""
    dev = data.p.device
    B, n = data.p.shape
    m, N = data.num_constr, num_iters
    _check_condensed_n(n, dev, "direct")
    consts, (x, y, z, xt) = _cuda_operands(state, data, rho, P, (B, n, n),
                                           "P")
    pr, dr = _scratch(dev, (B, N), (B, N))
    _run_steps(_build.function("stage2", "iadmm_stage2_direct_step",
                               _DIRECT_ARGS),
               "iadmm_stage2_direct_step", "launches_direct", N, (refine,),
               [*consts, x, y, z, xt, *_condensed_scratch(dev, B, n, m),
                pr, dr],
               (B, n, m, float(sigma), float(ALPHA_STAGE2),
                _build.stream_ptr(dev)))
    return x, y, z, xt, pr, dr


def stage2_cg_cuda(state: IterState, data: QPBatch, rho: torch.Tensor,
                   diag: torch.Tensor, *, num_iters: int, sigma: float,
                   cg_iters: int, tol: float):
    """The 'cg' kernel's N polish steps on CUDA tensors; same contract as
    :func:`stage2_cg_plain`.  The CG scalars (rz, ‖b‖, α, β, the mask) stay
    on the device."""
    dev = data.p.device
    B, n = data.p.shape
    m, N = data.num_constr, num_iters
    _check_condensed_n(n, dev, "cg")
    consts, (x, y, z, xt) = _cuda_operands(state, data, rho, diag, (B, n),
                                           "diag")
    warps = -(-n // CG_COLUMNS) * (CG_COLUMNS // 32)
    pv, ap, wsum, scal, pr, dr = _scratch(
        dev, (B, n), (B, n), (B, warps, 2), (B, 2), (B, N), (B, N))
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    _run_steps(_build.function("stage2", "iadmm_stage2_cg_step", _CG_ARGS),
               "iadmm_stage2_cg_step", "launches_cg", N, (cg_iters,),
               [*consts, x, y, z, xt, *_condensed_scratch(dev, B, n, m),
                pv, ap, wsum, scal, iters, pr, dr],
               (B, n, m, float(sigma), float(tol), float(ALPHA_STAGE2),
                _build.stream_ptr(dev)))
    return x, y, z, xt, pr, dr, iters


def fused_stage2(state: IterState, data: QPBatch, rho_vec: torch.Tensor,
                 *, num_iters: int, cg_iters: int = 100,
                 sigma: float = 6e-6, tol: float = 1e-8,
                 solver: str = "kkt", refine: int = None
                 ) -> Tuple[IterState, torch.Tensor, torch.Tensor]:
    """Run ``num_iters`` polish steps; returns (state', pr, dr) with
    per-step primal/dual residual traces of shape (B, num_iters).

    ``refine`` defaults per solver, as in the JAX package: 0 for 'kkt', 2
    otherwise ('cg' does not read it).  Operates in whatever space ``data``
    lives in; the serving path passes the original data and unscaled
    iterates.  On CUDA data each step launches the kernels of
    ``csrc/stage2.cu``; on CPU data it runs the solver's plain twin."""
    if solver not in ("kkt", "direct", "cg"):
        raise ValueError(f"unknown stage2 solver {solver!r}")
    if refine is None:
        refine = 0 if solver == "kkt" else 2
    B, m = data.p.shape[0], data.num_constr
    rho = (rho_vec.to(torch.float32)
           * torch.ones((B, m), dtype=torch.float32, device=data.p.device))
    cuda = data.p.is_cuda
    kw = dict(num_iters=num_iters, sigma=sigma)
    if solver == "kkt":
        form, run = kkt_inverse, (stage2_cuda if cuda else stage2_plain)
        kw.update(refine=refine)
    elif solver == "direct":
        form = direct_inverse
        run = stage2_direct_cuda if cuda else stage2_direct_plain
        kw.update(refine=refine)
    else:
        form, run = cg_diag, (stage2_cg_cuda if cuda else stage2_cg_plain)
        kw.update(cg_iters=cg_iters, tol=tol)
    with span("stage2/factor") as box:
        operand = form(data, rho, sigma)
        box["result"] = operand
    with span("stage2/polish") as box:
        x, y, z, xt, pr, dr = run(state, data, rho, operand, **kw)[:6]
        state = finish_state(state, data, rho, x, y, z, xt)
        box["result"] = state.x
    return state, pr, dr


# Polish steps launched, one a call into csrc/stage2.cu, by solver
fused_stage2.launches = 0          # 'kkt' (stage2_cuda)
fused_stage2.launches_direct = 0   # 'direct' (stage2_direct_cuda)
fused_stage2.launches_cg = 0       # 'cg' (stage2_cg_cuda)
