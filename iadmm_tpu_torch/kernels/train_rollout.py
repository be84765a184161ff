"""Fused TBPTT training chunk: forward and hand-derived backward kernels.

Replaces both kernel pairs of ``iadmm_tpu/kernels/train_rollout.py``:

- the stream pair, ``_fwd_stream_kernel`` (J learned iterations plus the
  per-step primal and dual residual losses, writing the per-step state
  streams) and ``_bwd_stream_kernel`` (the reverse sweep over those
  streams, no recompute of the forward).  On CUDA tensors
  :func:`make_fused_chunk_loss` calls ``csrc/train_fwd.cu`` once a chunk
  (its J steps run from C++) and ``csrc/train_bwd.cu`` once per reverse
  step.
- the segment-recompute pair, ``_fwd_seg_kernel`` (J steps from a
  checkpoint, no stream) and ``_bwd_seg_kernel`` (recompute the segment
  from its checkpoint, then the reverse sweep), taken where a chunk's
  streams do not fit (:func:`stream_bytes`), or on request (``seg``,
  ``stream=False``).  One call of each entry point per segment of J steps.

See the CUDA sources' headers for the design.  Bounds on the H100 at B=2,
S=n+m=2000, h=800, J=100, set by the gate GEMMs' operations: forward
2.1 ms (one GEMM a step) and backward 6.2 ms (three; the segment backward
8.3 ms, four) at the bf16 tensor-core rate, 30.6, 91.7 and 122.3 ms at the
float32 rate (``bounds.py``).  On CPU tensors the same functions run in
plain PyTorch (:func:`train_fwd_plain`, :func:`train_bwd_plain` and the
segment pair built from them), line for line with the TPU kernels' ``step``,
``fstep`` and ``bstep`` and with their bf16 rounding points.

Numerics (``compute_dtype="bfloat16"``, the fast profile): Q, A0, W, U,
W_h and every vector rounded to bf16 before each product, float32 sums;
float32 xv and g against bf16 W in the gates; H carried in float32 and
rounded to bf16 where the gate GEMM consumes it (the H stream holds that
operand); C carried and streamed in float32.  ``"float32"`` (the TPU
kernel's ``Precision.HIGHEST``) rounds nothing and computes in the dtype of
the state (float64 in the tests that hold the hand-derived backward against
autograd); its CUDA kernels take float32 operands, stream H in float32 and
run every product in float32 FFMA (no TF32).  Q is taken as symmetric, as
the TPU kernel's backward takes it (``Q·v`` is formed as ``vᵀQ``).
Launches are counted per wrapper and compute dtype: ``.launches`` (bf16)
and ``.launches_f32`` (float32) of ``train_fwd_cuda`` and
``train_bwd_cuda`` (one a step: the forward's one call a chunk counts its
J steps) and of ``train_fwd_seg_cuda`` and ``train_bwd_seg_cuda`` (one a
segment).

Gradients flow to ``W, U, b, W_h, b_h, rho, alpha`` only; the state and the
problem data get none, as ``_package_grads`` gives none.  The ``rho`` and
``alpha`` gradients land at ``[t0, t0 + J)`` of the ``K_total`` schedules.
No 128-lane padding: the shapes are the problem's own.

Streams, step-major (slot k of step k, slot J the final state):
``hs (J+1, B, S, h)`` (in the compute dtype), ``cs (J+1, B, S, h)``,
``xs (J+1, B, n)``, ``ys``, ``zs (J+1, B, m)``, ``xvs (J+1, B, S)``.  The
segment route keeps instead each segment's start state (x, y, z, xv, H,
C; H and C in the working dtype) and, inside its backward, one segment's
streams.  Both routes compute the same function: the same steps, the same
sums in the same order (the weight gradients accumulate across segments
in place), so on the same inputs they agree bitwise.
"""

from __future__ import annotations

import os
from typing import Dict

import torch

from ..solvers.step import rho_vector
from ..types import IterState, QPBatch
from . import _build
from .lstm_cell import CELL_KEYS, cell_operands, cell_scratch

_GRAD_KEYS = CELL_KEYS + ("rho", "alpha")
_COMPUTE_DTYPES = ("bfloat16", "float32")
_CDT = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _tile_rows(S: int) -> int:
    """The TPU kernels' token-axis tile (S a multiple of 128 there)."""
    for r in (512, 256, 128):
        if S % r == 0:
            return r
    return S


def pick_segment_len(n_pad: int, m_pad: int, hidden: int, chunk_len: int,
                     budget: float = 110e6) -> int:
    """The JAX package's rule (its ``train_rollout.py:971``): the largest
    divisor of ``chunk_len``, at most 16, whose backward-kernel VMEM
    estimate fits ``budget``; ``n_pad``, ``m_pad`` are the 128-padded sizes.

    The budget is a TPU core's VMEM.  The CUDA segment backward keeps its
    (J+1)-slot buffer in device memory and has nothing that needs it; the
    rule is kept so that both packages pick the same segment length (2 at
    QP_1000_500_500, h=800, K=100)."""
    S = n_pad + m_pad
    hp = _round_up(hidden, 128)
    R = _tile_rows(S)
    fixed = (4 * (n_pad * n_pad + m_pad * n_pad)   # Q, A0 bf16 2x-buffered
             + 2 * hp * 4 * hidden                 # U bf16
             + 4 * hp * 4 * hidden                 # dU f32 output window
             + 2 * S * hp * 4                      # sH, sC carries f32
             + 8 * S * 128 * 4                     # (S,1) lane-padded cols
             + 10 * R * hp * 4)                    # tile-loop live values
    per_j = S * hp * (2 + 4) + S * 128 * 4         # Hs bf16 + Cs f32 + xvs
    best = 1
    for j in range(1, min(chunk_len, 16) + 1):
        if chunk_len % j == 0 and fixed + (j + 1) * per_j <= budget:
            best = j
    return best


def _rounder(compute_dtype: str, wd: torch.dtype):
    """The operand a product sees, in the working dtype ``wd``."""
    if compute_dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"unknown compute_dtype {compute_dtype!r}")
    if compute_dtype == "bfloat16":
        return lambda a: a.to(torch.bfloat16).to(wd)
    return lambda a: a.to(wd)


def _matvecs(Qc, A0c, R):
    """Row-vector products against the rounded Q and A0 (the TPU kernel's
    ``_mv_maker``): v·Q, A0·v and vᵀ·A0."""
    def mv_q(v):
        return torch.einsum("bi,bij->bj", R(v), Qc)

    def mv_a0(v):
        return torch.einsum("bij,bj->bi", A0c, R(v))

    def mv_a0t(v):
        return torch.einsum("bi,bij->bj", R(v), A0c)

    return mv_q, mv_a0, mv_a0t


def train_fwd_plain(weights, state, data, *, t0: int, J: int, sigma: float,
                    compute_dtype: str = "bfloat16"):
    """Plain PyTorch version of the forward kernel.

    weights: (W, U, b, W_h, b_h, rho, alpha); state: (x, y, z, xv, H, C);
    data: (Q, A0, p, zl, zu, rhom) with rhom the per-row ρ multipliers.
    Returns (pr (B, J), dr (B, J), final state tuple, streams tuple).
    Differentiable by autograd (no in-place updates)."""
    W, U, b, W_h, b_h, rho, alpha = weights
    x, y, z, xv, H, C = state
    wd = x.dtype
    R = _rounder(compute_dtype, wd)
    hdt = torch.bfloat16 if compute_dtype == "bfloat16" else wd
    Q, A0, p, zl, zu, rhom = (t.to(wd) for t in data)
    n, h = x.shape[1], H.shape[-1]
    mv_q, mv_a0, mv_a0t = _matvecs(R(Q), R(A0), R)
    Wc, Uc, Whc = R(W), R(U), R(W_h)
    b, bh = b.to(wd), b_h.to(wd)
    H, C = H.to(wd), C.to(wd)
    hs, cs, xs, ys, zs, xvs, prs, drs = ([] for _ in range(8))

    def store():
        hs.append(R(H).to(hdt))
        cs.append(C)
        xs.append(x)
        ys.append(y)
        zs.append(z)
        xvs.append(xv)

    for k in range(J):
        store()
        rho_t = torch.sigmoid(rho[t0 + k].to(wd))
        alpha_t = 2.0 * torch.sigmoid(alpha[t0 + k].to(wd))
        rho_row = rho_t * rhom
        u, nu = xv[:, :n], xv[:, n:]
        b1 = sigma * x - p
        r1 = mv_q(u) + sigma * u + mv_a0t(nu) - b1
        r2 = mv_a0(u) - (nu - y) / rho_row - z
        g = torch.cat([mv_q(r1) + sigma * r1 + mv_a0t(r2),
                       mv_a0(r1) - r2 / rho_row], dim=-1)
        pre = (xv[..., None] * Wc[0] + g[..., None] * Wc[1]
               + hs[-1].to(wd) @ Uc + b)
        i_t = torch.sigmoid(pre[..., 0 * h:1 * h])
        f_t = torch.sigmoid(pre[..., 1 * h:2 * h])
        o_t = torch.sigmoid(pre[..., 2 * h:3 * h])
        u_t = torch.tanh(pre[..., 3 * h:4 * h])
        C = i_t * u_t + f_t * C
        H = o_t * torch.tanh(C)
        xv = xv - ((R(H) @ Whc)[..., 0] + bh)
        x_t, v = xv[:, :n], xv[:, n:]
        z_t = z + (v - y) / rho_row
        x_new = alpha_t * x_t + (1.0 - alpha_t) * x
        z_new = torch.minimum(torch.maximum(z_t + y / rho_row, zl), zu)
        y = y + rho_row * (z_t - z_new)
        x, z = x_new, z_new
        v1 = mv_a0(x) - z
        v2 = mv_q(x) + p + mv_a0t(y)
        prs.append(torch.sqrt((v1 * v1).sum(-1)))
        drs.append(torch.sqrt((v2 * v2).sum(-1)))
    store()
    streams = tuple(torch.stack(s) for s in (hs, cs, xs, ys, zs, xvs))
    return (torch.stack(prs, 1), torch.stack(drs, 1),
            (x, y, z, xv, H, C), streams)


def train_bwd_plain(weights, data, streams, dfinal, dpr, ddr, *, t0: int,
                    J: int, sigma: float, compute_dtype: str = "bfloat16",
                    col: int = 0, acc=None):
    """Plain PyTorch version of the backward kernel: the hand-derived
    reverse sweep over the streams of :func:`train_fwd_plain`.

    dfinal: cotangents of the final state (x, y, z, xv, H, C); dpr, ddr
    (B, L): of the losses, step k's at column ``col + k`` (L = J and col 0
    for a whole chunk).  ``acc``: gradients (dW, dU, db, dW_h, db_h,
    drho (L,), dalpha (L,)) to add this sweep's to, as the segment route
    sums over its segments; zeros where None.  Returns ((dW, dU, db, dW_h,
    db_h, drho, dalpha), cotangents of the start state), dρ and dα of step
    k at ``col + k``."""
    W, U, b, W_h, b_h, rho, alpha = weights
    hs, cs, xs, ys, zs, xvs = streams
    wd = cs.dtype
    R = _rounder(compute_dtype, wd)
    Q, A0, p, zl, zu, rhom = (t.to(wd) for t in data)
    n, h = xs.shape[-1], cs.shape[-1]
    mv_q, mv_a0, mv_a0t = _matvecs(R(Q), R(A0), R)
    Wc, Uc, Whc = R(W), R(U), R(W_h)
    b = b.to(wd)
    dx, dy, dz, dxv, sH, sC = (t.to(wd) for t in dfinal)
    dpr, ddr = dpr.to(wd), ddr.to(wd)
    if acc is None:
        acc = _zero_grads(h, dpr.shape[1], wd, b.device)
    dW, dU, db, dWh, dbh = (a.to(wd) for a in acc[:5])
    drho, dalpha = (a.to(wd).clone() for a in acc[5:])

    for k in reversed(range(J)):
        rho_raw, alpha_raw = rho[t0 + k].to(wd), alpha[t0 + k].to(wd)
        rho_t = torch.sigmoid(rho_raw)
        alpha_t = 2.0 * torch.sigmoid(alpha_raw)
        rho_row = rho_t * rhom
        x, y, z, xv = xs[k], ys[k], zs[k], xvs[k]
        x_new, y_new, z_new, xv_new = xs[k + 1], ys[k + 1], zs[k + 1], \
            xvs[k + 1]
        u, nu = xv[:, :n], xv[:, n:]
        x_t, v = xv_new[:, :n], xv_new[:, n:]
        z_t = z + (v - y) / rho_row
        w_clip = z_t + y / rho_row
        mask = ((w_clip >= zl) & (w_clip <= zu)).to(wd)
        b1 = sigma * x - p
        r1 = mv_q(u) + sigma * u + mv_a0t(nu) - b1
        r2 = mv_a0(u) - (nu - y) / rho_row - z

        # loss adjoint: pr = ‖A0x' − z'‖, dr = ‖Qx' + p + A0ᵀy'‖
        v1 = mv_a0(x_new) - z_new
        v2 = mv_q(x_new) + p + mv_a0t(y_new)
        pr_n = torch.sqrt((v1 * v1).sum(-1, keepdim=True))
        dr_n = torch.sqrt((v2 * v2).sum(-1, keepdim=True))
        c = col + k
        dv1 = dpr[:, c:c + 1] / torch.clamp(pr_n, min=1e-30) * v1
        dv2 = ddr[:, c:c + 1] / torch.clamp(dr_n, min=1e-30) * v2
        dxn = dx + mv_a0t(dv1) + mv_q(dv2)
        dyn = dy + mv_a0(dv2)
        dzn = dz - dv1

        # ADMM-update adjoint
        drho_vec = dyn * (z_t - z_new)
        dz_t = rho_row * dyn
        dw = (-rho_row * dyn + dzn) * mask
        dz_t = dz_t + dw
        dy = dyn + dw / rho_row
        drho_vec = drho_vec - dw * y / (rho_row * rho_row)
        dxt = alpha_t * dxn
        dx = (1.0 - alpha_t) * dxn
        dalpha_s = (dxn * (x_t - x)).sum()
        dz = dz_t
        dy = dy - dz_t / rho_row
        drho_vec = drho_vec - dz_t * (v - y) / (rho_row * rho_row)
        dxv = dxv + torch.cat([dxt, dz_t / rho_row], dim=-1)
        dbh = dbh - dxv.sum()

        # cell adjoint
        g = torch.cat([mv_q(r1) + sigma * r1 + mv_a0t(r2),
                       mv_a0(r1) - r2 / rho_row], dim=-1)
        H_k, H_n = hs[k].to(wd), hs[k + 1].to(wd)
        C_k, C_n = cs[k], cs[k + 1]
        ddel = R(-dxv)
        tC = torch.tanh(C_n)
        dH_new = sH + ddel[..., None] * Whc[:, 0]
        dWh = dWh + torch.einsum("bsh,bs->h", H_n, ddel)[:, None]
        pre = xv[..., None] * Wc[0] + g[..., None] * Wc[1] + H_k @ Uc + b
        i_t = torch.sigmoid(pre[..., 0 * h:1 * h])
        f_t = torch.sigmoid(pre[..., 1 * h:2 * h])
        o_t = torch.sigmoid(pre[..., 2 * h:3 * h])
        u_t = torch.tanh(pre[..., 3 * h:4 * h])
        dC_new = sC + dH_new * o_t * (1.0 - tC * tC)
        dpre = torch.cat([(dC_new * u_t) * i_t * (1.0 - i_t),
                          (dC_new * C_k) * f_t * (1.0 - f_t),
                          dH_new * tC * o_t * (1.0 - o_t),
                          (dC_new * i_t) * (1.0 - u_t * u_t)], dim=-1)
        dpre_r = R(dpre)
        dU = dU + torch.einsum("bsh,bsk->hk", H_k, dpre_r)
        db = db + dpre.sum((0, 1))
        dW = dW + torch.stack([torch.einsum("bs,bsk->k", xv, dpre),
                               torch.einsum("bs,bsk->k", g, dpre)])
        sH = dpre_r @ Uc.T
        sC = dC_new * f_t
        dxv = dxv + dpre @ Wc[0]
        dg = dpre @ Wc[1]

        # KKT-feature adjoint
        dg1, dg2 = dg[:, :n], dg[:, n:]
        drho_vec = drho_vec + dg2 * r2 / (rho_row * rho_row)
        dr1 = mv_q(dg1) + sigma * dg1 + mv_a0t(dg2)
        dr2 = mv_a0(dg1) - dg2 / rho_row
        du = mv_q(dr1) + sigma * dr1 + mv_a0t(dr2)
        dnu = mv_a0(dr1) - dr2 / rho_row
        dx = dx - sigma * dr1
        dy = dy + dr2 / rho_row
        dz = dz - dr2
        drho_vec = drho_vec + dr2 * (nu - y) / (rho_row * rho_row)
        dxv = dxv + torch.cat([du, dnu], dim=-1)

        s_rho = torch.sigmoid(rho_raw)
        s_alpha = torch.sigmoid(alpha_raw)
        drho[c] = (drho_vec * rhom).sum() * s_rho * (1.0 - s_rho)
        dalpha[c] = dalpha_s * 2.0 * s_alpha * (1.0 - s_alpha)
    return (dW, dU, db, dWh, dbh, drho, dalpha), (dx, dy, dz, dxv, sH, sC)


def _grad_shapes(h: int, L: int):
    """dW (2, 4h), dU (h, 4h), db (4h,), dW_h (h, 1), db_h (1,), drho and
    dalpha (L,)."""
    return ((2, 4 * h), (h, 4 * h), (4 * h,), (h, 1), (1,), (L,), (L,))


def _zero_grads(h: int, L: int, dtype, device):
    return tuple(torch.zeros(s, dtype=dtype, device=device)
                 for s in _grad_shapes(h, L))


def train_fwd_seg_plain(weights, state, data, *, t0: int, J: int,
                        sigma: float, compute_dtype: str = "bfloat16"):
    """Plain PyTorch version of the segment forward (the TPU kernel's
    ``_fwd_seg_kernel``): J steps from the checkpoint ``state``.  Returns
    (pr (B, J), dr (B, J), final state), the final H unrounded; keeps no
    stream."""
    pr, dr, final, _ = train_fwd_plain(weights, state, data, t0=t0, J=J,
                                       sigma=sigma,
                                       compute_dtype=compute_dtype)
    return pr, dr, final


def train_bwd_seg_plain(weights, state, data, dfinal, dpr, ddr, *, t0: int,
                        J: int, sigma: float, compute_dtype: str = "bfloat16",
                        col: int = 0, acc=None):
    """Plain PyTorch version of the segment backward (``_bwd_seg_kernel``):
    the segment's streams recomputed from its checkpoint ``state`` (H as the
    gate GEMM consumes it, C in the working dtype: the TPU kernel's
    ``fstep``), then the reverse sweep of :func:`train_bwd_plain` over them
    (its ``bstep``).  Arguments and result as :func:`train_bwd_plain`, with
    the checkpoint in place of the streams."""
    kw = dict(t0=t0, J=J, sigma=sigma, compute_dtype=compute_dtype)
    streams = train_fwd_plain(weights, state, data, **kw)[3]
    return train_bwd_plain(weights, data, streams, dfinal, dpr, ddr, col=col,
                           acc=acc, **kw)


# --------------------------------------------------------------------------
# CUDA wrappers
# --------------------------------------------------------------------------

_FWD_ARGS = ([_build.I] + [_build.P] * 30 + [_build.I] * 6
             + [_build.F, _build.P])
_BWD_ARGS = ([_build.I] * 2 + [_build.P] * 53 + [_build.I] * 6
             + [_build.F, _build.P])
# the segment entry points: t0, col, L first (the forward then pending and
# close); the backward also takes b_h
_FWD_SEG_ARGS = [_build.I] * 4 + _FWD_ARGS
_BWD_SEG_ARGS = ([_build.I] * 3 + [_build.P] * 54 + [_build.I] * 6
                 + [_build.F, _build.P])
_GEMM_ARGS = ([_build.I] * 3 + [_build.P, _build.I] * 3 + [_build.I] * 3
              + [_build.P])


def _cuda_operands(weights, state, data, compute_dtype, J, t0,
                   backward=False):
    """Check a chunk's inputs; return (B, n, m, h) and the kernel operands:
    Q and A0 in the compute dtype, float32 vectors (p, zl, zu, rhom, rho,
    alpha), all contiguous, then the cell weights as
    :func:`lstm_cell.cell_operands` makes them (W, Ut, b, W_h, b_h); the
    ``backward`` also reads U (dH = dpre·Uᵀ) and takes it before Ut."""
    if compute_dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"unknown compute_dtype {compute_dtype!r}")
    if J < 1:
        raise ValueError(f"a chunk needs J >= 1 steps, got {J}")
    x, y, z, xv, H, C = state
    B, n = x.shape
    m = y.shape[1]
    S, h = n + m, H.shape[-1]
    want = dict(x=(B, n), y=(B, m), z=(B, m), xv=(B, S), H=(B, S, h),
                C=(B, S, h), Q=(B, n, n), A0=(B, m, n), p=(B, n),
                zl=(B, m), zu=(B, m), rhom=(B, m))
    got = dict(zip(("x", "y", "z", "xv", "H", "C"), state))
    got.update(zip(("Q", "A0", "p", "zl", "zu", "rhom"), data))
    bad = {k: tuple(got[k].shape) for k in want
           if tuple(got[k].shape) != want[k]}
    if bad:
        raise ValueError(f"train kernel shapes {bad} do not fit B={B}, "
                         f"n={n}, m={m}, h={h}")
    for k, t in zip(("rho", "alpha"), weights[5:]):
        if t.dim() != 1 or t.shape[0] < t0 + J:
            raise ValueError(f"{k} has shape {tuple(t.shape)}; the chunk "
                             f"needs entries [{t0}, {t0 + J})")
    dev = x.device
    for t in (*weights, *state, *data):
        if t.device != dev:
            raise ValueError("all training tensors must be on one device")
    cw = cell_operands(*weights[:5], h=h, gate_dtype=compute_dtype,
                       backward=backward)
    return (B, n, m, h), (
        [_build.aligned(t.to(_CDT[compute_dtype])) for t in data[:2]]
        + [t.to(torch.float32).contiguous()
           for t in (*data[2:], *weights[5:])]
        + [cw.W, *([cw.U] if backward else []), cw.Ut, cw.b, cw.W_h, cw.b_h])


def _check_float32(named, shapes):
    """Raise unless each tensor is a contiguous float32 of its shape."""
    for (k, t), shape in zip(named.items(), shapes):
        if (t.dtype != torch.float32 or not t.is_contiguous()
                or tuple(t.shape) != tuple(shape)):
            raise ValueError(f"{k}: {t.dtype} {tuple(t.shape)}, expected a "
                             f"contiguous float32 {tuple(shape)}")


def _carries(state, compute_dtype, slots):
    """(hs, cs, xs, ys, zs, xvs) with ``slots`` slots, step-major, H in the
    compute dtype and the rest float32, ``state`` copied into slot 0."""
    x, y, z, xv, H, C = state
    f32 = torch.float32
    out = []
    for t, dt in ((H, _CDT[compute_dtype]), (C, f32), (x, f32), (y, f32),
                  (z, f32), (xv, f32)):
        buf = torch.empty((slots, *t.shape), dtype=dt, device=t.device)
        buf[0].copy_(t)
        out.append(buf)
    return tuple(out)


def _fwd_scratch(B, n, m, h, J, dev):
    """r, g, mv_partial, rowdot, mv_partial2, rowdot2 (the loss pass's
    second right-hand side), lv (J+1 slabs of loss vectors), cell_partial
    of the forward entry points."""
    S = n + m

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)
    chunks = (S + _build.KKT_ROWS - 1) // _build.KKT_ROWS
    return (empty(B, S), empty(B, S), empty(B, chunks, n), empty(B, m),
            empty(B, chunks, n), empty(B, m), empty(J + 1, B, S),
            cell_scratch(B * S, h, dev))


def _bwd_scratch(B, n, m, h, compute_dtype, dev):
    """The scratch of the backward entry points, in their order.  pxv is
    also the segment backward's delta scratch (``cell_scratch``'s rows,
    at least one per unit tile); dpreT, dpre transposed, is read by the
    float32 dH only (one element for bf16)."""
    S, M, h4 = n + m, B * (n + m), 4 * h
    n_mt = _build.cell_row_tiles(M)
    n_rp = _build.row_partials(h, compute_dtype)
    n_dp = _build.delta_partials(h)

    def empty(*shape, dt=torch.float32):
        return torch.empty(shape, dtype=dt, device=dev)
    return ([empty(B, S) for _ in range(6)]             # r g dv dg drr dun
            + [empty(B, m), empty(B, n), empty(1),       # drv dal scal
               empty(B, (S + _build.KKT_ROWS - 1) // _build.KKT_ROWS, n),
               empty(B, m), empty(M, h4, dt=_CDT[compute_dtype]),
               empty(h4, M) if compute_dtype == "float32" else empty(1),
               empty(n_dp, M), empty(n_rp, M),           # pxv pg
               empty(n_mt, h4), empty(n_mt, h4), empty(n_mt, h4),
               empty(n_mt, h)])                          # pdb pdw0 pdw1 pdwh


def _count(fn, compute_dtype, count=1):
    if compute_dtype == "float32":
        fn.launches_f32 += count
    else:
        fn.launches += count


def train_fwd_cuda(weights, state, data, *, t0: int, J: int, sigma: float,
                   compute_dtype: str = "bfloat16"):
    """The forward kernel on CUDA tensors; same contract as
    :func:`train_fwd_plain` (streams with the same layout)."""
    (B, n, m, h), ops = _cuda_operands(weights, state, data, compute_dtype,
                                       J, t0)
    dev = state[0].device
    f32 = torch.float32
    streams = _carries(state, compute_dtype, J + 1)
    H_final = torch.empty((B, n + m, h), dtype=f32, device=dev)
    pr = torch.empty((B, J), dtype=f32, device=dev)
    dr = torch.empty((B, J), dtype=f32, device=dev)
    fn = _build.function("train_fwd", "iadmm_train_fwd_chunk", _FWD_ARGS)
    code = fn(t0, *(t.data_ptr() for t in (
        *ops, *streams, H_final, pr, dr,
        *_fwd_scratch(B, n, m, h, J, dev))),
        B, n, m, h, J, int(compute_dtype == "float32"), float(sigma),
        _build.stream_ptr(dev))
    _build.check(code, "iadmm_train_fwd_chunk")
    _count(train_fwd_cuda, compute_dtype, J)
    hs, cs, xs, ys, zs, xvs = streams
    final = (xs[J].clone(), ys[J].clone(), zs[J].clone(), xvs[J].clone(),
             H_final, cs[J].clone())
    return pr, dr, final, streams


train_fwd_cuda.launches = 0      # steps launched, bf16 compute
train_fwd_cuda.launches_f32 = 0  # steps launched, float32 compute


def train_bwd_cuda(weights, data, streams, dfinal, dpr, ddr, *, t0: int,
                   J: int, sigma: float, compute_dtype: str = "bfloat16"):
    """The backward kernel on CUDA tensors; same contract as
    :func:`train_bwd_plain` (one chunk: dpr, ddr (B, J), fresh
    gradients)."""
    hs, cs, xs, ys, zs, xvs = streams
    state0 = (xs[0], ys[0], zs[0], xvs[0], cs[0], cs[0])
    (B, n, m, h), ops = _cuda_operands(weights, state0, data, compute_dtype,
                                       J, t0, backward=True)
    S = n + m
    want = {"hs": (_CDT[compute_dtype], (J + 1, B, S, h)),
            "cs": (torch.float32, (J + 1, B, S, h)),
            "xs": (torch.float32, (J + 1, B, n)),
            "ys": (torch.float32, (J + 1, B, m)),
            "zs": (torch.float32, (J + 1, B, m)),
            "xvs": (torch.float32, (J + 1, B, S)),
            "dpr": (None, (B, J)), "ddr": (None, (B, J))}
    for (k, (dt, shape)), t in zip(want.items(), (*streams, dpr, ddr)):
        if (dt is not None and (t.dtype != dt or not t.is_contiguous())) \
                or tuple(t.shape) != shape:
            raise ValueError(f"{k}: {t.dtype} {tuple(t.shape)}, expected a "
                             f"contiguous {dt} {shape}")
    dev = xs.device
    f32 = torch.float32
    carries = tuple(t.to(f32).contiguous().clone() for t in dfinal)
    dpr = dpr.to(f32).contiguous()
    ddr = ddr.to(f32).contiguous()
    grads = _zero_grads(h, J, f32, dev)
    fn = _build.function("train_bwd", "iadmm_train_bwd_step", _BWD_ARGS)
    stream = _build.stream_ptr(dev)
    # ops[:13]: Q A0 p zl zu rhom rho alpha W U Ut b Wh (the backward does
    # not read b_h)
    ptrs = [t.data_ptr() for t in (
        *ops[:13], *streams, dpr, ddr, *carries, *grads,
        *_bwd_scratch(B, n, m, h, compute_dtype, dev))]
    f32_flag = int(compute_dtype == "float32")
    for k in reversed(range(J)):
        code = fn(k, t0 + k, *ptrs, B, n, m, h, J, f32_flag, float(sigma),
                  stream)
        _build.check(code, "iadmm_train_bwd_step")
        _count(train_bwd_cuda, compute_dtype)
    return grads, carries


train_bwd_cuda.launches = 0      # reverse steps launched, bf16 compute
train_bwd_cuda.launches_f32 = 0  # reverse steps launched, float32 compute


def train_fwd_seg_cuda(weights, state, data, *, t0: int, J: int,
                       sigma: float, compute_dtype: str = "bfloat16",
                       losses=None, col: int = 0, pending: bool = False,
                       close: bool = True):
    """The segment forward kernel on CUDA tensors; same contract as
    :func:`train_fwd_seg_plain`.  ``losses``: the chunk's (pr, dr), each a
    contiguous float32 (B, L), whose columns [col, col + J) it writes and
    returns, in place of fresh (B, J) ones.  The loss pass folds into the
    next step's: ``pending`` (col > 0), the previous segment's call left
    its last loss (column col − 1) to this one, which takes it from
    ``state``; ``close=False`` leaves this call's last loss (column col +
    J − 1) to the next segment's call.  A chunk's segments in order, the
    first with ``pending=False`` and the last with ``close=True``, write
    every column."""
    (B, n, m, h), ops = _cuda_operands(weights, state, data, compute_dtype,
                                       J, t0)
    dev = state[0].device
    f32 = torch.float32
    if losses is None:
        losses = tuple(torch.empty((B, J), dtype=f32, device=dev)
                       for _ in range(2))
    L = losses[0].shape[-1]
    if col < 0 or col + J > L:
        raise ValueError(f"columns [{col}, {col + J}) do not fit losses of "
                         f"{L} columns")
    if pending and col == 0:
        raise ValueError("pending: no column before column 0")
    _check_float32(dict(pr=losses[0], dr=losses[1]), ((B, L), (B, L)))
    bufs = _carries(state, compute_dtype, 2)
    H_final = torch.empty((B, n + m, h), dtype=f32, device=dev)
    fn = _build.function("train_fwd", "iadmm_train_fwd_seg", _FWD_SEG_ARGS)
    code = fn(t0, col, L, int(pending), int(close), *(t.data_ptr() for t in (
        *ops, *bufs, H_final, *losses, *_fwd_scratch(B, n, m, h, J, dev))),
        B, n, m, h, J, int(compute_dtype == "float32"), float(sigma),
        _build.stream_ptr(dev))
    _build.check(code, "iadmm_train_fwd_seg")
    _count(train_fwd_seg_cuda, compute_dtype)
    hs, cs, xs, ys, zs, xvs = bufs
    last = J % 2
    final = (xs[last].clone(), ys[last].clone(), zs[last].clone(),
             xvs[last].clone(), H_final, cs[last].clone())
    return losses[0], losses[1], final


train_fwd_seg_cuda.launches = 0      # segments launched, bf16 compute
train_fwd_seg_cuda.launches_f32 = 0  # segments launched, float32 compute


def train_bwd_seg_cuda(weights, state, data, dfinal, dpr, ddr, *, t0: int,
                       J: int, sigma: float, compute_dtype: str = "bfloat16",
                       col: int = 0, acc=None):
    """The segment backward kernel on CUDA tensors; same contract as
    :func:`train_bwd_seg_plain`.  ``acc``, where given, holds contiguous
    float32 tensors and is added to in place (the chunk's sums across its
    segments); the cotangents ``dfinal`` are left as they are."""
    (B, n, m, h), ops = _cuda_operands(weights, state, data, compute_dtype,
                                       J, t0, backward=True)
    dev = state[0].device
    f32 = torch.float32
    dpr = dpr.to(f32).contiguous()
    ddr = ddr.to(f32).contiguous()
    L = dpr.shape[-1]
    if col < 0 or col + J > L:
        raise ValueError(f"columns [{col}, {col + J}) do not fit loss "
                         f"cotangents of {L} columns")
    _check_float32(dict(dpr=dpr, ddr=ddr), ((B, L), (B, L)))
    if acc is None:
        acc = _zero_grads(h, L, f32, dev)
    _check_float32(dict(zip(("dW", "dU", "db", "dW_h", "db_h", "drho",
                             "dalpha"), acc)),
                   _grad_shapes(h, L))
    for k, d, t in zip(("x", "y", "z", "xv", "H", "C"), dfinal, state):
        if d.shape != t.shape:
            raise ValueError(f"d{k}: shape {tuple(d.shape)}, expected "
                             f"{tuple(t.shape)}")
    carries = tuple(t.to(f32).contiguous().clone() for t in dfinal)
    bufs = _carries(state, compute_dtype, J + 1)
    fn = _build.function("train_bwd", "iadmm_train_bwd_seg", _BWD_SEG_ARGS)
    code = fn(t0, col, L, *(t.data_ptr() for t in (
        *ops, *bufs, dpr, ddr, *carries, *acc,
        *_bwd_scratch(B, n, m, h, compute_dtype, dev))),
        B, n, m, h, J, int(compute_dtype == "float32"), float(sigma),
        _build.stream_ptr(dev))
    _build.check(code, "iadmm_train_bwd_seg")
    _count(train_bwd_seg_cuda, compute_dtype)
    return tuple(acc), carries


train_bwd_seg_cuda.launches = 0      # segments launched, bf16 compute
train_bwd_seg_cuda.launches_f32 = 0  # segments launched, float32 compute


def _gemm_core(kind, dt, products, A, B, C, a_col, b_col, accumulate):
    """C (M, N) float32 = op(A)·op(B), or += with ``accumulate``, through
    the C entry point ``iadmm_gemm_<kind>`` for operands of dtype ``dt``,
    which takes the (a_col, b_col, accumulate) flags in ``products``; on
    CPU tensors the float32 product of the same operands."""
    name = f"{kind}_gemm"
    opA = A.t() if a_col else A
    opB = B.t() if b_col else B
    (M, K), N = opA.shape, opB.shape[1]
    if opB.shape[0] != K or tuple(C.shape) != (M, N):
        raise ValueError(f"{name}: {tuple(opA.shape)} x "
                         f"{tuple(opB.shape)} into {tuple(C.shape)}")
    if not C.is_cuda:
        prod = opA.float() @ opB.float()
        return C.add_(prod) if accumulate else C.copy_(prod)
    flags = (int(a_col), int(b_col), int(accumulate))
    if flags not in products:
        raise ValueError(f"{name}: the kernel takes the dH and dU "
                         f"products {products} only, not (a_col, b_col, "
                         f"accumulate) = {flags}")
    for k, t, want in (("A", A, dt), ("B", B, dt), ("C", C, torch.float32)):
        if t.dtype != want or not t.is_contiguous() or t.device != C.device:
            raise ValueError(f"{name}: {k} must be a contiguous {want} on "
                             f"{C.device}")
    fn = _build.function("train_bwd", f"iadmm_gemm_{kind}", _GEMM_ARGS)
    code = fn(*flags, A.data_ptr(), A.shape[1], B.data_ptr(), B.shape[1],
              C.data_ptr(), N, M, N, K, _build.stream_ptr(C.device))
    _build.check(code, f"iadmm_gemm_{kind}")
    return C


def bf16_gemm(A, B, C, *, a_col: bool, b_col: bool, accumulate: bool):
    """The training backward's bf16 GEMM core alone (``csrc/gemm_bf16.cuh``
    through ``iadmm_gemm_bf16``), to time and check it apart from the
    reverse step: C (M, N) float32 = op(A)·op(B), or += with
    ``accumulate``, where op(A) = Aᵀ with ``a_col`` and op(B) = Bᵀ with
    ``b_col``; A and B bf16, contiguous.  The kernel takes the backward's
    two products: dH = dpre·Uᵀ (a_col=False, b_col=True, accumulate=False)
    and dU += H_kᵀ·dpre (True, False, True).  On CPU tensors: float32
    products of the same operands.  Returns C."""
    return _gemm_core("bf16", torch.bfloat16, ((0, 1, 0), (1, 0, 1)), A, B,
                      C, a_col, b_col, accumulate)


def f32_gemm(A, B, C, *, a_col: bool, b_col: bool, accumulate: bool):
    """The float32 FFMA GEMM core alone (``csrc/gemm_f32.cuh`` through
    ``iadmm_gemm_f32``), the core of every float32 product of the port:
    as :func:`bf16_gemm` with A and B float32 (contiguous, any leading
    dimension, 4-byte aligned), summed in float32 FFMA (no TF32).  The
    kernel reads both operands along their rows, so it takes C = AᵀB:
    dH = (dpreᵀ)ᵀ·Uᵀ from the transposed copies the backward keeps
    (a_col=True, b_col=False, accumulate=False) and dU += H_kᵀ·dpre (True,
    False, True).  On CPU tensors: the float32 product.  Returns C."""
    return _gemm_core("f32", torch.float32, ((1, 0, 0), (1, 0, 1)), A, B,
                      C, a_col, b_col, accumulate)


def _param_grads(weights, grads, t0):
    """The chunk's parameter gradients: the cell's five in their own shapes
    and dtypes, dρ and dα placed at [t0, t0 + L) of the schedules."""
    out = [g.reshape(w.shape).to(w.dtype)
           for w, g in zip(weights[:5], grads[:5])]
    for w, g in zip(weights[5:], grads[5:]):
        full = torch.zeros_like(w)
        full[t0:t0 + g.shape[0]] = g.to(w.dtype)
        out.append(full)
    return out


class _TrainChunk(torch.autograd.Function):
    """The stream route: forward kernel in ``forward``, backward kernel in
    ``backward``; the plain pair on CPU tensors."""

    @staticmethod
    def forward(ctx, spec, t0, W, U, b, W_h, b_h, rho, alpha,
                x, y, z, xv, H, C, Q, A0, p, zl, zu, rhom):
        weights = (W, U, b, W_h, b_h, rho, alpha)
        state = (x, y, z, xv, H, C)
        data = (Q, A0, p, zl, zu, rhom)
        fwd = train_fwd_cuda if x.is_cuda else train_fwd_plain
        pr, dr, final, streams = fwd(weights, state, data, t0=t0, **spec)
        ctx.spec, ctx.t0 = spec, t0
        ctx.save_for_backward(*weights, *data, *streams)
        return (pr, dr, *final)

    @staticmethod
    def backward(ctx, dpr, ddr, *dfinal):
        saved = ctx.saved_tensors
        weights, data, streams = saved[:7], saved[7:13], saved[13:]
        bwd = train_bwd_cuda if dpr.is_cuda else train_bwd_plain
        grads, _ = bwd(weights, data, streams, dfinal, dpr, ddr, t0=ctx.t0,
                       **ctx.spec)
        return (None, None, *_param_grads(weights, grads, ctx.t0)) + \
            (None,) * 12


class _SegmentChunk(torch.autograd.Function):
    """The segment route: ``n_segs`` segments of J steps, each segment's
    start state kept as a checkpoint (the JAX package's ``lax.scan`` stacks
    them); the backward runs over the segments in reverse, carrying the
    state cotangents and summing the gradients.  The segment kernels on
    CUDA tensors, the plain segment pair on CPU tensors."""

    @staticmethod
    def forward(ctx, spec, t0, n_segs, W, U, b, W_h, b_h, rho, alpha,
                x, y, z, xv, H, C, Q, A0, p, zl, zu, rhom):
        weights = (W, U, b, W_h, b_h, rho, alpha)
        state = (x, y, z, xv, H, C)
        data = (Q, A0, p, zl, zu, rhom)
        J = spec["J"]
        ckpts, losses = [], []
        if x.is_cuda:
            chunk = tuple(torch.empty((x.shape[0], n_segs * J),
                                      dtype=torch.float32, device=x.device)
                          for _ in range(2))
        for s in range(n_segs):
            ckpts.append(state)
            kw = dict(t0=t0 + s * J, **spec)
            if x.is_cuda:   # each call takes the loss its previous left
                *_, state = train_fwd_seg_cuda(
                    weights, state, data, losses=chunk, col=s * J,
                    pending=s > 0, close=s == n_segs - 1, **kw)
            else:
                pr, dr, state = train_fwd_seg_plain(weights, state, data,
                                                    **kw)
                losses.append((pr, dr))
        if not x.is_cuda:
            chunk = tuple(torch.cat(v, 1) for v in zip(*losses))
        ctx.spec, ctx.t0, ctx.n_segs = spec, t0, n_segs
        ctx.save_for_backward(*weights, *data,
                              *(t for ck in ckpts for t in ck))
        return (*chunk, *state)

    @staticmethod
    def backward(ctx, dpr, ddr, *dfinal):
        saved = ctx.saved_tensors
        weights, data, ckpts = saved[:7], saved[7:13], saved[13:]
        bwd = train_bwd_seg_cuda if dpr.is_cuda else train_bwd_seg_plain
        J = ctx.spec["J"]
        acc, dstate = None, dfinal
        for s in reversed(range(ctx.n_segs)):
            acc, dstate = bwd(weights, ckpts[6 * s:6 * s + 6], data, dstate,
                              dpr, ddr, t0=ctx.t0 + s * J, col=s * J,
                              acc=acc, **ctx.spec)
        return (None, None, None, *_param_grads(weights, acc, ctx.t0)) + \
            (None,) * 12


def stream_bytes(batch: int, chunk_len: int, num_var: int, num_constr: int,
                 hidden: int) -> int:
    """Bytes of a chunk's H (bf16) and C (float32) streams as the JAX
    package counts them to pick its kernel pair (its
    ``train_rollout.py:1340-1348``): 6 bytes an element of n, m and h each
    padded to 128, whatever the compute dtype, so that both packages pick
    the same pair.  The port stores the streams unpadded, and at the
    float32 profile 8 bytes an element (float32 H): 2.59 GB at B=2, J=100,
    S=2000, h=800, where this counts 2.23 GB."""
    return (batch * (chunk_len + 1)
            * (_round_up(num_var, 128) + _round_up(num_constr, 128))
            * _round_up(hidden, 128) * 6)


def make_fused_chunk_loss(*, num_var: int, num_constr: int, batch: int,
                          hidden: int, sigma: float, chunk_len: int,
                          outer_T: int, K_total: int, seg: int = 0,
                          compute_dtype: str = "bfloat16", stream=None,
                          mesh=None):
    """Drop-in for ``rollouts.chunk_loss`` backed by the training kernels:
    ``fn(params, state, data, t0) -> (loss, state')`` with
    ``loss = (pr + dr).mean(0).sum() / outer_T``.

    ``stream=None`` picks the stream pair when no ``seg`` is given and its
    streams fit ``IADMM_STREAM_HBM`` bytes (default 10e9) as
    :func:`stream_bytes` counts them, the JAX package's rule; else the
    segment pair, with segments of ``seg`` steps, or of
    :func:`pick_segment_len`'s.  ``seg`` must divide ``chunk_len``.
    ``fn.stream`` and ``fn.segment_len`` say which.

    With a ``('data',)`` ``mesh`` (:func:`iadmm_tpu_torch.dist.make_mesh`)
    each rank runs the pair on its rows of the batch (``batch`` is the
    rank's batch, and picks the pair) and the returned loss is the mean
    over 'data', whose backward leaves each rank its local gradient for
    the harness to average."""
    from ..dist import mesh as dist_mesh
    if compute_dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"unknown compute_dtype {compute_dtype!r}")
    dist_mesh.check_mesh(mesh)
    if mesh is not None and mesh.tensor_parallel:
        raise ValueError("model_devices>1: the fused training kernels are "
                         "data-parallel only")
    if stream is None:
        budget = float(os.environ.get("IADMM_STREAM_HBM", 10e9))
        stream = seg == 0 and stream_bytes(batch, chunk_len, num_var,
                                           num_constr, hidden) <= budget
    if stream:
        J = chunk_len
    else:
        J = seg or pick_segment_len(_round_up(num_var, 128),
                                    _round_up(num_constr, 128), hidden,
                                    chunk_len)
        if J < 1 or chunk_len % J:
            raise ValueError(f"seg={seg} does not divide chunk_len="
                             f"{chunk_len}")
    n_segs = chunk_len // J
    spec = dict(J=J, sigma=float(sigma), compute_dtype=compute_dtype)

    def fused_chunk_loss(params: Dict, state: IterState, data: QPBatch, t0):
        t0 = int(t0)
        if state.x.shape[0] != batch:
            raise ValueError(f"state batch {state.x.shape[0]} != {batch}")
        for k in ("rho", "alpha"):
            if params[k].shape[0] != K_total:
                raise ValueError(f"params[{k!r}] has {params[k].shape[0]} "
                                 f"entries, expected K_total={K_total}")
        rhom = rho_vector(1.0, data.eq_mask).to(data.p.dtype)
        args = (*(params[k] for k in _GRAD_KEYS),
                state.x, state.y, state.z, state.xv, state.H, state.C,
                data.Q, data.A0, data.p, data.zl, data.zu, rhom)
        if stream:
            outs = _TrainChunk.apply(spec, t0, *args)
        else:
            outs = _SegmentChunk.apply(spec, t0, n_segs, *args)
        pr, dr = outs[0], outs[1]
        loss = (pr + dr).mean(0).sum() / outer_T
        return dist_mesh.data_mean(loss, mesh), IterState(*outs[2:])

    fused_chunk_loss.segment_len = J
    fused_chunk_loss.stream = bool(stream)
    return fused_chunk_loss
