"""Fused TBPTT training chunk: forward and hand-derived backward kernels.

Replaces the stream pair of ``iadmm_tpu/kernels/train_rollout.py``:
``_fwd_stream_kernel`` (J learned iterations plus the per-step primal and
dual residual losses, writing the per-step state streams) and
``_bwd_stream_kernel`` (the reverse sweep over those streams, no recompute
of the forward).  On CUDA tensors :func:`make_fused_chunk_loss` launches
``csrc/train_fwd.cu`` once per step of the chunk and ``csrc/train_bwd.cu``
once per reverse step; see their headers for the design.  Bounds on the
H100 at B=2, S=n+m=2000, h=800, J=100, both set by the gate GEMMs'
operations: forward 2.1 ms (one GEMM a step) and backward 6.2 ms (three)
at the bf16 tensor-core rate, 30.6 ms and 91.7 ms at the float32 rate.
On CPU tensors it runs :func:`train_fwd_plain` and :func:`train_bwd_plain`,
the same two functions in plain PyTorch, line for line with the TPU
kernel's ``step`` and ``bstep`` and with its bf16 rounding points.

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
Launches are counted per compute dtype: ``train_fwd_cuda.launches`` and
``train_bwd_cuda.launches`` (bf16), ``.launches_f32`` (float32).

Gradients flow to ``W, U, b, W_h, b_h, rho, alpha`` only; the state and the
problem data get none, as ``_package_grads`` gives none.  The ``rho`` and
``alpha`` gradients land at ``[t0, t0 + J)`` of the ``K_total`` schedules.
No 128-lane padding: the shapes are the problem's own.

Streams, step-major (slot k of step k, slot J the final state):
``hs (J+1, B, S, h)`` (in the compute dtype), ``cs (J+1, B, S, h)``,
``xs (J+1, B, n)``, ``ys``, ``zs (J+1, B, m)``, ``xvs (J+1, B, S)``.
"""

from __future__ import annotations

import os
from typing import Dict

import torch

from ..solvers.step import rho_vector
from ..types import IterState, QPBatch
from . import _build
from .lstm_cell import CELL_KEYS, check_cell_weights

_GRAD_KEYS = CELL_KEYS + ("rho", "alpha")
_COMPUTE_DTYPES = ("bfloat16", "float32")
_CDT = {"bfloat16": torch.bfloat16, "float32": torch.float32}


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
                    J: int, sigma: float, compute_dtype: str = "bfloat16"):
    """Plain PyTorch version of the backward kernel: the hand-derived
    reverse sweep over the streams of :func:`train_fwd_plain`.

    dfinal: cotangents of the final state (x, y, z, xv, H, C); dpr, ddr
    (B, J): of the losses.  Returns ((dW, dU, db, dW_h, db_h, drho (J,),
    dalpha (J,)), cotangents of the start state)."""
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
    dW = torch.zeros_like(Wc)
    dU = torch.zeros_like(Uc)
    db = torch.zeros_like(b)
    dWh = torch.zeros_like(Whc)
    dbh = torch.zeros(1, dtype=wd, device=b.device)
    drho = torch.zeros(J, dtype=wd, device=b.device)
    dalpha = torch.zeros(J, dtype=wd, device=b.device)

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
        dv1 = dpr[:, k:k + 1] / torch.clamp(pr_n, min=1e-30) * v1
        dv2 = ddr[:, k:k + 1] / torch.clamp(dr_n, min=1e-30) * v2
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
        drho[k] = (drho_vec * rhom).sum() * s_rho * (1.0 - s_rho)
        dalpha[k] = dalpha_s * 2.0 * s_alpha * (1.0 - s_alpha)
    return (dW, dU, db, dWh, dbh, drho, dalpha), (dx, dy, dz, dxv, sH, sC)


# --------------------------------------------------------------------------
# CUDA wrappers
# --------------------------------------------------------------------------

_FWD_ARGS = ([_build.I] * 2 + [_build.P] * 27 + [_build.I] * 6
             + [_build.F, _build.P])
_BWD_ARGS = ([_build.I] * 2 + [_build.P] * 51 + [_build.I] * 6
             + [_build.F, _build.P])


def _check_cuda_inputs(weights, state, data, compute_dtype, J, t0):
    if compute_dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"unknown compute_dtype {compute_dtype!r}")
    if J < 1:
        raise ValueError(f"a chunk needs J >= 1 steps, got {J}")
    x, y, z, xv, H, C = state
    B, n = x.shape
    m = y.shape[1]
    S, h = n + m, H.shape[-1]
    check_cell_weights(*weights[:5], h)
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
    return B, n, m, h


def _prep_cuda(weights, data, compute_dtype):
    """Kernel operands: matrices and cell weights in the compute dtype,
    float32 vectors, all contiguous."""
    cdt, f32 = _CDT[compute_dtype], torch.float32
    W, U, b, W_h, b_h, rho, alpha = weights
    Q, A0, p, zl, zu, rhom = data
    mats = [_build.aligned(Q.to(cdt)), _build.aligned(A0.to(cdt))]
    vecs = [t.to(f32).contiguous() for t in (p, zl, zu, rhom, rho, alpha)]
    wts = [W.to(cdt).contiguous(), _build.aligned(U.to(cdt)),
           b.to(f32).contiguous(), W_h.reshape(-1).to(cdt).contiguous(),
           b_h.reshape(-1).to(f32).contiguous()]
    return mats + vecs + wts


def train_fwd_cuda(weights, state, data, *, t0: int, J: int, sigma: float,
                   compute_dtype: str = "bfloat16"):
    """The forward kernel on CUDA tensors; same contract as
    :func:`train_fwd_plain` (streams with the same layout)."""
    B, n, m, h = _check_cuda_inputs(weights, state, data, compute_dtype, J,
                                    t0)
    dev = state[0].device
    S, M = n + m, B * (n + m)
    f32 = torch.float32
    ops = _prep_cuda(weights, data, compute_dtype)
    x, y, z, xv, H, C = state
    hs = torch.empty((J + 1, B, S, h), dtype=_CDT[compute_dtype], device=dev)
    cs = torch.empty((J + 1, B, S, h), dtype=f32, device=dev)
    xs = torch.empty((J + 1, B, n), dtype=f32, device=dev)
    ys = torch.empty((J + 1, B, m), dtype=f32, device=dev)
    zs = torch.empty((J + 1, B, m), dtype=f32, device=dev)
    xvs = torch.empty((J + 1, B, S), dtype=f32, device=dev)
    for dst, src in ((hs, H), (cs, C), (xs, x), (ys, y), (zs, z), (xvs, xv)):
        dst[0].copy_(src)
    H_final = torch.empty((B, S, h), dtype=f32, device=dev)
    pr = torch.empty((B, J), dtype=f32, device=dev)
    dr = torch.empty((B, J), dtype=f32, device=dev)
    r, g = (torch.empty((B, S), dtype=f32, device=dev) for _ in range(2))
    mv_partial = torch.empty((B, (S + _build.KKT_ROWS - 1) // _build.KKT_ROWS,
                              n), dtype=f32, device=dev)
    rowdot = torch.empty((B, m), dtype=f32, device=dev)
    cell_partial = torch.empty(((h + _build.CELL_HB - 1) // _build.CELL_HB, M),
                               dtype=f32, device=dev)
    fn = _build.function("train_fwd", "iadmm_train_fwd_step", _FWD_ARGS)
    stream = _build.stream_ptr(dev)
    fixed = [t.data_ptr() for t in (*ops, hs, cs, xs, ys, zs, xvs)]
    tail = [pr.data_ptr(), dr.data_ptr(), r.data_ptr(), g.data_ptr(),
            mv_partial.data_ptr(), rowdot.data_ptr(), cell_partial.data_ptr()]
    f32_flag = int(compute_dtype == "float32")
    for k in range(J):
        code = fn(k, t0 + k, *fixed,
                  H_final.data_ptr() if k == J - 1 else None, *tail,
                  B, n, m, h, J, f32_flag, float(sigma), stream)
        _build.check(code, "iadmm_train_fwd_step")
        if f32_flag:
            train_fwd_cuda.launches_f32 += 1
        else:
            train_fwd_cuda.launches += 1
    final = (xs[J].clone(), ys[J].clone(), zs[J].clone(), xvs[J].clone(),
             H_final, cs[J].clone())
    return pr, dr, final, (hs, cs, xs, ys, zs, xvs)


train_fwd_cuda.launches = 0      # steps launched, bf16 compute
train_fwd_cuda.launches_f32 = 0  # steps launched, float32 compute


def train_bwd_cuda(weights, data, streams, dfinal, dpr, ddr, *, t0: int,
                   J: int, sigma: float, compute_dtype: str = "bfloat16"):
    """The backward kernel on CUDA tensors; same contract as
    :func:`train_bwd_plain`."""
    hs, cs, xs, ys, zs, xvs = streams
    state0 = (xs[0], ys[0], zs[0], xvs[0], cs[0], cs[0])
    B, n, m, h = _check_cuda_inputs(weights, state0, data, compute_dtype, J,
                                    t0)
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
    M, h4 = B * S, 4 * h
    f32, cdt = torch.float32, _CDT[compute_dtype]
    ops = _prep_cuda(weights, data, compute_dtype)
    dx, dy, dz, dxv, sH, sC = (t.to(f32).contiguous().clone()
                               for t in dfinal)
    dpr = dpr.to(f32).contiguous()
    ddr = ddr.to(f32).contiguous()
    dW = torch.zeros((2, h4), dtype=f32, device=dev)
    dU = torch.zeros((h, h4), dtype=f32, device=dev)
    db = torch.zeros(h4, dtype=f32, device=dev)
    dWh = torch.zeros(h, dtype=f32, device=dev)
    dbh = torch.zeros(1, dtype=f32, device=dev)
    drho = torch.zeros(J, dtype=f32, device=dev)
    dalpha = torch.zeros(J, dtype=f32, device=dev)

    def empty(*shape, dt=f32):
        return torch.empty(shape, dtype=dt, device=dev)

    n_mt = (M + 127) // 128
    n_ut = (h + _build.CELL_HB - 1) // _build.CELL_HB
    scratch = [empty(B, S) for _ in range(6)]           # r g dv dg drr dun
    scratch += [empty(B, m), empty(B, n), empty(1),      # drv dal scal
                empty(B, (S + _build.KKT_ROWS - 1) // _build.KKT_ROWS, n),
                empty(B, m), empty(M, h4, dt=cdt),       # rowdot dpre
                empty(n_ut, M), empty(n_ut, M),          # pxv pg
                empty(n_mt, h4), empty(n_mt, h4), empty(n_mt, h4),
                empty(n_mt, h)]
    fn = _build.function("train_bwd", "iadmm_train_bwd_step", _BWD_ARGS)
    stream = _build.stream_ptr(dev)
    # ops[:12]: Q A0 p zl zu rhom rho alpha W U b Wh (the backward does
    # not read b_h)
    ptrs = [t.data_ptr() for t in (
        *ops[:12], hs, cs, xs, ys, zs, xvs, dpr, ddr,
        dx, dy, dz, dxv, sH, sC, dW, dU, db, dWh, dbh, drho, dalpha,
        *scratch)]
    f32_flag = int(compute_dtype == "float32")
    for k in reversed(range(J)):
        code = fn(k, t0 + k, *ptrs, B, n, m, h, J, f32_flag, float(sigma),
                  stream)
        _build.check(code, "iadmm_train_bwd_step")
        if f32_flag:
            train_bwd_cuda.launches_f32 += 1
        else:
            train_bwd_cuda.launches += 1
    grads = (dW, dU, db, dWh[:, None], dbh, drho, dalpha)
    return grads, (dx, dy, dz, dxv, sH.reshape(B, S, h), sC.reshape(B, S, h))


train_bwd_cuda.launches = 0      # reverse steps launched, bf16 compute
train_bwd_cuda.launches_f32 = 0  # reverse steps launched, float32 compute


class _TrainChunk(torch.autograd.Function):
    """Forward kernel in ``forward``, backward kernel in ``backward``; the
    plain pair on CPU tensors."""

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
        dW, dU, db, dWh, dbh, drho_c, dalpha_c = grads
        J = ctx.spec["J"]
        out = []
        for w, gr in zip(weights[:5], (dW, dU, db, dWh, dbh)):
            out.append(gr.reshape(w.shape).to(w.dtype))
        for w, gr in zip(weights[5:], (drho_c, dalpha_c)):
            full = torch.zeros_like(w)
            full[ctx.t0:ctx.t0 + J] = gr.to(w.dtype)
            out.append(full)
        return (None, None, *out) + (None,) * 12


def stream_bytes(batch: int, chunk_len: int, num_var: int, num_constr: int,
                 hidden: int) -> int:
    """Bytes of the H (bf16) and C (float32) streams of one chunk: 6 bytes
    an element whatever the compute dtype, as the JAX package counts them
    (its ``train_rollout.py:1345``), so that both packages pick the same
    kernel pair.  The float32 profile's streams really take 8 bytes an
    element (float32 H): 2.59 GB at B=2, J=100, S=2000, h=800, against the
    1.94 GB counted here."""
    return batch * (chunk_len + 1) * (num_var + num_constr) * hidden * 6


def make_fused_chunk_loss(*, num_var: int, num_constr: int, batch: int,
                          hidden: int, sigma: float, chunk_len: int,
                          outer_T: int, K_total: int, seg: int = 0,
                          compute_dtype: str = "bfloat16", stream=None,
                          mesh=None):
    """Drop-in for ``rollouts.chunk_loss`` backed by the training kernels:
    ``fn(params, state, data, t0) -> (loss, state')`` with
    ``loss = (pr + dr).mean(0).sum() / outer_T``.

    ``stream=None`` picks the stream pair when its H/C streams fit
    ``IADMM_STREAM_HBM`` bytes (default 10e9), the JAX package's rule
    counted on the port's unpadded sizes (:func:`stream_bytes`).  The
    segment-recompute pair (``stream=False``, ``seg > 0``, or streams that
    do not fit) and data parallelism (``mesh``) are not ported."""
    if compute_dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"unknown compute_dtype {compute_dtype!r}")
    if mesh is not None:
        raise NotImplementedError(
            "data-parallel fused training (mesh) is not ported to PyTorch "
            "yet; see ROADMAP.md (Queue 1, distribution)")
    nbytes = stream_bytes(batch, chunk_len, num_var, num_constr, hidden)
    if stream is None:
        budget = float(os.environ.get("IADMM_STREAM_HBM", 10e9))
        stream = seg == 0 and nbytes <= budget
    if seg or not stream:
        raise NotImplementedError(
            f"the segment-recompute training kernels (_fwd_seg_kernel, "
            f"_bwd_seg_kernel; stream=False, seg>0, or {nbytes} stream bytes "
            f"over IADMM_STREAM_HBM) are not ported to PyTorch yet; see "
            f"ROADMAP.md (Queue 2)")
    spec = dict(J=chunk_len, sigma=float(sigma), compute_dtype=compute_dtype)

    def fused_chunk_loss(params: Dict, state: IterState, data: QPBatch, t0):
        t0 = int(t0)
        if state.x.shape[0] != batch:
            raise ValueError(f"state batch {state.x.shape[0]} != {batch}")
        for k in ("rho", "alpha"):
            if params[k].shape[0] != K_total:
                raise ValueError(f"params[{k!r}] has {params[k].shape[0]} "
                                 f"entries, expected K_total={K_total}")
        rhom = rho_vector(1.0, data.eq_mask).to(data.p.dtype)
        outs = _TrainChunk.apply(
            spec, t0, *(params[k] for k in _GRAD_KEYS),
            state.x, state.y, state.z, state.xv, state.H, state.C,
            data.Q, data.A0, data.p, data.zl, data.zu, rhom)
        pr, dr = outs[0], outs[1]
        loss = (pr + dr).mean(0).sum() / outer_T
        return loss, IterState(*outs[2:])

    fused_chunk_loss.segment_len = chunk_len
    fused_chunk_loss.stream = True
    return fused_chunk_loss

