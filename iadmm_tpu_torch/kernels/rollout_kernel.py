"""The serving rollout: K learned ADMM iterations from a zero state.

Replaces ``iadmm_tpu/kernels/rollout_kernel.py::_rollout_kernel``.  On the
TPU one kernel runs all K iterations per instance with everything resident
in VMEM.  Here one call into ``csrc/rollout.cu`` launches the K iterations
(KKT-feature passes, the cell GEMM on the rollout's own wide persistent
tile, the ADMM update; see its header and ``cell_gemm.cuh`` for the design
and the bound), six launches an iteration issued by a loop in C.  No
library call sits inside the loop.

:func:`rollout_plain` is the same function in plain PyTorch, with the same
numerics: vectors rounded to bf16 before every matvec, bf16 Q/A0/W/U/W_h
with float32 sums, float32 xv and g against bf16 W in the gates, H carried
in bf16 and C in float32, z-relaxation off.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..solvers import cells
from ..solvers.step import rho_vector
from ..types import QPBatch
from . import _build
from .lstm_cell import (CELL_KEYS, cell_scratch, check_cell_weights,
                        relaid_u)


def rollout_plain(params: Dict, data: QPBatch, *, hidden: int, K: int,
                  sigma: float = 6e-6
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the rollout kernel; returns (x, y, z)."""
    f32, r16 = torch.float32, cells.bf16_round
    B, n = data.p.shape
    m = data.num_constr
    dev = data.p.device
    Q, A0 = r16(data.Q), r16(data.A0)
    p, zl, zu = (t.to(f32) for t in (data.p, data.zl, data.zu))
    rhom = rho_vector(1.0, data.eq_mask)  # (B, m) row multipliers
    W, U, Wh = r16(params["W"]), r16(params["U"]), r16(params["W_h"])
    b, bh = params["b"].to(f32), params["b_h"].to(f32)
    h = hidden
    H = torch.zeros((B, n + m, h), dtype=torch.bfloat16, device=dev)
    C = torch.zeros((B, n + m, h), dtype=f32, device=dev)
    xv = torch.zeros((B, n + m), dtype=f32, device=dev)
    x = torch.zeros((B, n), dtype=f32, device=dev)
    y = torch.zeros((B, m), dtype=f32, device=dev)
    z = torch.zeros((B, m), dtype=f32, device=dev)

    def matvec(u, nu):
        # Q symmetric: Q·u is taken as uᵀQ, the column sum the kernel forms
        u, nu = r16(u), r16(nu)
        top = (torch.einsum("bi,bij->bj", u, Q)
               + torch.einsum("bi,bij->bj", nu, A0))
        return top, torch.einsum("bij,bj->bi", A0, u)

    for t in range(K):
        rho = torch.sigmoid(params["rho"][t].to(f32)) * rhom
        alpha = 2.0 * torch.sigmoid(params["alpha"][t].to(f32))
        u, nu = xv[:, :n], xv[:, n:]
        t1, a1 = matvec(u, nu)
        r1 = t1 + sigma * u - (sigma * x - p)
        r2 = a1 - nu / rho - (z - y / rho)
        t2, a2 = matvec(r1, r2)
        g = torch.cat([t2 + sigma * r1, a2 - r2 / rho], dim=-1)
        gates = (H.to(f32) @ U + xv[..., None] * W[0] + g[..., None] * W[1]
                 + b)
        i_t = torch.sigmoid(gates[..., 0 * h:1 * h])
        f_t = torch.sigmoid(gates[..., 1 * h:2 * h])
        o_t = torch.sigmoid(gates[..., 2 * h:3 * h])
        u_t = torch.tanh(gates[..., 3 * h:4 * h])
        C = i_t * u_t + f_t * C
        H_new = o_t * torch.tanh(C)
        delta = (r16(H_new) @ Wh)[..., 0] + bh
        H = H_new.to(torch.bfloat16)
        xv = xv - delta
        x_t, v = xv[:, :n], xv[:, n:]
        z_t = z + (v - y) / rho
        x = alpha * x_t + (1.0 - alpha) * x
        z_new = torch.minimum(torch.maximum(z_t + y / rho, zl), zu)
        y = y + rho * (z_t - z_new)
        z = z_new
    return x, y, z


_ROLLOUT_ARGS = ([_build.I] + [_build.P] * 25 + [_build.I] * 4
                 + [_build.F, _build.P])


def _rollout_cuda(params: Dict, data: QPBatch, hidden: int, K: int,
                  sigma: float):
    dev = data.p.device
    B, n = data.p.shape
    m = data.num_constr
    S, h = n + m, hidden
    check_cell_weights(*(params[k] for k in CELL_KEYS), h)
    for k in ("W", "U", "b", "W_h", "b_h", "rho", "alpha"):
        if params[k].device != dev:
            raise ValueError(f"params[{k!r}] is on {params[k].device}, "
                             f"data on {dev}")
    bf, f32 = torch.bfloat16, torch.float32

    def vec(t, dt=f32):
        return t.to(dt).contiguous()

    Q, A0 = _build.aligned(data.Q.to(bf)), _build.aligned(data.A0.to(bf))
    p, zl, zu = vec(data.p), vec(data.zl), vec(data.zu)
    rhom = vec(rho_vector(1.0, data.eq_mask))  # (B, m) row multipliers
    rho_raw, alpha_raw = vec(params["rho"]), vec(params["alpha"])
    W = vec(params["W"], bf)
    # U re-laid for the rollout's tile, once for all K iterations
    Ut = relaid_u(params["U"].to(bf), h, _build.ROLLOUT_HB)
    b = vec(params["b"])
    Wh = vec(params["W_h"].reshape(-1), bf)
    bh = vec(params["b_h"].reshape(-1))

    def zeros(*shape, dt=f32):
        return torch.zeros(shape, dtype=dt, device=dev)

    def empty(*shape, dt=f32):
        return torch.empty(shape, dtype=dt, device=dev)

    xv, x, y, z = zeros(B, S), zeros(B, n), zeros(B, m), zeros(B, m)
    r, g = empty(B, S), empty(B, S)
    # H's rows padded to 16 bytes, so that the TMA reads it whatever h
    ldh = _build.ut_ld(h)
    H_a, H_b = zeros(B * S, ldh, dt=bf), empty(B * S, ldh, dt=bf)
    C = zeros(B * S, h)
    mv_partial = empty(B, (S + _build.KKT_ROWS - 1) // _build.KKT_ROWS, n)
    rowdot = empty(B, m)
    cell_partial = cell_scratch(B * S, h, dev)
    fn = _build.function("rollout", "iadmm_rollout", _ROLLOUT_ARGS)
    code = fn(K, *(t.data_ptr() for t in (
        Q, A0, p, zl, zu, rhom, rho_raw, alpha_raw, W, Ut, b, Wh, bh, xv, x,
        y, z, r, g, H_a, H_b, C, mv_partial, rowdot, cell_partial)),
        B, n, m, h, float(sigma), _build.stream_ptr(dev))
    _build.check(code, "iadmm_rollout")
    fused_rollout.launches += K
    return x, y, z


def fused_rollout(params: Dict, data: QPBatch, *, hidden: int, K: int,
                  sigma: float = 6e-6
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run K learned iterations from a zero state; returns (x, y, z).

    On CUDA data this launches the K iterations of ``csrc/rollout.cu``
    from one call; on CPU data it runs :func:`rollout_plain`.  Both run the
    LSTM cell with learned schedules: ``params`` must hold the LSTM's keys
    and shapes (ValueError otherwise), whichever cell they came from."""
    missing = [k for k in CELL_KEYS + ("rho", "alpha") if k not in params]
    if missing:
        raise ValueError(f"the fused rollout runs the LSTM cell with learned "
                         f"schedules; params lack {missing}")
    for k in ("rho", "alpha"):
        if len(params[k]) < K:
            raise ValueError(f"params[{k!r}] has {len(params[k])} entries, "
                             f"the rollout needs {K}")
    if data.p.is_cuda:
        return _rollout_cuda(params, data, hidden, K, sigma)
    check_cell_weights(*(params[k] for k in CELL_KEYS), hidden)
    return rollout_plain(params, data, hidden=hidden, K=K, sigma=sigma)


fused_rollout.launches = 0  # iterations launched, counted by _rollout_cuda
