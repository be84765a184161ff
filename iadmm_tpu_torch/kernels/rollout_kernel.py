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
in bf16 and C in float32, z-relaxation off.  Both read the weights that
:func:`prepare_rollout` makes, which ``api.make_solver`` does once a solver.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple, Union

import torch

from ..solvers import cells
from ..solvers.step import check_schedule_len, rho_vector
from ..types import QPBatch
from . import _build
from .lstm_cell import CELL_KEYS, CellOperands, cell_operands, cell_scratch


class RolloutWeights(NamedTuple):
    """The rollout's weights as :func:`prepare_rollout` makes them."""
    cell: CellOperands
    rho: torch.Tensor
    alpha: torch.Tensor


def prepare_rollout(params: Union[Dict, RolloutWeights], *, hidden: int,
                    K: int) -> RolloutWeights:
    """``params`` as the rollout reads them at width ``hidden``: the cell's
    bf16 operands at the rollout's tile, rho and alpha in float32.  Raises
    ValueError unless they hold the LSTM's keys and shapes and K schedule
    entries; prepared weights that fit are returned as they are."""
    if isinstance(params, RolloutWeights):
        if params.cell.W_h.shape[0] != hidden or len(params.rho) < K:
            raise ValueError(
                f"rollout weights for h={params.cell.W_h.shape[0]} and "
                f"{len(params.rho)} iterations do not fit h={hidden}, K={K}")
        return params
    missing = [k for k in CELL_KEYS + ("rho", "alpha") if k not in params]
    if missing:
        raise ValueError(f"the fused rollout runs the LSTM cell with learned "
                         f"schedules; params lack {missing}")
    check_schedule_len(params, K)
    cell = cell_operands(*(params[k] for k in CELL_KEYS), h=hidden,
                         gate_dtype="bfloat16", hb=_build.ROLLOUT_HB)
    return RolloutWeights(cell, *(params[k].to(torch.float32).contiguous()
                                  for k in ("rho", "alpha")))


def rollout_plain(params: Union[Dict, RolloutWeights], data: QPBatch, *,
                  hidden: int, K: int, sigma: float = 6e-6
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the rollout kernel, over the same prepared
    weights (:func:`prepare_rollout`); returns (x, y, z)."""
    f32, r16 = torch.float32, cells.bf16_round
    wts = prepare_rollout(params, hidden=hidden, K=K)
    B, n = data.p.shape
    m = data.num_constr
    dev = data.p.device
    Q, A0 = r16(data.Q), r16(data.A0)
    p, zl, zu = (t.to(f32) for t in (data.p, data.zl, data.zu))
    rhom = rho_vector(1.0, data.eq_mask)  # (B, m) row multipliers
    cw = wts.cell
    W, U, Wh = cw.W.to(f32), cw.U.to(f32), cw.W_h.to(f32)[:, None]
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
        rho = torch.sigmoid(wts.rho[t]) * rhom
        alpha = 2.0 * torch.sigmoid(wts.alpha[t])
        u, nu = xv[:, :n], xv[:, n:]
        t1, a1 = matvec(u, nu)
        r1 = t1 + sigma * u - (sigma * x - p)
        r2 = a1 - nu / rho - (z - y / rho)
        t2, a2 = matvec(r1, r2)
        g = torch.cat([t2 + sigma * r1, a2 - r2 / rho], dim=-1)
        gates = (H.to(f32) @ U + xv[..., None] * W[0] + g[..., None] * W[1]
                 + cw.b)
        i_t = torch.sigmoid(gates[..., 0 * h:1 * h])
        f_t = torch.sigmoid(gates[..., 1 * h:2 * h])
        o_t = torch.sigmoid(gates[..., 2 * h:3 * h])
        u_t = torch.tanh(gates[..., 3 * h:4 * h])
        C = i_t * u_t + f_t * C
        H_new = o_t * torch.tanh(C)
        delta = (r16(H_new) @ Wh)[..., 0] + cw.b_h
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


def _rollout_cuda(wts: RolloutWeights, data: QPBatch, hidden: int, K: int,
                  sigma: float):
    dev = data.p.device
    B, n = data.p.shape
    m = data.num_constr
    S, h = n + m, hidden
    for k, t in (("W", wts.cell.W), ("rho", wts.rho), ("alpha", wts.alpha)):
        if t.device != dev:
            raise ValueError(f"params[{k!r}] is on {t.device}, data on {dev}")
    bf, f32 = torch.bfloat16, torch.float32
    Q, A0 = _build.aligned(data.Q.to(bf)), _build.aligned(data.A0.to(bf))
    # rhom: the (B, m) row multipliers
    p, zl, zu, rhom = (t.to(f32).contiguous() for t in (
        data.p, data.zl, data.zu, rho_vector(1.0, data.eq_mask)))
    cw = wts.cell

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
        Q, A0, p, zl, zu, rhom, wts.rho, wts.alpha, cw.W, cw.Ut, cw.b,
        cw.W_h, cw.b_h, xv, x, y, z, r, g, H_a, H_b, C, mv_partial, rowdot,
        cell_partial)),
        B, n, m, h, float(sigma), _build.stream_ptr(dev))
    _build.check(code, "iadmm_rollout")
    fused_rollout.launches += K
    return x, y, z


def fused_rollout(params: Union[Dict, RolloutWeights], data: QPBatch, *,
                  hidden: int, K: int, sigma: float = 6e-6
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run K learned iterations from a zero state; returns (x, y, z).

    On CUDA data this launches the K iterations of ``csrc/rollout.cu``
    from one call; on CPU data it runs :func:`rollout_plain`.  Both run the
    LSTM cell with learned schedules: ``params``, a parameter dict or its
    :func:`prepare_rollout` weights, must hold the LSTM's keys and shapes
    (ValueError otherwise), whichever cell they came from."""
    wts = prepare_rollout(params, hidden=hidden, K=K)
    if data.p.is_cuda:
        return _rollout_cuda(wts, data, hidden, K, sigma)
    return rollout_plain(wts, data, hidden=hidden, K=K, sigma=sigma)


fused_rollout.launches = 0  # iterations launched, counted by _rollout_cuda


def fused_rollout_sharded(params: Dict, data: QPBatch, mesh, *, hidden: int,
                          K: int, sigma: float = 6e-6
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scenario-parallel :func:`fused_rollout` over a ``('data',)`` mesh
    (:func:`iadmm_tpu_torch.dist.make_mesh`): this rank runs its rows of
    the batch ``data`` through the rollout kernel, with no collectives (the
    instances are independent), and returns (x, y, z) of those rows.  The
    batch must split evenly over the data ranks."""
    from ..dist import mesh as dist_mesh
    dist_mesh.check_mesh(mesh)
    if mesh is None:
        raise ValueError("fused_rollout_sharded needs a mesh")
    return fused_rollout(params, dist_mesh.shard_batch(data, mesh),
                         hidden=hidden, K=K, sigma=sigma)
