"""One learned inexact-ADMM iteration.

Counterpart of ``iadmm_tpu/solvers/step.py``.  The LSTM input feature
``g = Ãᵀ(Ã·xv − b̃)`` is computed blockwise from ``Q``/``A0`` matvecs; Ã is
never formed.  With ``xv = [u; ν]``:

    Ã  = [[Q + σI, A0ᵀ], [A0, -diag(1/ρ)]]          (symmetric)
    b̃  = [σx − p ; z − y/ρ]
    r  = Ã·xv − b̃
    g  = Ã·r
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from ..types import IterState, QPBatch
from . import cells

RHO_EQ_OVER_RHO_INEQ = 1e3


def _matvec_operands(M, v, mode: Optional[str]):
    """Operands of a matvec in ``mode``: 'bf16' rounds both to bf16 and
    sums in float32; None/'highest'/'default' promote both to the wider of
    their dtypes, as ``jnp.einsum`` does (a bf16-stored Q meets a float32
    vector in float32; a float32 product on CUDA runs in full float32 with
    TF32 off, PyTorch's default for matmul)."""
    if mode == "bf16":
        return cells.bf16_round(M), cells.bf16_round(v)
    if mode not in (None, "highest", "default"):
        raise ValueError(f"unknown matvec mode {mode!r}")
    dt = torch.promote_types(M.dtype, v.dtype)
    return M.to(dt), v.to(dt)


def bmv(M: torch.Tensor, v: torch.Tensor, mode: Optional[str] = None):
    """Batched matvec (B,i,j),(B,j)->(B,i).  A 2-D ``M`` is diagonal
    storage ``(B, n)`` and the product is elementwise."""
    if M.dim() == 2:
        return M.to(v.dtype) * v
    M, v = _matvec_operands(M, v, mode)
    return torch.einsum("bij,bj->bi", M, v)


def bmv_t(M: torch.Tensor, v: torch.Tensor, mode: Optional[str] = None):
    """Batched transposed matvec (B,i,j),(B,i)->(B,j)."""
    if M.dim() == 2:
        return M.to(v.dtype) * v
    M, v = _matvec_operands(M, v, mode)
    return torch.einsum("bij,bi->bj", M, v)


def rho_vector(rho, eq_mask: torch.Tensor) -> torch.Tensor:
    """Per-row penalty: equality rows get 1e3x rho.  rho: scalar or (B,)."""
    rho = torch.as_tensor(rho, device=eq_mask.device)
    if rho.dim() == 1:
        rho = rho[:, None]
    mult = torch.where(eq_mask, RHO_EQ_OVER_RHO_INEQ, 1.0).to(rho.dtype)
    return rho * mult


def kkt_rhs(data: QPBatch, x, y, z, sigma, rho_vec):
    """b̃ = [σx − p ; z − y/ρ]."""
    return sigma * x - data.p, z - y / rho_vec


def kkt_matvec(data: QPBatch, u, nu, sigma, rho_vec,
               mode: Optional[str] = None) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """(top, bottom) blocks of Ã·[u; ν] without materialising Ã."""
    top = bmv(data.Q, u, mode) + sigma * u + bmv_t(data.A0, nu, mode)
    bottom = bmv(data.A0, u, mode) - nu / rho_vec
    return top, bottom


def kkt_residual(data: QPBatch, xv, x, y, z, sigma, rho_vec,
                 mode: Optional[str] = None):
    """r = Ã·xv − b̃, blockwise."""
    n = data.num_var
    t, btm = kkt_matvec(data, xv[:, :n], xv[:, n:], sigma, rho_vec, mode)
    b1, b2 = kkt_rhs(data, x, y, z, sigma, rho_vec)
    return t - b1, btm - b2


def kkt_feature(data: QPBatch, xv, x, y, z, sigma, rho_vec,
                mode: Optional[str] = None) -> torch.Tensor:
    """g = Ãᵀ(Ã·xv − b̃) = Ã·r (Ã symmetric)."""
    r1, r2 = kkt_residual(data, xv, x, y, z, sigma, rho_vec, mode)
    g1, g2 = kkt_matvec(data, r1, r2, sigma, rho_vec, mode)
    return torch.cat([g1, g2], dim=-1)


def admm_update(data: QPBatch, xv_new, x, y, z, rho_vec, alpha,
                relax_z: bool):
    """OSQP-style x/z/y updates after the (in)exact KKT solve.
    ``relax_z=False`` is the learned step; ``True`` the exact Stage II."""
    n = data.num_var
    x_t, v = xv_new[:, :n], xv_new[:, n:]
    z_t = z + (v - y) / rho_vec
    x_new = alpha * x_t + (1.0 - alpha) * x
    z_temp = alpha * z_t + (1.0 - alpha) * z if relax_z else z_t
    z_new = torch.maximum(torch.minimum(z_temp + y / rho_vec, data.zu),
                          data.zl)
    y_new = y + rho_vec * (z_temp - z_new)
    return x_new, y_new, z_new


def _schedules(params: Dict, t: int, eq_mask: torch.Tensor):
    """(ρ per row, α) of learned iteration ``t``: ρ = σ(rho[t]) with the
    equality rows scaled by 1e3, α = 2σ(alpha[t])."""
    rho_vec = rho_vector(torch.sigmoid(params["rho"][t]), eq_mask)
    alpha = 2.0 * torch.sigmoid(params["alpha"][t])
    return rho_vec, alpha


def _cell_step(cell_apply: Callable, params, t, state: IterState,
               data: QPBatch, sigma,
               matvec_mode: Optional[str] = None) -> IterState:
    rho_vec, alpha = _schedules(params, t, data.eq_mask)
    g = kkt_feature(data, state.xv, state.x, state.y, state.z, sigma,
                    rho_vec, matvec_mode)
    inputs = torch.stack([state.xv, g], dim=-1)  # (B, n+m, 2)
    delta, H, C = cell_apply(params, inputs, state.H, state.C)
    xv = state.xv - delta
    x, y, z = admm_update(data, xv, state.x, state.y, state.z,
                          rho_vec, alpha, relax_z=False)
    return IterState(x=x, y=y, z=z, xv=xv, H=H, C=C)


def lstm_step(params, t, state, data, sigma) -> IterState:
    """The live model's step: plain cell, native-precision matvecs."""
    return _cell_step(cells.lstm_apply, params, t, state, data, sigma)


def make_lstm_step(use_pallas: bool = False, gate_dtype: str = "float32",
                   matvec_mode: Optional[str] = None):
    """LSTM step factory.  ``use_pallas`` (the JAX package's name, kept)
    routes the token cell through the hand-written CUDA cell kernel
    (:mod:`iadmm_tpu_torch.kernels.lstm_cell`); ``gate_dtype`` and
    ``matvec_mode`` select the precision profile."""
    if not use_pallas and matvec_mode is None:
        return lstm_step
    if use_pallas:
        from ..kernels.lstm_cell import make_pallas_lstm_apply
        apply = make_pallas_lstm_apply(gate_dtype)
    else:
        apply = cells.lstm_apply

    def step(params, t, state, data, sigma):
        return _cell_step(apply, params, t, state, data, sigma,
                          matvec_mode=matvec_mode)

    return step


@dataclasses.dataclass(frozen=True)
class SolverCellSpec:
    """Registry entry: init + step for one solver-cell variant."""
    name: str
    init: Callable
    step: Callable
    input_dim: int = 2


CELL_REGISTRY: Dict[str, SolverCellSpec] = {
    "lstm": SolverCellSpec("lstm", cells.lstm_init, lstm_step),
}

_GHOST_CELLS = ("gru", "safeguard_lstm", "multi_layer_lstm", "gd",
                "indirect_lstm")


def check_schedule_len(params: Dict, num_iters: int) -> None:
    """Fail fast when a rollout asks for more iterations than the learned
    per-iteration schedules cover."""
    for k in ("rho", "alpha"):
        if k in params and len(params[k]) < num_iters:
            raise ValueError(
                f"schedule params[{k!r}] has length {len(params[k])} but the "
                f"rollout needs {num_iters} iterations (test_outer_T must "
                f"not exceed the trained outer_T)")


def get_cell(name: str) -> SolverCellSpec:
    key = name.lower()
    if key in _GHOST_CELLS:
        raise NotImplementedError(
            f"solver cell {name!r} is not ported to PyTorch yet; "
            f"see ROADMAP.md (Queue 1, ghost cells)")
    if key not in CELL_REGISTRY:
        raise ValueError(f"unknown solver cell {name!r}; "
                         f"available: {sorted(CELL_REGISTRY)}")
    return CELL_REGISTRY[key]
