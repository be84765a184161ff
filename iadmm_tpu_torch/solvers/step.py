"""One learned inexact-ADMM iteration, for every solver cell.

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


def _schedules(params: Dict, t: int, eq_mask: torch.Tensor,
               fixed_alpha: float = 1.6):
    """(ρ per row, α) of learned iteration ``t``: ρ = σ(rho[t]) with the
    equality rows scaled by 1e3, α = 2σ(alpha[t]).  A cell without a
    ``rho`` schedule takes ρ = 0.1, one without ``alpha`` α = 1.6, both
    float32 as in the JAX package."""
    if "rho" in params:
        rho = torch.sigmoid(params["rho"][t])
    else:
        rho = torch.tensor(0.1, dtype=torch.float32, device=eq_mask.device)
    rho_vec = rho_vector(rho, eq_mask)
    if "alpha" in params:
        alpha = 2.0 * torch.sigmoid(params["alpha"][t])
    else:
        alpha = torch.tensor(fixed_alpha, dtype=rho_vec.dtype,
                             device=eq_mask.device)
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


def gru_step(params, t, state, data, sigma) -> IterState:
    """The GRU ablation: the LSTM step with the GRU cell."""
    return _cell_step(cells.gru_apply, params, t, state, data, sigma)


def safeguard_lstm_step(params, t, state, data, sigma) -> IterState:
    """The no-alpha ablation: learned ρ, fixed α = 1.6 (the parameter set
    has no ``alpha``)."""
    return _cell_step(cells.lstm_apply, params, t, state, data, sigma)


def multi_layer_lstm_step(params, t, state, data, sigma,
                          inner_T: int = 5) -> IterState:
    """The multi-layer ablation: ``inner_T`` shared-weight LSTM refinements
    of xv per ADMM iteration against the same b̃, fixed schedules."""
    rho_vec, alpha = _schedules(params, t, data.eq_mask)
    xv, H, C = state.xv, state.H, state.C
    for _ in range(inner_T):
        g = kkt_feature(data, xv, state.x, state.y, state.z, sigma, rho_vec)
        delta, H, C = cells.lstm_apply(params, torch.stack([xv, g], dim=-1),
                                       H, C)
        xv = xv - delta
    x, y, z = admm_update(data, xv, state.x, state.y, state.z,
                          rho_vec, alpha, relax_z=False)
    return IterState(x=x, y=y, z=z, xv=xv, H=H, C=C)


def gd_step(params, t, state, data, sigma) -> IterState:
    """The non-learned baseline: a plain gradient step on the KKT
    residual, xv ← xv − lr·Ãᵀ(Ã·xv − b̃); H and C pass through."""
    rho_vec, alpha = _schedules(params, t, data.eq_mask)
    g = kkt_feature(data, state.xv, state.x, state.y, state.z, sigma, rho_vec)
    lr = params["lr"] if "lr" in params else torch.tensor(
        1e-3, dtype=torch.float32, device=g.device)
    xv = state.xv - lr * g
    x, y, z = admm_update(data, xv, state.x, state.y, state.z,
                          rho_vec, alpha, relax_z=False)
    return IterState(x=x, y=y, z=z, xv=xv, H=state.H, C=state.C)


def indirect_system(data: QPBatch, x, y, z, sigma, rho_vec):
    """The reduced (normal-equation) system of the indirect variant:
    ``(matvec_M, rhs)`` with M = Q + σI + A0ᵀdiag(ρ)A0 and
    rhs = σx − p + A0ᵀ(ρ∘z − y), the Schur complement of the KKT system
    after eliminating ν = ρ∘(A0x̃ − z) + y."""

    def matvec_M(v):
        return (bmv(data.Q, v) + sigma * v
                + bmv_t(data.A0, rho_vec * bmv(data.A0, v)))

    rhs = sigma * x - data.p + bmv_t(data.A0, rho_vec * z - y)
    return matvec_M, rhs


def indirect_lstm_step(params, t, state, data, sigma) -> IterState:
    """The indirect ablation: the LSTM over the n variable tokens of the
    reduced system M x̃ = rhs (:func:`indirect_system`), z̃ = A0·x̃.
    ``xv[:, :n]`` carries x̃; H and C keep their (B, n+m, h) layout and
    only their first n tokens change."""
    n = data.num_var
    rho_vec, alpha = _schedules(params, t, data.eq_mask)
    x_t = state.xv[:, :n]
    matvec_M, rhs = indirect_system(data, state.x, state.y, state.z,
                                    sigma, rho_vec)
    g = matvec_M(matvec_M(x_t) - rhs)
    delta, Hn, Cn = cells.lstm_apply(params, torch.stack([x_t, g], dim=-1),
                                     state.H[:, :n], state.C[:, :n])
    x_t = x_t - delta
    z_t = bmv(data.A0, x_t)
    x_new = alpha * x_t + (1.0 - alpha) * state.x
    z_new = torch.maximum(torch.minimum(z_t + state.y / rho_vec, data.zu),
                          data.zl)
    y_new = state.y + rho_vec * (z_t - z_new)
    # out of place, so autograd sees the write
    xv = torch.cat([x_t, state.xv[:, n:]], dim=1)
    H = torch.cat([Hn, state.H[:, n:]], dim=1)
    C = torch.cat([Cn, state.C[:, n:]], dim=1)
    return IterState(x=x_new, y=y_new, z=z_new, xv=xv, H=H, C=C)


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


def _gd_init(generator: torch.Generator, input_dim: int, hidden_dim: int,
             length: int, dtype=torch.float32, device="cuda",
             lr: float = 1e-3) -> Dict:
    """The GD baseline's parameters: a 0-d step size ``lr`` and raw rho /
    alpha schedules N(0, 0.01²)."""
    gdev = generator.device

    def normal():
        return (0.01 * torch.randn((length,), generator=generator,
                                   dtype=dtype, device=gdev)).to(device)

    rho = normal()
    return {"lr": torch.tensor(lr, dtype=dtype, device=device), "rho": rho,
            "alpha": normal()}


def _multi_layer_init(generator, input_dim, hidden_dim, length,
                      dtype=torch.float32, device="cuda", inner_T: int = 5):
    return cells.multi_layer_lstm_init(generator, input_dim, hidden_dim,
                                       inner_T, dtype, device)


CELL_REGISTRY: Dict[str, SolverCellSpec] = {
    "lstm": SolverCellSpec("lstm", cells.lstm_init, lstm_step),
    "gru": SolverCellSpec("gru", cells.gru_init, gru_step),
    "safeguard_lstm": SolverCellSpec(
        "safeguard_lstm", cells.safeguard_lstm_init, safeguard_lstm_step),
    "multi_layer_lstm": SolverCellSpec(
        "multi_layer_lstm", _multi_layer_init, multi_layer_lstm_step),
    "gd": SolverCellSpec("gd", _gd_init, gd_step),
    "indirect_lstm": SolverCellSpec(
        "indirect_lstm", cells.lstm_init, indirect_lstm_step),
}


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
    if key not in CELL_REGISTRY:
        raise ValueError(f"unknown solver cell {name!r}; "
                         f"available: {sorted(CELL_REGISTRY)}")
    return CELL_REGISTRY[key]
