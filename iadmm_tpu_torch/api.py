"""High-level solve API.

Counterpart of ``iadmm_tpu/api.py``: Ruiz scaling → learned rollout →
unscale → optional Stage-II exact polish → residuals and objective, for a
batch of instances.  The pipeline runs on the device the data lives on.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .types import QPBatch, IterState, init_state
from .scaling import scale_batch
from .solvers.step import (get_cell, make_lstm_step, _schedules,
                           check_schedule_len)
from .solvers.rollouts import rollout, unscale_state
from .solvers import exact as exact_mod
from .evaluation import metrics


@dataclasses.dataclass(frozen=True)
class SolveResult:
    x: torch.Tensor            # (B, n) primal solution (original space)
    y: torch.Tensor            # (B, m) dual
    z: torch.Tensor            # (B, m) auxiliary
    primal_res: torch.Tensor   # (B,)
    dual_res: torch.Tensor     # (B,)
    obj: torch.Tensor          # (B,)


_STAGE2_IMPLS = ("auto", "lu", "fused", "fused-direct", "cg")


def make_solver(params: Dict, *, hidden_dim: int, num_iters: int,
                sigma: float = 6e-6, scaling_iters: int = 10,
                feas_rest_num: int = 0, use_pallas: bool = False,
                gate_dtype: str = "float32",
                matvec_mode: Optional[str] = None,
                model_name: str = "lstm",
                rollout_impl: str = "step",
                stage2_impl: str = "auto"):
    """Build ``solve(data: QPBatch) -> SolveResult``.

    ``feas_rest_num > 0`` appends Stage-II exact polish with the last
    learned ρ.  ``rollout_impl='fused'`` runs the K learned iterations in
    the CUDA rollout kernel (:mod:`kernels.rollout_kernel`); ``'step'`` runs
    the step path, whose token cell goes through the CUDA cell kernel when
    ``use_pallas`` (the JAX package's name for the switch, kept).
    ``stage2_impl``: 'lu' (factor once, ``torch.linalg``), 'fused' (the
    CUDA Stage-II kernel, solver 'kkt'), 'fused-direct' (the same kernel's
    condensed-system M⁻¹ solver 'direct', accuracy-limited at cond(M)) or
    'cg' (matrix-free Jacobi CG in plain PyTorch, :mod:`solvers.cg`);
    'auto' resolves to 'fused' for CUDA data and 'lu' for CPU data.  On
    CPU data the fused solvers run their plain twins.

    ``model_name`` selects the step of ``rollout_impl='step'``.  The fused
    rollout runs the LSTM algorithm whatever ``model_name`` says, as the
    JAX package's does: ``indirect_lstm`` parameters run there as an LSTM,
    and a parameter dict without the LSTM's keys and shapes raises
    ValueError.
    """
    if stage2_impl not in _STAGE2_IMPLS:
        raise ValueError(f"unknown stage2_impl {stage2_impl!r}")
    if rollout_impl not in ("step", "fused"):
        raise ValueError(f"unknown rollout_impl {rollout_impl!r}")
    check_schedule_len(params, num_iters)
    if model_name == "lstm" and (use_pallas or matvec_mode):
        step_fn = make_lstm_step(use_pallas=use_pallas,
                                 gate_dtype=gate_dtype,
                                 matvec_mode=matvec_mode)
    else:
        step_fn = get_cell(model_name).step
    hc_dtype = torch.bfloat16 if gate_dtype == "bfloat16" else torch.float32

    @torch.no_grad()
    def solve(data: QPBatch) -> SolveResult:
        B = data.batch
        dev = data.device
        scaled, sc = scale_batch(data, iters=scaling_iters) \
            if scaling_iters else (data, None)
        if rollout_impl == "fused":
            from .kernels.rollout_kernel import fused_rollout
            x, y, z = fused_rollout(params, scaled, hidden=hidden_dim,
                                    K=num_iters, sigma=sigma)
            st = IterState(x=x, y=y, z=z, xv=torch.cat([x, y], -1),
                           H=torch.zeros((B, 1, 1), dtype=hc_dtype,
                                         device=dev),
                           C=torch.zeros((B, 1, 1), dtype=hc_dtype,
                                         device=dev))
        else:
            st = init_state(B, data.num_var, data.num_constr, hidden_dim,
                            dtype=data.p.dtype, hc_dtype=hc_dtype,
                            device=dev)
            st = rollout(step_fn, params, st, scaled, sigma, num_iters)
        if sc is not None:
            st = unscale_state(st, sc)
        if feas_rest_num:
            rho_vec, _ = _schedules(params, num_iters - 1, data.eq_mask)
            impl = stage2_impl
            if impl == "auto":
                impl = "fused" if data.p.is_cuda else "lu"
            if impl in ("fused", "fused-direct"):
                from .kernels.stage2_kernel import fused_stage2
                st, _, _ = fused_stage2(
                    st, data, rho_vec, num_iters=feas_rest_num, sigma=sigma,
                    solver="direct" if impl == "fused-direct" else "kkt")
            elif impl == "cg":
                from .solvers.cg import feasibility_restoration_cg
                st = feasibility_restoration_cg(st, data, sigma, rho_vec,
                                                feas_rest_num)
            else:
                st = exact_mod.feasibility_restoration(
                    st, data, sigma, rho_vec, feas_rest_num)
        pr, dr = metrics.primal_dual_residual(
            st.x, st.y, st.z, data.Q, data.p, data.A0, "default")
        obj = metrics.obj_fn(st.x, data.Q, data.p, "default")
        return SolveResult(x=st.x, y=st.y, z=st.z, primal_res=pr,
                           dual_res=dr, obj=obj)

    return solve


def solve_qp_batch(data: QPBatch, params: Dict, *, hidden_dim: int,
                   num_iters: int, **kw) -> SolveResult:
    """One-shot convenience wrapper around :func:`make_solver`."""
    return make_solver(params, hidden_dim=hidden_dim,
                       num_iters=num_iters, **kw)(data)
