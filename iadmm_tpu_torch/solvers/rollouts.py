"""K-step learned rollouts and per-iteration evaluation traces.

Counterpart of ``iadmm_tpu/solvers/rollouts.py``; the loops are Python
loops (PyTorch runs eagerly).  The evaluation rollouts keep each
iteration's metrics on the device and stack them once at the end, so the
host fetches a batch's traces in one go.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..evaluation import metrics
from ..types import IterState, QPBatch, ScalingState
from . import exact as exact_mod
from .step import _schedules, kkt_residual

StepFn = Callable  # step(params, t, state, data, sigma) -> IterState


def rollout(step_fn: StepFn, params, state: IterState, data: QPBatch,
            sigma, num_iters: int, t0: int = 0) -> IterState:
    """Roll ``num_iters`` learned steps; returns the final state."""
    for t in range(t0, t0 + num_iters):
        state = step_fn(params, t, state, data, sigma)
    return state


def chunk_loss(step_fn: StepFn, params, state: IterState, data: QPBatch,
               sigma, chunk_len: int, outer_T: int, t0: int,
               remat: bool = False) -> Tuple[torch.Tensor, IterState]:
    """TBPTT chunk objective: the sum over the chunk's ``chunk_len`` steps
    of mean_batch(primal + dual residual), over ``outer_T``.

    ``remat=True`` recomputes each step in the backward pass
    (``torch.utils.checkpoint``): activation memory drops from one step's
    worth per step of the chunk to one step's."""
    fields = [f.name for f in dataclasses.fields(IterState)]

    def body(t, *tensors):
        st = step_fn(params, t, IterState(*tensors), data, sigma)
        _, _, loss = metrics.primal_dual_loss(st.x, st.y, st.z, data)
        return (*(getattr(st, f) for f in fields), loss.mean())

    tensors = tuple(getattr(state, f) for f in fields)
    losses = []
    for t in range(int(t0), int(t0) + chunk_len):
        if remat:
            out = checkpoint(body, t, *tensors, use_reentrant=False)
        else:
            out = body(t, *tensors)
        tensors, loss = out[:-1], out[-1]
        losses.append(loss)
    return torch.stack(losses).sum() / outer_T, IterState(*tensors)


@dataclasses.dataclass
class EvalTrace:
    """Per-iteration test-time traces, each shaped (T,): the objective,
    primal and dual residuals (original space), the scaled-space
    linear-system residual and the violation statistics."""
    obj: torch.Tensor
    primal_res: torch.Tensor
    dual_res: torch.Tensor
    ls_res: torch.Tensor
    violations: Dict[str, torch.Tensor]


def stack_traces(rows: List[Dict]) -> EvalTrace:
    """One EvalTrace from per-iteration dicts of 0-d device tensors
    (``obj``, ``primal_res``, ``dual_res``, ``ls``, ``vio``)."""
    def stack(key):
        return torch.stack([r[key] for r in rows])
    return EvalTrace(obj=stack("obj"), primal_res=stack("primal_res"),
                     dual_res=stack("dual_res"), ls_res=stack("ls"),
                     violations={k: torch.stack([r["vio"][k] for r in rows])
                                 for k in rows[0]["vio"]})


def _unscale(st: IterState, scaling: Optional[ScalingState]):
    if scaling is None:
        return st.x, st.y, st.z
    return scaling.unscale_x(st.x), scaling.unscale_y(st.y), \
        scaling.unscale_z(st.z)


def ls_norm(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """Batch mean of ‖[r1; r2]‖₂."""
    return torch.linalg.vector_norm(torch.cat([r1, r2], -1), dim=-1).mean()


def _trace_row(st: IterState, old: IterState, data_scaled: QPBatch,
               data_orig: QPBatch, scaling, sigma, rho_vec,
               metrics_mode: str) -> Dict:
    """One iteration's metrics: ‖Ã·xv_new − b̃_old‖ in the scaled space
    (b̃ from the pre-update iterates), the rest in the original space
    against the unscaled data."""
    r1, r2 = kkt_residual(data_scaled, st.xv, old.x, old.y, old.z, sigma,
                          rho_vec, metrics_mode)
    return metrics_row(st, ls_norm(r1, r2), data_orig, scaling,
                       metrics_mode)


def metrics_row(st: IterState, ls, data_orig: QPBatch, scaling,
                metrics_mode: str) -> Dict:
    """The original-space metrics of one iteration, beside its ``ls``."""
    x_u, y_u, z_u = _unscale(st, scaling)
    obj = metrics.obj_fn(x_u, data_orig.Q, data_orig.p, metrics_mode).mean()
    pr, dr = metrics.primal_dual_residual(x_u, y_u, z_u, data_orig.Q,
                                          data_orig.p, data_orig.A0,
                                          metrics_mode)
    vio = metrics.violation_stats(x_u, data_orig, metrics_mode)
    return dict(obj=obj, primal_res=pr.mean(), dual_res=dr.mean(), ls=ls,
                vio=vio)


def eval_rollout(step_fn: StepFn, params, state: IterState,
                 data_scaled: QPBatch, data_orig: QPBatch,
                 scaling: Optional[ScalingState], sigma, num_iters: int,
                 metrics_mode: str = "default"
                 ) -> Tuple[IterState, EvalTrace]:
    """Test rollout with per-iteration metrics: objective, residuals and
    violations in the original space against the unscaled data, and the
    linear-system residual in the scaled space with b̃ built from the
    pre-update iterates."""
    rows = []
    st = state
    for t in range(num_iters):
        rho_vec, _ = _schedules(params, t, data_scaled.eq_mask)
        old = st
        st = step_fn(params, t, st, data_scaled, sigma)
        rows.append(_trace_row(st, old, data_scaled, data_orig, scaling,
                               sigma, rho_vec, metrics_mode))
    return st, stack_traces(rows)


def eval_stage2(state: IterState, data_scaled: QPBatch, data_orig: QPBatch,
                scaling: Optional[ScalingState], sigma,
                rho_vec: torch.Tensor, num_iters: int,
                metrics_mode: str = "default"
                ) -> Tuple[IterState, EvalTrace]:
    """Stage-II polish (exact LU steps, one factorisation) with
    per-iteration traces.  Stage II runs on the unscaled data with the last
    learned ρ: pass ``data_scaled = data_orig``, a state mapped back with
    :func:`unscale_state`, and ``scaling=None``."""
    lu, piv = exact_mod.lu_factorize(data_scaled, sigma, rho_vec)
    rows = []
    st = state
    for _ in range(num_iters):
        old = st
        st = exact_mod.exact_step(lu, piv, rho_vec, st, data_scaled, sigma)
        rows.append(_trace_row(st, old, data_scaled, data_orig, scaling,
                               sigma, rho_vec, metrics_mode))
    return st, stack_traces(rows)


def unscale_state(state: IterState, scaling: ScalingState) -> IterState:
    """Map iterates back to the original space before Stage II."""
    return IterState(x=scaling.unscale_x(state.x),
                     y=scaling.unscale_y(state.y),
                     z=scaling.unscale_z(state.z),
                     xv=state.xv, H=state.H, C=state.C)
