"""Theory-condition traces of the paper's inexactness analysis.

Counterpart of ``iadmm_tpu/evaluation/theory.py``: per test batch, a
rollout of the evaluation's own step that records, after each iteration,
the x-subproblem, z-subproblem and relaxation conditions, in the original
(unscaled) space against the unscaled data:

  * ``sigma_Q_max`` / ``sigma_AA_min``: the extreme eigenvalues of
    instance 0's float32 Q and A0ᵀA0 (:func:`extreme_eigs`);
  * ``x_tild`` = D·xv[:n], the pre-relaxation iterate, unscaled;
  * ``rho_norm``: batch mean of ‖ρ‖₂ of the step's ρ vector;
  * constants cx = cz = 1, and the (1.1, 0.9) slack factors of the
    beta_x / beta_z / alpha conditions.

Entry t=0 of every trace is NaN (the conditions compare successive
iterates).  ``x_cond_2_*`` are ``(T, B)`` (per instance); every other key
is ``(T,)``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..solvers.rollouts import _unscale
from ..solvers.step import _schedules
from ..types import IterState, QPBatch, ScalingState
from . import metrics

COND_KEYS = ("x_cond_1_left", "x_cond_2_left", "x_cond_2_right",
             "z_cond_1_left", "z_cond_1_right", "z_cond_2_left",
             "z_cond_2_right", "alpha_cond_left", "alpha_cond_right")

# The keys kept per instance, (T, B); the rest are batch means, (T,).
PER_INSTANCE_KEYS = ("x_cond_2_left", "x_cond_2_right")


def _norm(v):
    return torch.linalg.vector_norm(v, dim=-1)


def extreme_eigs(data_orig: QPBatch):
    """(largest eigenvalue of Q, smallest of A0ᵀA0) of instance 0, from
    its float32 matrices."""
    Q0 = data_orig.Q[0].to(torch.float32)
    A00 = data_orig.A0[0].to(torch.float32)
    return (torch.linalg.eigvalsh(Q0)[-1],
            torch.linalg.eigvalsh(A00.T @ A00)[0])


def theory_rollout(step_fn, params, state: IterState, data_scaled: QPBatch,
                   data_orig: QPBatch, scaling: Optional[ScalingState],
                   sigma, num_iters: int,
                   metrics_mode: str = "default") -> Dict[str, torch.Tensor]:
    """Per-iteration theory-condition traces, stacked over the
    ``num_iters`` iterations (see the module docstring)."""
    n = data_orig.num_var
    cx = cz = 1.0
    sigma_q_max, sigma_aa_min = extreme_eigs(data_orig)

    def aug(x, z, y, rho_vec):
        return metrics.aug_lagr(x, z, y, data_orig.Q, data_orig.p,
                                data_orig.A0, rho_vec).mean()

    def bmv(M, v):
        return metrics.bmv(M, v, metrics_mode)

    def bmv_t(M, v):
        return metrics.bmv_t(M, v, metrics_mode)

    rows = []
    st = state
    for t in range(num_iters):
        rho_vec, _ = _schedules(params, t, data_scaled.eq_mask)
        old = st
        st = step_fn(params, t, st, data_scaled, sigma)
        x_pre, y_pre, z_pre = _unscale(old, scaling)
        x_u, y_u, z_u = _unscale(st, scaling)
        xv_x = st.xv[:, :n]
        x_tild = scaling.d * xv_x if scaling is not None else xv_x
        rho_norm = _norm(rho_vec).mean()

        # x subproblem, condition 1
        beta_x = (2 * 1.1 / 0.9) * (
            2 * (sigma_q_max / rho_norm + cx) ** 2 + 8 * cx ** 2
        ) / sigma_aa_min
        x_diff = _norm(x_tild - x_pre).mean() ** 2
        x1l = (rho_norm * x_diff * beta_x) / 2 + aug(x_tild, z_pre, y_pre,
                                                     rho_vec)

        # x subproblem, condition 2 (per instance)
        grad = (bmv(data_orig.Q, x_tild) + data_orig.p
                + bmv_t(data_orig.A0, y_pre)
                + bmv_t(data_orig.A0,
                        rho_vec * (bmv(data_orig.A0, x_tild) - z_pre)))
        x2l = _norm(grad)
        x2r = cx * rho_norm * _norm(x_tild - x_pre)

        # z subproblem, condition 1
        z1r = aug(x_tild, z_pre, y_pre, rho_vec)
        beta_z = (32 * 1.1) / ((sigma_aa_min ** 2) * 0.9)
        z_diff = _norm(z_u - z_pre).mean() ** 2
        z1l = (rho_norm * z_diff * beta_z) / 2 + aug(x_tild, z_u, y_pre,
                                                     rho_vec)

        # z subproblem, condition 2
        resid = y_pre + rho_vec * (bmv(data_orig.A0, x_tild) - z_u)
        at_upper = (z_u == data_orig.zu) & (resid > 0)
        at_lower = (z_u == data_orig.zl) & (resid < 0)
        z_part_grad = torch.where(at_upper | at_lower,
                                  torch.zeros_like(resid), -resid)
        z2l = _norm(z_part_grad).mean()
        z2r = (cz * rho_norm * (_norm(z_u - z_pre)
                                + _norm(x_tild - x_pre))).mean()

        # relaxation (alpha) condition
        al = aug(x_u, z_u, y_u, rho_vec)
        a_diff = _norm(x_u - x_tild).mean() ** 2
        ar = aug(x_tild, z_u, y_u, rho_vec) - 0.9 * rho_norm * a_diff

        row = dict(zip(COND_KEYS, (x1l, x2l, x2r, z1l, z1r, z2l, z2r,
                                   al, ar)))
        if t == 0:
            row = {k: torch.full_like(v, float("nan"))
                   for k, v in row.items()}
        rows.append(row)
    return {k: torch.stack([r[k] for r in rows]) for k in COND_KEYS}
