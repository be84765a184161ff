"""Modified Ruiz equilibration of the KKT matrix + cost normalisation.

Counterpart of ``iadmm_tpu/scaling/ruiz.py``, with the same numerics:

  * per-column infinity norms of the stacked KKT matrix ``[[Q, A0ᵀ],[A0, 0]]``;
  * clamp to [1e-4, 1e4] with clamped-to-MIN entries reset to 1.0;
  * per-sweep cost normalisation by max(mean column norm of Q, ‖p‖_inf).

The factors are kept as vectors ``d (B,n)``, ``e (B,m)``, ``cost (B,)``.

CUDA tensors go through one launch of ``kernels/csrc/ruiz.cu``
(``kernels/ruiz_kernel.py``); every other tensor through the plain
function, :func:`ruiz_scale_plain`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..types import QPBatch, ScalingState

MIN_SCALING = 1e-4
MAX_SCALING = 1e4


def _limit_scaling(v: torch.Tensor) -> torch.Tensor:
    clamped = torch.clamp(v, MIN_SCALING, MAX_SCALING)
    return torch.where(clamped == MIN_SCALING,
                       torch.ones_like(clamped), clamped)


def ruiz_scale(Q, p, A0, zl, zu, iters: int = 10):
    """Scale (Q, p, A0, zl, zu); return scaled data + ScalingState.

    Shapes: Q (B,n,n), p (B,n), A0 (B,m,n), zl/zu (B,m).  ±inf bounds stay
    infinite under the positive row factors.  CUDA data: the kernel
    (float32 only; ``ruiz_kernel.ruiz_scale_cuda``); else
    :func:`ruiz_scale_plain`."""
    if Q.is_cuda:
        from ..kernels.ruiz_kernel import ruiz_scale_cuda
        return ruiz_scale_cuda(Q, p, A0, zl, zu, iters=iters)
    return ruiz_scale_plain(Q, p, A0, zl, zu, iters=iters)


def ruiz_scale_plain(Q, p, A0, zl, zu, iters: int = 10, col_mean=None):
    """The plain function of :func:`ruiz_scale`, on any device.
    ``col_mean``: the mean over the last dimension in the cost norm (None:
    ``torch.mean``)."""
    B, n = p.shape
    m = A0.shape[-2]
    kw = dict(dtype=Q.dtype, device=Q.device)
    d = torch.ones((B, n), **kw)
    e = torch.ones((B, m), **kw)
    cost = torch.ones((B,), **kw)

    for _ in range(iters):
        norm_q_cols = Q.abs().amax(dim=-2)
        norm_a_cols = A0.abs().amax(dim=-2)
        first = torch.maximum(norm_q_cols, norm_a_cols)
        second = A0.abs().amax(dim=-1)
        norms = _limit_scaling(torch.cat([first, second], dim=-1))
        s = 1.0 / torch.sqrt(norms)
        dt = s[:, :n]
        et = s[:, n:]

        Q = dt[:, :, None] * Q * dt[:, None, :]
        A0 = et[:, :, None] * A0 * dt[:, None, :]
        p = dt * p
        zl = et * zl
        zu = et * zu
        d = dt * d
        e = et * e

        q_cols = Q.abs().amax(dim=-2)
        norm_q_mean = (q_cols.mean(dim=-1) if col_mean is None
                       else col_mean(q_cols))
        inf_norm_p = _limit_scaling(p.abs().amax(dim=-1))
        scale_cost = _limit_scaling(torch.maximum(inf_norm_p, norm_q_mean))
        c_temp = 1.0 / scale_cost
        Q = c_temp[:, None, None] * Q
        p = c_temp[:, None] * p
        cost = c_temp * cost

    return Q, p, A0, zl, zu, ScalingState(d=d, e=e, cost=cost)


def scale_batch(data: QPBatch, iters: int = 10
                ) -> Tuple[QPBatch, ScalingState]:
    """Scale a QPBatch in solver space; metric-only views stay unscaled."""
    Q, p, A0, zl, zu, st = ruiz_scale(data.Q, data.p, data.A0,
                                      data.zl, data.zu, iters=iters)
    scaled = QPBatch(Q=Q, p=p, A0=A0, zl=zl, zu=zu, eq_mask=data.eq_mask,
                     G=data.G, c=data.c, A=data.A, b=data.b,
                     lb=data.lb, ub=data.ub)
    return scaled, st
