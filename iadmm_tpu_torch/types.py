"""Core tensor types of the PyTorch port.

Counterpart of ``iadmm_tpu/types.py``.  Conventions are the same:

  * vectors are ``(B, k)``;
  * ``Q`` is the **doubled** Hessian, so the objective is ``0.5 xᵀQx + pᵀx``;
  * equality rows are the rows with ``zl == zu`` and both finite.

The dataclasses are frozen containers of tensors; every function that
"updates" one returns a new instance.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class QPBatch:
    """A batch of dense QP instances in OSQP form.

    minimize    0.5 xᵀ Q x + pᵀ x
    subject to  zl <= A0 x <= zu

    ``G, c, A, b, lb, ub`` are metric-only views (per-class violation
    reports); the solver never reads them.
    """

    Q: Tensor   # (B, n, n) doubled Hessian
    p: Tensor   # (B, n)
    A0: Tensor  # (B, m, n)
    zl: Tensor  # (B, m)
    zu: Tensor  # (B, m)
    eq_mask: Tensor  # (B, m) bool
    G: Optional[Tensor] = None   # (B, mi, n)
    c: Optional[Tensor] = None   # (B, mi)
    A: Optional[Tensor] = None   # (B, me, n)
    b: Optional[Tensor] = None   # (B, me)
    lb: Optional[Tensor] = None  # (B, n)
    ub: Optional[Tensor] = None  # (B, n)

    @property
    def batch(self) -> int:
        return self.Q.shape[0]

    @property
    def num_var(self) -> int:
        return self.Q.shape[-1]

    @property
    def num_constr(self) -> int:
        return self.A0.shape[-2]

    @property
    def device(self) -> torch.device:
        return self.p.device


def make_eq_mask(zl: Tensor, zu: Tensor) -> Tensor:
    """Equality rows are exactly the rows with ``zl == zu`` (both finite)."""
    return (zl == zu) & torch.isfinite(zl)


@dataclasses.dataclass(frozen=True)
class IterState:
    """ADMM + recurrent-cell iterate state: primal ``x``, dual ``y``,
    auxiliary ``z``, stacked KKT iterate ``xv = [x̃; ν]`` and the cell's
    hidden/cell states ``H, C`` over the ``n+m`` token axis."""

    x: Tensor   # (B, n)
    y: Tensor   # (B, m)
    z: Tensor   # (B, m)
    xv: Tensor  # (B, n+m)
    H: Tensor   # (B, n+m, h)
    C: Tensor   # same shape as H


def init_state(batch: int, num_var: int, num_constr: int, hidden_dim: int,
               dtype=torch.float32, hc_dtype=None,
               device="cuda") -> IterState:
    """Zero state.  ``hc_dtype`` (default: ``dtype``) sets the recurrent
    carry dtype; ``torch.bfloat16`` halves the carry's memory traffic."""
    nm = num_var + num_constr
    hc = dtype if hc_dtype is None else hc_dtype

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    return IterState(
        x=zeros((batch, num_var), dtype),
        y=zeros((batch, num_constr), dtype),
        z=zeros((batch, num_constr), dtype),
        xv=zeros((batch, nm), dtype),
        H=zeros((batch, nm, hidden_dim), hc),
        C=zeros((batch, nm, hidden_dim), hc),
    )


@dataclasses.dataclass(frozen=True)
class ScalingState:
    """Ruiz equilibration factors kept as vectors.

    Unscale maps: ``x_orig = d * x``, ``z_orig = z / e``,
    ``y_orig = (e / cost) * y``.
    """

    d: Tensor     # (B, n)
    e: Tensor     # (B, m)
    cost: Tensor  # (B,)

    def unscale_x(self, x: Tensor) -> Tensor:
        return self.d * x

    def unscale_z(self, z: Tensor) -> Tensor:
        return z / self.e

    def unscale_y(self, y: Tensor) -> Tensor:
        return (self.e / self.cost[:, None]) * y
