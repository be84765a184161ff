"""Sparse problem data through the learned solver: BCOO and BSR.

Counterpart of ``iadmm_tpu/kernels/sparse.py``.  Two batch layouts expose
the three solver matvecs ``Qv``/``Av``/``ATv``, and the step, loss, metric
and evaluation functions below take either:

  * :class:`SparseQPBatch` (``sparse_format='bcoo'``, the default): Q and A0
    as :class:`~iadmm_tpu_torch.kernels.bcoo.BCOOMatrix` batches with the
    JAX package's nse, each matvec a gather-based sum per row or column,
    differentiable with the JAX package's VJP;
  * :class:`BSRQPBatch` (``'bsr'``): Q, A0 and A0ᵀ as :class:`BSRMatrix`
    tiles, each matvec the BSR kernel on the card (:func:`bsr_matvec_ad`);
    the step's products whose vectors are ready together go as one grouped
    launch (:meth:`BSRQPBatch.group`), forward and backward.

The learned cell is the plain :func:`cells.lstm_apply` with float32 gates,
as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..solvers import cells
from ..solvers.rollouts import ls_norm, metrics_row, stack_traces
from ..solvers.step import _schedules, admm_update
from ..types import IterState, QPBatch
from .bcoo import BCOOMatrix, bcoo_from_dense, bcoo_matvec, bcoo_matvec_t
from .sparse_matvec import BSRMatrix, bsr_from_dense, bsr_matvec_ad, \
    bsr_matvec_group_ad, bsr_pair_from_dense


@dataclasses.dataclass(frozen=True)
class SparseQPBatch:
    """QP batch with BCOO Q and A0 (one padded nse per operand)."""

    Q: BCOOMatrix     # (B, n, n)
    p: torch.Tensor   # (B, n)
    A0: BCOOMatrix    # (B, m, n)
    zl: torch.Tensor
    zu: torch.Tensor
    eq_mask: torch.Tensor

    @property
    def num_var(self) -> int:
        return self.Q.shape[-1]

    @property
    def num_constr(self) -> int:
        return self.A0.shape[0]

    def Qv(self, v: torch.Tensor) -> torch.Tensor:
        return bcoo_matvec(self.Q, v)

    def Av(self, v: torch.Tensor) -> torch.Tensor:
        return bcoo_matvec(self.A0, v)

    def ATv(self, v: torch.Tensor) -> torch.Tensor:
        return bcoo_matvec_t(self.A0, v)


@dataclasses.dataclass(frozen=True)
class BSRQPBatch:
    """QP batch with tile-sparse Q, A0 and A0ᵀ (the transpose stored as a
    second operand).  Q is symmetric for every family (Ruiz scaling keeps
    it so), so ``Qv`` passes Q as its own transpose."""

    Q: BSRMatrix      # (n, n) per instance
    p: torch.Tensor   # (B, n)
    A0: BSRMatrix     # (m, n)
    A0T: BSRMatrix    # (n, m)
    zl: torch.Tensor
    zu: torch.Tensor
    eq_mask: torch.Tensor

    @property
    def num_var(self) -> int:
        return self.Q.shape[-1]

    @property
    def num_constr(self) -> int:
        return self.A0.shape[0]

    def Qv(self, v: torch.Tensor) -> torch.Tensor:
        return bsr_matvec_ad(self.Q, self.Q, v)

    def Av(self, v: torch.Tensor) -> torch.Tensor:
        return bsr_matvec_ad(self.A0, self.A0T, v)

    def ATv(self, v: torch.Tensor) -> torch.Tensor:
        return bsr_matvec_ad(self.A0T, self.A0, v)

    def group(self, *products) -> Tuple[torch.Tensor, ...]:
        """Up to three products in one launch, forward and backward:
        ``products`` are ``(name, v)`` with name ``'Q'``, ``'A0'`` or
        ``'A0T'``; returns each product, in order, as ``Qv``/``Av``/``ATv``
        would."""
        pairs = dict(Q=(self.Q, self.Q), A0=(self.A0, self.A0T),
                     A0T=(self.A0T, self.A0))
        return bsr_matvec_group_ad([pairs[nm] for nm, _ in products],
                                   [v for _, v in products])


def tile_dtype(matvec_mode: str) -> torch.dtype:
    """BSR tile storage of a precision profile: bf16 tiles pair with the
    bf16 matvec profile, float32 tiles otherwise."""
    return torch.bfloat16 if matvec_mode == "bf16" else torch.float32


def from_dense(data: QPBatch, fmt: str = "bcoo", tile=(8, 128),
               dtype=torch.float32, nse_pad: int = 1024, min_nse=(0, 0)):
    """Convert a dense QPBatch to a sparse layout on its device.

    ``fmt='bcoo'``: :class:`SparseQPBatch`, each operand's nse the largest
    nonzero count over the batch rounded up to a multiple of ``nse_pad``,
    at least ``min_nse`` (Q, A0), at most the dense size.  The values keep
    the batch's dtype whatever ``dtype`` says, as in the JAX package, whose
    BCOO branch takes no ``dtype``.  ``fmt='bsr'``: :class:`BSRQPBatch`,
    Q, A0 and A0ᵀ tiled on the host with ``tile`` tiles stored as
    ``dtype``."""
    if fmt == "bcoo":
        return SparseQPBatch(Q=bcoo_from_dense(data.Q, nse_pad, min_nse[0]),
                             p=data.p,
                             A0=bcoo_from_dense(data.A0, nse_pad, min_nse[1]),
                             zl=data.zl, zu=data.zu, eq_mask=data.eq_mask)
    if fmt != "bsr":
        raise ValueError(f"unknown sparse format {fmt!r}")
    dev = data.p.device
    A0, A0T = bsr_pair_from_dense(data.A0, tile, dtype, dev)
    return BSRQPBatch(Q=bsr_from_dense(data.Q, tile, dtype, device=dev),
                      p=data.p, A0=A0, A0T=A0T,
                      zl=data.zl, zu=data.zu, eq_mask=data.eq_mask)


# On the BSR route each group of products below is one launch.  The order
# within a group is autograd's: a vector given to two products of a group
# (u, r1, x) gets their two gradient contributions in the group's order, and
# that order (A0·v before Q·v) is the one in which autograd sums them when
# each product is its own node, so the gradients are the ungrouped route's
# bitwise.


def kkt_residual_sparse(data, u, nu, x, y, z, sigma, rho_vec):
    """(r1, r2) = Ã·xv − b̃ in blocks, with xv = (u, ν)."""
    if isinstance(data, BSRQPBatch):
        Au, ATnu, Qu = data.group(("A0", u), ("A0T", nu), ("Q", u))
        r1 = Qu + sigma * u + ATnu - (sigma * x - data.p)
        r2 = Au - nu / rho_vec - (z - y / rho_vec)
        return r1, r2
    r1 = data.Qv(u) + sigma * u + data.ATv(nu) - (sigma * x - data.p)
    r2 = data.Av(u) - nu / rho_vec - (z - y / rho_vec)
    return r1, r2


def kkt_feature_sparse(data, xv, x, y, z, sigma, rho_vec) -> torch.Tensor:
    """g = Ãᵀ(Ã·xv − b̃) with every Q/A0 product a sparse matvec (the dense
    blockwise algebra is :func:`solvers.step.kkt_feature`)."""
    n = data.num_var
    u, nu = xv[:, :n], xv[:, n:]
    r1, r2 = kkt_residual_sparse(data, u, nu, x, y, z, sigma, rho_vec)
    if isinstance(data, BSRQPBatch):
        Ar1, ATr2, Qr1 = data.group(("A0", r1), ("A0T", r2), ("Q", r1))
        g1 = Qr1 + sigma * r1 + ATr2
        g2 = Ar1 - r2 / rho_vec
    else:
        g1 = data.Qv(r1) + sigma * r1 + data.ATv(r2)
        g2 = data.Av(r1) - r2 / rho_vec
    return torch.cat([g1, g2], dim=-1)


def sparse_lstm_step(params, t, state: IterState, data,
                     sigma) -> IterState:
    """Learned LSTM step over sparse problem data (the numerics of
    :func:`solvers.step.lstm_step`)."""
    rho_vec, alpha = _schedules(params, t, data.eq_mask)
    g = kkt_feature_sparse(data, state.xv, state.x, state.y, state.z,
                           sigma, rho_vec)
    inputs = torch.stack([state.xv, g], dim=-1)
    delta, H, C = cells.lstm_apply(params, inputs, state.H, state.C)
    xv = state.xv - delta
    x, y, z = admm_update(data, xv, state.x, state.y, state.z,
                          rho_vec, alpha, relax_z=False)
    return IterState(x=x, y=y, z=z, xv=xv, H=H, C=C)


def primal_dual_residual_sparse(x, y, z, data):
    """(‖A0x − z‖₂, ‖Qx + p + A0ᵀy‖₂) per instance, sparse matvecs."""
    if isinstance(data, BSRQPBatch):
        Qx, ATy, Ax = data.group(("Q", x), ("A0T", y), ("A0", x))
        pr = torch.linalg.vector_norm(Ax - z, dim=-1)
        dr = torch.linalg.vector_norm(Qx + data.p + ATy, dim=-1)
        return pr, dr
    pr = torch.linalg.vector_norm(data.Av(x) - z, dim=-1)
    dr = torch.linalg.vector_norm(data.Qv(x) + data.p + data.ATv(y), dim=-1)
    return pr, dr


def obj_fn_sparse(x, data) -> torch.Tensor:
    """0.5 xᵀQx + pᵀx per instance, the Q product sparse."""
    return 0.5 * (x * data.Qv(x)).sum(-1) + (data.p * x).sum(-1)


def chunk_loss_sparse(params, state: IterState, data, sigma,
                      chunk_len: int, outer_T: int, t0: int,
                      remat: bool = False) -> Tuple[torch.Tensor, IterState]:
    """TBPTT chunk objective over sparse problem data: the sum over the
    chunk of mean_batch(primal + dual residual), over ``outer_T``.
    ``remat=True`` recomputes each step in the backward pass."""
    fields = [f.name for f in dataclasses.fields(IterState)]

    def body(t, *tensors):
        st = sparse_lstm_step(params, t, IterState(*tensors), data, sigma)
        pr, dr = primal_dual_residual_sparse(st.x, st.y, st.z, data)
        return (*(getattr(st, f) for f in fields), (pr + dr).mean())

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


def make_sparse_chunk_loss(sigma, chunk_len: int, outer_T: int,
                           remat: bool = False, mesh=None):
    """The harness's loss hook for the sparse route: ``loss_fn(params,
    state, data, t0) -> (loss, state')``.  Single device only."""
    if mesh is not None:
        raise NotImplementedError(
            "data-parallel sparse training is not ported to PyTorch yet; "
            "see ROADMAP.md (Queue 1, distribution)")

    def loss_fn(p, st, data, t0):
        return chunk_loss_sparse(p, st, data, sigma, chunk_len, outer_T, t0,
                                 remat=remat)
    return loss_fn


def eval_rollout_sparse(params, state: IterState, data_sp,
                        data_orig: QPBatch, scaling, sigma, num_iters: int,
                        metrics_mode: str = "default"):
    """Test rollout with per-iteration metrics, the solver matvecs sparse.

    The solver path runs on the scaled sparse data; the metrics are taken in
    the original space against the dense unscaled data, and the scaled-space
    residual ‖Ã·xv_new − b̃_old‖ with sparse matvecs.  Traces stay on the
    device, stacked over the iterations."""
    n = data_sp.num_var
    rows = []
    st = state
    for t in range(num_iters):
        rho_vec, _ = _schedules(params, t, data_sp.eq_mask)
        old = st
        st = sparse_lstm_step(params, t, st, data_sp, sigma)
        r1, r2 = kkt_residual_sparse(data_sp, st.xv[:, :n], st.xv[:, n:],
                                     old.x, old.y, old.z, sigma, rho_vec)
        rows.append(metrics_row(st, ls_norm(r1, r2), data_orig, scaling,
                                metrics_mode))
    return st, stack_traces(rows)
