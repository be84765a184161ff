"""Synthetic QP family generators.

A verbatim numpy copy of ``iadmm_tpu/problems/generators.py``: the port
may not import the JAX package, and the same seed must give the same
arrays in both packages.

Reimplements the five distributions of the reference generator
(reference: generate_data.py:31-228) with NumPy on host, but batched: a whole
dataset is produced as stacked arrays instead of one gzip pickle per instance.

Conventions preserved from the reference:
  * the stored ``Q`` is the *half* Hessian; loaders double it
    (``P = 2*Q`` fed to the oracle, reference: generate_data.py:79 and
    main.py:298).  ``RawDataset.Q`` here is the half Hessian; use
    :func:`iadmm_tpu_torch.problems.io.to_qp_batch` to get the doubled solver form.
  * feasibility trick ``c = sum_cols |G @ pinv(A)|`` for the QP/QP_RHS
    families (reference: generate_data.py:40, 72).
  * the SVM family appends slack variables and identity box rows into ``A0``
    (reference: generate_data.py:186-207).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class RawDataset:
    """Host-side dataset: per-instance arrays stacked on a leading axis.

    ``Q`` is the HALF Hessian (reference storage convention).  Fields that a
    family does not define are ``None``.  ``x_opt, y_opt`` are oracle labels
    (filled by the oracle, not yet ported).
    """

    prob_type: str
    Q: np.ndarray            # (N, n, n) half Hessian
    p: np.ndarray            # (N, n)
    A0: np.ndarray           # (N, m, n)
    zl: np.ndarray           # (N, m)
    zu: np.ndarray           # (N, m)
    G: Optional[np.ndarray] = None   # (N, mi, n)
    c: Optional[np.ndarray] = None   # (N, mi)
    A: Optional[np.ndarray] = None   # (N, me, n)
    b: Optional[np.ndarray] = None   # (N, me)
    lb: Optional[np.ndarray] = None  # (N, n)
    ub: Optional[np.ndarray] = None  # (N, n)
    x_opt: Optional[np.ndarray] = None  # (N, n)
    y_opt: Optional[np.ndarray] = None  # (N, m)

    @property
    def size(self) -> int:
        # zl always carries the true instance count (shared-data families
        # store per-instance bounds but dim-1 shared matrices).
        return self.zl.shape[0]

    def slice(self, idx) -> "RawDataset":
        def take(a):
            if a is None:
                return None
            return a if a.shape[0] == 1 else a[idx]  # dim-1 = shared
        return RawDataset(
            prob_type=self.prob_type,
            Q=take(self.Q), p=take(self.p), A0=take(self.A0),
            zl=self.zl[idx], zu=self.zu[idx],
            G=take(self.G), c=take(self.c), A=take(self.A), b=take(self.b),
            lb=take(self.lb), ub=take(self.ub),
            x_opt=take(self.x_opt), y_opt=take(self.y_opt),
        )


def _stack_ineq_eq(G, c, A, b):
    """A0 = [G; A], zl = [-inf; b], zu = [c; b] (reference: generate_data.py:74-76)."""
    A0 = np.concatenate([G, A], axis=-2)
    zl = np.concatenate([np.full(c.shape, -np.inf, dtype=c.dtype), b],
                        axis=-1)
    zu = np.concatenate([c, b], axis=-1)
    return A0, zl, zu


def generate_qp(num_var: int, num_ineq: int, num_eq: int, data_size: int,
                rng: np.random.Generator) -> RawDataset:
    """``QP`` family: per-instance diagonal Q, Gaussian A/G, feasible c
    (reference: generate_data.py:63-94).

    Built float32 (the reference generates with torch's default f32 too);
    at the 1500-var size the f64 construction needs ~75 GB host RAM and
    doubles the on-disk npz for no downstream benefit (the device path is
    f32/bf16 and the oracle re-solves in f64 regardless)."""
    n, mi, me, N = num_var, num_ineq, num_eq, data_size
    f32 = np.float32
    Qdiag = 0.5 * rng.random((N, n), dtype=f32)
    Q = np.zeros((N, n, n), dtype=f32)
    Q[:, np.arange(n), np.arange(n)] = Qdiag
    p = rng.random((N, n), dtype=f32)
    A = rng.standard_normal((N, me, n), dtype=f32)
    b = (2.0 * rng.random((N, me), dtype=f32) - 1.0).astype(f32)
    G = rng.standard_normal((N, mi, n), dtype=f32)
    # feasibility trick: c = sum_cols |G @ pinv(A)| guarantees a feasible x.
    c = np.abs(G @ np.linalg.pinv(A)).sum(axis=-1)
    A0, zl, zu = _stack_ineq_eq(G, c, A, b)
    return RawDataset("QP", Q, p, A0, zl, zu, G=G, c=c, A=A, b=b)


def generate_qp_rhs(num_var: int, num_ineq: int, num_eq: int, data_size: int,
                    rng: np.random.Generator) -> RawDataset:
    """``QP_RHS`` family: one shared (Q, p, A, G); only the equality RHS b
    varies across instances (reference: generate_data.py:31-61).

    Shared arrays are stored with leading dim 1 (the reference — and its
    loader — materializes N host copies; at the 1500-var workload that is
    ~18 GB of identical matrices).  ``RawDataset.slice`` keeps dim-1
    leaves; ``to_qp_batch`` broadcasts on device."""
    n, mi, me, N = num_var, num_ineq, num_eq, data_size
    Qdiag = 0.5 * rng.random(n)
    Q0 = np.diag(Qdiag)
    p0 = rng.random(n)
    A_ = rng.normal(0.0, 1.0, (me, n))
    b = 2.0 * rng.random((N, me)) - 1.0
    G_ = rng.normal(0.0, 1.0, (mi, n))
    c_ = np.abs(G_ @ np.linalg.pinv(A_)).sum(axis=-1)
    Q = Q0[None]
    p = p0[None]
    A = A_[None]
    G = G_[None]
    c = c_[None]
    A0 = np.concatenate([G, A], axis=-2)                       # (1, m, n)
    zl = np.concatenate([np.broadcast_to(np.full((1, mi), -np.inf),
                                         (N, mi)), b], axis=-1)
    zu = np.concatenate([np.broadcast_to(c, (N, mi)), b], axis=-1)
    return RawDataset("QP_RHS", Q, p, A0, zl, zu, G=G, c=c, A=A, b=b)


def generate_random_qp(num_var: int, num_ineq: int, data_size: int,
                       rng: np.random.Generator,
                       sparsity: float = 0.6) -> RawDataset:
    """``Random_QP`` family: sparse PSD Q = (MMᵀ+0.01I)/2... note the
    reference stores (MMᵀ+0.01I)*0.5 as the half Hessian; two-sided box
    inequality rows (reference: generate_data.py:96-134).

    The metric view G=[A0;-A0], c=[zu;-zl] (one-sided violation reporting
    covering both bounds, reference: generate_data.py:115-116) is NOT
    materialized here — it would double the dataset (15 GB at the canonical
    size).  ``io.to_qp_batch`` derives it on device per batch; storage and
    host RAM keep only A0.
    """
    n, mi, N = num_var, num_ineq, data_size
    f32 = np.float32
    Q = np.empty((N, n, n), dtype=f32)
    A0 = np.empty((N, mi, n), dtype=f32)
    for i in range(N):
        M = rng.standard_normal((n, n), dtype=f32)
        M *= rng.random((n, n)) < sparsity
        Q[i] = (M @ M.T + 0.01 * np.eye(n, dtype=f32)) * 0.5
        Ai = rng.standard_normal((mi, n), dtype=f32)
        Ai *= rng.random((mi, n)) < sparsity
        A0[i] = Ai
    p = rng.standard_normal((N, n), dtype=f32)
    zl = -rng.random((N, mi), dtype=f32)
    zu = rng.random((N, mi), dtype=f32)
    return RawDataset("Random_QP", Q, p, A0, zl, zu)


def generate_sparse_qp(num_var: int, num_ineq: int, data_size: int,
                       rng: np.random.Generator,
                       bandwidth: int = 16) -> RawDataset:
    """``Sparse_QP`` family: genuinely sparse (<10%-dense) banded QP.

    The reference's "sparse" families (Random_QP/Equality_QP,
    generate_data.py:119-175) draw ~50%-dense masks whose Gram products
    are effectively dense, so its CSC storage is densified at load and the
    compute path never exploits sparsity.  This family is the workload the
    device sparse path (kernels/sparse.py BCOO route, kernels/sparse_matvec
    BSR tiles) is *for*: Q = (BBᵀ + 0.01I)/2 with banded B (bandwidth w →
    Q bandwidth 2w, density ≈ (4w+1)/n), and banded two-sided box rows
    A0 (each row i covers columns around i·n/mi).  At n=1000, w=16 the
    densities are ~6% (Q) and ~3% (A0) — tile-aligned bands, so the BSR
    tile-occupancy matches the element density instead of saturating."""
    n, mi, N = num_var, num_ineq, data_size
    f32 = np.float32
    w = bandwidth
    idx = np.arange(n)
    band_q = (np.abs(idx[:, None] - idx[None, :]) <= w)
    Q = np.empty((N, n, n), dtype=f32)
    A0 = np.empty((N, mi, n), dtype=f32)
    centers = ((np.arange(mi) * n) // mi)
    band_a = (np.abs(centers[:, None] - idx[None, :]) <= w)
    for i in range(N):
        M = rng.standard_normal((n, n), dtype=f32)
        M *= band_q
        # scale so diag(Q) is O(1) regardless of bandwidth
        Q[i] = (M @ M.T) / (2 * w + 1) + 0.01 * np.eye(n, dtype=f32)
        Q[i] *= 0.5
        Ai = rng.standard_normal((mi, n), dtype=f32)
        Ai *= band_a
        A0[i] = Ai
    p = rng.standard_normal((N, n), dtype=f32)
    zl = -rng.random((N, mi), dtype=f32)
    zu = rng.random((N, mi), dtype=f32)
    return RawDataset("Sparse_QP", Q, p, A0, zl, zu)


def generate_equality_qp(num_var: int, num_eq: int, data_size: int,
                         rng: np.random.Generator,
                         sparsity: float = 0.5) -> RawDataset:
    """``Equality_QP`` family: sparse PSD Q, equality-only rows zl=zu=b
    (reference: generate_data.py:136-175)."""
    n, me, N = num_var, num_eq, data_size
    f32 = np.float32
    Q = np.empty((N, n, n), dtype=f32)
    A = np.empty((N, me, n), dtype=f32)
    for i in range(N):
        M = rng.standard_normal((n, n), dtype=f32)
        M *= rng.random((n, n)) < sparsity
        Q[i] = (M @ M.T + 0.01 * np.eye(n, dtype=f32)) * 0.5
        Ai = rng.standard_normal((me, n), dtype=f32)
        Ai *= rng.random((me, n)) < sparsity
        A[i] = Ai
    p = rng.standard_normal((N, n), dtype=f32)
    b = rng.standard_normal((N, me), dtype=f32)
    # A (the equality metric view) aliases A0 — save_npz stores one copy
    # and load_npz restores the view.
    return RawDataset("Equality_QP", Q, p, A, b.copy(), b.copy(),
                      A=A, b=b)


def generate_svm(num_var: int, num_ineq: int, data_size: int,
                 rng: np.random.Generator,
                 sparsity: float = 0.5) -> RawDataset:
    """``SVM`` family: soft-margin hinge-loss QP with explicit slack vars.

    Decision vector is [w; t] with n weights and mi slacks; hinge rows
    G=[diag(b̂)Â, -I] and identity box rows appended into A0
    (reference: generate_data.py:177-228).

    NOTE: the returned ``G`` is a live VIEW of ``A0[:, :mi, :]`` (they share
    memory, saving ~4 GB at the canonical size).  Any host-side in-place
    edit of one mutates the other; device/oracle paths copy on cast so this
    only matters for host-side preprocessing.  ``save_npz`` stores the
    single copy and ``load_npz`` restores the view.
    """
    # Built float32 and strictly in place: at the canonical size
    # (n=1500, mi=500, N=1000) the dense f64 Q/A0/G buffers of the naive
    # construction total ~80 GB; f32 with G aliased into A0 is ~36 GB.
    n, mi, N = num_var, num_ineq, data_size
    ntot = n + mi
    f32 = np.float32
    Q = np.zeros((N, ntot, ntot), dtype=f32)
    Q[:, np.arange(n), np.arange(n)] = 1.0
    p = np.empty((N, ntot), dtype=f32)
    half = mi // 2
    b_hat = np.concatenate([np.ones(half), -np.ones(mi - half)])
    A0 = np.zeros((N, mi + ntot, ntot), dtype=f32)
    A0[:, mi:, :] = np.eye(ntot, dtype=f32)
    neg_eye = -np.eye(mi)
    for i in range(N):
        lamb = rng.normal(1.0)
        p[i, :n] = 0.0
        p[i, n:] = lamb
        A_hat = np.concatenate([
            rng.normal(1.0 / n, 1.0 / n, (half, n)),
            rng.normal(-1.0 / n, 1.0 / n, (mi - half, n)),
        ])
        A_hat *= rng.random((mi, n)) < sparsity
        A0[i, :mi, :n] = b_hat[:, None] * A_hat
        A0[i, :mi, n:] = neg_eye
    G = A0[:, :mi, :]
    c = -np.ones((N, mi), dtype=f32)
    lb = np.concatenate([np.full((N, n), -np.inf, dtype=f32),
                         np.zeros((N, mi), dtype=f32)], axis=-1)
    ub = np.full((N, ntot), np.inf, dtype=f32)
    zl = np.concatenate([np.full((N, mi), -np.inf, dtype=f32), lb], axis=-1)
    zu = np.concatenate([c, ub], axis=-1)
    return RawDataset("SVM", Q, p, A0, zl, zu, G=G, c=c, lb=lb, ub=ub)


def generate_portfolio(num_var: int, num_factors: int, data_size: int,
                       rng: np.random.Generator) -> RawDataset:
    """``Portfolio`` family (TPU-build addition, BASELINE.json configs[4]):
    Markowitz portfolio QP with a factor-model covariance.

        min ½ xᵀ(2Σ)x − μᵀx   s.t.  1ᵀx = 1,  0 ≤ x ≤ w_max

    Σ = F diag(s) Fᵀ + diag(d) with k factors (dense PSD Q, unlike the
    diagonal/sparse reference families).  Stored Q is the half Hessian Σ
    per the reference's Q×2 convention (reference: generate_data.py:79,
    main.py:298).  Rows: 1 budget equality + n long-only box rows.
    """
    n, k, N = num_var, num_factors, data_size
    F = rng.normal(0.0, 1.0, (N, n, k)) / np.sqrt(k)
    s = rng.random((N, k)) + 0.5
    d_diag = 0.1 * rng.random((N, n)) + 0.01
    Q = np.einsum("bik,bk,bjk->bij", F, s, F)
    Q[:, np.arange(n), np.arange(n)] += d_diag
    mu = rng.normal(0.0, 0.1, (N, n))
    p = -mu
    w_max = np.full((N, n), min(1.0, 10.0 / n))
    ones_row = np.ones((N, 1, n))
    eye = np.broadcast_to(np.eye(n), (N, n, n))
    A0 = np.concatenate([ones_row, eye], axis=-2)
    zl = np.concatenate([np.ones((N, 1)), np.zeros((N, n))], axis=-1)
    zu = np.concatenate([np.ones((N, 1)), w_max], axis=-1)
    # metric views: budget row as equality, box rows via lb/ub
    A = ones_row
    b = np.ones((N, 1))
    lb = np.zeros((N, n))
    ub = w_max
    return RawDataset("Portfolio", Q, p, A0, zl, zu, A=A, b=b, lb=lb, ub=ub)


FAMILIES = ("QP", "QP_RHS", "Random_QP", "Sparse_QP", "Equality_QP", "SVM",
            "Portfolio")


def generate(prob_type: str, *, num_var: int, data_size: int,
             num_ineq: int = 0, num_eq: int = 0,
             seed: int = 0, bandwidth: int = 16) -> RawDataset:
    """Dispatch on problem family name (reference: generate_data.py:31).
    ``bandwidth`` applies to the Sparse_QP family only (band half-width of
    the Q/A0 bands; density scales as ~4*bandwidth/num_var)."""
    rng = np.random.default_rng(seed)
    if prob_type == "QP":
        return generate_qp(num_var, num_ineq, num_eq, data_size, rng)
    if prob_type == "QP_RHS":
        return generate_qp_rhs(num_var, num_ineq, num_eq, data_size, rng)
    if prob_type == "Random_QP":
        return generate_random_qp(num_var, num_ineq, data_size, rng)
    if prob_type == "Sparse_QP":
        return generate_sparse_qp(num_var, num_ineq, data_size, rng,
                                  bandwidth=bandwidth)
    if prob_type == "Equality_QP":
        return generate_equality_qp(num_var, num_eq, data_size, rng)
    if prob_type == "SVM":
        return generate_svm(num_var, num_ineq, data_size, rng)
    if prob_type == "Portfolio":
        # num_ineq is repurposed as the factor count (default n // 10)
        return generate_portfolio(num_var, num_ineq or max(num_var // 10, 1),
                                  data_size, rng)
    raise ValueError(f"unknown prob_type {prob_type!r}; choose from {FAMILIES}")
