"""Ground-truth QP oracle.

Counterpart of ``iadmm_tpu/problems/oracle.py``, kept as its own copy (the
port imports nothing of the JAX package).  The reference labels every
instance with the OSQP C solver at 1e-4 tolerance.  The primary oracle is
the native C++ solver (:mod:`iadmm_tpu_torch.native`); :func:`solve_qp` is
a float64 Python implementation of the same operator splitting
(direct-method ADMM with over-relaxation and adaptive rho, the OSQP
algorithm) on the standard eps_abs/eps_rel criterion.  If the ``osqp``
package is importable, ``label_dataset(backend='osqp')`` labels with it,
and ``'auto'`` prefers it to the Python oracle when the native library
cannot be built.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.linalg

try:  # optional, matches reference labeling exactly when present
    import osqp as _osqp  # type: ignore
    HAVE_OSQP = True
except Exception:  # pragma: no cover - environment without osqp
    _osqp = None
    HAVE_OSQP = False

RHO_EQ_OVER_RHO_INEQ = 1e3  # reference: models/lstm.py:18


@dataclasses.dataclass
class OracleResult:
    x: np.ndarray
    y: np.ndarray
    solved: bool
    iters: int
    pri_res: float
    dua_res: float


def solve_qp(P: np.ndarray, q: np.ndarray, A: np.ndarray,
             zl: np.ndarray, zu: np.ndarray,
             eps_abs: float = 1e-4, eps_rel: float = 1e-4,
             max_iter: int = 20000, sigma: float = 1e-6,
             alpha: float = 1.6, rho0: float = 0.1,
             adaptive_rho_tol: float = 5.0,
             x0: Optional[np.ndarray] = None,
             y0: Optional[np.ndarray] = None) -> OracleResult:
    """Solve ``min 0.5 xᵀPx + qᵀx s.t. zl <= Ax <= zu`` to OSQP tolerances.

    ``P`` is the full (doubled) Hessian, i.e. what the reference passes to
    OSQP as ``csc_matrix(Q)*2`` (reference: generate_data.py:79).
    Dense float64 LU on the KKT matrix, refactorised only when the adaptive
    rho moves by more than ``adaptive_rho_tol``x.
    """
    n = P.shape[0]
    m = A.shape[0]
    P = np.asarray(P, np.float64)
    q = np.asarray(q, np.float64).reshape(n)
    A = np.asarray(A, np.float64)
    zl = np.asarray(zl, np.float64).reshape(m)
    zu = np.asarray(zu, np.float64).reshape(m)

    eq = np.isfinite(zl) & (zl == zu)
    loose = ~np.isfinite(zl) & ~np.isfinite(zu)

    def rho_vec_for(rho_bar: float) -> np.ndarray:
        rv = np.full(m, rho_bar)
        rv[eq] *= RHO_EQ_OVER_RHO_INEQ
        rv[loose] *= 1e-6  # OSQP's rho for (-inf, inf) rows
        return rv

    rho_bar = rho0
    rho_vec = rho_vec_for(rho_bar)

    def factor(rv: np.ndarray):
        K = np.zeros((n + m, n + m))
        K[:n, :n] = P + sigma * np.eye(n)
        K[:n, n:] = A.T
        K[n:, :n] = A
        K[n:, n:] = -np.diag(1.0 / rv)
        return scipy.linalg.lu_factor(K)

    lu = factor(rho_vec)

    # Optional warm start (the ghost models/osqp.py baseline warm-started
    # consecutive instances, SURVEY.md §2.3).
    x = np.zeros(n) if x0 is None else np.asarray(x0, np.float64).copy()
    y = np.zeros(m) if y0 is None else np.asarray(y0, np.float64).copy()
    z = A @ x if x0 is not None else np.zeros(m)
    pri = dua = np.inf
    it = 0
    for it in range(1, max_iter + 1):
        rhs = np.concatenate([sigma * x - q, z - y / rho_vec])
        xv = scipy.linalg.lu_solve(lu, rhs)
        x_t, nu = xv[:n], xv[n:]
        z_t = z + (nu - y) / rho_vec
        x = alpha * x_t + (1 - alpha) * x
        z_temp = alpha * z_t + (1 - alpha) * z
        z_new = np.clip(z_temp + y / rho_vec, zl, zu)
        y = y + rho_vec * (z_temp - z_new)
        z = z_new

        if it % 10 == 0 or it == max_iter:
            Ax = A @ x
            Px = P @ x
            ATy = A.T @ y
            pri = np.max(np.abs(Ax - z)) if m else 0.0
            dua = np.max(np.abs(Px + q + ATy))
            eps_pri = eps_abs + eps_rel * max(np.max(np.abs(Ax)) if m else 0.0,
                                              np.max(np.abs(z)) if m else 0.0)
            eps_dua = eps_abs + eps_rel * max(np.max(np.abs(Px)),
                                              np.max(np.abs(ATy)) if m else 0.0,
                                              np.max(np.abs(q)))
            if pri <= eps_pri and dua <= eps_dua:
                return OracleResult(x, y, True, it, pri, dua)
            # adaptive rho (OSQP rule): scale by sqrt of residual ratio
            if m and pri > 0 and dua > 0:
                num = pri / max(np.max(np.abs(Ax)), np.max(np.abs(z)), 1e-12)
                den = dua / max(np.max(np.abs(Px)), np.max(np.abs(ATy)),
                                np.max(np.abs(q)), 1e-12)
                new_rho_bar = rho_bar * np.sqrt(num / max(den, 1e-18))
                new_rho_bar = float(np.clip(new_rho_bar, 1e-6, 1e6))
                if (new_rho_bar > adaptive_rho_tol * rho_bar
                        or new_rho_bar < rho_bar / adaptive_rho_tol):
                    rho_bar = new_rho_bar
                    rho_vec = rho_vec_for(rho_bar)
                    lu = factor(rho_vec)

    return OracleResult(x, y, False, it, float(pri), float(dua))


def solve_qp_osqp(P, q, A, zl, zu, eps: float = 1e-4,
                  max_iter: int = 20000) -> OracleResult:
    """Label with the real OSQP solver when available, using the reference's
    settings (reference: generate_data.py:79-83)."""
    from scipy.sparse import csc_matrix
    solver = _osqp.OSQP()
    solver.setup(P=csc_matrix(P), q=np.asarray(q, np.float64),
                 A=csc_matrix(A), l=np.asarray(zl, np.float64),
                 u=np.asarray(zu, np.float64), verbose=False,
                 eps_prim_inf=eps, eps_dual_inf=eps, eps_abs=eps,
                 eps_rel=eps, check_termination=1,
                 adaptive_rho_interval=1, max_iter=max_iter)
    res = solver.solve()
    solved = res.info.status == "solved"
    return OracleResult(np.asarray(res.x), np.asarray(res.y), solved,
                        res.info.iter, res.info.pri_res, res.info.dua_res)


def solve_native(ds, eps: float = 1e-4, max_iter: int = 20000,
                 verbose: bool = False):
    """Solve every instance of a RawDataset with the native batch solver
    (:mod:`iadmm_tpu_torch.native`), the stored half Hessian doubled as
    the reference passes it to OSQP.  A shared-matrix family (QP_RHS) is
    one shared instance with per-instance bounds.  Returns (x, y, iters,
    status) as :func:`iadmm_tpu_torch.native.solve_qp_batch` does."""
    from .. import native
    if ds.Q.shape[0] == 1 and ds.size > 1:
        Pn = np.asarray(ds.Q[0], np.float64) * 2.0  # single matrix
        return native.solve_qp_batch(
            Pn, ds.p[0], ds.A0[0], ds.zl, ds.zu,
            eps_abs=eps, eps_rel=eps, max_iter=max_iter)
    # Chunked conversion: the solver wants contiguous f64 P/A, and a
    # whole-dataset cast would transiently need ~2x the dataset in f64
    # (an f32 SVM dataset is ~35 GB -> ~70 GB f64).  Cap the f64 staging
    # at ~4 GB per chunk instead.
    n = ds.Q.shape[-1]
    m = ds.A0.shape[-2]
    per_inst = 8 * (n * n + m * n)
    chunk = max(1, int(4e9 // per_inst))
    outs = []
    for s in range(0, ds.size, chunk):
        sl = slice(s, s + chunk)
        Pc = ds.Q[sl].astype(np.float64)  # always copies
        Pc *= 2.0
        outs.append(native.solve_qp_batch(
            Pc, ds.p[sl], ds.A0[sl], ds.zl[sl], ds.zu[sl],
            eps_abs=eps, eps_rel=eps, max_iter=max_iter))
        if verbose:
            print(f"native oracle: {min(s + chunk, ds.size)}/{ds.size} ...",
                  flush=True)
    return tuple(np.concatenate([o[i] for o in outs]) for i in range(4))


def label_dataset(ds, eps: float = 1e-4, max_iter: int = 20000,
                  verbose: bool = False, backend: str = "auto"):
    """Attach oracle labels ``x_opt, y_opt`` to a RawDataset in place and
    return the indices of solved instances (unsolved instances are dropped by
    the caller, mirroring the reference's skip-on-failure).

    ``backend``: 'native' = C++ OpenMP batch solver (:func:`solve_native`),
    'python' = pure-Python reference oracle, 'osqp' = the real OSQP
    package, 'auto' = native when buildable, else osqp if installed, else
    python."""
    if backend == "auto":
        from .. import native
        backend = ("native" if native.available()
                   else "osqp" if HAVE_OSQP else "python")
    if backend == "native":
        x, y, iters, status = solve_native(ds, eps, max_iter, verbose)
        solved_ids = np.nonzero(status == 0)[0]
        if verbose:
            print(f"native oracle: {len(solved_ids)}/{ds.size} solved, "
                  f"mean {iters[status == 0].mean():.1f} iters")
        ds.x_opt = x
        ds.y_opt = y
        return solved_ids.astype(np.int64)
    N = ds.size
    n = ds.Q.shape[-1]
    m = ds.A0.shape[-2]
    x_opt = np.zeros((N, n))
    y_opt = np.zeros((N, m))
    solved_ids = []
    def sh(a, i):  # dim-1 leading axis = shared across instances (QP_RHS)
        return a[i if a.shape[0] > 1 else 0]

    for i in range(N):
        P = sh(ds.Q, i) * 2.0  # stored half Hessian -> full (reference conv.)
        if backend == "osqp":
            r = solve_qp_osqp(P, sh(ds.p, i), sh(ds.A0, i), ds.zl[i],
                              ds.zu[i], eps=eps, max_iter=max_iter)
        else:
            r = solve_qp(P, sh(ds.p, i), sh(ds.A0, i), ds.zl[i], ds.zu[i],
                         eps_abs=eps, eps_rel=eps, max_iter=max_iter)
        if r.solved:
            x_opt[i] = r.x
            y_opt[i] = r.y
            solved_ids.append(i)
        elif verbose:
            print(f"instance {i}: oracle failed "
                  f"(pri={r.pri_res:.2e}, dua={r.dua_res:.2e})")
    ds.x_opt = x_opt
    ds.y_opt = y_opt
    return np.asarray(solved_ids, np.int64)
