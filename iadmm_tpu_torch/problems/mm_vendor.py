"""Vendored real Maros-Mészáros instance: HS35.

Counterpart of ``iadmm_tpu/problems/mm_vendor.py``, kept as its own copy.
The reference treats Maros-Mészáros QPs as ``MM_<NAME>`` prob_types whose
datasets are perturbation families of one real instance, stored in its
per-instance gz-pickle layout, but ships no instance data.  This module
vendors **HS35** (Hock-Schittkowski #35, a member of the Maros-Mészáros
CUTE subset), whose published data is exact and small:

    minimize    9 − 8x₁ − 6x₂ − 4x₃ + 2x₁² + 2x₂² + x₃² + 2x₁x₂ + 2x₁x₃
    subject to  x₁ + x₂ + 2x₃ ≤ 3,   x ≥ 0

with optimal value 1/9 at x* = (4/3, 7/9, 4/9).  In the framework's OSQP
form (constant dropped, stored Q = Hessian/2 by the Q×2 load convention):

    Q_stored = [[2,1,1],[1,2,0],[1,0,1]],  p = (−8,−6,−4)
    A0 = [G; I₃],  zl = (−inf, 0,0,0),  zu = (c, inf,inf,inf),  c = 3

``write_family`` emits an ``MM_HS35`` perturbation family (instance 0 is
the exact published instance; the rest perturb the inequality RHS and the
linear cost), labelled by the QP oracle, in the reference gz-pickle schema
(CSC: the reference's loader calls ``.toarray()`` on every field of a
non-QP prob_type).
"""

from __future__ import annotations

import os

import numpy as np

# Exact published HS35 data (stored-Q convention: half the Hessian).
HS35_Q_STORED = np.array([[2.0, 1.0, 1.0],
                          [1.0, 2.0, 0.0],
                          [1.0, 0.0, 1.0]])
HS35_P = np.array([-8.0, -6.0, -4.0])
HS35_G = np.array([[1.0, 1.0, 2.0]])
HS35_C = np.array([3.0])
HS35_X_OPT = np.array([4.0 / 3.0, 7.0 / 9.0, 4.0 / 9.0])
HS35_OBJ = 1.0 / 9.0 - 9.0  # constant-free objective at x*


def build_family(data_size: int = 16, seed: int = 17):
    """Perturbation family as a RawDataset: instance 0 exact; others scale
    the RHS c by U[0.8, 1.2] and the linear cost by U[0.9, 1.1]
    (entry-wise), keeping every instance feasible (x=0 stays feasible for
    any c > 0) and bounded (Q ≻ 0 on the x₂/x₃ block... Q is PSD with
    x ≥ 0 compactifying nothing — boundedness comes from Q ⪰ 0 and the
    box below, same as the published instance)."""
    from .generators import RawDataset

    rng = np.random.default_rng(seed)
    n = 3
    Q = np.broadcast_to(HS35_Q_STORED, (data_size, n, n)).copy()
    p = np.broadcast_to(HS35_P, (data_size, n)).copy()
    c = np.broadcast_to(HS35_C, (data_size, 1)).copy()
    p[1:] *= rng.uniform(0.9, 1.1, (data_size - 1, n))
    c[1:] *= rng.uniform(0.8, 1.2, (data_size - 1, 1))

    G = np.broadcast_to(HS35_G, (data_size, 1, n)).copy()
    eye = np.broadcast_to(np.eye(n), (data_size, n, n)).copy()
    A0 = np.concatenate([G, eye], axis=1)                 # (N, 1+n, n)
    inf = np.inf
    zl = np.concatenate([np.full((data_size, 1), -inf),
                         np.zeros((data_size, n))], axis=1)
    zu = np.concatenate([c, np.full((data_size, n), inf)], axis=1)
    lb = np.zeros((data_size, n))
    ub = np.full((data_size, n), inf)
    return RawDataset("hs35", Q.astype(np.float32), p.astype(np.float32),
                      A0.astype(np.float32), zl.astype(np.float32),
                      zu.astype(np.float32), G=G.astype(np.float32),
                      c=c[:, 0:1].astype(np.float32),
                      lb=lb.astype(np.float32), ub=ub.astype(np.float32))


def write_family(data_root: str, data_size: int = 16, seed: int = 17,
                 label: bool = True, verbose: bool = False) -> str:
    """Write ``<data_root>/MM_HS35/hs35_<i>.gz`` in the reference schema
    (CSC fields: the reference's loader densifies every field of an MM
    prob_type).  Returns the directory path."""
    from .io import save_reference_gz_dir
    from .oracle import label_dataset

    ds = build_family(data_size, seed)
    if label:
        ids = label_dataset(ds, eps=1e-4, verbose=verbose)
        ds = ds.slice(np.asarray(ids))
    d = os.path.join(data_root, "MM_HS35")
    save_reference_gz_dir(ds, d, "hs35")
    return d
