"""Dataset storage, the train/val/test split and conversion to a device
``QPBatch``.

Counterpart of ``iadmm_tpu/problems/io.py``.  A dataset is one stacked
``.npz``; both packages read the files the other writes.  The reference's
per-instance gz-pickle layout is read and written too
(:func:`load_reference_gz_dir`, :func:`save_reference_gz_dir`): the
``QPLIB`` and ``MM_*`` families exist only in it.
"""

from __future__ import annotations

import gzip
import os
import pickle
import random
from typing import Sequence

import numpy as np
import torch

from ..types import QPBatch, make_eq_mask
from .generators import RawDataset

_OPTIONAL = ("G", "c", "A", "b", "lb", "ub", "x_opt", "y_opt")


def save_npz(ds: RawDataset, path: str, compress: bool = False) -> None:
    """Single stacked ``.npz`` per dataset, in the JAX package's layout.

    Metric views that are row blocks of ``A0`` (G its first mi rows, A its
    last me rows) are not stored twice; :func:`load_npz` restores them as
    views.  Matrices with fewer than a third of their entries non-zero are
    stored as COO triplets.  The file is written under a temporary name and
    renamed, so a reader never sees a partial dataset."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {"prob_type": np.asarray(ds.prob_type),
               "Q": ds.Q, "p": ds.p, "A0": ds.A0, "zl": ds.zl, "zu": ds.zu}
    for k in _OPTIONAL:
        v = getattr(ds, k)
        if v is not None:
            payload[k] = v
    if ds.G is not None and ds.c is not None:
        mi = ds.c.shape[-1]
        if (ds.G.shape == ds.A0[:, :mi].shape
                and np.array_equal(ds.G, ds.A0[:, :mi])):
            del payload["G"]
            payload["G_rows_of_A0"] = np.asarray(mi, np.int64)
    if ds.A is not None and ds.b is not None:
        me = ds.b.shape[-1]
        if (ds.A.shape == ds.A0[:, ds.A0.shape[1] - me:].shape
                and np.array_equal(ds.A, ds.A0[:, ds.A0.shape[1] - me:])):
            del payload["A"]
            payload["A_rows_of_A0"] = np.asarray(me, np.int64)
    for k in ("Q", "A0"):
        M = payload[k]
        if np.count_nonzero(M) / M.size < 1.0 / 3.0:
            flat = M.reshape(M.shape[0], -1)
            idx = [np.flatnonzero(f) for f in flat]
            payload[f"{k}_sp_idx"] = np.concatenate(idx).astype(np.int64)
            payload[f"{k}_sp_val"] = np.concatenate(
                [f[i] for f, i in zip(flat, idx)]).astype(M.dtype)
            payload[f"{k}_sp_cnt"] = np.asarray([len(i) for i in idx],
                                                np.int64)
            payload[f"{k}_sp_shape"] = np.asarray(M.shape, np.int64)
            del payload[k]
    tmp = path + ".tmp.npz"
    (np.savez_compressed if compress else np.savez)(tmp, **payload)
    os.replace(tmp, path)


def load_npz(path: str) -> RawDataset:
    with np.load(path, allow_pickle=False) as f:
        def mat(k):
            if k in f:
                return f[k]
            shape = tuple(f[f"{k}_sp_shape"])
            M = np.zeros((shape[0], shape[1] * shape[2]),
                         f[f"{k}_sp_val"].dtype)
            offs = np.concatenate([[0], np.cumsum(f[f"{k}_sp_cnt"])])
            idx, val = f[f"{k}_sp_idx"], f[f"{k}_sp_val"]
            for b in range(shape[0]):
                s = slice(offs[b], offs[b + 1])
                M[b, idx[s]] = val[s]
            return M.reshape(shape)

        kw = {k: f[k] for k in _OPTIONAL if k in f}
        A0 = mat("A0")
        if "G_rows_of_A0" in f:
            kw["G"] = A0[:, :int(f["G_rows_of_A0"])]
        if "A_rows_of_A0" in f:
            kw["A"] = A0[:, A0.shape[1] - int(f["A_rows_of_A0"]):]
        return RawDataset(prob_type=str(f["prob_type"]),
                          Q=mat("Q"), p=f["p"], A0=A0,
                          zl=f["zl"], zu=f["zu"], **kw)


def dataset_path(root: str, prob_type: str, num_var: int,
                 num_ineq: int = 0, num_eq: int = 0) -> str:
    """Run-keyed dataset file name, the JAX package's."""
    if prob_type in ("QP", "QP_RHS"):
        name = f"{prob_type}_{num_var}_{num_ineq}_{num_eq}"
    elif prob_type in ("Random_QP", "Portfolio", "Sparse_QP"):
        name = f"{prob_type}_{num_var}_{num_ineq}"
    elif prob_type == "Equality_QP":
        name = f"Equality_QP_{num_var}_{num_eq}"
    elif prob_type == "SVM":
        name = f"SVM_{num_var + num_ineq}_{num_ineq}"
    else:
        name = prob_type
    return os.path.join(root, name + ".npz")


def load_dataset(root: str, prob_type: str, num_var: int = 0,
                 num_ineq: int = 0, num_eq: int = 0, qplib_num: int = 0,
                 data_size: int = 1000) -> RawDataset:
    """The stacked ``.npz`` at :func:`dataset_path` if present, else the
    reference's per-instance gz-pickle directory beside it, including the
    ``QPLIB`` family (``<root>/QPLIB_<num>/qplib_<num>_<i>.gz``) and the
    ``MM_*`` families (``<root>/MM_<NAME>/<name>_<i>.gz``), which exist
    only in that layout.  Unpickling runs code: load only files this
    project or the reference wrote."""
    if prob_type == "QPLIB":
        d = os.path.join(root, f"QPLIB_{qplib_num}")
        return load_reference_gz_dir(d, f"qplib_{qplib_num}",
                                     range(data_size))
    if prob_type.startswith("MM_"):
        # Maros-Mészáros perturbation families: e.g. MM_MOSARQP2 ->
        # <root>/MM_MOSARQP2/mosarqp2_<i>.gz
        d = os.path.join(root, prob_type)
        return load_reference_gz_dir(d, prob_type[3:].lower(),
                                     range(data_size))
    path = dataset_path(root, prob_type, num_var, num_ineq, num_eq)
    if os.path.exists(path):
        return load_npz(path)
    # reference directory layout: <root>/<name>/<prob_type_lowercase>_<i>.gz
    # ('qp_{}.gz', 'equality_qp_{}.gz', ...)
    name = os.path.splitext(os.path.basename(path))[0]
    d = os.path.join(root, name)
    if os.path.isdir(d):
        return load_reference_gz_dir(d, prob_type.lower(), range(data_size))
    raise FileNotFoundError(f"no dataset at {path} or {d}")


def save_reference_gz_dir(ds: RawDataset, data_dir: str,
                          prefix: str) -> None:
    """Export a RawDataset to the reference's per-instance gzip-pickle
    layout (payload: 2-D Q/A0, column vectors p/c/b/zl/zu, flat
    ground-truth x/y), so reference tooling can train and evaluate on
    datasets produced here.

    Non-QP/QP_RHS families are stored as scipy CSC: the reference's loader
    calls ``.toarray()`` on every field for those prob_types, so dense
    payloads would crash it."""
    os.makedirs(data_dir, exist_ok=True)
    as_sparse = ds.prob_type not in ("QP", "QP_RHS")
    if as_sparse:
        import scipy.sparse as sps

    def sh(a, i):  # shared leading dim (QP_RHS) broadcasts
        return a[i if a.shape[0] > 1 else 0]

    col = lambda v: np.asarray(v, np.float64)[:, None]
    derive_box = (ds.G is None
                  and ds.prob_type.lower() in ("random_qp", "sparse_qp"))
    for i in range(ds.size):
        d = {"Q": np.asarray(sh(ds.Q, i), np.float64),
             "p": col(sh(ds.p, i)),
             "A0": np.asarray(sh(ds.A0, i), np.float64),
             "zl": col(ds.zl[i]), "zu": col(ds.zu[i])}
        if derive_box:
            # reference pickles store the materialised two-sided view
            d["G"] = np.concatenate([d["A0"], -d["A0"]])
            d["c"] = np.concatenate([col(ds.zu[i]), -col(ds.zl[i])])
        for k, squeeze in (("G", False), ("A", False), ("c", True),
                           ("b", True), ("lb", True), ("ub", True)):
            v = getattr(ds, k)
            if v is not None:
                d[k] = col(sh(v, i)) if squeeze else np.asarray(
                    sh(v, i), np.float64)
        if as_sparse:
            d = {k: sps.csc_matrix(v) for k, v in d.items()}
        if ds.x_opt is not None:
            d["x"] = np.asarray(ds.x_opt[i], np.float64)
            d["y"] = np.asarray(ds.y_opt[i], np.float64)
        with gzip.open(os.path.join(data_dir, f"{prefix}_{i}.gz"),
                       "wb") as f:
            pickle.dump(d, f)


def load_reference_gz_dir(data_dir: str, prefix: str,
                          ids: Sequence[int]) -> RawDataset:
    """Load reference-format per-instance gzip pickles
    ``<data_dir>/<prefix>_<i>.gz``.  Sparse families store scipy CSC
    matrices, which are densified on load, as the reference does."""
    def dense(v):
        return v.toarray() if hasattr(v, "toarray") else np.asarray(v)

    fields: dict = {k: [] for k in
                    ("Q", "p", "A0", "zl", "zu", "G", "c", "A", "b",
                     "lb", "ub", "x", "y")}
    present = {k: True for k in fields}
    for i in ids:
        path = os.path.join(data_dir, f"{prefix}_{i}.gz")
        with gzip.open(path, "rb") as f:
            d = pickle.load(f)
        for k in fields:
            if k in d:
                fields[k].append(dense(d[k]))
            else:
                present[k] = False

    def stack(k, squeeze=False):
        if not present[k] or not fields[k]:
            return None
        arr = np.stack(fields[k]).astype(np.float64)
        if squeeze and arr.ndim == 3 and arr.shape[-1] == 1:
            arr = arr[..., 0]
        return arr

    return RawDataset(
        prob_type=prefix,
        Q=stack("Q"), p=stack("p", True), A0=stack("A0"),
        zl=stack("zl", True), zu=stack("zu", True),
        G=stack("G"), c=stack("c", True), A=stack("A"), b=stack("b", True),
        lb=stack("lb", True), ub=stack("ub", True),
        x_opt=stack("x", True), y_opt=stack("y", True),
    )


def to_qp_batch(ds: RawDataset, idx=None, dtype=torch.float32,
                with_metric_views: bool = True,
                device="cuda") -> QPBatch:
    """Device batch with the doubled Hessian (``Q*2`` load convention) and
    the ``zl == zu`` equality-row mask.

    Shared-data leaves (leading dim 1, QP_RHS family) are broadcast to the
    batch size."""
    sub = ds if idx is None else ds.slice(idx)
    B = sub.zl.shape[0]

    def arr(v):
        if v is None:
            return None
        a = torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
        if a.shape[0] == 1 and B > 1:
            a = a.expand((B,) + tuple(a.shape[1:]))
        return a

    zl = arr(sub.zl)
    zu = arr(sub.zu)
    kw = {}
    if with_metric_views:
        kw = dict(G=arr(sub.G), c=arr(sub.c), A=arr(sub.A), b=arr(sub.b),
                  lb=arr(sub.lb), ub=arr(sub.ub))
        if kw["G"] is None and sub.prob_type.lower() in ("random_qp",
                                                         "sparse_qp"):
            # Two-sided box rows: the G=[A0;-A0], c=[zu;-zl] view.
            A0d = arr(sub.A0)
            kw["G"] = torch.cat([A0d, -A0d], dim=-2)
            kw["c"] = torch.cat([zu, -zl], dim=-1)
    return QPBatch(
        Q=arr(sub.Q) * 2.0, p=arr(sub.p), A0=arr(sub.A0),
        zl=zl, zu=zu, eq_mask=make_eq_mask(zl, zu), **kw)


def split_ids(data_size: int, val_frac: float, test_frac: float,
              seed: int = 17):
    """The shuffled train/val/test id split of the JAX package (the
    reference's, with the stdlib-random shuffle): the same ids for the same
    arguments."""
    train_size = int(data_size * (1.0 - val_frac - test_frac))
    val_size = int(data_size * val_frac)
    ids = list(range(data_size))
    random.Random(seed).shuffle(ids)
    return (np.asarray(ids[:train_size]),
            np.asarray(ids[train_size:train_size + val_size]),
            np.asarray(ids[train_size + val_size:]))
