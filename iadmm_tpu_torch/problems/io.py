"""Dataset storage, the train/val/test split and conversion to a device
``QPBatch``.

Counterpart of ``save_npz``/``load_npz``, ``dataset_path``,
``load_dataset``, ``to_qp_batch`` and ``split_ids`` in
``iadmm_tpu/problems/io.py``.  A dataset is one stacked ``.npz``; both
packages read the files the other writes.  The reference's per-instance
gz-pickle directories, QPLIB and the ``MM_*`` families are not ported yet.
"""

from __future__ import annotations

import os
import random

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
    """The stacked ``.npz`` at :func:`dataset_path`.  The JAX package's
    other sources (QPLIB, ``MM_*``, the reference's gz-pickle directories)
    raise ``NotImplementedError``."""
    if prob_type == "QPLIB" or prob_type.startswith("MM_"):
        raise NotImplementedError(
            f"loading {prob_type} (reference gz-pickle instances) is not "
            f"ported to PyTorch yet; see ROADMAP.md (Queue 1, data layer)")
    path = dataset_path(root, prob_type, num_var, num_ineq, num_eq)
    if os.path.exists(path):
        return load_npz(path)
    d = os.path.splitext(path)[0]
    if os.path.isdir(d):
        raise NotImplementedError(
            f"{d} is a reference gz-pickle directory; its loader is not "
            f"ported to PyTorch yet; see ROADMAP.md (Queue 1, data layer)")
    raise FileNotFoundError(f"no dataset at {path}")


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
