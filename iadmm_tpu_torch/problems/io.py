"""Conversion of a host dataset to a device ``QPBatch``.

Counterpart of ``to_qp_batch`` in ``iadmm_tpu/problems/io.py``.  The
``.npz`` storage and the reference gz-pickle loader are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..types import QPBatch, make_eq_mask
from .generators import RawDataset


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
