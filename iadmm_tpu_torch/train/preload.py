"""Train-split preloading: the dense scaled stack and the sparse tile cache.

Counterpart of ``iadmm_tpu/train/preload.py``.

* **Dense scaled stack** (:func:`preload_train_stack`): the whole train
  split Ruiz-scaled once and kept on the device as ``(n_batches, B, ...)``
  leaves, written a chunk of at most 64 instances at a time.  Scaling is
  deterministic per instance, so the per-batch route's conversion and
  scaling of every batch in every epoch is loop-invariant work.  Q and A0
  are stored in ``cfg.preload_dtype``; a dataset whose Hessians are all
  diagonal (QP, QP_RHS) stores Q as its float32 diagonal, which
  ``solvers.step.bmv`` multiplies elementwise.  The shared leaves of the
  QP_RHS family stay ``(1, 1, ...)`` and are broadcast with ``expand`` when
  a batch is indexed, never materialised.
* **Sparse cache** (:func:`preload_sparse_cache`): each batch is
  Ruiz-scaled on the device and converted, and only the converted arrays
  are kept; then every batch is padded to one family-wide shape per
  operand and placed on the device.  BSR: tiled on the host, padded to the
  largest tile count K of each operand (Q, A0, A0ᵀ).  BCOO: converted on
  the device, padded to the largest nonzero count over the split of each
  operand (Q, A0), with no rounding to ``nse_pad``, as the JAX package's
  cache pads it.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import ExperimentConfig
from ..kernels import sparse as sparse_mod
from ..kernels.bcoo import BCOOMatrix, bcoo_entries, bcoo_pad
from ..kernels.sparse_matvec import bsr_from_host, bsr_pad_k, bsr_tiles_host
from ..problems.generators import RawDataset
from ..problems.io import to_qp_batch
from ..types import QPBatch
from ..utils import profiling

_SOLVER_FIELDS = ("Q", "p", "A0", "zl", "zu")
_STORE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dataset_q_is_diagonal(ds: RawDataset, chunk: int = 8) -> bool:
    """True when every instance Hessian is diagonal (the QP and QP_RHS
    families).  One chunked host pass; Ruiz scaling keeps a diagonal
    Hessian diagonal (Q̄ = cost·D Q D)."""
    Q = ds.Q
    n = Q.shape[-1]
    if Q.ndim != 3 or Q.shape[-2] != n:
        return False
    idx = np.arange(n)
    for s in range(0, Q.shape[0], chunk):
        blk = np.array(Q[s:s + chunk])
        blk[:, idx, idx] = 0.0
        if np.any(blk):
            return False
    return True


def train_stack_bytes(ds: RawDataset, n_used: int,
                      dtype_bytes: int = 4, diag_q: bool = False) -> int:
    """Device bytes of the scaled train stack (one copy; shared leaves
    counted once; ``diag_q`` counts the Hessian as its float32
    diagonal)."""
    total = 0
    for name in _SOLVER_FIELDS:
        a = getattr(ds, name)
        lead = 1 if a.shape[0] == 1 else n_used
        if name == "Q" and diag_q:
            total += 4 * lead * a.shape[-1]
            continue
        total += dtype_bytes * lead * int(np.prod(a.shape[1:]))
    total += n_used * ds.zl.shape[-1]  # eq_mask (bool)
    return total


def device_memory_budget(device="cuda", default: float = 8e9,
                         frac: float = 0.6) -> float:
    """Device bytes the preload may take: ``frac`` of the device memory,
    leaving the rest to training and the validation split.
    ``IADMM_HBM_BYTES`` (bytes of one device) wins; a CUDA device reports
    its total memory; elsewhere the JAX package's fallback of ``default``
    bytes applies, with a note printed once."""
    env = os.environ.get("IADMM_HBM_BYTES")
    if env:
        return frac * float(env)
    device = torch.device(device)
    if device.type == "cuda":
        return frac * float(torch.cuda.mem_get_info(device)[1])
    profiling.log_once(
        "hbm-budget-fallback",
        f"device_memory_budget: {device.type} reports no device memory; "
        f"assuming a {default / 1e9:.0f} GB preload budget. Set "
        f"IADMM_HBM_BYTES if this device differs.")
    return default


def _index_batch(a: torch.Tensor, bi: int, batch_size: int) -> torch.Tensor:
    """Batch ``bi`` of a stacked leaf.  A shared leaf (leading dim 1, the
    QP_RHS family) is broadcast to the batch size with ``expand``: a view,
    nothing is copied."""
    sub = a[0] if a.shape[0] == 1 else a[bi]
    if sub.shape[0] == 1 and batch_size > 1:
        sub = sub.expand((batch_size,) + tuple(sub.shape[1:]))
    return sub


def index_stack(stacked: QPBatch, cost_stack: Optional[torch.Tensor],
                bi: int, batch_size: int
                ) -> Tuple[QPBatch, Optional[torch.Tensor]]:
    """Batch ``bi`` of the stack and its Ruiz cost (or None)."""
    data = QPBatch(**{k: _index_batch(getattr(stacked, k), bi, batch_size)
                      for k in _SOLVER_FIELDS + ("eq_mask",)})
    cost = (_index_batch(cost_stack, bi, batch_size)
            if cost_stack is not None else None)
    return data, cost


def preload_train_stack(ds: RawDataset, ids: np.ndarray, n_batches: int,
                        batch_size: int, cfg: ExperimentConfig,
                        scale: Callable, device="cuda", diag_q: bool = False
                        ) -> Tuple[QPBatch, Optional[torch.Tensor]]:
    """The **scaled** train split on ``device``, stacked
    ``(n_batches, B, ...)``, written a chunk of at most 64 instances at a
    time so the peak holds one copy and one chunk.

    Returns ``(stacked, cost_stack)``: ``stacked`` is a QPBatch whose
    per-instance leaves are ``(n_batches, B, ...)`` and whose shared leaves
    (QP_RHS) are ``(1, 1, ...)``; ``cost_stack`` is the per-instance Ruiz
    cost (None when scaling is off), for unscaling the reported objective.
    Q and A0 are stored in ``cfg.preload_dtype``; ``diag_q=True`` (the
    caller checked that every Hessian is diagonal) stores Q as its float32
    diagonal, ``(…, n)``."""
    B = batch_size
    store_dtype = _STORE_DTYPES[cfg.preload_dtype]

    # QP_RHS: scale one instance; its d, e and cost depend only on the
    # shared (Q, p, A0), and the per-instance zl, zu scale by the shared e.
    e_shared = cost_shared = None
    shared_leaves: Dict[str, torch.Tensor] = {}
    if all(getattr(ds, k).shape[0] == 1 for k in ("Q", "p", "A0")):
        src = to_qp_batch(ds, np.asarray(ids[:1]), with_metric_views=False,
                          device=device)
        if cfg.scaling:
            src, st_one = scale(src)
            e_shared, cost_shared = st_one.e, st_one.cost   # (1, m), (1,)
        for k in ("Q", "p", "A0"):
            v = getattr(src, k)
            if k == "Q" and diag_q:
                v = torch.diagonal(v, dim1=-2, dim2=-1)
            elif k in ("Q", "A0"):
                v = v.to(store_dtype)
            shared_leaves[k] = v[None]   # (1, 1, ...)

    n, m = ds.Q.shape[-1], ds.A0.shape[-2]
    spec = {"zl": ((n_batches, B, m), torch.float32),
            "zu": ((n_batches, B, m), torch.float32),
            "eq_mask": ((n_batches, B, m), torch.bool)}
    if not shared_leaves:
        spec.update(Q=((n_batches, B, n), torch.float32) if diag_q
                    else ((n_batches, B, n, n), store_dtype),
                    p=((n_batches, B, n), torch.float32),
                    A0=((n_batches, B, m, n), store_dtype))
        if cfg.scaling:
            spec["cost"] = ((n_batches, B), torch.float32)
    buf = {k: torch.zeros(s, dtype=d, device=device)
           for k, (s, d) in spec.items()}

    cb = max(1, min(n_batches, 64 // B or 1))   # batches per chunk
    for s in range(0, n_batches, cb):
        nb = min(cb, n_batches - s)
        orig = to_qp_batch(ds, np.asarray(ids[s * B:(s + nb) * B]),
                           with_metric_views=False, device=device)
        if shared_leaves:
            zl, zu = orig.zl, orig.zu
            if cfg.scaling:
                zl, zu = e_shared * zl, e_shared * zu
            chunk = dict(zl=zl, zu=zu, eq_mask=orig.eq_mask)
        else:
            scd, cost = orig, None
            if cfg.scaling:
                scd, st = scale(orig)
                cost = st.cost
            chunk = dict(Q=scd.Q, p=scd.p, A0=scd.A0, zl=scd.zl, zu=scd.zu,
                         eq_mask=scd.eq_mask, cost=cost)
            if diag_q:
                chunk["Q"] = torch.diagonal(chunk["Q"], dim1=-2, dim2=-1)
        for k, dst in buf.items():
            v = chunk[k]
            dst[s:s + nb].copy_(v.reshape((nb, B) + tuple(v.shape[1:])))

    cost_stack = buf.pop("cost", None)
    if cost_stack is None and cost_shared is not None:
        cost_stack = cost_shared[None]   # (1, 1)
    stacked = QPBatch(
        Q=shared_leaves.get("Q", buf.get("Q")),
        p=shared_leaves.get("p", buf.get("p")),
        A0=shared_leaves.get("A0", buf.get("A0")),
        zl=buf["zl"], zu=buf["zu"], eq_mask=buf["eq_mask"])
    return stacked, cost_stack


# ---------------------------------------------------------------------------
# Sparse train-split cache
# ---------------------------------------------------------------------------

TILE = (8, 128)   # the route's (TM, TN) tiles


def sparse_cache_bytes(cache: List) -> int:
    """Device bytes of a sparse cache (values, indices, the BCOO gather
    plans, vectors, costs)."""
    total = 0
    for entry, cost in cache:
        leaves = [entry.p, entry.zl, entry.zu, entry.eq_mask]
        if isinstance(entry, sparse_mod.SparseQPBatch):
            for op in (entry.Q, entry.A0):
                leaves += [op.data, op.indices, *op.rows, *op.cols]
        else:
            for op in (entry.Q, entry.A0, entry.A0T):
                leaves += [op.vals, op.cols]
        if cost is not None:
            leaves.append(cost)
        total += sum(t.numel() * t.element_size() for t in leaves)
    return total


def preload_sparse_cache(ds: RawDataset, ids: np.ndarray, n_batches: int,
                         batch_size: int, cfg: ExperimentConfig,
                         scale: Callable, device="cuda",
                         verbose: bool = False) -> List[Tuple]:
    """``[(sparse batch, Ruiz cost or None)]`` per train batch, on
    ``device``: :class:`~sparse_mod.BSRQPBatch` for
    ``sparse_format='bsr'``, tiles stored in bf16 for
    ``matvec_mode='bf16'`` and in float32 otherwise;
    :class:`~sparse_mod.SparseQPBatch` for ``'bcoo'``, values in the scaled
    batch's dtype (float32)."""
    if cfg.sparse_format == "bcoo":
        return _preload_bcoo_cache(ds, ids, n_batches, batch_size, cfg,
                                   scale, device, verbose)
    if cfg.sparse_format != "bsr":
        raise ValueError(f"unknown sparse format {cfg.sparse_format!r}")
    B = batch_size
    dt = sparse_mod.tile_dtype(cfg.matvec_mode)

    # Pass 1: scale on the device, tile on the host, keep only the tiles.
    t0 = time.time()
    host = []
    kmax = [1, 1, 1]   # Q, A0, A0T tile counts
    for bi in range(n_batches):
        sl = np.asarray(ids[bi * B:(bi + 1) * B])
        data = to_qp_batch(ds, sl, with_metric_views=False, device=device)
        cost = None
        if cfg.scaling:
            data, sc = scale(data)
            cost = sc.cost
        Qh = data.Q.cpu().numpy()
        Ah = data.A0.cpu().numpy()
        h = dict(p=data.p, zl=data.zl, zu=data.zu, eq_mask=data.eq_mask,
                 cost=cost, shape_q=Qh.shape[1:], shape_a=Ah.shape[1:],
                 Q=bsr_tiles_host(Qh, TILE), A0=bsr_tiles_host(Ah, TILE),
                 A0T=bsr_tiles_host(Ah.transpose(0, 2, 1), TILE))
        for i, k in enumerate(("Q", "A0", "A0T")):
            kmax[i] = max(kmax[i], h[k][0].shape[2])
        host.append(h)

    # Pass 2: pad to the family-wide shape and place on the device.
    cache = []
    for h in host:
        shapes = dict(Q=h["shape_q"], A0=h["shape_a"],
                      A0T=h["shape_a"][::-1])
        ops = {k: bsr_from_host(*bsr_pad_k(*h[k], kmax[i]), shapes[k], dt,
                                device)
               for i, k in enumerate(("Q", "A0", "A0T"))}
        sp = sparse_mod.BSRQPBatch(p=h["p"], zl=h["zl"], zu=h["zu"],
                                   eq_mask=h["eq_mask"], **ops)
        cache.append((sp, h["cost"]))

    if verbose:
        gb = sparse_cache_bytes(cache) / 1e9
        print(f"sparse train cache: {n_batches} batches, {gb:.4f} GB on "
              f"{device} (bsr, converted in {time.time() - t0:.1f}s)",
              flush=True)
    return cache


def _preload_bcoo_cache(ds: RawDataset, ids: np.ndarray, n_batches: int,
                        batch_size: int, cfg: ExperimentConfig,
                        scale: Callable, device, verbose: bool) -> List[Tuple]:
    """The BCOO branch of :func:`preload_sparse_cache`."""
    B = batch_size
    t0 = time.time()
    host = []
    nse = [1, 1]   # Q, A0: the largest nonzero count over the split
    for bi in range(n_batches):
        sl = np.asarray(ids[bi * B:(bi + 1) * B])
        data = to_qp_batch(ds, sl, with_metric_views=False, device=device)
        cost = None
        if cfg.scaling:
            data, sc = scale(data)
            cost = sc.cost
        h = dict(p=data.p, zl=data.zl, zu=data.zu, eq_mask=data.eq_mask,
                 cost=cost)
        for i, k in enumerate(("Q", "A0")):
            M = getattr(data, k)
            count = int((M != 0).sum(dim=(-2, -1)).max())
            h[k] = (bcoo_entries(M, max(count, 1)), tuple(M.shape[-2:]))
            nse[i] = max(nse[i], count)
        host.append(h)

    cache = []
    for h in host:
        ops = {k: BCOOMatrix(*bcoo_pad(*h[k][0], nse[i], h[k][1]), h[k][1])
               for i, k in enumerate(("Q", "A0"))}
        sp = sparse_mod.SparseQPBatch(p=h["p"], zl=h["zl"], zu=h["zu"],
                                      eq_mask=h["eq_mask"], **ops)
        cache.append((sp, h["cost"]))

    if verbose:
        gb = sparse_cache_bytes(cache) / 1e9
        print(f"sparse train cache: {n_batches} batches, {gb:.4f} GB on "
              f"{device} (bcoo, nse {nse[0]}/{nse[1]}, converted in "
              f"{time.time() - t0:.1f}s)", flush=True)
    return cache
