"""The sparse train-split cache: scale and tile every train batch once.

Counterpart of ``preload_sparse_cache`` (its BSR branch) and
``sparse_cache_bytes`` in ``iadmm_tpu/train/preload.py``.  Each batch is
Ruiz-scaled on the device, fetched and tiled on the host, and only the
tiles are kept; then every batch is padded to the family-wide tile count K
of each operand (Q, A0, A0ᵀ), so all batches share one shape, and placed
on the device.  The BCOO branch is not ported.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..config import ExperimentConfig
from ..kernels import sparse as sparse_mod
from ..kernels.sparse_matvec import bsr_from_host, bsr_pad_k, bsr_tiles_host
from ..problems.generators import RawDataset
from ..problems.io import to_qp_batch

TILE = (8, 128)   # the route's (TM, TN) tiles


def sparse_cache_bytes(cache: List) -> int:
    """Device bytes of a sparse cache (tiles, indices, vectors, costs)."""
    total = 0
    for entry, cost in cache:
        leaves = [entry.p, entry.zl, entry.zu, entry.eq_mask]
        for op in (entry.Q, entry.A0, entry.A0T):
            leaves += [op.vals, op.cols]
        if cost is not None:
            leaves.append(cost)
        total += sum(t.numel() * t.element_size() for t in leaves)
    return total


def preload_sparse_cache(ds: RawDataset, ids: np.ndarray, n_batches: int,
                         batch_size: int, cfg: ExperimentConfig,
                         scale: Callable, device="cuda",
                         verbose: bool = False
                         ) -> List[Tuple[sparse_mod.BSRQPBatch,
                                         Optional[torch.Tensor]]]:
    """``[(BSRQPBatch, Ruiz cost or None)]`` per train batch, on
    ``device``, tiles stored in bf16 for ``matvec_mode='bf16'`` and in
    float32 otherwise."""
    if cfg.sparse_format != "bsr":
        raise NotImplementedError(
            f"the {cfg.sparse_format!r} sparse cache is not ported to "
            f"PyTorch yet; see ROADMAP.md (Queue 1, the BCOO sparse route)")
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
