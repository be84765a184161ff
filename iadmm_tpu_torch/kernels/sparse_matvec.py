"""Block-sparse (BSR) batched matvec: CUDA kernel, plain version, autograd.

Replaces ``iadmm_tpu/kernels/sparse_matvec.py::_bsr_matvec_kernel``.  A
matrix is stored as the (TM, TN) tiles that hold a nonzero: for each
instance and row-tile, a padded list of K column-tile indices and their
value tiles.  Pad tiles are zeros at column 0, so they add nothing.  The
matvec reads only the stored tiles; for banded or block-structured
constraint matrices that cuts the bytes by the tile-occupancy factor.

The kernel (``csrc/bsr_matvec.cu``) runs a warp per eight rows of a
row-tile, each lane reading 16 bytes of a tile row at a time and the vector
elements under them directly, with no shared memory and no barrier.
Its bound is the stored tiles' bytes (see the header of the source).
:func:`bsr_matvec` launches it on CUDA tensors and runs
:func:`bsr_matvec_plain` on CPU tensors; :func:`bsr_matvec_group` runs up
to three independent products in one launch.  :func:`bsr_matvec_ad` and
:func:`bsr_matvec_group_ad` are differentiable in the vectors, with the
backward the same launch over the stored transposes.

Host tiling (:func:`bsr_tiles_host`, :func:`bsr_pad_k`) is numpy, as in the
JAX package.
"""

from __future__ import annotations

import array
import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

KERNEL_TM = (8, 128)   # row-tile heights the CUDA kernel takes
KERNEL_TN = 128        # the column-tile width it takes
_TILE_DTYPES = (torch.bfloat16, torch.float32)
GROUP_MAX = 3           # products a launch takes
# The C entry takes each product's 4 pointers and 6 sizes packed in one
# int64 array: ctypes converts each argument on every call, and 33 of them
# cost the host more than the launch.
_ARGS = [_build.P, _build.I, _build.I, _build.P]
_fn = None              # the bound C entry, looked up at the first launch


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class BSRMatrix:
    """Batched block-sparse matrix in padded BSR form.

    vals: (B, R, K, TM, TN) value tiles (zero-padded);
    cols: (B, R, K) int32 column-tile index of each stored tile;
    shape: the logical (m, n) of one instance.

    Construction checks the shapes and that every column index lies in
    ``[0, Cn)``, ``Cn = ceil(n / TN)``: the kernel gathers the vector at
    those offsets.  Build it once per batch (:func:`bsr_from_dense`, the
    sparse train cache), not per matvec."""

    vals: torch.Tensor
    cols: torch.Tensor
    shape: Tuple[int, int]

    def __post_init__(self):
        if self.vals.dim() != 5 or self.cols.dim() != 3:
            raise ValueError(f"BSR vals must be (B, R, K, TM, TN) and cols "
                             f"(B, R, K); got {tuple(self.vals.shape)} and "
                             f"{tuple(self.cols.shape)}")
        if tuple(self.vals.shape[:3]) != tuple(self.cols.shape):
            raise ValueError(f"BSR vals {tuple(self.vals.shape)} and cols "
                             f"{tuple(self.cols.shape)} disagree")
        if self.cols.dtype != torch.int32:
            raise TypeError(f"BSR cols must be int32, not {self.cols.dtype}")
        m, n = self.shape
        tm, tn = self.tile
        if self.vals.shape[1] * tm < m:
            raise ValueError(f"{self.vals.shape[1]} row-tiles of {tm} rows "
                             f"do not cover m={m}")
        cn = _round_up(n, tn) // tn
        if self.cols.numel() and (int(self.cols.min()) < 0
                                  or int(self.cols.max()) >= cn):
            raise ValueError(f"BSR column-tile index outside [0, {cn}) for "
                             f"n={n}, TN={tn}")

    @property
    def tile(self) -> Tuple[int, int]:
        return self.vals.shape[-2], self.vals.shape[-1]

    @property
    def occupancy(self) -> float:
        """Stored tiles / total tiles (the byte factor against dense): K
        stored column-tiles per row-tile over Cn column-tiles."""
        B, R, K = self.cols.shape
        tm, tn = self.tile
        cn = _round_up(self.shape[1], tn) // tn
        return K / max(cn, 1)


def bsr_tiles_host(M: np.ndarray, tile: Tuple[int, int] = (128, 128),
                   min_k: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Host tiling of a (B, m, n) dense batch into padded BSR ``(vals,
    cols)`` numpy arrays; K is the largest active column-tile count over
    all (instance, row-tile) pairs, or ``min_k`` if larger."""
    M = np.asarray(M)
    B, m, n = M.shape
    tm, tn = tile
    mp, np_ = _round_up(m, tm), _round_up(n, tn)
    Mp = np.zeros((B, mp, np_), M.dtype)
    Mp[:, :m, :n] = M
    R, Cn = mp // tm, np_ // tn
    tiles = Mp.reshape(B, R, tm, Cn, tn).transpose(0, 1, 3, 2, 4)
    active = tiles.reshape(B, R, Cn, -1).any(axis=-1)      # (B, R, Cn)
    K = max(int(active.sum(axis=-1).max()), 1, min_k)
    K = min(K, Cn)
    # A stable argsort of ~active lists the active column tiles first, in
    # ascending column order.
    order = np.argsort(~active, axis=-1, kind="stable")[:, :, :K]  # (B,R,K)
    taken = np.take_along_axis(active, order, axis=-1)
    vals = np.take_along_axis(tiles, order[..., None, None], axis=2)
    vals = np.where(taken[..., None, None], vals, 0)
    cols = np.where(taken, order, 0).astype(np.int32)
    return vals, cols


def bsr_pad_k(vals: np.ndarray, cols: np.ndarray,
              K: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad host BSR arrays to K stored tiles per row-tile (zero tiles at
    column 0), so batches of one family share one shape."""
    k0 = vals.shape[2]
    if k0 >= K:
        return vals, cols
    pad = [(0, 0)] * vals.ndim
    pad[2] = (0, K - k0)
    return (np.pad(vals, pad), np.pad(cols, [(0, 0), (0, 0), (0, K - k0)]))


def bsr_from_host(vals: np.ndarray, cols: np.ndarray, shape,
                  dtype=torch.float32, device="cuda") -> BSRMatrix:
    """Host BSR arrays -> device :class:`BSRMatrix` with ``dtype`` tiles."""
    return BSRMatrix(
        vals=torch.as_tensor(np.ascontiguousarray(vals)).to(device, dtype),
        cols=torch.as_tensor(np.ascontiguousarray(cols)).to(device),
        shape=(int(shape[0]), int(shape[1])))


def bsr_from_dense(M, tile: Tuple[int, int] = (128, 128),
                   dtype=torch.float32, min_k: int = 0,
                   device="cuda") -> BSRMatrix:
    """Dense (B, m, n) batch (numpy, or a tensor fetched to the host) ->
    :class:`BSRMatrix` on ``device``.  ``min_k`` floors the padded tile
    count K so batches of one family share one shape."""
    if isinstance(M, torch.Tensor):
        M = M.detach().cpu().numpy()
    M = np.asarray(M)
    vals, cols = bsr_tiles_host(M, tile, min_k=min_k)
    return bsr_from_host(vals, cols, M.shape[-2:], dtype, device)


def bsr_pair_from_dense(M, tile: Tuple[int, int] = (128, 128),
                        dtype=torch.float32,
                        device="cuda") -> Tuple[BSRMatrix, BSRMatrix]:
    """(M, Mᵀ) in BSR form: the transpose is a second stored operand."""
    if isinstance(M, torch.Tensor):
        M = M.detach().cpu().numpy()
    M = np.asarray(M)
    return (bsr_from_dense(M, tile, dtype, device=device),
            bsr_from_dense(M.transpose(0, 2, 1), tile, dtype, device=device))


def bsr_matvec_plain(bsr: BSRMatrix, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: y = M·v, (B, n) -> (B, m) f32.

    Each stored tile's TN-wide segment of the zero-padded float32 ``v`` is
    rounded to the tile dtype before the product (the TPU kernel's
    ``seg.astype(tile.dtype)``); products are summed in float32."""
    B, R, K, TM, TN = bsr.vals.shape
    m, n = bsr.shape
    n_pad = _round_up(n, TN)
    v_p = F.pad(v.to(torch.float32), (0, n_pad - n)).reshape(B, -1, TN)
    idx = bsr.cols.reshape(B, R * K, 1).long().expand(B, R * K, TN)
    seg = torch.gather(v_p, 1, idx).reshape(B, R, K, TN)
    seg = seg.to(bsr.vals.dtype).to(torch.float32)
    out = torch.einsum("brkij,brkj->bri", bsr.vals.to(torch.float32), seg)
    return out.reshape(B, R * TM)[:, :m]


def bsr_matvec_group_plain(mats, vs) -> Tuple[torch.Tensor, ...]:
    """Plain version of the grouped launch: ``bsr_matvec_plain(M_i, v_i)``
    for each pair, in order."""
    return tuple(bsr_matvec_plain(M, v) for M, v in zip(mats, vs))


def check_kernel_shapes(bsr: BSRMatrix, v: torch.Tensor) -> None:
    """Raise unless the CUDA kernel takes this matrix and vector."""
    B, R, K, TM, TN = bsr.vals.shape
    if TM not in KERNEL_TM or TN != KERNEL_TN:
        raise ValueError(f"the CUDA BSR kernel takes (TM, TN) with TM in "
                         f"{KERNEL_TM} and TN={KERNEL_TN}, not ({TM}, {TN})")
    if bsr.vals.dtype not in _TILE_DTYPES:
        raise TypeError(f"BSR tiles must be one of {_TILE_DTYPES}, not "
                        f"{bsr.vals.dtype}")
    if v.dim() != 2 or v.shape != (B, bsr.shape[1]):
        raise ValueError(f"vector {tuple(v.shape)} does not fit a batch of "
                         f"{B} matrices of shape {bsr.shape}")
    if not (bsr.vals.is_cuda and bsr.cols.is_cuda and v.is_cuda):
        raise ValueError("the CUDA BSR kernel takes CUDA tensors only")
    if not (bsr.vals.device == bsr.cols.device == v.device):
        raise ValueError("BSR tiles, indices and vector must be on one "
                         "device")


def _operand(bsr: BSRMatrix, v: torch.Tensor):
    """(kernel arguments of one product, its output, the tensors the
    arguments point into): the checks, then the copies the kernel needs only
    where the tensors do not qualify.  The caller holds the tensors until
    the launch is queued: a copy freed before that could be handed to the
    next allocation (another product's copy) and overwritten first."""
    check_kernel_shapes(bsr, v)
    B, R, K, TM, _ = bsr.vals.shape
    m, n = bsr.shape
    vals = _build.aligned(bsr.vals)
    cols = bsr.cols if bsr.cols.is_contiguous() else bsr.cols.contiguous()
    if v.dtype != torch.float32 or not v.is_contiguous():
        v = v.to(torch.float32).contiguous()
    out = torch.empty((B, m), dtype=torch.float32, device=v.device)
    return ([vals.data_ptr(), cols.data_ptr(), v.data_ptr(), out.data_ptr(),
             B, R, K, TM, m, n], out, (vals, cols, v))


def bsr_matvec_cuda(bsr: BSRMatrix, v: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors; same contract as
    :func:`bsr_matvec_plain`."""
    return bsr_matvec_group_cuda([bsr], [v])[0]


def bsr_matvec(bsr: BSRMatrix, v: torch.Tensor) -> torch.Tensor:
    """y = M·v batched, (B, n) -> (B, m) float32, reading only the stored
    tiles: the kernel on CUDA tensors, the plain version on CPU tensors."""
    if v.is_cuda:
        return bsr_matvec_cuda(bsr, v)
    return bsr_matvec_plain(bsr, v)


bsr_matvec.launches = 0  # kernel launches (of one product or a group),
# counted by bsr_matvec_group_cuda


def bsr_matvec_group_cuda(mats, vs) -> Tuple[torch.Tensor, ...]:
    """Up to ``GROUP_MAX`` independent products ``M_i·v_i`` (each with its
    own shape and stored-tile count, all of one tile dtype) in one launch
    of the kernel; each output bitwise the product launched alone."""
    if not 1 <= len(mats) == len(vs) <= GROUP_MAX:
        raise ValueError(f"a grouped BSR launch takes 1 to {GROUP_MAX} "
                         f"(matrix, vector) pairs, not {len(mats)} and "
                         f"{len(vs)}")
    dtype = mats[0].vals.dtype
    if any(M.vals.dtype != dtype for M in mats):
        raise TypeError("the products of a grouped BSR launch must share "
                        "one tile dtype")
    if any(v.device != vs[0].device for v in vs):
        raise ValueError("the products of a grouped BSR launch must be on "
                         "one device")
    args, outs, held = [], [], []
    for M, v in zip(mats, vs):
        a, out, h = _operand(M, v)
        args += a
        outs.append(out)
        held.append(h)
    global _fn
    if _fn is None:
        _fn = _build.function("bsr_matvec", "iadmm_bsr_matvec_group",
                              _ARGS)
    packed = array.array("q", args)
    code = _fn(packed.buffer_info()[0], len(mats),
               int(dtype == torch.bfloat16), _build.stream_ptr(vs[0].device))
    del held
    _build.check(code, "iadmm_bsr_matvec_group")
    bsr_matvec.launches += 1
    return tuple(outs)


def bsr_matvec_group(mats, vs) -> Tuple[torch.Tensor, ...]:
    """``(M_1·v_1, ...)`` for up to ``GROUP_MAX`` pairs: one launch of the
    kernel on CUDA tensors, the plain version on CPU tensors."""
    if vs[0].is_cuda:
        return bsr_matvec_group_cuda(mats, vs)
    return bsr_matvec_group_plain(mats, vs)


class _BSRGroupAD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pairs, *vs):
        ctx.transposes = tuple(MT for _, MT in pairs)
        return bsr_matvec_group(tuple(M for M, _ in pairs), vs)

    @staticmethod
    def backward(ctx, *gs):
        need = [i for i, ok in enumerate(ctx.needs_input_grad[1:]) if ok]
        dv = bsr_matvec_group([ctx.transposes[i] for i in need],
                              [gs[i] for i in need])
        grads = [None] * len(gs)
        for i, d in zip(need, dv):
            grads[i] = d
        return (None, *grads)


def bsr_matvec_group_ad(pairs, vs) -> Tuple[torch.Tensor, ...]:
    """Differentiable (in each vector) grouped BSR matvec: ``(M_i·v_i)``
    for ``pairs`` of ``(M_i, M_iᵀ)``, one launch; the VJP is one launch of
    ``M_iᵀ·ȳ_i`` over the products whose vector needs a gradient.  A
    vector given twice gets its two contributions from autograd in the
    order of ``pairs``."""
    return _BSRGroupAD.apply(tuple(pairs), *vs)


def bsr_matvec_ad(M: BSRMatrix, MT: BSRMatrix, v: torch.Tensor
                  ) -> torch.Tensor:
    """Differentiable (in ``v``) BSR matvec: y = M·v, with the VJP
    dv = Mᵀ·ȳ a second BSR matvec over the stored transpose ``MT``.  The
    matrices are problem data and get no gradient."""
    return bsr_matvec_group_ad([(M, MT)], [v])[0]
