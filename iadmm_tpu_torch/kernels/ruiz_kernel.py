"""Ruiz scaling on the card: every sweep of ``scaling.ruiz_scale`` in one
launch of ``csrc/ruiz.cu``.

:func:`ruiz_scale_cuda` takes CUDA float32 data and returns what
``ruiz_scale`` returns (the scaled Q, p, A0, zl, zu and the factors d, e,
cost); ``ruiz_scale_cuda.launches`` counts its launches.  ``ruiz_scale``
calls it for CUDA tensors and runs its plain body, ``ruiz_scale_plain``,
on CPU tensors.

The kernel forms every element and factor in the eager order, so the one
place its bits can leave the eager function's is the mean of the column
maxima of Q in the cost norm: one warp sums them in the order of PyTorch's
CUDA mean over a contiguous row (:func:`kernel_order_mean`), which is
PyTorch's own order where n ≥ 128 and n is a multiple of 4 (rows 16-byte
aligned).  :func:`ruiz_plain` is the plain function with that mean, the
kernel's plain version for every shape.
"""

from __future__ import annotations

import ctypes
import threading
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..scaling.ruiz import ruiz_scale_plain
from ..types import ScalingState
from . import _build

# barrier counters at the head of the workspace
RUIZ_MAX_SLOTS = _build.header_int("ruiz.cu", "MAX_SLOTS")
_ARGS = [_build.P] * 14 + [_build.I] * 4 + [_build.P]
_COUNT_LOCK = threading.Lock()   # callers may scale from several threads


class RuizPlan(NamedTuple):
    """How a launch lays out B instances: rows in shared memory
    (``resident``) or in the outputs, instances at a time (``slots``), CTAs
    an instance, rows of [Q; A0] a CTA, shared memory bytes a CTA, and the
    block width of the mean's order."""
    resident: bool
    slots: int
    ctas: int
    rows: int
    smem: int
    mean_width: int


@lru_cache(maxsize=64)
def _plan(device_index: int, B: int, n: int, m: int):
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(device_index):
        fits = _build.function("ruiz", "iadmm_ruiz_plan",
                               [_build.I] * 3 + [_build.P])(B, n, m, out) == 0
    return RuizPlan(bool(out[0]), *out[1:]) if fits else None


def ruiz_plan(B: int, n: int, m: int, dev) -> RuizPlan:
    """The kernel's layout for B instances of n variables and m rows on the
    CUDA device ``dev``; raises ValueError where n is too large for its
    shared memory (the dt, p and column-maximum vectors of n floats each)."""
    plan = _plan(torch.device(dev).index or 0, B, n, m)
    if plan is None:
        raise ValueError(f"ruiz_scale: n={n} is above what the kernel's "
                         f"shared memory takes on this device")
    return plan


def mean_width(B: int, n: int) -> int:
    """The block width of PyTorch's CUDA mean over the last dimension of a
    contiguous (B, n) float32 tensor, vectorized by 4: at most 512 threads,
    block.x first a warp, block.y over the B outputs up to what is left,
    block.x widened into the rest (ATen's ``ReduceConfig``); at least 32.
    ``csrc/ruiz.cu`` takes the same."""
    def last_pow2(x):
        return 1 << (max(int(x), 1).bit_length() - 1)
    d0 = last_pow2(n // 4) if n // 4 < 512 else 512
    d1 = last_pow2(B) if B < 512 else 512
    bh = min(d1, 512 // min(d0, 32))
    return max(min(d0, 512 // bh), 32)


def kernel_order_mean(v: torch.Tensor) -> torch.Tensor:
    """The mean over the last dimension of ``v`` (B, n), float32, in the
    kernel's order: virtual thread x < W (``mean_width``) adds the vectors
    of 4 at x, x + W, ... into four accumulators, the n % 4 tail to thread
    x's first, and combines them in lane order; the W sums fold in halves
    to 32, then as shfl_down from 16 to 1; the sum times float(B)/float(B·n)."""
    B, n = v.shape
    W = mean_width(B, n)
    nv = n // 4
    acc = v.new_zeros((B, W, 4))
    vec = v[:, :4 * nv].reshape(B, nv, 4)
    for s in range(0, nv, W):
        part = vec[:, s:s + W]
        acc[:, :part.shape[1]] = acc[:, :part.shape[1]] + part
    tail = n - 4 * nv
    if tail:
        acc[:, :tail, 0] = acc[:, :tail, 0] + v[:, 4 * nv:]
    s = ((acc[..., 0] + acc[..., 1]) + acc[..., 2]) + acc[..., 3]
    while s.shape[1] > 32:
        h = s.shape[1] // 2
        s = s[:, :h] + s[:, h:]
    for off in (16, 8, 4, 2, 1):
        s = s[:, :off] + s[:, off:2 * off]
    factor = np.float32(B) / np.float32(B * n)
    return s[:, 0] * float(factor)


def ruiz_plain(Q, p, A0, zl, zu, iters: int = 10):
    """Plain PyTorch version of ``csrc/ruiz.cu``: ``ruiz_scale_plain`` with
    the cost norm's mean in the kernel's order (:func:`kernel_order_mean`)."""
    return ruiz_scale_plain(Q, p, A0, zl, zu, iters=iters,
                            col_mean=kernel_order_mean)


def ruiz_scale_cuda(Q, p, A0, zl, zu, iters: int = 10):
    """``iters`` sweeps of Ruiz scaling in one launch of ``csrc/ruiz.cu``:
    (Q, p, A0, zl, zu) scaled and ``ScalingState(d, e, cost)``.  CUDA
    float32 tensors, Q (B,n,n), p (B,n), A0 (B,m,n), zl/zu (B,m); raises
    ValueError for any other dtype or device."""
    B, n = p.shape
    m = A0.shape[-2]
    if (tuple(Q.shape) != (B, n, n) or tuple(A0.shape) != (B, m, n)
            or tuple(zl.shape) != (B, m) or tuple(zu.shape) != (B, m)):
        raise ValueError(f"ruiz_scale: Q {tuple(Q.shape)}, p "
                         f"{tuple(p.shape)}, A0 {tuple(A0.shape)}, zl "
                         f"{tuple(zl.shape)}, zu {tuple(zu.shape)} do not fit "
                         f"Q (B,n,n), p (B,n), A0 (B,m,n), zl/zu (B,m)")
    ins = (Q, p, A0, zl, zu)
    dev = Q.device
    if not Q.is_cuda or any(t.dtype != torch.float32 or t.device != dev
                            for t in ins):
        raise ValueError("ruiz_scale: the kernel takes float32 CUDA tensors "
                         "on one device; got "
                         + ", ".join(f"{t.dtype} on {t.device}" for t in ins))
    if iters < 0:
        raise ValueError(f"ruiz_scale: iters={iters} < 0")

    def new(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)
    if B == 0:
        return (Q.clone(), p.clone(), A0.clone(), zl.clone(), zu.clone(),
                ScalingState(d=new(0, n), e=new(0, m), cost=new(0)))
    ruiz_plan(B, n, m, dev)
    Q, p, A0, zl, zu = (_build.aligned(t) for t in ins)
    Qo, Ao = new(B, n, n), new(B, m, n)
    po, d, zlo, zuo, e, cost = (new(B, n), new(B, n), new(B, m), new(B, m),
                                new(B, m), new(B))
    ws = torch.empty((RUIZ_MAX_SLOTS + B * (iters + 1) * 2 * n,),
                     dtype=torch.int32, device=dev)
    fn = _build.function("ruiz", "iadmm_ruiz_scale", _ARGS)
    _build.check(fn(*(t.data_ptr() for t in (Q, p, A0, zl, zu, Qo, po, Ao,
                                             zlo, zuo, d, e, cost, ws)),
                    B, n, m, iters, _build.stream_ptr(dev)),
                 "iadmm_ruiz_scale")
    with _COUNT_LOCK:
        ruiz_scale_cuda.launches += 1
    return Qo, po, Ao, zlo, zuo, ScalingState(d=d, e=e, cost=cost)


ruiz_scale_cuda.launches = 0   # launches of csrc/ruiz.cu
