"""The KKT pass alone: one read of the stacked matrix [Q; A0] that yields
both halves of a KKT matvec, for one or two right-hand sides.

Every learned iteration of the port runs this pass (``csrc/kkt_matvec.cuh``)
inside its kernels: twice a step in the rollout and the training forward,
six times in the training backward, once a polish step or CG iteration in
Stage II.  It computes the TPU kernels' ``_mv_maker`` products
(``iadmm_tpu/kernels/train_rollout.py``): for w = [wt; wb],

    Σ_c partial[b, c, :] = Q·wt + A0ᵀ·wb      (mv_q(wt) + mv_a0t(wb))
    rowdot[b, :]         = A0·wt               (mv_a0(wt))

with ``partial[b, c, j]`` the sum over chunk c of ``_build.KKT_ROWS`` rows
of [Q; A0] (Q symmetric).  bf16 data: the vectors are rounded to bf16, the
sums float32; float32 data: nothing rounded.  :func:`kkt_pass` launches
``csrc/kkt_pass.cu`` on CUDA tensors (``kkt_pass.launches`` counts the
launches) and runs :func:`kkt_pass_plain` on CPU tensors.
"""

from __future__ import annotations

import torch

from . import _build

_ARGS = [_build.P] * 10 + [_build.I] * 4 + [_build.P]
_DATA_DTYPES = (torch.bfloat16, torch.float32)


def n_chunks(n: int, m: int) -> int:
    """Chunks of ``_build.KKT_ROWS`` rows of the (n+m) x n matrix."""
    return -(-(n + m) // _build.KKT_ROWS)


def kkt_pass_plain(Q, A0, wt, wb):
    """Plain PyTorch version of one right-hand side: (partial (B, chunks,
    n), rowdot (B, m)).  bf16 Q and A0: the vectors rounded to bf16, float32
    products and sums; else everything in the dtype of Q."""
    B, n = wt.shape
    m = wb.shape[1]
    wd = torch.float32 if Q.dtype == torch.bfloat16 else Q.dtype

    def R(v):
        return v.to(Q.dtype).to(wd)
    rows = _build.KKT_ROWS
    nch = n_chunks(n, m)
    mat = torch.cat([Q.to(wd), A0.to(wd)], dim=1)
    w = torch.cat([R(wt), R(wb)], dim=1)
    pad = nch * rows - (n + m)
    mat = torch.nn.functional.pad(mat, (0, 0, 0, pad))
    w = torch.nn.functional.pad(w, (0, pad))
    partial = torch.einsum("bcr,bcrj->bcj", w.reshape(B, nch, rows),
                           mat.reshape(B, nch, rows, n))
    rowdot = torch.einsum("bij,bj->bi", A0.to(wd), R(wt))
    return partial, rowdot


def _check(Q, A0, rhs):
    B, n = Q.shape[0], Q.shape[-1]
    m = A0.shape[1]
    bad = []
    if tuple(Q.shape) != (B, n, n):
        bad.append(f"Q {tuple(Q.shape)}")
    if tuple(A0.shape) != (B, m, n):
        bad.append(f"A0 {tuple(A0.shape)}")
    for k, (wt, wb) in enumerate(rhs):
        if tuple(wt.shape) != (B, n) or tuple(wb.shape) != (B, m):
            bad.append(f"right-hand side {k}: wt {tuple(wt.shape)}, wb "
                       f"{tuple(wb.shape)}")
    if bad:
        raise ValueError(f"kkt_pass: {', '.join(bad)} do not fit Q (B, n, "
                         f"n), A0 (B, m, n), wt (B, n), wb (B, m)")
    return B, n, m


def kkt_pass(Q, A0, wt, wb, wt2=None, wb2=None):
    """[(partial, rowdot)] for the right-hand side (wt, wb) and, when given,
    (wt2, wb2), from one read of [Q; A0]; each output is bitwise what a
    one-vector call gives.  Q (B,n,n), A0 (B,m,n) in bf16 or float32;
    wt (B,n), wb (B,m)."""
    rhs = [(wt, wb)] + ([] if wt2 is None else [(wt2, wb2)])
    if (wt2 is None) != (wb2 is None):
        raise ValueError("kkt_pass: give both wt2 and wb2, or neither")
    B, n, m = _check(Q, A0, rhs)
    if not Q.is_cuda:
        return [kkt_pass_plain(Q, A0, a, b) for a, b in rhs]
    if Q.dtype not in _DATA_DTYPES or A0.dtype != Q.dtype:
        raise ValueError(f"kkt_pass: Q {Q.dtype}, A0 {A0.dtype}; the kernel "
                         f"takes both bf16 or both float32")
    dev = Q.device
    for t in (A0, *(v for pair in rhs for v in pair)):
        if t.device != dev:
            raise ValueError("kkt_pass: all tensors must be on one device")
    Qc, Ac = _build.aligned(Q), _build.aligned(A0)
    vecs = [_build.aligned(v.to(torch.float32)) for pair in rhs for v in pair]
    outs = [(torch.empty((B, n_chunks(n, m), n), dtype=torch.float32,
                         device=dev),
             torch.empty((B, m), dtype=torch.float32, device=dev))
            for _ in rhs]
    ptrs = [vecs[0], vecs[1], *outs[0]]
    ptrs += [vecs[2], vecs[3], *outs[1]] if len(rhs) == 2 else [None] * 4
    fn = _build.function("kkt_pass", "iadmm_kkt_pass", _ARGS)
    code = fn(Qc.data_ptr(), Ac.data_ptr(),
              *(None if t is None else t.data_ptr() for t in ptrs),
              B, n, m, int(Q.dtype == torch.float32), _build.stream_ptr(dev))
    _build.check(code, "iadmm_kkt_pass")
    kkt_pass.launches += 1
    return outs


kkt_pass.launches = 0   # kernel launches
