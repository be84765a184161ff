"""Least times an NVIDIA H100 SXM could take for a kernel's work.

    python -m iadmm_tpu_torch.kernels.bounds

prints the bounds of the TPU kernels the port has not ported yet, from
their shapes: the segment pair of ``train_rollout.py`` at the flagship
chunk (B=2, J=100, S=2000, h=800) and the BSR matvec at
``scripts/bench_sparse.py``'s default (B=8, n=1000, band half-widths
8..256, (8, 128) bf16 tiles, one matvec).  ``chip_smoke.py`` computes the
ported kernels' bounds with ``bound_ms`` from the inputs of its run.

A bound is the larger of two times: the bytes the work must move (each
input read once, each output written once) over the memory rate, and its
operations over the peak rate of their type (NVIDIA data sheet, dense).
"""

from __future__ import annotations

import json

import numpy as np

HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


def bound_ms(nbytes, bf16_ops=0.0, f32_ops=0.0):
    """(bound in ms, "bytes" or "operations": which of the two limits)."""
    t_bytes = nbytes / HBM_BPS
    t_ops = bf16_ops / BF16_FLOPS + f32_ops / F32_FLOPS
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, by


def segment_pair(B=2, J=100, n=1000, m=1000, h=800):
    """Bounds of ``_fwd_seg_kernel`` and ``_bwd_seg_kernel`` for one chunk:
    per step the gate GEMM (2·M·h·4h) and the KKT matvecs, the backward
    recomputing the forward; the data and the chunk's start H, C (float32)
    read once."""
    M = B * (n + m)
    gemm = 2.0 * M * h * 4 * h
    mv = 2.0 * B * (n * n + 2 * m * n)
    data = B * (n * n + m * n) * 2 + (2 * 4 * h + h * 4 * h + h) * 2
    ckpt = M * h * 8
    return {
        "fwd_seg (train_rollout.py:147)": bound_ms(
            data + ckpt, bf16_ops=J * (gemm + 3 * mv),
            f32_ops=J * M * (2.0 * 2 * 4 * h + 20.0 * h)),
        "bwd_seg (train_rollout.py:664)": bound_ms(
            data + ckpt + (h * 4 * h + 2 * 4 * h) * 4,
            bf16_ops=J * (4 * gemm + 8 * mv),
            f32_ops=J * M * (6.0 * 2 * 4 * h + 60.0 * h))}


def bsr_tiles(nb=1000, w=8, tm=8, tn=128):
    """Stored (tm, tn) tiles of an nb x nb band of half-width w."""
    idx = np.arange(nb)
    band = np.abs(idx[:, None] - idx[None, :]) <= w
    rows, cols = -(-nb // tm), -(-nb // tn)
    pad = np.zeros((rows * tm, cols * tn), bool)
    pad[:nb, :nb] = band
    return int(pad.reshape(rows, tm, cols, tn).any(axis=(1, 3)).sum())


def bsr_matvec(B=8, nb=1000, widths=(8, 16, 64, 128, 256), tm=8, tn=128):
    """Bounds of one ``_bsr_matvec_kernel`` call per band half-width: the
    stored bf16 tiles and their int32 indices, the vector in and out."""
    out = {}
    for w in widths:
        tiles = bsr_tiles(nb, w, tm, tn)
        out[f"bsr_matvec w={w} ({tiles} tiles/instance)"] = bound_ms(
            B * (tiles * (tm * tn * 2 + 4) + nb * 8),
            bf16_ops=B * 2.0 * tiles * tm * tn)
    return out


def unported():
    return {k: dict(bound_ms=v[0], bound_by=v[1])
            for k, v in {**segment_pair(), **bsr_matvec()}.items()}


if __name__ == "__main__":
    print(json.dumps(unported(), indent=1))
