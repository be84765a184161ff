"""Least times an NVIDIA H100 SXM could take for a kernel's work.

    python -m iadmm_tpu_torch.kernels.bounds

prints the bounds of the TPU kernels the port has not ported yet, from
their shapes: the segment pair of ``train_rollout.py`` at the flagship
chunk (B=2, J=100, S=2000, h=800).  ``chip_smoke.py`` computes the ported
kernels' bounds from the inputs of its run with :func:`cell`,
:func:`train_fwd`, :func:`train_bwd` (each at the bf16 or the float32
profile), :func:`bsr_matvec` and ``bound_ms``.

A bound is the larger of two times: the bytes the work must move (each
input read once, each output written once) over the memory rate, and its
operations over the peak rate of their type (NVIDIA data sheet, dense):
a profile's products at its own rate (bf16 tensor cores, or float32
outside the tensor cores: the TPU kernels' float32 products run at
``Precision.HIGHEST``, with no TF32), the elementwise work at the float32
rate.
"""

from __future__ import annotations

import json

HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


def bound_ms(nbytes, bf16_ops=0.0, f32_ops=0.0):
    """(bound in ms, "bytes" or "operations": which of the two limits)."""
    t_bytes = nbytes / HBM_BPS
    t_ops = bf16_ops / BF16_FLOPS + f32_ops / F32_FLOPS
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, by


def _rates(dtype, product_ops, f32_ops):
    """``bound_ms`` keywords: the products at ``dtype``'s rate, the rest at
    the float32 rate."""
    if dtype == "bfloat16":
        return dict(bf16_ops=product_ops, f32_ops=f32_ops)
    if dtype != "float32":
        raise ValueError(f"unknown dtype {dtype!r}")
    return dict(f32_ops=product_ops + f32_ops)


def _nbytes(dtype) -> int:
    return 2 if dtype == "bfloat16" else 4


def cell(M, h, gate="bfloat16", state_bytes=4):
    """Bound of one cell call over M tokens: x (M, 2) float32, H and C read
    and H', C' written at ``state_bytes`` an element, delta out; the
    weights in the gate dtype, b and b_h float32.  The H·U GEMM at the gate
    dtype's rate; x·W and the gates' elementwise work in float32."""
    h4 = 4 * h
    nbytes = (M * 2 * 4 + 4 * M * h * state_bytes + M * 4
              + (2 * h4 + h * h4 + h) * _nbytes(gate) + h4 * 4 + 4)
    return bound_ms(nbytes, **_rates(gate, 2.0 * M * h * h4,
                                     2.0 * M * 2 * h4 + 20.0 * M * h))


def _chunk(B, J, n, m, h, K, dtype):
    """(data bytes, stream bytes, matvec ops a step, GEMM ops a step) of a
    training chunk in ``dtype``: Q, A0 and the cell weights in it, the
    vectors float32; the H stream in it, C float32."""
    M, h4, cb = B * (n + m), 4 * h, _nbytes(dtype)
    data = (B * (n * n + m * n) * cb + B * (n + 3 * m) * 4
            + (2 * h4 + h * h4 + h) * cb + (h4 + 1) * 4 + 2 * K * 4)
    return (data, J * M * h * (cb + 4), 2.0 * B * (n * n + 2 * m * n),
            2.0 * M * h * h4)


def train_fwd(B, J, n, m, h, K, dtype="bfloat16"):
    """Bound of the training forward over one chunk: the data read once,
    the J slabs of the H and C streams and the (B, J) losses written; one
    gate GEMM and three KKT matvecs a step."""
    data, streams, mv, gemm = _chunk(B, J, n, m, h, K, dtype)
    M = B * (n + m)
    return bound_ms(data + streams + B * J * 8,
                    **_rates(dtype, J * (gemm + 3 * mv),
                             J * M * (2.0 * 2 * 4 * h + 20.0 * h)))


def train_bwd(B, J, n, m, h, K, dtype="bfloat16"):
    """Bound of the training backward over one chunk: the data and the
    streams read once, the float32 gradients written; three GEMMs and six
    KKT matvecs a step."""
    data, streams, mv, gemm = _chunk(B, J, n, m, h, K, dtype)
    M = B * (n + m)
    grads = (2 * 4 * h + h * 4 * h + 5 * h + 1 + 2 * J) * 4
    return bound_ms(data + streams + grads,
                    **_rates(dtype, J * (3 * gemm + 6 * mv),
                             J * M * (4.0 * 2 * 4 * h + 40.0 * h)))


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


def stored_tiles(vals) -> int:
    """Tiles of a (…, TM, TN) BSR value array (numpy or torch) that hold a
    nonzero: the tiles the data needs, pad tiles left out."""
    return int((vals != 0).any(-1).any(-1).sum())


def bsr_matvec(tiles, B, m, n, tm=8, tn=128, tile_bytes=2):
    """Bound of one BSR matvec over a batch of B (m, n) matrices with
    ``tiles`` stored (tm, tn) tiles in all: the tiles (bf16 for
    ``tile_bytes=2``, else float32) and their int32 indices, the float32
    vector in and out; 2 operations per tile element at the tiles' rate."""
    ops = 2.0 * tiles * tm * tn
    nbytes = tiles * (tm * tn * tile_bytes + 4) + B * (n + m) * 4
    if tile_bytes == 2:
        return bound_ms(nbytes, bf16_ops=ops)
    return bound_ms(nbytes, f32_ops=ops)


def unported():
    return {k: dict(bound_ms=v[0], bound_by=v[1])
            for k, v in segment_pair().items()}


if __name__ == "__main__":
    print(json.dumps(unported(), indent=1))
