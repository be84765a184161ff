"""Least times an NVIDIA H100 SXM could take for a kernel's work.

    python -m iadmm_tpu_torch.kernels.bounds

prints the bounds of the TPU kernels the port has not ported yet (none are
left).  ``chip_smoke.py`` computes the ported kernels' bounds from the
inputs of its run with :func:`cell`, :func:`train_fwd`, :func:`train_bwd`,
:func:`train_fwd_seg`, :func:`train_bwd_seg` (each at the bf16 or the
float32 profile), :func:`stage2` (each solver), :func:`kkt_inverse` (its 'kkt' operand),
:func:`bsr_matvec`,
:func:`bsr_matvec_group`,
:func:`kkt_pass` (the KKT pass those kernels run, alone), :func:`ruiz` (Ruiz
scaling) and ``bound_ms``.

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


def _state_bytes(B, n, m, h):
    """Bytes of one training state (x, y, z, xv; H and C in float32), as
    the segment route keeps its checkpoints."""
    return B * ((n + m) * h * 8 + (2 * n + 3 * m) * 4)


def train_fwd_seg(B, J, seg, n, m, h, K, dtype="bfloat16"):
    """Bound of the segment route's forward over a chunk of J steps in
    J/seg segments: the data and the start state read once, the J/seg
    segment-end states written (the checkpoints and the final state), the
    (B, J) losses written; one gate GEMM and three KKT matvecs a step."""
    data, _, mv, gemm = _chunk(B, J, n, m, h, K, dtype)
    M = B * (n + m)
    states = (J // seg + 1) * _state_bytes(B, n, m, h)
    return bound_ms(data + states + B * J * 8,
                    **_rates(dtype, J * (gemm + 3 * mv),
                             J * M * (2.0 * 2 * 4 * h + 20.0 * h)))


def train_bwd_seg(B, J, seg, n, m, h, K, dtype="bfloat16"):
    """Bound of the segment route's backward over a chunk of J steps in
    J/seg segments: the data, the J/seg checkpoints, the loss cotangents
    and the final state's cotangents read once, the start state's
    cotangents and the float32 gradients written; four GEMMs a step (the
    recompute's gate GEMM and the reverse step's three) and eight KKT
    matvecs (two recomputed, six of the reverse step)."""
    data, _, mv, gemm = _chunk(B, J, n, m, h, K, dtype)
    M = B * (n + m)
    states = (J // seg + 2) * _state_bytes(B, n, m, h)
    grads = (2 * 4 * h + h * 4 * h + 5 * h + 1 + 2 * J) * 4
    return bound_ms(data + states + B * J * 8 + grads,
                    **_rates(dtype, J * (4 * gemm + 8 * mv),
                             J * M * (6.0 * 2 * 4 * h + 60.0 * h)))


def stage2(B, N, n, m, solver="kkt", cg_iters=100, refine=None):
    """Bound of N Stage-II polish steps over B instances, all in float32
    (the TPU kernel runs them at ``Precision.HIGHEST``): Q, A0 and the
    solver's operand read once (Ã⁻¹ (n+m)² for ``'kkt'``, M⁻¹ n² for
    ``'direct'``, the Jacobi diagonal n for ``'cg'``), the start state read
    and the state and residual traces written.  Per step the solve
    (``'kkt'``: one Ã⁻¹ matvec and ``refine`` passes of Ã and Ã⁻¹;
    ``'direct'``: one M⁻¹ matvec and ``refine`` passes of M = Q + σI +
    A0ᵀρA0 and M⁻¹; ``'cg'``: cg_iters + 1 matvecs of M, the most its loop
    runs: pass the mean count of unmasked iterations a step that a run's
    data needed, which may be fractional), the matvecs of the right-hand
    side and the residuals, and the elementwise work."""
    if refine is None:
        refine = 0 if solver == "kkt" else 2
    S = n + m
    q, a = 2.0 * n * n, 2.0 * m * n      # one Q and one A0 (or A0ᵀ) matvec
    mv_m = q + 2 * a
    if solver == "kkt":
        operand, solve = S * S, 2.0 * S * S + refine * (2.0 * S * S + mv_m)
        rest = mv_m + 20.0 * S
    elif solver == "direct":
        operand, solve = n * n, 2.0 * n * n + refine * (2.0 * n * n + mv_m)
        rest = mv_m + 2 * a + 20.0 * S
    elif solver == "cg":
        operand, solve = n, (cg_iters + 1) * (mv_m + 10.0 * n)
        rest = mv_m + 2 * a + 20.0 * S
    else:
        raise ValueError(f"unknown stage2 solver {solver!r}")
    nbytes = 4 * B * (operand + n * n + m * n + (2 * n + 4 * m)
                      + (2 * n + 2 * m + 2 * N))
    return bound_ms(nbytes, f32_ops=N * B * (solve + rest))


def kkt_inverse(B, n, m):
    """Bound of forming Ã and its inverse, B instances, S = n + m, float32:
    Q, A0 and ρ read once and Ã⁻¹ written once; 2·S³ FFMA operations a
    matrix (an explicit inverse by elimination with row pivoting: getrf's
    2/3·S³ and getri's 4/3·S³, or Gauss–Jordan's 2·S³)."""
    S = n + m
    nbytes = 4 * B * (n * n + m * n + m + S * S)
    return bound_ms(nbytes, f32_ops=2.0 * B * S ** 3)


def kkt_pass(B, n, m, dtype="bfloat16", nv=1):
    """Bound of one KKT pass (``kernels/kkt_pass.py``) over B instances
    with ``nv`` right-hand sides: Q (B,n,n) and A0 (B,m,n) in ``dtype``
    read once, each side's float32 wt (B,n) and wb (B,m) read and its
    partials (B, chunks of 32 rows, n) and row dots (B,m) written; per side
    2 operations an element of [Q; A0] and 2 of A0, float32 FMA on the CUDA
    cores.  Bytes bound it at every shape the port runs."""
    chunks = -(-(n + m) // 32)
    nbytes = (B * (n + m) * n * _nbytes(dtype)
              + nv * B * 4 * ((n + m) + chunks * n + m))
    return bound_ms(nbytes, f32_ops=nv * B * (2.0 * (n + m) * n
                                              + 2.0 * m * n))


def ruiz(B, n, m, iters=10):
    """Bound of Ruiz scaling (``csrc/ruiz.cu``) over B instances, float32
    (``qpbench/counts/ruiz.py``'s arithmetic): Q and A0 read once and
    written once, the vectors read and the factors written; about 6
    elementwise operations an element a sweep."""
    elems = B * (n * n + m * n)
    return bound_ms(8 * elems + 4 * B * 6 * (n + m),
                    f32_ops=iters * 6.0 * elems)


def stored_tiles(vals) -> int:
    """Tiles of a (…, TM, TN) BSR value array (numpy or torch) that hold a
    nonzero: the tiles the data needs, pad tiles left out."""
    return int((vals != 0).any(-1).any(-1).sum())


def _bsr_work(tiles, B, m, n, tm=8, tn=128, tile_bytes=2):
    """(bytes, operations) of one BSR product: see :func:`bsr_matvec`."""
    return (tiles * (tm * tn * tile_bytes + 4) + B * (n + m) * 4,
            2.0 * tiles * tm * tn)


def _bsr_bound(nbytes, ops, tile_bytes):
    if tile_bytes == 2:
        return bound_ms(nbytes, bf16_ops=ops)
    return bound_ms(nbytes, f32_ops=ops)


def bsr_matvec(tiles, B, m, n, tm=8, tn=128, tile_bytes=2):
    """Bound of one BSR matvec over a batch of B (m, n) matrices with
    ``tiles`` stored (tm, tn) tiles in all: the tiles (bf16 for
    ``tile_bytes=2``, else float32) and their int32 indices, the float32
    vector in and out; 2 operations per tile element at the tiles' rate."""
    return _bsr_bound(*_bsr_work(tiles, B, m, n, tm, tn, tile_bytes),
                      tile_bytes)


def bsr_matvec_group(products):
    """Bound of one grouped BSR launch: the sum of its products' bytes and
    operations.  ``products``: each product's :func:`bsr_matvec`
    arguments as a tuple ``(tiles, B, m, n, tm, tn, tile_bytes)``, all of
    one tile dtype."""
    if len({p[6] for p in products}) != 1:
        raise ValueError("the products of a grouped launch share one tile "
                         "dtype")
    work = [_bsr_work(*p) for p in products]
    return _bsr_bound(sum(b for b, _ in work), sum(o for _, o in work),
                      products[0][6])


def unported():
    """Bounds of the TPU kernels not ported yet: none is left (Stage II's
    'direct' and 'cg' solvers were the last; :func:`stage2` covers them)."""
    return {}


if __name__ == "__main__":
    left = unported()
    print(json.dumps(left, indent=1) if left
          else "every TPU kernel of the repository is ported")
