"""Work that Stage II needs, whatever implements it.

Stage II polishes B instances with N exact ADMM steps at a fixed ρ.  It
needs one factorization of each instance's system and N solves with it,
plus the right-hand sides, the updates and the residuals.  The
factorization is counted as the lesser of the two known routes, both
float32: the LU of the saddle-point matrix Ã, 2/3·(n+m)³, or forming the
condensed M = Q + σI + A0ᵀρA0 (2·m·n²) and its Cholesky (n³/3).  A solve
with the factor is two triangular solves of n (2·n² each); a step also
forms b = σx − p + A0ᵀ(ρz − y) (2mn), recovers ν = ρ(A0·x̃ − z) + y (2mn)
and the residuals ‖A0x − z‖, ‖Qx + p + A0ᵀy‖ (2mn + 2n² + 2mn), with
about 20 elementwise operations a row.  Bytes: Q and A0 (float32, as
served) and the vectors read once, the state and the residual traces
written once.  The route's own operand (Ã⁻¹, M⁻¹) is not an input and is
not counted, so no route can read over 100%.

The stage-level replacement of ``iadmm_tpu_torch/kernels/bounds.py::
stage2`` (commit cc8fe97), which counts the 'kkt' route's own Ã⁻¹.
"""


def factor_ops(n, m):
    return min(2.0 / 3.0 * (n + m) ** 3, 2.0 * m * n * n + n ** 3 / 3.0)


def work(s):
    B, n, m, N = s["B"], s["n"], s["m"], s["N"]
    S = n + m
    step = 4.0 * n * n + 2.0 * m * n * 4 + 2.0 * n * n + 20.0 * S
    nbytes = 4 * B * (n * n + m * n + (2 * n + 4 * m)
                      + (2 * n + 2 * m + 2 * N))
    return dict(bytes=nbytes, bf16_ops=0.0,
                f32_ops=B * (factor_ops(n, m) + N * step))
