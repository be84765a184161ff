"""Work of the serving rollout (``csrc/rollout.cu``): K learned iterations.

Copied from ``chip_smoke.py::phase_rollout``'s bound (commit cc8fe97).
Bytes: Q and A0 in bf16, p, zl, zu and the row multipliers in float32,
the cell weights in bf16 (b, b_h float32), the 2K schedules, read once;
x, y, z written.  Operations per iteration: the gate GEMM H·U (2·B·S·h·4h)
and four KKT matvecs (two passes over [Q; A0] and A0ᵀ, 4·B·(n² + 2mn)) at
the bf16 tensor-core rate; x·W and the gates' elementwise work
(B·S·(16h + 20h)) at the float32 rate.
"""


def work(s):
    B, n, m, h, K = s["B"], s["n"], s["m"], s["h"], s["K"]
    S = n + m
    nbytes = (B * (n * n + m * n) * 2 + B * (n + 3 * m) * 4
              + (2 * 4 * h + h * 4 * h + h) * 2 + 4 * h * 4 + 2 * K * 4
              + B * (n + 2 * m) * 4)
    return dict(bytes=nbytes,
                bf16_ops=K * (2.0 * B * S * h * 4 * h
                              + 4.0 * B * (n * n + 2 * m * n)),
                f32_ops=K * B * S * (2.0 * 2 * 4 * h + 20.0 * h))
