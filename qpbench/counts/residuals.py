"""Work of the served residuals and objective (``evaluation/metrics.py``):
‖A0x − z‖, ‖Qx + p + A0ᵀy‖ and ½xᵀQx + pᵀx in float32: three matvecs of
Q and two of A0 (2n² and 2mn each).  Bytes: Q and A0 read once."""


def work(s):
    B, n, m = s["B"], s["n"], s["m"]
    return dict(bytes=4 * B * (n * n + m * n), bf16_ops=0.0,
                f32_ops=B * (2 * 2.0 * n * n + 2 * 2.0 * m * n + 10.0 * (n + m)))
