"""Work of the serving rollout's KKT pass (``csrc/kkt_matvec.cuh``'s
column pass and ``admm_step.cuh``'s finish, twice a step) over K steps.

Bytes a step: one sweep of bf16 [Q; A0] from memory, (n + m)·n elements
an instance: the second pass of a step may find in L2 what the first
left, so no more is counted and L2 hits cannot beat the count.  Each of
the two passes also reads its right-hand side (n + m floats) and writes
its chunk partials (ceil((n + m) / ROWS) rows of n floats) and the row
dots A0·u (m floats), which its finish reads back; the first finish
reads x, p, z, y and the row multipliers to form b̃ (n + n + 3m floats);
each finish writes its result (n + m floats).  Operations a step: the
products of both passes, [Q; A0]ᵀ·w and A0·u (2·(n + m)·n + 2·m·n each),
at the bf16 tensor-core rate, and about 6 elementwise float32 operations
a row in each finish.  ``ROWS`` is ``kkt::ROWS`` of ``kkt_matvec.cuh``
(32), frozen here.
"""

ROWS = 32


def work(s):
    B, n, m, K = s["B"], s["n"], s["m"], s["K"]
    S = n + m
    chunks = -(-S // ROWS)
    sweep = 2 * B * S * n
    a_pass = 4 * B * (S + 2 * chunks * n + 2 * m + S)
    b_tilde = 4 * B * (2 * n + 3 * m)
    return dict(bytes=K * (sweep + 2 * a_pass + b_tilde),
                bf16_ops=K * 2 * (2.0 * B * S * n + 2.0 * B * m * n),
                f32_ops=K * 2 * 6.0 * B * S)
