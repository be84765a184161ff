"""Work of Ruiz scaling (``scaling/ruiz.py``) over B instances, ``iters``
sweeps, all float32 elementwise: per sweep each element of Q and A0 is
read for two column or row maxima, scaled (two products) and read again
for the cost norm (about 6 operations an element).  Bytes: Q, A0 and the
vectors read once, the scaled copies and the factors written once."""


def work(s):
    B, n, m, it = s["B"], s["n"], s["m"], s.get("scaling_iters", 10)
    elems = B * (n * n + m * n)
    return dict(bytes=8 * elems + 4 * B * 6 * (n + m), bf16_ops=0.0,
                f32_ops=it * 6.0 * elems)
