"""Work of the training forward (``csrc/train_fwd.cu``) over one chunk.

Frozen copy of ``iadmm_tpu_torch/kernels/bounds.py::train_fwd`` (commit
cc8fe97): the data read once, the J slabs of the H and C streams and the
(B, J) losses written; one gate GEMM and three KKT matvecs a step."""

from qpbench.counts._chunk import chunk, split


def work(s):
    B, J, n, m, h, K, dt = (s["B"], s["J"], s["n"], s["m"], s["h"], s["K"],
                            s["dtype"])
    data, streams, mv, gemm = chunk(B, J, n, m, h, K, dt)
    M = B * (n + m)
    return dict(bytes=data + streams + B * J * 8,
                **split(dt, J * (gemm + 3 * mv),
                        J * M * (2.0 * 2 * 4 * h + 20.0 * h)))
