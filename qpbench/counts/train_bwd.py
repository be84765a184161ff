"""Work of the training backward (``csrc/train_bwd.cu``) over one chunk.

Frozen copy of ``iadmm_tpu_torch/kernels/bounds.py::train_bwd`` (commit
cc8fe97): the data and the streams read once, the float32 gradients
written; three GEMMs and six KKT matvecs a step."""

from qpbench.counts._chunk import chunk, split


def work(s):
    B, J, n, m, h, K, dt = (s["B"], s["J"], s["n"], s["m"], s["h"], s["K"],
                            s["dtype"])
    data, streams, mv, gemm = chunk(B, J, n, m, h, K, dt)
    M = B * (n + m)
    grads = (2 * 4 * h + h * 4 * h + 5 * h + 1 + 2 * J) * 4
    return dict(bytes=data + streams + grads,
                **split(dt, J * (3 * gemm + 6 * mv),
                        J * M * (4.0 * 2 * 4 * h + 40.0 * h)))
