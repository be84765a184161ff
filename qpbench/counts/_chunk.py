"""Shared arithmetic of a training chunk's work.

Frozen copy of ``iadmm_tpu_torch/kernels/bounds.py::_chunk`` (commit
cc8fe97): (data bytes, stream bytes, matvec operations a step, gate-GEMM
operations a step) of a chunk in ``dtype``: Q, A0 and the cell weights in
it, the vectors float32; the H stream in it, C float32."""


def chunk(B, J, n, m, h, K, dtype):
    cb = 2 if dtype == "bfloat16" else 4
    M, h4 = B * (n + m), 4 * h
    data = (B * (n * n + m * n) * cb + B * (n + 3 * m) * 4
            + (2 * h4 + h * h4 + h) * cb + (h4 + 1) * 4 + 2 * K * 4)
    return (data, J * M * h * (cb + 4), 2.0 * B * (n * n + 2 * m * n),
            2.0 * M * h * h4)


def split(dtype, product_ops, f32_ops):
    if dtype == "bfloat16":
        return dict(bf16_ops=product_ops, f32_ops=f32_ops)
    return dict(bf16_ops=0.0, f32_ops=product_ops + f32_ops)
