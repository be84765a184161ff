"""The table of peaks and the least time a piece of work can take.

Frozen copy of ``iadmm_tpu_torch/kernels/bounds.py::bound_ms`` and its
rates (commit cc8fe97).  Published peaks of one NVIDIA H100 SXM (NVIDIA's
data sheet, dense, at the full 700 W power limit).
"""

from __future__ import annotations

HBM_BPS = 3.35e12     # HBM3, bytes/s
BF16_FLOPS = 989e12   # bf16 tensor cores
F32_FLOPS = 67e12     # float32 outside the tensor cores (no TF32)


def bytes_ms(nbytes: float) -> float:
    return nbytes / HBM_BPS * 1e3


def ops_ms(bf16_ops: float = 0.0, f32_ops: float = 0.0) -> float:
    """The least time of the operations alone: products at the bf16
    tensor-core rate, the rest at the float32 rate."""
    return (bf16_ops / BF16_FLOPS + f32_ops / F32_FLOPS) * 1e3


def bound_ms(nbytes: float, bf16_ops: float = 0.0, f32_ops: float = 0.0):
    """(least ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over their peak rates."""
    tb, to = bytes_ms(nbytes), ops_ms(bf16_ops, f32_ops)
    return max(tb, to), ("bytes" if tb >= to else "operations")


def rates(dtype: str, product_ops: float, f32_ops: float) -> dict:
    """``bound_ms`` keywords: products at ``dtype``'s rate, the rest float32."""
    if dtype == "bfloat16":
        return dict(bf16_ops=product_ops, f32_ops=f32_ops)
    if dtype != "float32":
        raise ValueError(f"unknown dtype {dtype!r}")
    return dict(f32_ops=product_ops + f32_ops)


def nbytes_of(dtype: str) -> int:
    return 2 if dtype == "bfloat16" else 4
