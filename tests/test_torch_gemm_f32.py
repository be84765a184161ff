"""``train_rollout.f32_gemm``, the float32 FFMA GEMM core's wrapper, on the
CPU: its layout flags (``a_col``: op(A) = Aᵀ, ``b_col``: op(B) = Bᵀ,
``accumulate``: C += instead of C =) against numpy float64, to 1e-5 of
max|ref| (float32 sums over K).  The kernel itself runs on the card
(``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from iadmm_tpu_torch.kernels import train_rollout as ttr


@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("b_col", [False, True])
@pytest.mark.parametrize("a_col", [False, True])
def test_f32_gemm_layout_semantics(a_col, b_col, accumulate):
    rng = np.random.default_rng(4 * a_col + 2 * b_col + accumulate)
    M, N, K = 37, 21, 53
    A = rng.standard_normal((K, M) if a_col else (M, K)).astype(np.float32)
    B = rng.standard_normal((N, K) if b_col else (K, N)).astype(np.float32)
    C0 = rng.standard_normal((M, N)).astype(np.float32)
    C = torch.from_numpy(C0.copy())
    out = ttr.f32_gemm(torch.from_numpy(A), torch.from_numpy(B), C,
                       a_col=a_col, b_col=b_col, accumulate=accumulate)
    assert out is C and C.dtype == torch.float32
    opA = A.T if a_col else A
    opB = B.T if b_col else B
    ref = opA.astype(np.float64) @ opB.astype(np.float64)
    if accumulate:
        ref = ref + C0
    np.testing.assert_allclose(C.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("a_col", [False, True])
def test_f32_gemm_rejects_mismatched_shapes(a_col):
    A = torch.zeros((5, 3))
    B = torch.zeros((4, 6))
    C = torch.zeros((3 if a_col else 5, 6))
    with pytest.raises(ValueError, match="f32_gemm"):
        ttr.f32_gemm(A, B, C, a_col=a_col, b_col=False, accumulate=False)
