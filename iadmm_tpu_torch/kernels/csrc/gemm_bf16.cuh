// A tensor-core GEMM, C (=|+=) A·B, bf16 operands with float32
// accumulation, for the two weight-side products of the training backward
// (train_bwd.cu): dH = dpre·Uᵀ and dU += H_kᵀ·dpre.
//
// hopper.cuh's core on 128 x 128 tiles: wgmma m64n128k16 fed by a TMA ring
// of 64-deep stages from a producer warp, two CTAs an SM.  Either operand
// may be stored
// transposed (A_COL: A(i,k) = A[k·lda + i]; B_COL: B(k,j) = B[j·ldb + k]);
// that is the operand's major-ness in the TMA box and the wgmma descriptor
// (dH: A and B K-major; dU: both MN-major), so nothing is transposed
// through registers.  An operand whose rows the TMA cannot address (a
// leading dimension that is not a multiple of 8) is loaded by the
// producer's threads in the same layout.  The grid walks the N tiles
// fastest, so a row block of A is read from device memory once.
//
// dU at the flagship has only 7 x 25 = 175 output tiles, which two CTAs an
// SM hold in one wave on 132 SMs, and no split of K: a split-K pass would
// have to sum h x 4h float32 slabs in a fixed order (no atomics), about 20
// µs a split at B=2 against the ~25 µs the GEMM itself needs at the
// tensor-core rate.
//
// Every output element is summed by one thread over the whole K loop and
// stored (ACC: added to C) once, so the result does not depend on the
// schedule: no atomics, bitwise repeatable.
#pragma once

#include "hopper.cuh"

namespace iadmm {
namespace gemm {

// The operands are bf16: the TMA reads them unless h is odd (or not a
// multiple of 8, for H_k), where the one producer warp loads them.
using GemmShape = hop::Shape<true>;

template <bool A_K, bool B_K, bool ACC>
__global__ void __launch_bounds__(GemmShape::THREADS, GemmShape::CTAS)
    gemm_kernel(const __grid_constant__ CUtensorMap ma,
                const __grid_constant__ CUtensorMap mb, hop::Operand a,
                hop::Operand b, float* __restrict__ C, int ldc, int M, int N,
                int K) {
  extern __shared__ uint8_t smem_raw[];
  using Shape = GemmShape;
  const hop::Ring ring =
      hop::ring_init<Shape::S, Shape::P>(smem_raw, !a.tma || !b.tma);
  const int m0 = blockIdx.y * hop::BM;
  const int n0 = blockIdx.x * hop::BN;
  float acc[64];
  hop::mainloop<A_K, B_K, Shape::S, Shape::P>(&ma, &mb, a, b, m0, n0, K,
                                              ring, acc);
  if (threadIdx.x >= hop::CONSUMERS) return;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int gr = m0 + hop::acc_row(i), gc = n0 + hop::acc_col(i);
    if (gr >= M || gc >= N) continue;
    float* o = C + (size_t)gr * ldc + gc;
    *o = ACC ? *o + acc[i] : acc[i];
  }
}

// C (M, N) (=|+=) A·B over K; see the header for A_COL and B_COL.
template <bool A_COL, bool B_COL, bool ACC>
inline void launch(const void* A, int lda, const void* B, int ldb, float* C,
                   int ldc, int M, int N, int K, cudaStream_t stream) {
  constexpr bool A_K = !A_COL, B_K = B_COL;
  hop::Operand a{A, lda, A_K ? K : M, A_K ? M : K, 0, 0};
  hop::Operand b{B, ldb, B_K ? K : N, B_K ? N : K, 0, 0};
  CUtensorMap ma, mb;
  hop::prepare(a, A_K, &ma);
  hop::prepare(b, B_K, &mb);
  hop::allow_smem(gemm_kernel<A_K, B_K, ACC>, GemmShape::SMEM);
  dim3 grid((N + hop::BN - 1) / hop::BN, (M + hop::BM - 1) / hop::BM);
  gemm_kernel<A_K, B_K, ACC>
      <<<grid, GemmShape::THREADS, GemmShape::SMEM, stream>>>(
          ma, mb, a, b, C, ldc, M, N, K);
}

}  // namespace gemm
}  // namespace iadmm
