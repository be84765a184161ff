// A plain tensor-core GEMM, C (=|+=) A·B, bf16 operands with float32
// accumulation, for the two weight-side products of the training backward
// (train_bwd.cu): dH = dpre·Uᵀ and dU += H_kᵀ·dpre.
//
// Either operand may be stored transposed (A_COL: A(i,k) = A[k·lda + i];
// B_COL: B(k,j) = B[j·ldb + k]); the tile loads read 8 neighbouring elements
// of the stored layout as one 16-byte load when the leading dimension allows
// it and write them to shared memory in the row-major layout the wmma
// fragments take.  Tiles of 128 x 64 x 32, 8 warps of 32 x 32, as in
// cell_gemm.cuh; loads are synchronous (no cp.async/TMA pipeline yet).
//
// Every output element is computed by one thread over the whole K loop and
// stored (ACC: added to C) once, so the result does not depend on the
// schedule: no atomics, bitwise repeatable.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace iadmm {
namespace gemm {

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int LDA = BK + 8;
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;

struct SmemIn {
  __nv_bfloat16 A[BM * LDA];
  __nv_bfloat16 B[BK * LDB];
};
union Smem {
  SmemIn in;
  float C[BM * LDC];
};

// p[0..7], with the elements at index >= lim read as zero (lim <= 0: all).
__device__ __forceinline__ void fetch8(const __nv_bfloat16* p, int lim,
                                       bool vec, __nv_bfloat16 (&out)[8]) {
  if (vec && lim >= 8) {
    *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(p);
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    out[e] = e < lim ? p[e] : __float2bfloat16_rn(0.f);
}

template <bool A_COL, bool B_COL, bool ACC>
__global__ void __launch_bounds__(THREADS)
    gemm_kernel(const __nv_bfloat16* __restrict__ A, int lda,
                const __nv_bfloat16* __restrict__ Bm, int ldb,
                float* __restrict__ C, int ldc, int M, int N, int K,
                int vec) {
  using namespace nvcuda;
  __shared__ __align__(128) Smem sm;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int wr = (warp >> 1) * 32;
  const int wc = (warp & 1) * 32;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    __align__(16) __nv_bfloat16 t[8];
    if (!A_COL) {
      for (int c = tid; c < BM * BK / 8; c += THREADS) {
        const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
        const int gr = m0 + r, gk = k0 + kc;
        const int lim = gr < M ? K - gk : 0;
        if (lim > 0)
          fetch8(A + (size_t)gr * lda + gk, lim, vec, t);
        else
          for (int e = 0; e < 8; ++e) t[e] = zero;
        *reinterpret_cast<uint4*>(sm.in.A + r * LDA + kc) =
            *reinterpret_cast<const uint4*>(t);
      }
    } else {
      for (int c = tid; c < BM * BK / 8; c += THREADS) {
        const int kk = c / (BM / 8), ic = (c % (BM / 8)) * 8;
        const int gk = k0 + kk, gi = m0 + ic;
        const int lim = gk < K ? M - gi : 0;
        if (lim > 0)
          fetch8(A + (size_t)gk * lda + gi, lim, vec, t);
        else
          for (int e = 0; e < 8; ++e) t[e] = zero;
#pragma unroll
        for (int e = 0; e < 8; ++e) sm.in.A[(ic + e) * LDA + kk] = t[e];
      }
    }
    if (!B_COL) {
      for (int c = tid; c < BK * BN / 8; c += THREADS) {
        const int kk = c / (BN / 8), jc = (c % (BN / 8)) * 8;
        const int gk = k0 + kk, gj = n0 + jc;
        const int lim = gk < K ? N - gj : 0;
        if (lim > 0)
          fetch8(Bm + (size_t)gk * ldb + gj, lim, vec, t);
        else
          for (int e = 0; e < 8; ++e) t[e] = zero;
        *reinterpret_cast<uint4*>(sm.in.B + kk * LDB + jc) =
            *reinterpret_cast<const uint4*>(t);
      }
    } else {
      for (int c = tid; c < BK * BN / 8; c += THREADS) {
        const int j = c / (BK / 8), kc = (c % (BK / 8)) * 8;
        const int gj = n0 + j, gk = k0 + kc;
        const int lim = gj < N ? K - gk : 0;
        if (lim > 0)
          fetch8(Bm + (size_t)gj * ldb + gk, lim, vec, t);
        else
          for (int e = 0; e < 8; ++e) t[e] = zero;
#pragma unroll
        for (int e = 0; e < 8; ++e) sm.in.B[(kc + e) * LDB + j] = t[e];
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], sm.in.A + (wr + 16 * i) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], sm.in.B + kk * LDB + wc + 16 * j, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sm.C + (wr + 16 * i) * LDC + wc + 16 * j,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int r = e / BN, c = e % BN;
    const int gr = m0 + r, gc = n0 + c;
    if (gr >= M || gc >= N) continue;
    const float v = sm.C[r * LDC + c];
    float* o = C + (size_t)gr * ldc + gc;
    *o = ACC ? *o + v : v;
  }
}

// vec: every leading dimension a multiple of 8 and both operands 16-byte
// aligned, so the 8-element loads may be vector loads.
template <bool A_COL, bool B_COL, bool ACC>
inline void launch(const void* A, int lda, const void* B, int ldb, float* C,
                   int ldc, int M, int N, int K, cudaStream_t stream) {
  const bool vec = lda % 8 == 0 && ldb % 8 == 0 &&
                   reinterpret_cast<size_t>(A) % 16 == 0 &&
                   reinterpret_cast<size_t>(B) % 16 == 0;
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  gemm_kernel<A_COL, B_COL, ACC><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(A), lda,
      static_cast<const __nv_bfloat16*>(B), ldb, C, ldc, M, N, K, vec);
}

}  // namespace gemm
}  // namespace iadmm
