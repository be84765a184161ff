// A plain float32 GEMM on the CUDA cores, C (=|+=) A·B, for the two
// weight-side products of the float32 training backward (train_bwd.cu):
// dH = dpre·Uᵀ and dU += H_kᵀ·dpre.  The float32 counterpart of
// gemm_bf16.cuh: float32 operands, float32 FFMA sums, no TF32 (the TPU
// kernel runs these products at Precision.HIGHEST).
//
// Tiles of 128 x 64 x 16 and 256 threads; thread (tr, tc) of a 16 x 16 grid
// owns an 8 x 4 register micro-tile, rows tr·8 .. tr·8+7 and columns
// tc·4 .. tc·4+3 of the tile (tile_fma, shared with the float32 cell GEMM of
// cell_gemm.cuh).  Both shared tiles are stored k-major (As[k][i], Bs[k][j]),
// so a thread reads its 8 A values as two float4 and its 4 B values as one.
// Either operand may be stored transposed (A_COL: A(i,k) = A[k·lda + i];
// B_COL: B(k,j) = B[j·ldb + k]); each tile is loaded along the stored
// layout's contiguous axis, 4 elements at a time (one float4 when the
// leading dimension and the address allow it).  Loads are synchronous (no
// cp.async/TMA pipeline yet).
//
// Every output element is computed by one thread over the whole K loop in
// order and stored (ACC: added to C) once, so the result does not depend on
// the schedule: no atomics, bitwise repeatable.
#pragma once

#include "common.cuh"

namespace iadmm {
namespace gemm32 {

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;
constexpr int LDA = BM + 4;  // padded k-major strides (float4-aligned rows)
constexpr int LDB = BN + 4;

// acc[i][j] += Σ_k As[k][tr·8 + i] · Bs[k][tc·4 + j] over the BK rows.
__device__ __forceinline__ void tile_fma(const float* As, const float* Bs,
                                         int tr, int tc,
                                         float (&acc)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(As + kk * LDA + tr * 8);
    const float4 a1 =
        *reinterpret_cast<const float4*>(As + kk * LDA + tr * 8 + 4);
    const float4 b4 = *reinterpret_cast<const float4*>(Bs + kk * LDB + tc * 4);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <bool A_COL, bool B_COL, bool ACC>
__global__ void __launch_bounds__(THREADS)
    gemm_kernel(const float* __restrict__ A, int lda,
                const float* __restrict__ Bm, int ldb, float* __restrict__ C,
                int ldc, int M, int N, int K, int vec) {
  __shared__ __align__(16) float As[BK * LDA];
  __shared__ __align__(16) float Bs[BK * LDB];
  const int tid = threadIdx.x;
  const int tr = tid >> 4, tc = tid & 15;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  float acc[8][4] = {};

  for (int k0 = 0; k0 < K; k0 += BK) {
    float v[4];
    if (!A_COL) {  // 4 along k, stored transposed
      for (int c = tid; c < BM * BK / 4; c += THREADS) {
        const int i = c / (BK / 4), kc = (c % (BK / 4)) * 4;
        const int gi = m0 + i, gk = k0 + kc;
        const int lim = gi < M ? K - gk : 0;
        fetch4(A + (lim > 0 ? (size_t)gi * lda + gk : 0), lim, vec, v);
#pragma unroll
        for (int e = 0; e < 4; ++e) As[(kc + e) * LDA + i] = v[e];
      }
    } else {  // 4 along i
      for (int c = tid; c < BM * BK / 4; c += THREADS) {
        const int kk = c / (BM / 4), ic = (c % (BM / 4)) * 4;
        const int gk = k0 + kk, gi = m0 + ic;
        const int lim = gk < K ? M - gi : 0;
        fetch4(A + (lim > 0 ? (size_t)gk * lda + gi : 0), lim, vec, v);
        *reinterpret_cast<float4*>(As + kk * LDA + ic) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    if (!B_COL) {  // 4 along j
      for (int c = tid; c < BK * BN / 4; c += THREADS) {
        const int kk = c / (BN / 4), jc = (c % (BN / 4)) * 4;
        const int gk = k0 + kk, gj = n0 + jc;
        const int lim = gk < K ? N - gj : 0;
        fetch4(Bm + (lim > 0 ? (size_t)gk * ldb + gj : 0), lim, vec, v);
        *reinterpret_cast<float4*>(Bs + kk * LDB + jc) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    } else {  // 4 along k, stored transposed
      for (int c = tid; c < BK * BN / 4; c += THREADS) {
        const int j = c / (BK / 4), kc = (c % (BK / 4)) * 4;
        const int gj = n0 + j, gk = k0 + kc;
        const int lim = gj < N ? K - gk : 0;
        fetch4(Bm + (lim > 0 ? (size_t)gj * ldb + gk : 0), lim, vec, v);
#pragma unroll
        for (int e = 0; e < 4; ++e) Bs[(kc + e) * LDB + j] = v[e];
      }
    }
    __syncthreads();
    tile_fma(As, Bs, tr, tc, acc);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = m0 + tr * 8 + i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = n0 + tc * 4 + j;
      if (gc >= N) continue;
      float* o = C + (size_t)gr * ldc + gc;
      *o = ACC ? *o + acc[i][j] : acc[i][j];
    }
  }
}

// vec: both leading dimensions a multiple of 4 and both operands 16-byte
// aligned, so the 4-element loads may be float4 loads.
template <bool A_COL, bool B_COL, bool ACC>
inline void launch(const float* A, int lda, const float* B, int ldb,
                   float* C, int ldc, int M, int N, int K,
                   cudaStream_t stream) {
  const bool vec = lda % 4 == 0 && ldb % 4 == 0 &&
                   reinterpret_cast<size_t>(A) % 16 == 0 &&
                   reinterpret_cast<size_t>(B) % 16 == 0;
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  gemm_kernel<A_COL, B_COL, ACC><<<grid, THREADS, 0, stream>>>(
      A, lda, B, ldb, C, ldc, M, N, K, vec);
}

}  // namespace gemm32
}  // namespace iadmm
