// One pass over the stacked matrix [Q; A0] that yields both halves of a
// KKT matvec.  Shared by rollout.cu (bf16 data, vectors rounded to bf16)
// and stage2.cu (float32 data and vectors).
//
// For instance b, the CTA (c, b) takes rows [c·ROWS, (c+1)·ROWS) of the
// (n+m) x n matrix [Q; A0] and the vector w = [wt; wb] (n + m):
//   partial[b, c, j] = Σ_{i in chunk} [Q; A0][i, j] · w[i]
//   rowdot[b, i-n]   = Σ_j A0[i-n, j] · wt[j]          for chunk rows i >= n
// Q is symmetric, so Σ_c partial[b, c, :] = Q·wt + A0ᵀ·wb; rowdot = A0·wt.
// Each element of Q and A0 is read once per pass, with neighbouring threads
// on neighbouring columns.  The chunk partials are summed in a fixed order
// by the caller's next kernel and each row dot by a fixed-order sum over the
// warps, so the result does not depend on scheduling (no atomics).
//
// Bound: bytes, one read of Q and A0 per pass.  At n = 1000, m = 1000 the
// bf16 data of 8 instances is 24 MB and stays in the 50 MB L2 across passes.
#pragma once

#include "common.cuh"

namespace iadmm {
namespace kkt {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 32;

inline int n_chunks(int n, int m) { return (n + m + ROWS - 1) / ROWS; }

template <typename T, bool ROUND>
__global__ void __launch_bounds__(THREADS)
    colpass_kernel(const T* __restrict__ Q, const T* __restrict__ A0,
                   const float* __restrict__ wt, int wt_ld,
                   const float* __restrict__ wb, int wb_ld,
                   float* __restrict__ partial, float* __restrict__ rowdot,
                   int n, int m, int nchunks) {
  __shared__ float wrow[ROWS];
  __shared__ float racc[WARPS][ROWS];
  const int b = blockIdx.y, c = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i0 = c * ROWS;
  const int rows = min(ROWS, n + m - i0);
  const float* wtb = wt + (size_t)b * wt_ld;
  const float* wbb = wb + (size_t)b * wb_ld;
  if (tid < ROWS) {
    float v = 0.f;
    if (tid < rows) {
      const int i = i0 + tid;
      v = i < n ? wtb[i] : wbb[i - n];
      if (ROUND) v = bf16_round(v);
    }
    wrow[tid] = v;
  }
  for (int k = tid; k < WARPS * ROWS; k += THREADS) (&racc[0][0])[k] = 0.f;
  __syncthreads();
  const T* Qb = Q + (size_t)b * n * n;
  const T* Ab = A0 + (size_t)b * m * n;
  for (int j0 = 0; j0 < n; j0 += THREADS) {
    const int j = j0 + tid;
    const bool ok = j < n;
    float uj = 0.f;
    if (ok) {
      uj = wtb[j];
      if (ROUND) uj = bf16_round(uj);
    }
    float acc = 0.f;
    for (int r = 0; r < rows; ++r) {
      const int i = i0 + r;  // uniform across the CTA: no divergence below
      const T* row = i < n ? Qb + (size_t)i * n : Ab + (size_t)(i - n) * n;
      const float a = ok ? to_f(row[j]) : 0.f;
      acc = fmaf(a, wrow[r], acc);
      if (i >= n) {
        const float d = warp_sum(a * uj);
        if (lane == 0) racc[warp][r] += d;
      }
    }
    if (ok) partial[((size_t)b * nchunks + c) * n + j] = acc;
  }
  __syncthreads();
  if (tid < rows && i0 + tid >= n) {
    float d = 0.f;
    for (int w = 0; w < WARPS; ++w) d += racc[w][tid];
    rowdot[(size_t)b * m + (i0 + tid - n)] = d;
  }
}

// Σ_c partial[b, c, j] in chunk order.
__device__ __forceinline__ float sum_partials(const float* partial, int b,
                                              int nchunks, int n, int j) {
  const float* p = partial + (size_t)b * nchunks * n + j;
  float s = 0.f;
  for (int c = 0; c < nchunks; ++c) s += p[(size_t)c * n];
  return s;
}

template <typename T, bool ROUND>
inline void colpass(const void* Q, const void* A0, const float* wt, int wt_ld,
                    const float* wb, int wb_ld, float* partial, float* rowdot,
                    int n, int m, int B, cudaStream_t s) {
  dim3 grid(n_chunks(n, m), B);
  colpass_kernel<T, ROUND><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(Q), static_cast<const T*>(A0), wt, wt_ld, wb,
      wb_ld, partial, rowdot, n, m, n_chunks(n, m));
}

}  // namespace kkt
}  // namespace iadmm
