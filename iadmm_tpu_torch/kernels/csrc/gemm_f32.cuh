// The float32 FFMA GEMM core for Hopper (sm_90a), and the plain GEMM
// C (=|+=) AᵀB built on it.  It carries every float32 product of the port:
// the float32 cell's H·U (cell_gemm.cuh: the per-step cell, the training
// forwards, the segment recompute), the float32 cell adjoint's recompute
// and the backward's dH = dpre·Uᵀ and dU += H_kᵀ·dpre (train_bwd.cu).
// Float32 operands, float32 FFMA sums on the CUDA cores: no tensor core,
// no TF32, nothing rounded (the TPU kernel runs these products at
// Precision.HIGHEST).  Bound on the H100: the operations at 67 TFLOP/s.
//
// A CTA computes a BM x BN tile (Tile) with one TM x TN register
// micro-tile a thread: rows tr·4 + 0..3 (+ 4·TR, ...), columns tc·4 + 0..3
// (+ 4·TC, ...), so a warp's fragment reads are float4 loads of
// consecutive addresses (a warp is 4 x 8 threads, or 8 x 4 where TC is not
// a multiple of 8).  Each k-step a thread reads TM + TN floats from shared
// memory for TM·TN FFMA; the fragments of step k+1 are read before the
// FFMA of step k.
//
// The loads are asynchronous: a ring of Tile::STAGES stages of BK = 16 k,
// filled by cp.async STAGES − 1 stages ahead, one barrier a stage.  An
// operand stored along its rows or columns (both of C = AᵀB; the cell's U)
// is copied 16 bytes at a time into a k-major tile (X[k][j], rows padded by
// 4 floats) where its leading dimension and address allow, else 4 bytes at
// a time; the cell's H, stored along k, is copied as it is stored
// (load_rows: 16 bytes of 4 k a row) and read a float4 of 4 k a row
// (fma_stage_rows), a bf16 H kept bf16 and widened as it is read
// (load_h_bf16).  4-byte copies that transposed along-k operands into the
// k-major layout cost a quarter of the FFMA rate on the H100, so the
// float32 backward keeps dpre and U transposed for dH instead
// (train_bwd.cu).  Elements past an operand's edges (rows past
// M, columns past N, k past K) are zero-filled by the copies' source size.
//
// Every output element is one thread's fmaf chain over k, ascending from
// k = 0 with zeros past K, and is stored (ACC: added to C) once: no split
// of K, no atomics, so results are bitwise repeatable and do not depend on
// the tile shape.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace iadmm {
namespace gemm32 {

constexpr int BK = 16;      // k depth of a stage
constexpr int PAD = 4;      // floats of padding per k-major row
constexpr int LDH = BK + 8; // bf16 per row of a bf16 H stage tile

// ---- cp.async -------------------------------------------------------------

// 4 bytes, or zeros where !ok (src is not read then).
__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   hop::smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
// 16 bytes, of which the first `bytes` are read and the rest zero-filled.
__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   hop::smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// ---- tiles ----------------------------------------------------------------

// A CTA's tile: BM x BN, TM x TN micro-tiles, CTAS CTAs an SM, a ring of
// STAGES stages.
template <int BM_, int BN_, int TM_, int TN_, int CTAS_, int STAGES_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, CTAS = CTAS_, STAGES = STAGES_;
  static constexpr int TM = TM_, TN = TN_;        // a thread's micro-tile
  static constexpr int TR = BM / TM, TC = BN / TN;  // the thread grid
  static constexpr int THREADS = TR * TC;
  static constexpr int LDA = BM + PAD, LDB = BN + PAD;  // k-major rows
  static constexpr int WC = TC % 8 == 0 ? 8 : 4;  // a warp's threads along n
  static constexpr int WR = 32 / WC;
  static_assert(TM % 4 == 0 && TN % 4 == 0 && BM % TM == 0 &&
                    BN % TN == 0 && TR % WR == 0 && TC % WC == 0,
                "whole warps of whole micro-tiles");
  // Row i of the micro-tile is tile row tr·4 + i % 4 + (i / 4)·4·TR;
  // column j is tc·4 + j % 4 + (j / 4)·4·TC.
  __device__ static int row(int tr, int i) {
    return tr * 4 + i % 4 + (i / 4) * 4 * TR;
  }
  __device__ static int col(int tc, int j) {
    return tc * 4 + j % 4 + (j / 4) * 4 * TC;
  }
};

// This thread's place (tr, tc) in T's thread grid.
template <class T>
__device__ __forceinline__ void coords(int& tr, int& tc) {
  constexpr int WX = T::TC / T::WC;  // warps along n
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  tr = (warp / WX) * T::WR + lane / T::WC;
  tc = (warp % WX) * T::WC + lane % T::WC;
}

// The columns of an operand tile: tile index j maps to index col(j) along
// the operand's row or column axis, and run(j) elements from there on lie
// in one contiguous run inside the matrix (<= 0: past its edge).  Span is
// the plain map; cell_gemm.cuh gathers the cell's gate columns with its
// own.
struct Span {
  int j0, extent;
  __device__ __forceinline__ int col(int j) const { return j0 + j; }
  __device__ __forceinline__ int run(int j) const { return extent - j0 - j; }
};

// ---- loaders: one stage, k0 .. k0 + BK ------------------------------------

// An operand stored along j (element (k, j) at p[k·ld + col(j)]) into
// dst[k·LD + j]: 16-byte copies of 4 j's where vec (ld % 4 == 0, p 16-byte
// aligned, runs whole multiples of 4), else 4-byte copies.
template <int W, int NT, class Map>
__device__ __forceinline__ void load_along_j(float* dst, int LD,
                                             const float* p, long long ld,
                                             const Map& map, int k0, int K,
                                             bool vec) {
  if (vec) {
    constexpr int N = BK * W / 4;
#pragma unroll
    for (int it = 0; it < (N + NT - 1) / NT; ++it) {
      const int c = threadIdx.x + it * NT;
      if (N % NT != 0 && c >= N) break;
      const int kk = c / (W / 4), j = (c % (W / 4)) * 4;
      const int run = k0 + kk < K ? min(map.run(j), 4) : 0;
      cp16(dst + kk * LD + j,
           run > 0 ? p + (long long)(k0 + kk) * ld + map.col(j) : p,
           run > 0 ? 4 * run : 0);
    }
  } else {
#pragma unroll 1
    for (int e = threadIdx.x; e < BK * W; e += NT) {
      const int kk = e / W, j = e % W;
      const bool ok = k0 + kk < K && map.run(j) > 0;
      cp4(dst + kk * LD + j,
          ok ? p + (long long)(k0 + kk) * ld + map.col(j) : p, ok);
    }
  }
}

// Rows stored along k (element (j, k) at p[col(j)·ld + k]: the cell's H)
// into dst[j·BK + k − k0], as they are stored: 16-byte copies of 4 k where
// vec (ld % 4 == 0, p 16-byte aligned), else 4-byte copies.  Read by
// fma_stage_rows, a float4 of 4 k a row.
template <int W, int NT, class Map>
__device__ __forceinline__ void load_rows(float* dst, const float* p,
                                          long long ld, const Map& map,
                                          int k0, int K, bool vec) {
  if (vec) {
    constexpr int N = W * BK / 4;
#pragma unroll
    for (int it = 0; it < (N + NT - 1) / NT; ++it) {
      const int c = threadIdx.x + it * NT;
      if (N % NT != 0 && c >= N) break;
      const int j = c / (BK / 4), kk = (c % (BK / 4)) * 4;
      const int run = map.run(j) > 0 ? min(K - k0 - kk, 4) : 0;
      cp16(dst + j * BK + kk,
           run > 0 ? p + (long long)map.col(j) * ld + k0 + kk : p,
           run > 0 ? 4 * run : 0);
    }
  } else {
#pragma unroll 1
    for (int e = threadIdx.x; e < W * BK; e += NT) {
      const int j = e / BK, kk = e % BK;
      const bool ok = map.run(j) > 0 && k0 + kk < K;
      cp4(dst + j * BK + kk,
          ok ? p + (long long)map.col(j) * ld + k0 + kk : p, ok);
    }
  }
}

// bf16 H rows (element (j, k) at p[col(j)·ld + k], p 4-byte aligned) into
// dst[j·LDH + s_j + k − k0], kept bf16: 16-byte copies of 8 k where vec
// (ld % 8 == 0, p 16-byte aligned; s_j = 0), else the 4-byte words that
// hold the row's k, the row starting at s_j = the parity of (j, k0)'s
// element (1: the second half of a word).  Words past the row's k hold the
// next row's elements: ReadBF16 masks k past K.
template <int W, int NT, class Map>
__device__ __forceinline__ void load_h_bf16(__nv_bfloat16* dst,
                                            const __nv_bfloat16* p,
                                            long long ld, const Map& map,
                                            int k0, int K, bool vec) {
  if (vec) {
    constexpr int N = W * BK / 8;
#pragma unroll
    for (int it = 0; it < (N + NT - 1) / NT; ++it) {
      const int c = threadIdx.x + it * NT;
      if (N % NT != 0 && c >= N) break;
      const int j = c / (BK / 8), kk = (c % (BK / 8)) * 8;
      const bool ok = map.run(j) > 0 && k0 + kk < K;
      cp16(dst + j * LDH + kk,
           ok ? p + (long long)map.col(j) * ld + k0 + kk : p, ok ? 16 : 0);
    }
  } else {
    constexpr int WORDS = BK / 2 + 1;
    constexpr int N = W * WORDS;
    const int kv = min(BK, K - k0);
#pragma unroll 1
    for (int e = threadIdx.x; e < N; e += NT) {
      const int j = e / WORDS, i = e % WORDS;
      const long long e0 = (long long)map.col(j) * ld + k0;
      const int s = static_cast<int>(e0 & 1);
      const int lo = 2 * i - s;  // k − k0 of the word's first element
      const bool ok = map.run(j) > 0 && lo + 1 >= 0 && lo < kv;
      cp4(dst + j * LDH + 2 * i, ok ? p + e0 - s + 2 * i : p, ok);
    }
  }
}

// ---- fragments and the FFMA of one stage ----------------------------------

// A float32 k-major stage tile: at step kk, this thread's N values,
// N / 4 float4 at s + g·STRIDE (s points at its first).
template <int N, int STRIDE, int LD>
struct ReadF32 {
  const float* s;
  __device__ __forceinline__ void operator()(int kk, float (&v)[N]) const {
#pragma unroll
    for (int g = 0; g < N / 4; ++g) {
      const float4 x =
          *reinterpret_cast<const float4*>(s + kk * LD + g * STRIDE);
      v[4 * g] = x.x;
      v[4 * g + 1] = x.y;
      v[4 * g + 2] = x.z;
      v[4 * g + 3] = x.w;
    }
  }
};

// A bf16 H stage tile (load_h_bf16's layout): element k0 + kk of this
// thread's N rows, widened; with MASK, zero for kk >= kv.
template <int N, bool MASK>
struct ReadBF16 {
  const __nv_bfloat16* s;
  int pos[N];  // row·LDH + s_row of each of the thread's rows
  int kv;
  __device__ __forceinline__ void operator()(int kk, float (&v)[N]) const {
#pragma unroll
    for (int i = 0; i < N; ++i)
      v[i] = (!MASK || kk < kv) ? __bfloat162float(s[pos[i] + kk]) : 0.f;
  }
};

// acc[i][j] = fmaf(a_i, b_j, acc[i][j]) for k = k0 .. k0 + BK − 1 in order;
// the fragments of step k + 1 are read before the FFMA of step k.
template <int TM, int TN, class RA, class RB>
__device__ __forceinline__ void fma_stage(const RA& ra, const RB& rb,
                                          float (&acc)[TM][TN]) {
  float a[2][TM], b[2][TN];
  ra(0, a[0]);
  rb(0, b[0]);
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    if (kk + 1 < BK) {
      ra(kk + 1, a[(kk + 1) & 1]);
      rb(kk + 1, b[(kk + 1) & 1]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        acc[i][j] = fmaf(a[kk & 1][i], b[kk & 1][j], acc[i][j]);
  }
}

// fma_stage with A in load_rows' layout (sa: the stage's A rows): each 4
// k a thread reads one float4 of each of its TM rows, then runs 4 steps.
template <class T, class RB>
__device__ __forceinline__ void fma_stage_rows(const float* sa, int tr,
                                               const RB& rb,
                                               float (&acc)[T::TM][T::TN]) {
#pragma unroll
  for (int g = 0; g < BK / 4; ++g) {
    float a[T::TM][4];
#pragma unroll
    for (int i = 0; i < T::TM; ++i) {
      const float4 x = *reinterpret_cast<const float4*>(
          sa + T::row(tr, i) * BK + 4 * g);
      a[i][0] = x.x;
      a[i][1] = x.y;
      a[i][2] = x.z;
      a[i][3] = x.w;
    }
    float b[2][T::TN];
    rb(4 * g, b[0]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk + 1 < 4) rb(4 * g + kk + 1, b[(kk + 1) & 1]);
#pragma unroll
      for (int i = 0; i < T::TM; ++i)
#pragma unroll
        for (int j = 0; j < T::TN; ++j)
          acc[i][j] = fmaf(a[i][kk], b[kk & 1][j], acc[i][j]);
    }
  }
}

// The ring over K: load(stage, k0) issues one stage's copies, compute(stage,
// k0) its FFMA.  Ends with the ring drained and a barrier, so the caller may
// reuse the shared memory.
template <int STAGES, class Load, class Compute>
__device__ __forceinline__ void pipeline(int K, const Load& load,
                                         const Compute& compute) {
  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s * BK);
    commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    wait<STAGES - 2>();
    __syncthreads();  // stage kt landed; stage kt − 1 is free
    const int nx = kt + STAGES - 1;
    if (nx < nk) load(nx % STAGES, nx * BK);
    commit();
    compute(kt % STAGES, kt * BK);
  }
  wait<0>();
  __syncthreads();
}

// ---- the plain GEMM -------------------------------------------------------

template <class T>
__host__ __device__ constexpr int smem_bytes() {
  return T::STAGES * BK * (T::LDA + T::LDB) * 4;
}

// C (M, N) (=|+=) AᵀB over K: A (K, M) and B (K, N) row-major (lda, ldb),
// both copied along their rows.  vec_*: the operand may be copied (C
// stored) 16 bytes at a time.
template <class T, bool ACC>
__global__ void __launch_bounds__(T::THREADS, T::CTAS)
    gemm_kernel(const float* __restrict__ A, long long lda,
                const float* __restrict__ B, long long ldb,
                float* __restrict__ C, long long ldc, int M, int N, int K,
                int vec_a, int vec_b, int vec_c) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  constexpr int STAGE = BK * (T::LDA + T::LDB);
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  int tr, tc;
  coords<T>(tr, tc);
  const Span ma{m0, M}, mb{n0, N};
  float acc[T::TM][T::TN] = {};
  pipeline<T::STAGES>(
      K,
      [&](int s, int k0) {
        float* As = sm + s * STAGE;
        load_along_j<T::BM, T::THREADS>(As, T::LDA, A, lda, ma, k0, K,
                                        vec_a);
        load_along_j<T::BN, T::THREADS>(As + BK * T::LDA, T::LDB, B, ldb, mb,
                                        k0, K, vec_b);
      },
      [&](int s, int) {
        const float* As = sm + s * STAGE;
        const float* Bs = As + BK * T::LDA;
        fma_stage(ReadF32<T::TM, 4 * T::TR, T::LDA>{As + tr * 4},
                  ReadF32<T::TN, 4 * T::TC, T::LDB>{Bs + tc * 4}, acc);
      });
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int gr = m0 + T::row(tr, i);
    if (gr >= M) continue;
    float* row = C + gr * ldc;
#pragma unroll
    for (int q = 0; q < T::TN / 4; ++q) {
      const int gc = n0 + T::col(tc, 4 * q);
      if (vec_c && gc + 4 <= N) {
        float4* o = reinterpret_cast<float4*>(row + gc);
        float4 r = make_float4(acc[i][4 * q], acc[i][4 * q + 1],
                               acc[i][4 * q + 2], acc[i][4 * q + 3]);
        if (ACC) {
          const float4 c = *o;
          r = make_float4(c.x + r.x, c.y + r.y, c.z + r.z, c.w + r.w);
        }
        *o = r;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (gc + e < N)
            row[gc + e] = ACC ? row[gc + e] + acc[i][4 * q + e]
                              : acc[i][4 * q + e];
      }
    }
  }
}

template <class T, bool ACC>
inline void launch_tile(const float* A, int lda, const float* B, int ldb,
                        float* C, int ldc, int M, int N, int K,
                        cudaStream_t stream) {
  auto aligned = [](const void* p) {
    return reinterpret_cast<size_t>(p) % 16 == 0;
  };
  const int vec_a = lda % 4 == 0 && aligned(A);
  const int vec_b = ldb % 4 == 0 && aligned(B);
  const int vec_c = ldc % 4 == 0 && aligned(C);
  auto kernel = gemm_kernel<T, ACC>;
  hop::allow_smem(kernel, smem_bytes<T>());
  dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM);
  kernel<<<grid, T::THREADS, smem_bytes<T>(), stream>>>(
      A, lda, B, ldb, C, ldc, M, N, K, vec_a, vec_b, vec_c);
}

// Two tiles: 128 x 128 of 8 x 16 micro-tiles, 128 threads, two CTAs an
// SM; and 160 x 128 of 8 x 8, 320 threads, one CTA an SM, for products
// whose tiles all fit one wave of one CTA an SM (dU: h = 800 is 5 whole
// tiles of 160, and its 125 tiles run at once on 132 SMs, where 175 tiles
// of 128 leave 43 SMs with two).  On the H100, 8 x 16 beat 8 x 8 on the
// square tile and lost on the tall one (255 registers at 160 threads), and
// the tall tile ran faster with 3 stages than with 4.
using Square = Tile<128, 128, 8, 16, 2, 4>;
using Tall = Tile<160, 128, 8, 8, 1, 3>;

static inline int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

// C (M, N) (=|+=) AᵀB over K (gemm_kernel's operands).  The grid walks the
// N tiles fastest, so a column block of A is read from device memory once.
template <bool ACC>
inline void launch(const float* A, int lda, const float* B, int ldb,
                   float* C, int ldc, int M, int N, int K,
                   cudaStream_t stream) {
  const long long tall = (long long)((M + Tall::BM - 1) / Tall::BM) *
                         ((N + Tall::BN - 1) / Tall::BN);
  if (tall <= sm_count())
    launch_tile<Tall, ACC>(A, lda, B, ldb, C, ldc, M, N, K, stream);
  else
    launch_tile<Square, ACC>(A, lda, B, ldb, C, ldc, M, N, K, stream);
}

}  // namespace gemm32
}  // namespace iadmm
