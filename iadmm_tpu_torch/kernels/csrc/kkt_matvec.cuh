// One pass over the stacked matrix [Q; A0] that yields both halves of a
// KKT matvec, for one right-hand side or for two against a single read of
// the matrix.  Shared by rollout.cu (bf16 data, vectors rounded to bf16),
// stage2.cu (float32 data and vectors), train_fwd.cu, train_bwd.cu (either)
// and kkt_pass.cu (the pass alone).
//
// For instance b and a right-hand side w = [wt; wb] (n + m), chunks of ROWS
// rows of the (n+m) x n matrix [Q; A0]:
//   partial[b, c, j] = Σ_{i in chunk c} [Q; A0][i, j] · w[i]
//   rowdot[b, i-n]   = Σ_j A0[i-n, j] · wt[j]          for chunk rows i >= n
// Q is symmetric, so Σ_c partial[b, c, :] = Q·wt + A0ᵀ·wb; rowdot = A0·wt.
// The chunk partials are summed by the caller's next kernel in chunk order
// (sum_partials).  No atomics: every sum has one fixed order, the order of
// the port's first design (one column a thread, a warp_sum a row), so its
// results stay bit for bit:
//   - partial: one fmaf chain from 0.f over the chunk's rows in row order;
//   - rowdot: for each group g of GROUP = 32 columns, the butterfly tree of
//     warp_sum (pairs at distance 16, 8, 4, 2, 1) over the products a·u
//     (columns >= n count 0); then racc_w = the groups g ≡ w (mod WAYS = 8)
//     added in g order from 0.f; then rowdot = Σ_w racc_w in w order.
// Each product is rounded before it is added (the first design's product
// fed a shuffle and was not contracted into an FMA).
//
// Design for the H100.  The pass reads (n+m)·n elements of [Q; A0] an
// instance (2 bytes in bf16, 4 in float32) and does about 2 flops a byte:
// bytes bound it.  A CTA takes one chunk of one instance and walks its
// columns in blocks of 2 KB a row (1024 bf16 or 512 float32 columns).  It
// brings the 32-row tile of a block into shared memory with one bulk copy
// a row (cp.async.bulk, the TMA without a tensor map, completing on one
// mbarrier; element loads where n is not a multiple of 16 bytes), all in
// flight at once, then 256 threads read it twice, each in the layout its
// sum wants:
//   - the partials: a thread takes 16 bytes of columns of one right-hand
//     side and runs their fmaf chains down the rows;
//   - the row dots of the A0 rows: a thread takes one group of 32 columns
//     of one side and a slice of the rows (the slice varying fastest
//     across threads), keeps wt's 32 entries in registers and forms the
//     group's butterfly for each of its rows in registers, no shuffle; the
//     group sums go through shared memory and are folded into the racc_w
//     in group order.
// The tile's rows are 16 bytes longer than a block row, so eight threads
// reading one column chunk of eight rows hit eight bank quads.  With two
// right-hand sides the tile is read once from memory and twice from shared
// memory for each.  A grid of chunks x instances: 126 CTAs of 8 warps at
// n + m = 2000, B = 2; 69–77 KB of shared memory, two or three CTAs an SM.
//
// Bound: bytes, one read of Q and A0 per pass (the partials it writes are
// 1/16 of that in bf16).  At n = m = 1000 the bf16 data of 8 instances is
// 32 MB and the L2 (50 MB) can serve every pass after the first; at B = 16
// (64 MB) each pass reads memory.  Two right-hand sides share that read.
#pragma once

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace iadmm {
namespace kkt {

constexpr int ROWS = 32;          // rows of a chunk: one fmaf chain a column
constexpr int GROUP = 32;         // columns of a row-dot butterfly
constexpr int WAYS = 8;           // racc_w: groups g ≡ w (mod WAYS)
constexpr int THREADS = 256;
constexpr int TILE_ROW_BYTES = 2048;   // a column block's bytes a row
// The tile's row pitch: 16 bytes more than a block row, so that the
// 16-byte reads of one column chunk in eight rows hit eight bank quads.
constexpr int PITCH = TILE_ROW_BYTES + 16;

inline int n_chunks(int n, int m) { return (n + m + ROWS - 1) / ROWS; }

// Columns of a 16-byte vector, of a column block, and groups of a block.
template <typename T>
struct Lay {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int CB = TILE_ROW_BYTES / sizeof(T);
  static constexpr int GPB = CB / GROUP;
};

// One right-hand side: w = [wt; wb] (rows of wt_ld and wb_ld floats), and
// its outputs partial (B, n_chunks, n), rowdot (B, m).
struct Rhs {
  const float* wt;
  int wt_ld;
  const float* wb;
  int wb_ld;
  float* partial;
  float* rowdot;
};

template <int NV>
struct Rhss {
  Rhs v[NV];
};

// Side v of at most two, by selects (no indexing of the parameter).
template <int NV>
__device__ __forceinline__ Rhs side(const Rhss<NV>& r, int v) {
  return (NV == 1 || v == 0) ? r.v[0] : r.v[NV - 1];
}

// Shared memory of a CTA: the tile (ROWS rows of PITCH bytes), and for
// each side the chunk's vector entries, the group sums of a block (rows of
// GPB + 1) and the racc_w; then the tile's mbarrier.
template <typename T>
__host__ __device__ constexpr size_t float_words(int nv) {
  return nv * (ROWS + ROWS * (Lay<T>::GPB + 1) + ROWS * WAYS);
}
template <typename T>
constexpr size_t smem_bytes(int nv) {
  return ROWS * PITCH + (sizeof(float) * float_words<T>(nv) + 7) / 8 * 8 + 8;
}

// Bulk copy (TMA, no tensor map) of `bytes` (a multiple of 16, both
// addresses 16-byte aligned) from global memory to shared memory,
// completing on the mbarrier bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(hop::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// n elements of T from shared memory, widened (n a multiple of VEC, 16-byte
// aligned).
template <typename T, int N>
__device__ __forceinline__ void widen(const T* src, float* a) {
#pragma unroll
  for (int k = 0; k < N; k += Lay<T>::VEC) {
    const uint4 v = *reinterpret_cast<const uint4*>(src + k);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a[k + 2 * e] = __uint_as_float(w[e] << 16);
        a[k + 2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[k + e] = __uint_as_float(w[e]);
    }
  }
}

// The butterfly of one row and group g of a tile row, in warp_sum's
// pairing (distance 16, 8, 4, 2, 1; see the header), over the products
// a·u, each rounded.  Columns l and l + 16 are read together, a 16-byte
// chunk of each at a time, so few registers hold the row.
template <typename T>
__device__ __forceinline__ float group_dot(const T* row, int g,
                                           const float (&u)[GROUP]) {
  static_assert(GROUP == 32, "the tree below is written for 32 columns");
  constexpr int VEC = Lay<T>::VEC;
  float s[16];
#pragma unroll
  for (int l = 0; l < 16; l += VEC) {
    float lo[VEC], hi[VEC];
    widen<T, VEC>(row + g * GROUP + l, lo);
    widen<T, VEC>(row + g * GROUP + l + 16, hi);
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      s[l + e] = __fadd_rn(__fmul_rn(lo[e], u[l + e]),
                           __fmul_rn(hi[e], u[l + e + 16]));
  }
  // constant bounds, so that s stays in registers
#pragma unroll
  for (int l = 0; l < 8; ++l) s[l] = __fadd_rn(s[l], s[l + 8]);
#pragma unroll
  for (int l = 0; l < 4; ++l) s[l] = __fadd_rn(s[l], s[l + 4]);
#pragma unroll
  for (int l = 0; l < 2; ++l) s[l] = __fadd_rn(s[l], s[l + 2]);
  return __fadd_rn(s[0], s[1]);
}

// CTA (chunk c, instance b).  VEC16: 16-byte copies (n a multiple of VEC,
// the matrices 16-byte aligned) and float4 stores; else one element at a
// time.
template <typename T, bool ROUND, int NV, bool VEC16>
__global__ void __launch_bounds__(THREADS, 3)
    colpass_kernel(const T* __restrict__ Q, const T* __restrict__ A0,
                   Rhss<NV> rhs, int n, int m, int nchunks) {
  using L = Lay<T>;
  constexpr int VEC = L::VEC, CB = L::CB, GPB = L::GPB;
  constexpr int LD = PITCH / sizeof(T);   // tile elements a row
  constexpr int GS = GPB + 1;             // group sums a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);                     // [ROWS][LD]
  float* wrow = reinterpret_cast<float*>(smem_raw + ROWS * PITCH);
  float* gs = wrow + NV * ROWS;             // [NV][ROWS][GS]
  float* racc = gs + NV * ROWS * GS;        // [NV][ROWS][WAYS]
  const uint32_t bar = hop::smem_addr(
      smem_raw + ROWS * PITCH +
      (sizeof(float) * float_words<T>(NV) + 7) / 8 * 8);
  const int b = blockIdx.y, c = blockIdx.x, tid = threadIdx.x;
  const int i0 = c * ROWS;
  const int rows = min(ROWS, n + m - i0);
  const int ra = max(0, n - i0);            // the chunk's first A0 row
  const bool has_a0 = ra < rows;            // uniform over the CTA
  for (int k = tid; k < NV * ROWS; k += THREADS) {
    const int v = k / ROWS, r = k % ROWS;
    const Rhs h = side(rhs, v);
    float w = 0.f;
    if (r < rows) {
      const int i = i0 + r;
      w = i < n ? h.wt[(size_t)b * h.wt_ld + i]
                : h.wb[(size_t)b * h.wb_ld + (i - n)];
      if (ROUND) w = bf16_round(w);
    }
    wrow[k] = w;
  }
  for (int k = tid; k < NV * ROWS * WAYS; k += THREADS) racc[k] = 0.f;
  if (VEC16 && tid == 0) {
    hop::mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  const T* Qb = Q + (size_t)b * n * n;
  const T* Ab = A0 + (size_t)b * m * n;
  const int slices = THREADS / (NV * GPB);   // row slices of the row dots
  for (int cb = 0, phase = 0; cb < n; cb += CB, phase ^= 1) {
    const int ngr = min(GPB, (n - cb + GROUP - 1) / GROUP);   // groups
    const int width = ngr * GROUP;          // tile columns, zero from n on
    const int valid = min(CB, n - cb);      // columns of the matrices
    // 1. the tile: the chunk's rows, the block's columns, each row one
    //    bulk copy (lane r of warp 0), all in flight at once, the columns
    //    from n to the group's end zero; a row-dot thread's wt entries
    //    beside them
    if (VEC16) {
      for (int k = tid; k < rows * (width - valid); k += THREADS) {
        const int r = k / (width - valid), j = valid + k % (width - valid);
        tile[r * LD + j] = from_f<T>(0.f);
      }
      __syncthreads();   // the barrier's init and the zeros, before the copies
      if (tid < 32) {
        if (tid == 0) hop::mbar_expect_tx(bar, rows * valid * sizeof(T));
        __syncwarp();
        if (tid < rows) {
          const int i = i0 + tid;
          const T* row = i < n ? Qb + (size_t)i * n : Ab + (size_t)(i - n) * n;
          bulk_load(tile + tid * LD, row + cb, valid * sizeof(T), bar);
        }
      }
    } else {
      for (int k = tid; k < rows * width; k += THREADS) {
        const int r = k / width, j = cb + k % width, i = i0 + r;
        const T* row = i < n ? Qb + (size_t)i * n : Ab + (size_t)(i - n) * n;
        tile[r * LD + (j - cb)] = j < n ? row[j] : from_f<T>(0.f);
      }
    }
    const bool unit = has_a0 && tid < NV * slices * ngr;
    const int usl = tid % slices, ug = (tid / slices) % ngr,
              uv = tid / (ngr * slices);
    float u[GROUP];
    if (unit) {
      const Rhs h = side(rhs, uv);
      const float* src = h.wt + (size_t)b * h.wt_ld + cb + ug * GROUP;
      const int j0 = cb + ug * GROUP;
      if (VEC16 && j0 + GROUP <= n &&
          reinterpret_cast<uintptr_t>(src) % 16 == 0) {
#pragma unroll
        for (int e = 0; e < GROUP; e += 4) {
          const float4 t = *reinterpret_cast<const float4*>(src + e);
          u[e] = t.x;
          u[e + 1] = t.y;
          u[e + 2] = t.z;
          u[e + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < GROUP; ++e) u[e] = j0 + e < n ? src[e] : 0.f;
      }
      if (ROUND) {
#pragma unroll
        for (int e = 0; e < GROUP; ++e) u[e] = bf16_round(u[e]);
      }
    }
    if (VEC16) hop::mbar_wait(bar, phase);
    __syncthreads();
    // 2. the partials: a thread a side and VEC columns, one fmaf chain a
    //    column down the chunk's rows in order
    const int nvec = (min(CB, n - cb) + VEC - 1) / VEC;
    if (tid < NV * nvec) {                  // at most one task a thread
      const int v = tid / nvec, j = cb + (tid % nvec) * VEC;
      const float* w = wrow + v * ROWS;
      const T* col = tile + (j - cb);
      float acc[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll 4
      for (int r = 0; r < rows; ++r) {
        float a[VEC];
        widen<T, VEC>(col + r * LD, a);
        const float wr = w[r];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = fmaf(a[e], wr, acc[e]);
      }
      float* out = side(rhs, v).partial + ((size_t)b * nchunks + c) * n + j;
      if (VEC16) {
#pragma unroll
        for (int e = 0; e < VEC; e += 4)
          *reinterpret_cast<float4*>(out + e) =
              make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          if (j + e < n) out[e] = acc[e];
      }
    }
    // 3. the row dots of the A0 rows: a thread a side, a group and a slice
    //    of the rows, the group's butterfly in registers for each row
    if (unit) {
      for (int r = ra + usl; r < rows; r += slices)
        gs[(uv * ROWS + r) * GS + ug] = group_dot<T>(tile + r * LD, ug, u);
    }
    __syncthreads();
    // 4. fold the block's group sums into the racc_w, in group order
    if (has_a0) {
      for (int k = tid; k < NV * ROWS * WAYS; k += THREADS) {
        const int w = k % WAYS, r = (k / WAYS) % ROWS, v = k / (WAYS * ROWS);
        if (r >= ra && r < rows) {
          const float* gr = gs + (v * ROWS + r) * GS;
          float s = racc[k];
          for (int g = w; g < ngr; g += WAYS) s = __fadd_rn(s, gr[g]);
          racc[k] = s;
        }
      }
    }
    // the tile's generic reads, before the next block's bulk copies
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
  }
  if (has_a0) {
    for (int k = tid; k < NV * ROWS; k += THREADS) {
      const int v = k / ROWS, r = k % ROWS;
      if (r >= ra && r < rows) {
        const float* ra_w = racc + k * WAYS;
        float d = 0.f;
        for (int w = 0; w < WAYS; ++w) d = __fadd_rn(d, ra_w[w]);
        side(rhs, v).rowdot[(size_t)b * m + (i0 + r - n)] = d;
      }
    }
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

template <typename T, bool ROUND, int NV>
inline void launch(const void* Q, const void* A0, const Rhss<NV>& rhs, int n,
                   int m, int B, cudaStream_t s) {
  const dim3 grid(n_chunks(n, m), B);
  constexpr size_t smem = smem_bytes<T>(NV);
  bool vec16 = n % Lay<T>::VEC == 0 &&
               reinterpret_cast<uintptr_t>(Q) % 16 == 0 &&
               reinterpret_cast<uintptr_t>(A0) % 16 == 0;
  for (int v = 0; v < NV; ++v)
    vec16 &= reinterpret_cast<uintptr_t>(rhs.v[v].partial) % 16 == 0;
  const T* q = static_cast<const T*>(Q);
  const T* a = static_cast<const T*>(A0);
  auto kernel = vec16 ? colpass_kernel<T, ROUND, NV, true>
                      : colpass_kernel<T, ROUND, NV, false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  kernel<<<grid, THREADS, smem, s>>>(q, a, rhs, n, m, n_chunks(n, m));
}

// One right-hand side (wt, wb) into (partial, rowdot).
template <typename T, bool ROUND>
inline void colpass(const void* Q, const void* A0, const float* wt, int wt_ld,
                    const float* wb, int wb_ld, float* partial, float* rowdot,
                    int n, int m, int B, cudaStream_t s) {
  launch<T, ROUND, 1>(Q, A0, Rhss<1>{{{wt, wt_ld, wb, wb_ld, partial, rowdot}}},
                      n, m, B, s);
}

// Two right-hand sides, one read of [Q; A0]; each output as colpass gives
// it alone, bit for bit.
template <typename T, bool ROUND>
inline void colpass2(const void* Q, const void* A0, const Rhs& r1,
                     const Rhs& r2, int n, int m, int B, cudaStream_t s) {
  launch<T, ROUND, 2>(Q, A0, Rhss<2>{{r1, r2}}, n, m, B, s);
}

}  // namespace kkt
}  // namespace iadmm
