// Stage II's 'kkt' operand for Hopper (sm_90a): Ã and its float32 inverse
// Ã⁻¹, Ã = [[Q + σI, A0ᵀ], [A0, −diag(1/ρ)]], formed in one launch.
//
// Replaces no TPU kernel: the JAX package forms this operand with a library
// inverse (jnp.linalg.inv at iadmm_tpu/kernels/stage2_kernel.py:267) outside
// its Pallas call.  It was added because on the H100 torch.linalg.inv (MAGMA's
// batched LU: pivot search, row swaps, trsm and gemm panels launched one after
// another by a host loop, and an info check that syncs) took ~70–83 ms of a
// ~120 ms serving solve at B = 8, S = n + m = 2000, about 2 TFLOP/s.
//
// Algorithm: blocked Gauss–Jordan elimination with partial (row) pivoting,
// in place, all float32 FFMA (no TF32).  It costs 2·S³ like getrf + getri, and
// was chosen over them because every panel step is the same rank-nb update of
// the whole matrix: one loop, one work list a step, no triangular inverse and
// no second sweep, and S/nb steps that keep every SM busy to the last panel
// (the LU's trailing matrix shrinks to nothing).  Step t factors the panel of
// columns k = t·nb .. k + nb over all S rows (the pivot chosen among rows
// ≥ k + j, the largest |value|, ties to the lowest row); every other column
// c then takes  new[i][c] = (i in the block ? 0 : old[i][c]) + Σ_b P[i][b]·R[b][c],
// R the block's pivoted rows before the step: one fmaf chain over b in
// order, starting from the old value.
// Rows are never moved: a map phys (logical row -> row of the working matrix
// W) takes each swap, so a step reads and writes every row where it lies.
// At the end Ã⁻¹[r][c] = W[phys[r]][phys⁻¹[c]], written row-major into the
// operand buffer.  kernels/stage2_kernel.py::kkt_inverse_plain repeats this
// panel order in PyTorch.
//
// What bounds it: the operations, 2·S³ FFMA a matrix (128 GFLOP at B = 8,
// 1.9 ms at 67 TFLOP/s), and the latency of S pivot steps in a row.  The
// design:
// - each instance in flight has a factoring cluster of CL = 8 CTAs; the
//   clusters left over form a pool of updaters shared evenly among the
//   instances.  The panel's rows are spread over the cluster's shared
//   memory (S/8 rows each).  A pivot step is one cluster barrier: each CTA
//   publishes its local max |value|, its candidate row and (the owner) the
//   current block row in a double-buffered slot; after the barrier every CTA
//   gathers the CL slots over DSMEM in one round of float4 reads, takes the
//   first largest in rank order, and updates its own rows.
// - the panel is factored in sub-panels of SB = 32 columns: a pivot step
//   updates only its sub-panel's columns (a warp a block of rows, float4
//   lanes), and the sub-panel's end applies its rank-32 update to the
//   panel's other columns (4 x 4 register tiles, its pivot rows gathered
//   over DSMEM), so most of the panel's work is small rank updates and
//   not rank-1 steps.
// - the rank-nb updates of the other columns run on gemm_f32.cuh's FFMA
//   tiles (256 x nb, 8 x 16 micro-tiles at nb = 128: nb/4 FLOP a byte of W,
//   above the card's 20) over work items of (column strip, 256 rows), split
//   evenly among the updaters; each sum starts from the old value, loaded
//   while the operands' ring fills.
// - look-ahead: the factoring cluster itself updates the next panel's strip
//   and factors it while the updaters still update the rest with the
//   previous panel, so the pivot steps' latency overlaps the updates.  The
//   two groups meet through flags in device memory (release / acquire): the
//   panel count and each CTA's finished step; no host loop, no pointer
//   arrays, no sync with the host.  P, R and phys of a step are double
//   buffered by its parity.
// - nb, the instances in flight and the updaters an instance follow the
//   observed B and S: nb is the widest of 128, 64, 32 whose panel fits the
//   cluster's shared memory; all clusters are co-resident (the launch is
//   cooperative and at most cudaOccupancyMaxActiveClusters clusters);
//   instances beyond them run in further rounds of the same CTAs.
// - a zero pivot sets the instance's info to its row + 1 (LAPACK's info);
//   nothing reads it on the hot path.
// Every sum is one thread's chain in a fixed order and the pivot reduction
// has a fixed order: two calls give the same bits.  The flags are the only
// atomics-like accesses, and they order work, they sum nothing.

#include <cooperative_groups.h>

#include <algorithm>

#include "gemm_f32.cuh"

namespace cg = cooperative_groups;

namespace iadmm {
namespace kinv {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CL = 8;          // CTAs a cluster
constexpr int BM = 256;        // rows of an update item
constexpr int STAGES = 3;      // the update's cp.async ring
constexpr int NB_MAX = 128;    // the widest panel (scratch is sized for it)
constexpr int SB = 32;         // the width of a panel's sub-panels
constexpr int FLAGS = 264;     // ints of flags an instance: panels, CTAs
constexpr int MAX_G = FLAGS - 8;
static_assert(CL == WARPS, "a warp gathers each rank's slot");

template <int NB>
struct Shape {
  static constexpr int TN = NB >= 128 ? 16 : NB >= 64 ? 8 : 4;
  using T = gemm32::Tile<BM, NB, 8, TN, 1, STAGES>;
  static_assert(T::THREADS == THREADS, "one thread count for every phase");
  static constexpr int LDP = NB + 4;    // a panel row in shared memory
  // a slot: max, row, 2 pad; the candidate row; the block row (16-byte
  // aligned, so that DSMEM copies move float4)
  static constexpr int SLOT = 4 + 2 * NB;
  static constexpr int RING = STAGES * gemm32::BK * (T::LDA + T::LDB);
};

// Shared memory (floats): the union region (the panel; the update's ring;
// the transposing tile; phys⁻¹), phys, this CTA's two slots, every rank's
// slot gathered, the block row gathered, a column of the panel's rows twice
// (the multipliers of this pivot step and the next), the warps' maxima; a
// sub-panel's pivot rows (Rs) in the gathered slots' place.
template <int NB>
struct Lay {
  int uni, phys, slots, cands, grow, fcol, rows4, red, rs, total;
  __host__ __device__ Lay(int S) {
    using Sh = Shape<NB>;
    const int rows = (S + CL - 1) / CL;
    int u = rows * Sh::LDP;
    u = u > Sh::RING ? u : Sh::RING;
    u = u > 32 * 33 ? u : 32 * 33;
    u = u > S ? u : S;
    uni = 0;
    phys = (u + 3) / 4 * 4;
    slots = phys + (S + 3) / 4 * 4;
    cands = slots + 2 * Sh::SLOT;   // and, at a sub-panel's end, Rs
    rs = cands;
    grow = cands + (CL * Sh::SLOT > SB * NB ? CL * Sh::SLOT : SB * NB);
    fcol = grow + NB;
    rows4 = (rows + 3) / 4 * 4;
    red = fcol + 2 * rows4;
    total = red + 4 * WARPS;
  }
};

struct Args {
  const float* Q;
  const float* A0;
  const float* rho;
  float sigma;
  float* out;     // (B, S, S) row-major
  float* W;       // (B, S, ldw) working matrix
  float* Pb;      // (B, 2, NB_MAX, ldw) the panel, transposed
  float* Rb;      // (B, 2, NB_MAX, ldw) the block's rows before the step
  int* physb;     // (B, 2, S)
  int* flags;     // (B, FLAGS): [0] panels published, [1 + c] CTA c's steps
  int* info;      // (B,)
  int B, n, m, S, ldw;
  int slots, pool;   // instances at a time; updater CTAs in all
};

// ---- flags ----------------------------------------------------------------

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
// Thread 0 waits until *p >= v; a wait of ~10 s traps (a fault, not a
// hang).  Every thread must call it: it ends in a barrier.
__device__ __forceinline__ void wait_geq(const int* p, int v) {
  if (threadIdx.x == 0) {
    const long long t0 = clock64();
    while (ld_acquire(p) < v)
      if (clock64() - t0 > (1LL << 34)) __trap();
  }
  __syncthreads();
}
// Every thread: its writes are visible at device scope before thread 0
// stores v (release) into *p.
__device__ __forceinline__ void publish(int* p, int v) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) st_release(p, v);
}

// ---- one instance ---------------------------------------------------------

struct Inst {
  const float* Q;
  const float* A0;
  const float* rho;
  float* out;
  float* W;
  float* Pb;
  float* Rb;
  int* physb;
  int* flags;
  int* info;
  int n, m, S, ldw, T, nrt;
  __device__ float* pt(int t) const {   // the panel of step t, transposed
    return Pb + (size_t)(t & 1) * NB_MAX * ldw;
  }
  __device__ float* rb(int t) const {
    return Rb + (size_t)(t & 1) * NB_MAX * ldw;
  }
  __device__ int* ph(int t) const { return physb + (size_t)(t & 1) * S; }
  __device__ int* prog(int c) const { return flags + 1 + c; }
};

// W = Ã: Q + σI and −diag(1/ρ) and A0 row by row, A0ᵀ through 32 x 32
// tiles in shared memory.  CTA c of G takes every G-th row and tile.
__device__ void form(const Inst& I, float sigma, int c, int G, float* tile) {
  const int n = I.n, m = I.m, S = I.S;
  for (int i = c; i < S; i += G) {
    float* row = I.W + (size_t)i * I.ldw;
    if (i < n) {
      const float* q = I.Q + (size_t)i * n;
      for (int j = threadIdx.x; j < n; j += THREADS)
        row[j] = j == i ? q[j] + sigma : q[j];
    } else {
      const int r = i - n;
      const float* a = I.A0 + (size_t)r * n;
      const float d = -1.0f / I.rho[r];
      for (int j = threadIdx.x; j < S; j += THREADS)
        row[j] = j < n ? a[j] : (j == i ? d : 0.f);
    }
  }
  const int tq = (m + 31) / 32, ti = (n + 31) / 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int id = c; id < tq * ti; id += G) {
    const int q0 = (id / ti) * 32, i0 = (id % ti) * 32;
    for (int r = ty; r < 32; r += WARPS) {
      const int q = q0 + r, i = i0 + tx;
      tile[r * 33 + tx] = q < m && i < n ? I.A0[(size_t)q * n + i] : 0.f;
    }
    __syncthreads();
    for (int r = ty; r < 32; r += WARPS) {
      const int i = i0 + r, q = q0 + tx;
      if (i < n && q < m) I.W[(size_t)i * I.ldw + n + q] = tile[tx * 33 + r];
    }
    __syncthreads();
  }
}

// One update item of step t: rows rt·BM .. + BM of column strip s,
// W[phys[i]][c] = (i in the block ? 0 : W[phys[i]][c]) + Σ_b P[i][b]·R[b][c],
// one fmaf chain over b in order, starting from the old value.
template <int NB>
__device__ void update_item(const Inst& I, int t, int s, int rt,
                            const int* phys, float* ring) {
  using T = typename Shape<NB>::T;
  constexpr int STAGE = gemm32::BK * (T::LDA + T::LDB);
  const int k = t * NB, K = min(NB, I.S - k);
  const int i0 = rt * BM, c0 = s * NB, cend = min(I.S, c0 + NB);
  const float* A = I.pt(t);
  const float* Bm = I.rb(t);
  const gemm32::Span ma{i0, I.S}, mb{c0, cend};
  int tr, tc;
  gemm32::coords<T>(tr, tc);
  // each sum starts from the old value (zero in the block's rows), loaded
  // while the ring fills, and its fmaf chain runs over b in order
  float acc[T::TM][T::TN];
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int gi = i0 + T::row(tr, i);
    const bool load = gi < I.S && !(gi >= k && gi < k + K);
    const float* row = I.W + (size_t)(gi < I.S ? phys[gi] : 0) * I.ldw;
#pragma unroll
    for (int q = 0; q < T::TN / 4; ++q) {
      const int gc = c0 + T::col(tc, 4 * q);
      float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
      if (load && gc + 4 <= cend) {
        b = __ldcg(reinterpret_cast<const float4*>(row + gc));
      } else if (load) {
        if (gc < cend) b.x = __ldcg(row + gc);
        if (gc + 1 < cend) b.y = __ldcg(row + gc + 1);
        if (gc + 2 < cend) b.z = __ldcg(row + gc + 2);
      }
      acc[i][4 * q] = b.x;
      acc[i][4 * q + 1] = b.y;
      acc[i][4 * q + 2] = b.z;
      acc[i][4 * q + 3] = b.w;
    }
  }
  gemm32::pipeline<T::STAGES>(
      K,
      [&](int st, int k0) {
        float* As = ring + st * STAGE;
        gemm32::load_along_j<T::BM, T::THREADS>(As, T::LDA, A, I.ldw, ma,
                                                k0, K, true);
        gemm32::load_along_j<T::BN, T::THREADS>(As + gemm32::BK * T::LDA,
                                                T::LDB, Bm, I.ldw, mb, k0, K,
                                                true);
      },
      [&](int st, int) {
        const float* As = ring + st * STAGE;
        const float* Bs = As + gemm32::BK * T::LDA;
        gemm32::fma_stage(
            gemm32::ReadF32<T::TM, 4 * T::TR, T::LDA>{As + tr * 4},
            gemm32::ReadF32<T::TN, 4 * T::TC, T::LDB>{Bs + tc * 4}, acc);
      });
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int gi = i0 + T::row(tr, i);
    if (gi >= I.S) continue;
    float* row = I.W + (size_t)phys[gi] * I.ldw;
#pragma unroll
    for (int q = 0; q < T::TN / 4; ++q) {
      const int gc = c0 + T::col(tc, 4 * q);
      if (gc + 4 <= cend) {
        *reinterpret_cast<float4*>(row + gc) =
            make_float4(acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2],
                        acc[i][4 * q + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (gc + e < cend) row[gc + e] = acc[i][4 * q + e];
      }
    }
  }
}

// Items [lo, hi) of step t's list: the strips other than t (and than t + 1
// where skip1), BM-row items of each, strip by strip.
template <int NB>
__device__ void update_items(const Inst& I, int t, bool skip1, int lo,
                             int hi, const int* phys, float* ring) {
  const int gap = (skip1 && t + 1 < I.T) ? 2 : 1;
  for (int u = lo; u < hi; ++u) {
    const int si = u / I.nrt, rt = u % I.nrt;
    update_item<NB>(I, t, si < t ? si : si + gap, rt, phys, ring);
  }
}

// (v, i) becomes (ov, oi) where that is the better candidate: the larger
// |value| (−1: none), ties to the lower row.
__device__ __forceinline__ void take_best(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi >= 0 && (i < 0 || oi < i))) {
    v = ov;
    i = oi;
  }
}

// The best candidate over the warp, in every lane.
__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    take_best(v, i, ov, oi);
  }
}

// The CTA's best candidate for the pivot of row g (the warps' maxima wv,
// wi: the largest |value| among rows >= g, ties to the lowest row) into its
// slot, with that row and, where the CTA holds row g, row g.  Every thread
// calls it; it starts with a barrier.
template <int NB>
__device__ void offer(const float* P, int nloc, int r0, int g, int nbw,
                      float* slot, const float* wv, const int* wi) {
  constexpr int LDP = Shape<NB>::LDP;
  __syncthreads();
  float v = -1.f;
  int r = -1;
  for (int w = 0; w < WARPS; ++w) take_best(v, r, wv[w], wi[w]);
  const int t = threadIdx.x;
  if (t == 0) {
    slot[0] = v;
    slot[1] = __int_as_float(r);
  }
  const int n4 = (nbw + 3) / 4;
  float4* s4 = reinterpret_cast<float4*>(slot + 4);
  if (t < n4) {
    if (r >= 0) s4[t] = reinterpret_cast<const float4*>(P + (r - r0) * LDP)[t];
    if (g >= r0 && g < r0 + nloc)
      s4[NB / 4 + t] = reinterpret_cast<const float4*>(P + (g - r0) * LDP)[t];
  }
}

// The factoring cluster's part of an instance: every panel, its publication
// and the look-ahead; with no updaters (U = 0) every update too.
template <int NB>
__device__ void factor_all(const Inst& I, int rank, int G, float* sm,
                           const Lay<NB>& L) {
  constexpr int LDP = Shape<NB>::LDP, SLOT = Shape<NB>::SLOT;
  constexpr int LPR = SB / 4, RPW = 32 / LPR;   // lanes a row, rows a warp
  constexpr int UR = 4;   // rows a lane updates at once
  cg::cluster_group cluster = cg::this_cluster();
  const int S = I.S;
  const int rows = (S + CL - 1) / CL;
  const int r0 = rank * rows, nloc = max(0, min(S, r0 + rows) - r0);
  float* P = sm + L.uni;
  int* phys = reinterpret_cast<int*>(sm + L.phys);
  float* slots = sm + L.slots;
  float* cands = sm + L.cands;
  float* growl = sm + L.grow;
  float* wv = sm + L.red;
  int* wi = reinterpret_cast<int*>(sm + L.red + WARPS);
  const int U = G - CL;   // updater CTAs
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // each warp's block of the CTA's panel rows
  const int per_warp = (nloc + WARPS - 1) / WARPS;
  const int w0 = min(nloc, warp * per_warp), w1 = min(nloc, w0 + per_warp);
  for (int i = threadIdx.x; i < S; i += THREADS) phys[i] = i;
  // W is formed by every CTA of the instance
  for (int c = 0; c < G; ++c) wait_geq(I.prog(c), 1);
  for (int t = 0; t < I.T; ++t) {
    const int k = t * NB, nbw = min(NB, S - k);
    // the panel's rows of this CTA, from where they lie
    for (int e = threadIdx.x; e < nloc * nbw; e += THREADS) {
      const int li = e / nbw, b = e % nbw;
      P[li * LDP + b] = __ldcg(I.W + (size_t)phys[r0 + li] * I.ldw + k + b);
    }
    __syncthreads();
    // column col's multipliers (every row) and this CTA's candidate for its
    // pivot (rows >= k + col), offered in the slot of col's parity
    auto start_column = [&](int col) {
      float bv = -1.f;
      int bi = -1;
      float* fcb = sm + L.fcol + (col & 1) * L.rows4;
      for (int li = threadIdx.x; li < nloc; li += THREADS) {
        const float x = P[li * LDP + col];
        fcb[li] = x;
        if (r0 + li >= k + col && fabsf(x) > bv) {   // ascending rows
          bv = fabsf(x);
          bi = r0 + li;
        }
      }
      warp_best(bv, bi);
      if (lane == 0) {
        wv[warp] = bv;
        wi[warp] = bi;
      }
      offer<NB>(P, nloc, r0, k + col, nbw, slots + (col & 1) * SLOT, wv, wi);
    };
    start_column(0);
    hop::cluster_sync();
    for (int jj = 0; jj < nbw; ++jj) {
      const int g = k + jj, og = g / rows;
      const float* slot = slots + (jj & 1) * SLOT;
      float* fc = sm + L.fcol + (jj & 1) * L.rows4;        // column jj
      float* fn = sm + L.fcol + ((jj + 1) & 1) * L.rows4;  // column jj + 1
      // every rank's slot (a warp a rank), and row g from its owner, in one
      // round over DSMEM, as float4
      const int n4 = (nbw + 3) / 4;
      {
        const float4* src = reinterpret_cast<const float4*>(
            cluster.map_shared_rank(slot, warp));
        float4* dst = reinterpret_cast<float4*>(cands + warp * SLOT);
        for (int j = lane; j <= n4; j += 32) dst[j] = src[j];
        if (warp == WARPS - 1) {
          const float4* gs = reinterpret_cast<const float4*>(
              cluster.map_shared_rank(slot, og) + 4 + NB);
          for (int j = lane; j < n4; j += 32)
            reinterpret_cast<float4*>(growl)[j] = gs[j];
        }
      }
      __syncthreads();
      // the pivot: the ranks hold ascending rows, so the first max stays
      float v = -1.f;
      int p = -1, w = 0;
      for (int c = 0; c < CL; ++c) {
        const float cv = cands[c * SLOT];
        const int ci = __float_as_int(cands[c * SLOT + 1]);
        if (cv > v && ci >= 0) {
          v = cv;
          p = ci;
          w = c;
        }
      }
      if (!(v > 0.f)) {   // a zero (or NaN) pivot: flagged, kept in place
        if (rank == 0 && threadIdx.x == 0 && *I.info == 0) *I.info = g + 1;
        if (p < 0) p = g;
      }
      const float* prow = p == g ? growl : cands + w * SLOT + 4;
      if (threadIdx.x == 0) {
        const int pg = phys[g];
        phys[g] = phys[p];
        phys[p] = pg;
      }
      if (p != g && p >= r0 && p < r0 + nloc) {   // row p takes row g
        for (int c = threadIdx.x; c < nbw; c += THREADS)
          P[(p - r0) * LDP + c] = growl[c];
        if (threadIdx.x == 0) fc[p - r0] = growl[jj];
      }
      if (p != g && g >= r0 && g < r0 + nloc)   // and row g row p, whose
        for (int c = threadIdx.x; c < nbw; c += THREADS)   // columns outside
          P[(g - r0) * LDP + c] = prow[c];   // the sub-panel wait unscaled
      __syncthreads();
      // the scaled pivot row on a lane's 4 columns of the sub-panel; each
      // warp updates its block of rows (LPR lanes a row, float4 each), the
      // pivot row taking the scaled row (multiplier −1 of a zero row) and
      // column jj −f/d; the panel's other columns wait for the sub-panel's end
      const float inv = 1.0f / prow[jj];
      const int sb0 = jj / SB * SB;   // the sub-panel's first column
      const int c0 = sb0 + 4 * (lane % LPR), jl = jj - c0;
      float rr[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + e;
        rr[e] = c == jj ? inv : (c < nbw ? prow[c] * inv : 0.f);
      }
      for (int a = w0 + lane / LPR; a < w1; a += RPW * UR) {
        float4 x[UR];
        float f[UR];
#pragma unroll
        for (int u = 0; u < UR; ++u) {
          const int li = a + u * RPW;
          x[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          f[u] = -1.f;
          if (li < w1 && r0 + li != g) {
            x[u] = *reinterpret_cast<const float4*>(P + li * LDP + c0);
            f[u] = fc[li];
          }
        }
#pragma unroll
        for (int u = 0; u < UR; ++u) {
          const int li = a + u * RPW;
          if (li < w1) {
            const float4 y = make_float4(
                fmaf(-f[u], rr[0], jl == 0 ? 0.f : x[u].x),
                fmaf(-f[u], rr[1], jl == 1 ? 0.f : x[u].y),
                fmaf(-f[u], rr[2], jl == 2 ? 0.f : x[u].z),
                fmaf(-f[u], rr[3], jl == 3 ? 0.f : x[u].w));
            *reinterpret_cast<float4*>(P + li * LDP + c0) = y;
          }
        }
      }
      // column jj + 1 of the warp's rows: the next multipliers, and the
      // warp's candidate among the rows below g
      const int nx = jj + 1;
      const bool sub_end = nx % SB == 0 || nx == nbw;
      if (!sub_end) {
        __syncwarp();
        float bv = -1.f;
        int bi = -1;
        for (int li = w0 + lane; li < w1; li += 32) {
          const float y = P[li * LDP + nx];
          fn[li] = y;
          if (r0 + li > g && fabsf(y) > bv) {   // ascending rows
            bv = fabsf(y);
            bi = r0 + li;
          }
        }
        warp_best(bv, bi);
        if (lane == 0) {
          wv[warp] = bv;
          wi[warp] = bi;
        }
        offer<NB>(P, nloc, r0, g + 1, nbw, slots + (nx & 1) * SLOT, wv, wi);
      }
      hop::cluster_sync();
      if (sub_end && nbw > SB) {
        // the sub-panel's rank-sbw update of the panel's other columns:
        // its pivot rows Rs over DSMEM from their owners, then each row
        // c ∉ sub-panel takes (row in the sub-block ? 0 : P) + Σ_b P[·][sb0 +
        // b]·Rs[b][c], one fmaf chain over b, 4 x 4 tiles a thread
        const int gs = k + sb0, sbw = min(SB, nbw - sb0);
        const int n4 = (nbw + 3) / 4;
        float* rs = sm + L.rs;
        for (int b = warp; b < sbw; b += WARPS) {
          const int row = gs + b, own = row / rows;
          const float4* src = reinterpret_cast<const float4*>(
              cluster.map_shared_rank(P + (row - own * rows) * LDP, own));
          for (int j = lane; j < n4; j += 32)
            reinterpret_cast<float4*>(rs + b * NB)[j] = src[j];
        }
        hop::cluster_sync();   // every rank holds Rs before rows change
        const int glo = sb0 / 4, ghi = (sb0 + sbw + 3) / 4;
        const int ncg = n4 - (ghi - glo), nrg = (nloc + 3) / 4;
        for (int e = threadIdx.x; e < nrg * ncg; e += THREADS) {
          const int l0 = 4 * (e / ncg), cg = e % ncg;
          const int c = 4 * (cg < glo ? cg : cg + ghi - glo);
          float acc[4][4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int li = l0 + u;
            float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
            if (li < nloc && !(r0 + li >= gs && r0 + li < gs + sbw))
              x = *reinterpret_cast<const float4*>(P + li * LDP + c);
            acc[u][0] = x.x;
            acc[u][1] = x.y;
            acc[u][2] = x.z;
            acc[u][3] = x.w;
          }
#pragma unroll 4
          for (int b = 0; b < sbw; ++b) {
            const float4 r4 = *reinterpret_cast<const float4*>(rs + b * NB + c);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float a = l0 + u < nloc ? P[(l0 + u) * LDP + sb0 + b] : 0.f;
              acc[u][0] = fmaf(a, r4.x, acc[u][0]);
              acc[u][1] = fmaf(a, r4.y, acc[u][1]);
              acc[u][2] = fmaf(a, r4.z, acc[u][2]);
              acc[u][3] = fmaf(a, r4.w, acc[u][3]);
            }
          }
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (l0 + u < nloc)
              *reinterpret_cast<float4*>(P + (l0 + u) * LDP + c) =
                  make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
        }
        __syncthreads();
        if (nx < nbw) {
          start_column(nx);
          hop::cluster_sync();
        }
      }
    }
    // publish P (transposed, and into W), phys, R
    float* pt = I.pt(t);
    for (int e = threadIdx.x; e < nloc * nbw; e += THREADS) {
      const int b = e / nloc, li = e % nloc;
      pt[(size_t)b * I.ldw + r0 + li] = P[li * LDP + b];
    }
    for (int e = threadIdx.x; e < nloc * nbw; e += THREADS) {
      const int li = e / nbw, b = e % nbw;
      I.W[(size_t)phys[r0 + li] * I.ldw + k + b] = P[li * LDP + b];
    }
    int* ph = I.ph(t);
    for (int i = r0 + threadIdx.x; i < r0 + nloc; i += THREADS) ph[i] = phys[i];
    // the updaters are done with step t − 1 (and with P, R, phys of t − 2)
    for (int c = CL; c < G; ++c) wait_geq(I.prog(c), t + 1);
    float* rbt = I.rb(t);
    for (int b = rank; b < nbw; b += CL) {
      const float4* src =
          reinterpret_cast<const float4*>(I.W + (size_t)phys[k + b] * I.ldw);
      float4* dst = reinterpret_cast<float4*>(rbt + (size_t)b * I.ldw);
      for (int j = threadIdx.x; j < I.ldw / 4; j += THREADS)
        dst[j] = __ldcg(src + j);
    }
    __threadfence();
    hop::cluster_sync();
    if (rank == 0 && threadIdx.x == 0) st_release(I.flags, t + 1);
    // look-ahead: strip t + 1 (and, without updaters, every other strip)
    int n_items = t + 1 < I.T ? I.nrt : 0;
    if (U == 0) n_items = (I.T - 1) * I.nrt;
    if (U == 0) {
      for (int u = rank; u < n_items; u += CL)
        update_items<NB>(I, t, false, u, u + 1, phys, P);
    } else {
      for (int rt = rank; rt < n_items; rt += CL)
        update_item<NB>(I, t, t + 1, rt, phys, P);
    }
    __threadfence();
    hop::cluster_sync();
    if (threadIdx.x == 0) st_release(I.prog(rank), t + 2);
  }
}

// An updater CTA (u of U): step by step, its share of the list.
template <int NB>
__device__ void update_all(const Inst& I, int u, int U, int cta, float* sm,
                           const Lay<NB>& L) {
  int* phys = reinterpret_cast<int*>(sm + L.phys);
  for (int t = 0; t < I.T; ++t) {
    wait_geq(I.flags, t + 1);
    const int* ph = I.ph(t);
    for (int i = threadIdx.x; i < I.S; i += THREADS) phys[i] = __ldcg(ph + i);
    __syncthreads();
    const int strips = I.T - 1 - (t + 1 < I.T ? 1 : 0);
    const long long N = (long long)strips * I.nrt;
    const int lo = (int)(N * u / U), hi = (int)(N * (u + 1) / U);
    update_items<NB>(I, t, true, lo, hi, phys, sm + L.uni);
    publish(I.prog(cta), t + 2);
  }
}

template <int NB>
__global__ void __launch_bounds__(THREADS, 1) kinv_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const Lay<NB> L(a.S);
  // the first slots·CL CTAs: a factoring cluster an instance slot; the rest
  // a pool of updaters, pool CTA u serving slot u % slots
  int slot, cta;
  if ((int)blockIdx.x < a.slots * CL) {
    slot = blockIdx.x / CL;
    cta = blockIdx.x % CL;
  } else {
    const int u = blockIdx.x - a.slots * CL;
    slot = u % a.slots;
    cta = CL + u / a.slots;
  }
  const int G = CL + (a.pool - slot + a.slots - 1) / a.slots;
  const int S = a.S;
  for (int b = slot; b < a.B; b += a.slots) {
    Inst I;
    I.Q = a.Q + (size_t)b * a.n * a.n;
    I.A0 = a.A0 + (size_t)b * a.m * a.n;
    I.rho = a.rho + (size_t)b * a.m;
    I.out = a.out + (size_t)b * S * S;
    I.W = a.W + (size_t)b * S * a.ldw;
    I.Pb = a.Pb + (size_t)b * 2 * NB_MAX * a.ldw;
    I.Rb = a.Rb + (size_t)b * 2 * NB_MAX * a.ldw;
    I.physb = a.physb + (size_t)b * 2 * S;
    I.flags = a.flags + (size_t)b * FLAGS;
    I.info = a.info + b;
    I.n = a.n;
    I.m = a.m;
    I.S = S;
    I.ldw = a.ldw;
    I.T = (S + NB - 1) / NB;
    I.nrt = (S + BM - 1) / BM;
    form(I, a.sigma, cta, G, sm + L.uni);
    publish(I.prog(cta), 1);
    if (cta < CL)
      factor_all<NB>(I, cta, G, sm, L);
    else
      update_all<NB>(I, cta - CL, G - CL, cta, sm, L);
    // every step of every CTA, then Ã⁻¹[r][c] = W[phys[r]][phys⁻¹[c]]
    for (int c = 0; c < G; ++c) wait_geq(I.prog(c), I.T + 1);
    int* phys = reinterpret_cast<int*>(sm + L.phys);
    int* pinv = reinterpret_cast<int*>(sm + L.uni);
    const int* ph = I.ph(I.T - 1);
    for (int i = threadIdx.x; i < S; i += THREADS) {
      const int v = __ldcg(ph + i);
      phys[i] = v;
      pinv[v] = i;
    }
    __syncthreads();
    for (int r = cta; r < S; r += G) {
      const float* src = I.W + (size_t)phys[r] * a.ldw;
      float* dst = I.out + (size_t)r * S;
      for (int c = threadIdx.x; c < S; c += THREADS)
        dst[c] = __ldcg(src + pinv[c]);
    }
    __syncthreads();
  }
  hop::cluster_sync();   // no CTA leaves while a peer may read its slots
}

// ---- host -----------------------------------------------------------------

static int smem_optin() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return optin;
}

template <int NB>
static size_t smem_bytes(int S) {
  return sizeof(float) * (size_t)Lay<NB>(S).total;
}

// The panel width at S on this device: the widest whose panel fits the
// cluster's shared memory; 0 where none does.
static int choose_nb(int S) {
  const size_t optin = (size_t)smem_optin();
  if (smem_bytes<128>(S) <= optin) return 128;
  if (smem_bytes<64>(S) <= optin) return 64;
  if (smem_bytes<32>(S) <= optin) return 32;
  return 0;
}

template <int NB>
static int launch(Args a, cudaStream_t stream) {
  auto kernel = kinv_kernel<NB>;
  const size_t smem = smem_bytes<NB>(a.S);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // co-resident clusters at this shared memory (queried once a size)
  static size_t known_smem = 0;
  static int known = 0;
  if (known_smem != smem) {
    known = 0;
    if (cudaOccupancyMaxActiveClusters(&known, kernel, &cfg) != cudaSuccess)
      known = 0;
    known_smem = smem;
  }
  const int clusters = known;
  if (clusters <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  cfg.numAttrs = 2;
  const int T = (a.S + NB - 1) / NB, nrt = (a.S + BM - 1) / BM;
  // a factoring cluster for each instance at a time; the clusters left
  // over update, shared evenly among those instances, no more than a
  // step's items can use
  a.slots = a.B < clusters ? a.B : clusters;
  const long long items = (long long)(T > 2 ? T - 2 : 0) * nrt * a.slots;
  int pool_cl = clusters - a.slots;
  pool_cl = (int)std::min<long long>(pool_cl, (items + CL - 1) / CL);
  pool_cl = std::min(pool_cl, (MAX_G - CL) * a.slots / CL);
  a.pool = CL * pool_cl;
  cfg.gridDim = dim3(CL * (a.slots + pool_cl));
  cudaLaunchKernelEx(&cfg, kernel, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace kinv
}  // namespace iadmm

using namespace iadmm;

extern "C" {

// The panel width the kernel takes at S = n + m on the current device (0:
// S too large for its shared memory).
int iadmm_kkt_inverse_nb(int S) { return kinv::choose_nb(S); }

// Ã⁻¹ of B instances, float32: Q (B,n,n), A0 (B,m,n), rho (B,m), out
// (B,S,S) row-major, S = n + m.  Scratch: W (B,S,ldw), Pb and Rb
// (B,2,NB_MAX,ldw) floats, physb (B,2,S) ints, ldw = S rounded up to 4;
// flags (B,FLAGS) and info (B,) ints, zero on entry (info: the first zero
// pivot's row + 1 of each instance, else 0).  All pointers 16-byte aligned.
int iadmm_kkt_inverse(const void* Q, const void* A0, const void* rho,
                      float sigma, void* out, void* W, void* Pb, void* Rb,
                      void* physb, void* flags, void* info, int B, int n,
                      int m, void* stream) {
  const int S = n + m;
  if (B <= 0 || S <= 0) return 0;
  kinv::Args a{static_cast<const float*>(Q),  static_cast<const float*>(A0),
               static_cast<const float*>(rho), sigma,
               static_cast<float*>(out),      static_cast<float*>(W),
               static_cast<float*>(Pb),       static_cast<float*>(Rb),
               static_cast<int*>(physb),      static_cast<int*>(flags),
               static_cast<int*>(info),       B, n, m, S, (S + 3) / 4 * 4,
               0, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kinv::choose_nb(S)) {
    case 128: return kinv::launch<128>(a, s);
    case 64: return kinv::launch<64>(a, s);
    case 32: return kinv::launch<32>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
