// The bf16 tensor-core GEMM core for Hopper (sm_90a), shared by the cell
// GEMM of cell_gemm.cuh (the per-step cell, the rollout, the training
// forward and the backward's recompute) and the weight-side GEMMs of
// gemm_bf16.cuh (the training backward's dH and dU).
//
// One CTA computes a BM x (NB·BN) float32 tile of A·B, NB = 1 (128 x 128)
// unless a kernel says:
//  * warpgroups 0 and 1 consume: each runs NB wgmma.mma_async m64n128k16
//    per k16 step (bf16 operands from shared memory, float32 sums in 64·NB
//    registers a thread) on its 64-row half of the tile;
//  * the threads after them produce: a ring of stages of BK = 64 (one A and
//    one B tile each, 16 KB apiece, 128-byte swizzle) filled by TMA
//    (cp.async.bulk.tensor, one thread) and handed over through mbarriers:
//    "full" (the tile has landed) and "empty" (both consumers are done
//    with it).  Shape<TMA> sets their number and the ring's depth: one
//    warp and 3 stages where the TMA reads both operands, so that two
//    CTAs share an SM and one's epilogue runs beside the other's main
//    loop; a warpgroup and 4 stages, one CTA an SM, where threads load.
// A kernel may also run the core persistently (one CTA an SM walking many
// tiles: produce and consume take the ring's running step count, so the
// producer fills the next tile's stages while the consumers finish this
// one) and over a cluster of CL CTAs on neighbouring row bands of the same
// columns: each CTA's producer loads its own A tile and 1/CL of the B
// stage, which one TMA multicast writes into every CTA of the cluster; a
// stage is free again once the consumers of all CL CTAs have released it
// (the "empty" barriers count a remote arrive of each consumer warp).
// An operand the TMA cannot read (float32 elements, which must be rounded
// to bf16 on the way; a row stride that is not a multiple of 16 bytes; an
// unaligned base) is loaded by the producer's threads instead: plain
// loads, rounded to bf16, stored in the layout the TMA would have written
// (the same swizzle), then fence.proxy.async and an arrive.  Elements past
// an operand's extents read as zero either way (TMA's out-of-bounds fill),
// so ragged M, N and K need no masking in the main loop.
//
// Operands are described by their stored layout: element (o, i) at
// p[o·ld + i], i the contiguous ("inner") index.  K-major: i is the GEMM's
// k and o the row (of A) or column (of B) of the product; MN-major: o is k.
// A stage tile of a K-major operand is one TMA box of 128 rows x 64 k, of an
// MN-major one two boxes of 64 k x 64 rows; wgmma reads either through its
// descriptor (bf16 allows both majors for A and B), so no operand is
// transposed through registers.
//
// Every output element is summed by one thread over the whole K loop in a
// fixed order (wgmma's), so results are bitwise repeatable: no atomics.
//
// The TMA tensor maps are encoded on the host by cuTensorMapEncodeTiled,
// obtained through cudaGetDriverEntryPoint(ByVersion), so the libraries do
// not link libcuda; <cuda.h> is included for its types only.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace iadmm {
namespace hop {

constexpr int BM = 128;         // tile rows: two consumer warpgroups of 64
constexpr int BN = 128;         // tile columns: wgmma n128
constexpr int BK = 64;          // k depth of a stage: 128 bytes of bf16
constexpr int STAGES = 4;       // the ring's depth, unless a kernel says
constexpr int CONSUMERS = 256;  // warpgroups 0 and 1
constexpr int PRODUCERS = 128;  // warpgroup 2, unless a kernel says
constexpr int TILE_BYTES = BM * BK * 2;  // one operand's stage tile (16 KB)
static_assert(BM == BN, "A and B stage tiles have the same size");
// The ring of S stages of NB B boxes each (aligned to 1024 bytes, the
// 128-byte swizzle's period) and its barriers; the extra 1024 bytes pay
// for the alignment.
template <int S, int NB = 1>
constexpr int smem_bytes() {
  return 1024 + S * (1 + NB) * TILE_BYTES + 2 * S * 8;
}

// One GEMM operand as the core loads it (see the header).
struct Operand {
  const void* p;
  long long ld;      // elements between consecutive o
  int inner, outer;  // extents; elements past them read as zero
  int f32;           // float32 elements, rounded to bf16 as loaded
  int tma;           // set by prepare(): loaded by TMA through its map
};

// ---- device side ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}
// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// 2-D TMA load of the box at (c0 inner, c1 outer) into dst, completing on
// bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
// The same box written at dst, and completing on bar, in every CTA of the
// cluster named by the bits of mask.
__device__ __forceinline__ void tma_load_mc(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "h"(mask)
      : "memory");
}

// ---- clusters, register budgets, named barriers ----

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}
// Every thread of every CTA of the cluster.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;" ::
          : "memory");
}
// Arrive on the barrier at the shared address bar of the cluster's CTA
// rank (this CTA's own included).  Release at CTA scope, the default: the
// arrive orders this warp's finished wgmma reads of the stage before the
// peer's next TMA write into it; .release.cluster made each k-step wait,
// and the cluster ran slower than no cluster on the H100.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, int rank) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}" ::"r"(bar),
      "r"(rank)
      : "memory");
}

// A warpgroup's register budget (every thread of the warpgroup).
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}
// Barrier 1 over the consumer warpgroups only.
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; byte offsets.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[OFF .. OFF+63] += A·B over one k16 slice; TA/TB: 1 for an MN-major
// operand.
template <int TA, int TB, int OFF = 0, int N>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[N], uint64_t da,
                                              uint64_t db) {
  static_assert(OFF + 64 <= N, "the accumulators of one n128 block");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]),
        "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]),
        "+f"(d[OFF + 6]), "+f"(d[OFF + 7]), "+f"(d[OFF + 8]),
        "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]),
        "+f"(d[OFF + 15]), "+f"(d[OFF + 16]), "+f"(d[OFF + 17]),
        "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]),
        "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
        "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]),
        "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]),
        "+f"(d[OFF + 30]), "+f"(d[OFF + 31]), "+f"(d[OFF + 32]),
        "+f"(d[OFF + 33]), "+f"(d[OFF + 34]), "+f"(d[OFF + 35]),
        "+f"(d[OFF + 36]), "+f"(d[OFF + 37]), "+f"(d[OFF + 38]),
        "+f"(d[OFF + 39]), "+f"(d[OFF + 40]), "+f"(d[OFF + 41]),
        "+f"(d[OFF + 42]), "+f"(d[OFF + 43]), "+f"(d[OFF + 44]),
        "+f"(d[OFF + 45]), "+f"(d[OFF + 46]), "+f"(d[OFF + 47]),
        "+f"(d[OFF + 48]), "+f"(d[OFF + 49]), "+f"(d[OFF + 50]),
        "+f"(d[OFF + 51]), "+f"(d[OFF + 52]), "+f"(d[OFF + 53]),
        "+f"(d[OFF + 54]), "+f"(d[OFF + 55]), "+f"(d[OFF + 56]),
        "+f"(d[OFF + 57]), "+f"(d[OFF + 58]), "+f"(d[OFF + 59]),
        "+f"(d[OFF + 60]), "+f"(d[OFF + 61]), "+f"(d[OFF + 62]),
        "+f"(d[OFF + 63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// The ring in dynamic shared memory: stage tiles and barriers.
struct Ring {
  uint8_t* base;   // 1024-aligned: A tiles, then B tiles, then barriers
  uint32_t a, b;   // shared addresses of stage 0's A and B tiles
  uint32_t full, empty;
};

// A stage's release by the consumers: every consumer thread arrives on its
// CTA's empty barrier, or, over a cluster, each consumer warp once on the
// barrier of every CTA of the cluster (whose producer writes into this
// CTA's B tiles).
template <int CL>
__host__ __device__ constexpr int empty_count() {
  return CL == 1 ? CONSUMERS : CL * (CONSUMERS / 32);
}
template <int CL>
__device__ __forceinline__ void release(uint32_t empty) {
  if (CL == 1) {
    mbar_arrive(empty);
  } else if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int c = 0; c < CL; ++c) mbar_arrive_cluster(empty, c);
  }
}

// Carve the ring of S stages (NB B boxes each) from raw dynamic shared
// memory and initialise its barriers; every thread of the CTA (of the
// cluster, CL > 1) must call it (it ends in a barrier).  manual: some
// operand is loaded by the P producer threads (the full barriers then
// count P arrivals, else the one TMA thread's).
template <int S = STAGES, int P = PRODUCERS, int NB = 1, int CL = 1>
__device__ __forceinline__ Ring ring_init(uint8_t* raw, bool manual) {
  constexpr int STAGES = S;
  Ring r;
  const uint32_t pad = (1024u - (smem_addr(raw) & 1023u)) & 1023u;
  r.base = raw + pad;
  r.a = smem_addr(r.base);
  r.b = r.a + STAGES * TILE_BYTES;
  r.full = r.b + STAGES * NB * TILE_BYTES;
  r.empty = r.full + STAGES * 8;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(r.full + 8 * s, manual ? P : 1);
      mbar_init(r.empty + 8 * s, empty_count<CL>());
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (CL > 1)
    cluster_sync();   // no multicast before every CTA's barriers exist
  else
    __syncthreads();
  return r;
}

// Elements (o, i … i+7) of op rounded to bf16, zero past its extents.
__device__ __forceinline__ void fetch8(const Operand& op, int o, int i,
                                       __nv_bfloat16 (&v)[8]) {
  const int lim = o < op.outer ? op.inner - i : 0;
  if (lim <= 0) {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16_rn(0.f);
    return;
  }
  const size_t off = static_cast<size_t>(o) * op.ld + i;
  if (op.f32) {
    const float* p = static_cast<const float*>(op.p) + off;
    if (lim >= 8 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
      const float4 a = reinterpret_cast<const float4*>(p)[0];
      const float4 b = reinterpret_cast<const float4*>(p)[1];
      const float t[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16_rn(t[e]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = __float2bfloat16_rn(e < lim ? p[e] : 0.f);
    }
  } else {
    const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(op.p) + off;
    if (lim >= 8 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
      *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(p);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = e < lim ? p[e] : __float2bfloat16_rn(0.f);
    }
  }
}

// One operand's stage tile by the producer's threads, in the TMA's layout:
// boxes of O outer x 64 inner elements, each row 128 bytes with its 16-byte
// chunks XOR-ed by the row index mod 8.  (o0, i0): the tile's origin; P:
// the producer threads.
template <bool KMAJOR, int P>
__device__ __forceinline__ void load_manual(const Operand& op, int o0, int i0,
                                            uint8_t* dst, int ptid) {
  constexpr int O = KMAJOR ? BM : BK;         // outer extent of the tile
  constexpr int CH = (KMAJOR ? BK : BM) / 8;  // 8-element chunks a row
  for (int c = ptid; c < O * CH; c += P) {
    const int ol = c / CH, il = (c % CH) * 8;
    __align__(16) __nv_bfloat16 v[8];
    fetch8(op, o0 + ol, i0 + il, v);
    const int off = (il >> 6) * (O * 128) + ol * 128 +
                    ((((il & 63) >> 3) ^ (ol & 7)) << 4);
    *reinterpret_cast<uint4*>(dst + off) = *reinterpret_cast<const uint4*>(v);
  }
}

// TMA loads of one operand's stage tile; row0: the tile's first row (A) or
// column (B) of the product, kt: the stage's k step.
template <bool KMAJOR>
__device__ __forceinline__ void tma_tile(const CUtensorMap* map, uint32_t dst,
                                         uint32_t bar, int row0, int kt) {
  if (KMAJOR) {
    tma_load(dst, map, bar, kt * BK, row0);
  } else {
    tma_load(dst, map, bar, row0, kt * BK);
    tma_load(dst + BK * 64 * 2, map, bar, row0 + 64, kt * BK);
  }
}

// The main loop's producer: the P threads after the consumers (warpgroup
// 2, or one warp) fill the ring of S stages with the A and B tiles of the
// K loop, then return (in TMA mode all but the first return at once).
// it0: the ring's steps before this tile (a persistent kernel's running
// count).  NB > 1 takes both operands by TMA (the caller checks), B
// K-major, one box of 128 columns each, over a cluster of CL > 1 CTAs
// (which walk the same B columns): box j is loaded by the CTA j % CL and
// multicast to all of them.
template <bool A_K, bool B_K, int S = STAGES, int P = PRODUCERS, int NB = 1,
          int CL = 1>
__device__ __forceinline__ void produce(const CUtensorMap* ma,
                                        const CUtensorMap* mb,
                                        const Operand& a, const Operand& b,
                                        int m0, int n0, int K,
                                        const Ring& r, int it0 = 0) {
  static_assert(NB == 1 || (B_K && CL > 1), "wide B tiles are K-major and "
                "come over a cluster");
  constexpr int STAGES = S;
  const int nk = (K + BK - 1) / BK;
  const int ptid = threadIdx.x - CONSUMERS;
  const bool manual = !a.tma || !b.tma;
  if (!manual && ptid != 0) return;
  const uint32_t tx =
      (a.tma ? TILE_BYTES : 0) + (b.tma ? NB * TILE_BYTES : 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int it = it0 + kt;
    const int s = it % STAGES;
    const uint32_t full = r.full + 8 * s;
    mbar_wait(r.empty + 8 * s, ((it / STAGES) & 1) ^ 1);
    const uint32_t sa = r.a + s * TILE_BYTES,
                   sb = r.b + s * NB * TILE_BYTES;
    if (NB == 1 && manual) {
      uint8_t* pa = r.base + s * TILE_BYTES;
      uint8_t* pb = r.base + (STAGES + s) * TILE_BYTES;
      if (!a.tma)
        load_manual<A_K, P>(a, A_K ? m0 : kt * BK, A_K ? kt * BK : m0, pa,
                            ptid);
      if (!b.tma)
        load_manual<B_K, P>(b, B_K ? n0 : kt * BK, B_K ? kt * BK : n0, pb,
                            ptid);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
    if (ptid == 0) {
      if (tx)
        mbar_expect_tx(full, tx);
      else
        mbar_arrive(full);
      if (a.tma) tma_tile<A_K>(ma, sa, full, m0, kt);
      if (b.tma) {
        if constexpr (NB == 1) {
          tma_tile<B_K>(mb, sb, full, n0, kt);
        } else {
          const int rank = cluster_rank();
#pragma unroll
          for (int j = 0; j < NB; ++j)
            if (j % CL == rank)
              tma_load_mc(sb + j * TILE_BYTES, mb, full, kt * BK,
                          n0 + j * BN, static_cast<uint16_t>((1u << CL) - 1));
        }
      }
    } else {
      mbar_arrive(full);
    }
  }
}

// The main loop's consumers: warpgroups 0 and 1 end with acc = A[m0 ..
// m0+127, :]·B[:, n0 .. n0+128·NB-1], their 64-row half, in wgmma's
// accumulator layout (thread t of warpgroup w, warp q = (t%128)/32, lane l:
// acc[4c + 2r + e] is row 64w + 16q + l/4 + 8r, column 8c + 2(l%4) + e of
// the tile; c < 16·NB, the n128 instruction c / 16's column 8(c%16) + …).
// Each k16 step runs the NB n128 instructions on their own columns, so
// every sum is the one a 128 x 128 tile forms.  it0: as produce's; every
// stage, the last included, is released.
template <bool A_K, bool B_K, int S = STAGES, int NB = 1, int CL = 1>
__device__ __forceinline__ void consume(int K, const Ring& r,
                                        float (&acc)[64 * NB], int it0 = 0) {
  static_assert(NB == 1 || (NB == 2 && B_K), "one or two n128 blocks; "
                "two of a K-major B");
  constexpr int STAGES = S;
  const int nk = (K + BK - 1) / BK;
  const int wg = threadIdx.x >> 7;
#pragma unroll
  for (int i = 0; i < 64 * NB; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int it = it0 + kt;
    const int s = it % STAGES;
    mbar_wait(r.full + 8 * s, (it / STAGES) & 1);
    // this warpgroup's 64 rows: the first half of a K-major box, or the
    // first of an MN-major tile's two boxes
    const uint32_t sa = r.a + s * TILE_BYTES + wg * (64 * 128);
    const uint32_t sb = r.b + s * NB * TILE_BYTES;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // K-major: a k16 slice is 32 bytes along each 128-byte row; MN-major:
      // 16 rows of 128 bytes, and the second 64-wide box of B lies one box
      // (64 rows of 128 bytes) further on.
      const uint64_t da = A_K ? desc(sa + kk * 32, 16, 1024)
                              : desc(sa + kk * 2048, 64 * 128, 1024);
      const uint64_t db = B_K ? desc(sb + kk * 32, 16, 1024)
                              : desc(sb + kk * 2048, 64 * 128, 1024);
      wgmma_m64n128<A_K ? 0 : 1, B_K ? 0 : 1>(acc, da, db);
      if constexpr (NB == 2)   // the second n128 block: the next B box
        wgmma_m64n128<A_K ? 0 : 1, 0, 64>(
            acc, da, desc(sb + TILE_BYTES + kk * 32, 16, 1024));
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    // keep this step's group in flight; the previous one is done, so its
    // stage goes back to the producer
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    fence_acc(acc);
    if (kt > 0) release<CL>(r.empty + 8 * ((it - 1) % STAGES));
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_acc(acc);
  if (nk > 0) release<CL>(r.empty + 8 * ((it0 + nk - 1) % STAGES));
}

// Both roles: consumers end with acc (consume's layout), producers return
// once they have issued every stage.
template <bool A_K, bool B_K, int S = STAGES, int P = PRODUCERS>
__device__ __forceinline__ void mainloop(const CUtensorMap* ma,
                                         const CUtensorMap* mb,
                                         const Operand& a, const Operand& b,
                                         int m0, int n0, int K, const Ring& r,
                                         float (&acc)[64]) {
  if (threadIdx.x >= CONSUMERS)
    produce<A_K, B_K, S, P>(ma, mb, a, b, m0, n0, K, r);
  else
    consume<A_K, B_K, S>(K, r, acc);
}

// The shape of a kernel over this core.  An operand the TMA reads needs
// one producer warp; then two CTAs of 288 threads and 3 stages share an SM
// (96 registers a thread), so that one CTA's epilogue runs beside the
// other's main loop.  Operands the producer's threads load need a
// producer warpgroup: one CTA of 384 threads an SM, 4 stages.
template <bool TMA>
struct Shape {
  static constexpr int P = TMA ? 32 : PRODUCERS;
  static constexpr int CTAS = TMA ? 2 : 1;
  static constexpr int S = TMA ? 3 : STAGES;
  static constexpr int THREADS = CONSUMERS + P;
  static constexpr int SMEM = smem_bytes<S>();
};

// Row and column of acc[i] within the tile (see consume).
__device__ __forceinline__ int acc_row(int i) {
  const int t = threadIdx.x;
  return (t >> 7) * 64 + ((t & 127) >> 5) * 16 + ((t & 31) >> 2) +
         8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1);
}

// ---- host side -----------------------------------------------------------

// The host helpers below have internal linkage (static): each csrc/*.cu is
// its own library, and a function-local static of an inline function would
// be one object shared by every library loaded into the process.

// A host-side failure (a tensor map that cannot be encoded) of the current
// entry point; last_error() reports it before cudaGetLastError().
static inline cudaError_t& host_error() {
  static thread_local cudaError_t e = cudaSuccess;
  return e;
}
static inline int last_error() {
  const cudaError_t h = host_error();
  host_error() = cudaSuccess;
  const cudaError_t e = cudaGetLastError();
  return static_cast<int>(h != cudaSuccess ? h : e);
}

// Allow the core's dynamic shared memory (above the default 48 KB) for a
// kernel of this library; called before each launch (a host call of a few
// microseconds).
template <typename Kernel>
static inline void allow_smem(Kernel kernel, int bytes) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       bytes);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

static inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : static_cast<EncodeTiled>(nullptr);
  }();
  return fn;
}

// Decide how op is loaded and encode its tensor map: TMA where the TMA can
// read it (bf16, 16-byte row stride and base), else the producer's threads
// (map left zero).  An eligible operand whose map cannot be encoded is an
// error, reported by last_error().
static inline void prepare(Operand& op, bool kmajor, CUtensorMap* map) {
  std::memset(map, 0, sizeof(*map));
  op.tma = 0;
  if (op.f32 || op.ld % 8 != 0 ||
      reinterpret_cast<uintptr_t>(op.p) % 16 != 0)
    return;
  const EncodeTiled enc = encode_tiled();
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(op.inner),
                              static_cast<cuuint64_t>(op.outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(op.ld) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(kmajor ? BM : BK)};
  const cuuint32_t estr[2] = {1, 1};
  if (!enc ||
      enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(op.p),
          dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    host_error() = cudaErrorInvalidValue;
    return;
  }
  op.tma = 1;
}

}  // namespace hop
}  // namespace iadmm
