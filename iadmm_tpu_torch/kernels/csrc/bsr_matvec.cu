// Block-sparse (BSR) batched matvec for Hopper (sm_90a).
//
// Replaces iadmm_tpu/kernels/sparse_matvec.py::_bsr_matvec_kernel (driven
// there by bsr_matvec).  For each instance b and row-tile r:
//
//   out[b, r*TM + i] = sum_k sum_j vals[b,r,k,i,j] * rnd(v[b, cols[b,r,k]*TN + j])
//
// where rnd rounds to the tile dtype (bf16 tiles: the vector segment is
// rounded to bf16 before the product, as the TPU kernel's
// seg.astype(tile.dtype); f32 tiles: no rounding) and v reads as zero past
// n.  Products are summed in float32 with plain FMA (no tensor cores, no
// TF32); a bf16 x bf16 product is exact in float32.
//
// Bound on the H100: bytes.  One product reads each stored tile once
// (B*R*K*TM*TN elements), its column indices and the vector, and writes
// (B, m) float32; at 2 flops per tile element it is far below the
// tensor-core ridge.  At Sparse_QP_Large (n = 4096, (8, 128) bf16 tiles,
// K = 2) one Q matvec moves 1.6 MB of stored tiles per instance: 0.95 us at
// B=2, 4.75 us at B=10 at 3.35 TB/s.  So little work a call is bound by
// latency and launch cost unless each warp's loads are all in flight
// together, the card is filled at once and calls are few.
//
// The first design (one CTA of 8 warps per 8 rows, the vector segment
// staged in shared memory behind two barriers per stored tile, 8-byte tile
// loads) made a chain of 2K+1 dependent trips per row.  This one:
//
// - A warp owns ROWS = 8 consecutive rows of one row-tile, in passes of 2
//   rows (bf16 tiles: 16 lanes a row, 8 elements = 16 bytes a lane) or 1
//   row (float32 tiles: 32 lanes, 4 elements = 16 bytes a lane); a CTA is
//   4 warps.  No shared memory, no barrier.
// - The row-tile's column indices are read once (lane k holds index k)
//   and broadcast by shuffle.  Each lane reads the vector elements under
//   its tile elements straight through the read-only path (16 bytes a
//   load), once for all its passes, and rounds them in registers.
// - Stored tiles are taken UNROLL at a time, every tile and vector load of
//   the group issued before the first FMA: a row's dependent chain is one
//   trip for the indices and one for the vector, the tile loads beside
//   them.
// - One launch (iadmm_bsr_matvec_group) runs one product or a group of
//   up to three independent ones: a flat block index over the products'
//   blocks (per-product offsets passed by value), so a group's warps fill
//   the card together and the host pays one launch.
//
// Measured alternatives (PERF.md): 2 rows a warp with 8-warp CTAs (the
// vector read again by every warp of a row-tile), 2- and 8-warp CTAs, and
// each warp's tile rows brought into shared memory by cp.async.bulk (TMA
// 1-D) on an mbarrier: the last was 3% faster on one cold B=10 product and
// slower warm and on grouped calls.
//
// Summation order (bitwise the first design's): the 32 "virtual lanes" of
// a row each hold the partial of 4 consecutive elements of every stored
// tile, fmaf in element order, tiles in k order; the 32 partials are summed
// by the xor tree 16, 8, 4, 2, 1.  A bf16 lane holds the virtual lanes 2j
// and 2j+1, so the tree's offsets 16, 8, 4, 2 are shuffles at 8, 4, 2, 1 on
// each of its two partials, and offset 1 is their in-lane sum (IEEE
// addition commutes).  Rows past m (the ragged last row-tile) are
// computed on the zero pad and not written.

#include "common.cuh"

#include <cstdint>

namespace {

constexpr int TN = 128;       // column-tile width (the wrapper checks)
constexpr int ROWS = 8;       // rows a warp (TM is a multiple)
constexpr int WARPS = 4;      // warps a CTA
constexpr int UNROLL = 2;     // stored tiles whose loads are issued together
constexpr int MAX_OPS = 3;    // products a grouped launch
constexpr unsigned FULL = 0xffffffffu;

// Lane layout of a tile dtype: VL virtual lanes (4-element partials) a
// lane, EL elements (16 bytes) a lane, LPR lanes a row, RPW rows a pass
// of the warp.
template <typename T>
struct Layout {
  static constexpr int VL = 16 / (4 * static_cast<int>(sizeof(T)));
  static constexpr int EL = 4 * VL;
  static constexpr int LPR = TN / EL;
  static constexpr int RPW = 32 / LPR;
};

// EL tile elements from one 16-byte load, widened to float32.
__device__ __forceinline__ void widen(const uint4& q, float (&a)[4]) {
  a[0] = __uint_as_float(q.x); a[1] = __uint_as_float(q.y);
  a[2] = __uint_as_float(q.z); a[3] = __uint_as_float(q.w);
}
__device__ __forceinline__ void widen(const uint4& q, float (&a)[8]) {
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a[2 * i] = __uint_as_float(w[i] << 16);
    a[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// The EL vector elements at e0 .. e0+EL-1 (zero at and past n), rounded to
// the tile dtype.  VEC: n % 4 == 0 and v 16-byte aligned, so each aligned
// group of 4 lies wholly below or wholly at/past n.  Loads are issued
// unconditionally at clamped addresses and the zeros selected after.
template <typename T, bool VEC>
__device__ __forceinline__ void load_seg(const float* __restrict__ vb,
                                         int e0, int n,
                                         float (&s)[Layout<T>::EL]) {
  constexpr int EL = Layout<T>::EL;
  if (VEC) {
#pragma unroll
    for (int h = 0; h < EL / 4; ++h) {
      const int e = e0 + 4 * h;
      const float4 q =
          __ldg(reinterpret_cast<const float4*>(vb + min(e, n - 4)));
      const bool in = e < n;
      s[4 * h] = in ? q.x : 0.f;
      s[4 * h + 1] = in ? q.y : 0.f;
      s[4 * h + 2] = in ? q.z : 0.f;
      s[4 * h + 3] = in ? q.w : 0.f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < EL; ++i) {
      const float q = __ldg(vb + min(e0 + i, n - 1));
      s[i] = e0 + i < n ? q : 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < EL; ++i) s[i] = iadmm::as_operand<T>(s[i]);
}

struct Operand {
  const void* vals;   // (B, R, K, TM, TN) tiles
  const int* cols;    // (B, R, K)
  const float* v;     // (B, n)
  float* out;         // (B, m)
  int B, R, K, TM, m, n;
  int vec;            // n % 4 == 0 and v 16-byte aligned
};

struct Group {
  Operand op[MAX_OPS];
  int start[MAX_OPS];   // first block of each product; the total past count
};

// One warp's rows: ROWS consecutive rows of one row-tile, in PASSES
// passes of RPW rows.  Every pass reads the same vector elements, so they
// are loaded once for the warp's rows.
template <typename T, bool VEC>
__device__ __forceinline__ void warp_rows(const Operand& op, int item,
                                          int lane) {
  using L = Layout<T>;
  constexpr int PASSES = ROWS / L::RPW;
  const int per_tile = op.TM / ROWS;
  const int rt = item / per_tile;               // b * R + r
  const int i0 = (item % per_tile) * ROWS + lane / L::LPR;  // pass 0's row
  const int j = lane % L::LPR;                  // lane within the row
  const int b = rt / op.R, r = rt % op.R;
  const size_t tile_elems = static_cast<size_t>(op.TM) * TN;
  const T* tile = static_cast<const T*>(op.vals) +
                  static_cast<size_t>(rt) * op.K * tile_elems +
                  static_cast<size_t>(i0) * TN + j * L::EL;
  const int* cols = op.cols + static_cast<size_t>(rt) * op.K;
  const float* vb = op.v + static_cast<size_t>(b) * op.n;

  float p[PASSES][L::VL];
#pragma unroll
  for (int w = 0; w < PASSES; ++w)
#pragma unroll
    for (int h = 0; h < L::VL; ++h) p[w][h] = 0.f;
  for (int k0 = 0; k0 < op.K; k0 += 32) {
    const int kc = min(32, op.K - k0);
    const int my_col = __ldg(cols + k0 + min(lane, kc - 1));
    for (int k = 0; k < kc; k += UNROLL) {
      uint4 q[UNROLL][PASSES];
      float s[UNROLL][L::EL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const T* t = tile + static_cast<size_t>(k0 + min(k + u, kc - 1)) *
                                tile_elems;
#pragma unroll
        for (int w = 0; w < PASSES; ++w)
          q[u][w] = __ldg(reinterpret_cast<const uint4*>(t + w * L::RPW * TN));
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int c = __shfl_sync(FULL, my_col, min(k + u, kc - 1));
        load_seg<T, VEC>(vb, c * TN + j * L::EL, op.n, s[u]);
      }
      // A clamped tile past kc is computed and its sums not kept (a select,
      // not a branch, so that no load sinks behind the previous FMAs).
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const bool live = k + u < kc;
#pragma unroll
        for (int w = 0; w < PASSES; ++w) {
          float a[L::EL];
          widen(q[u][w], a);
#pragma unroll
          for (int h = 0; h < L::VL; ++h) {
            float t = p[w][h];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              t = fmaf(a[4 * h + e], s[u][4 * h + e], t);
            p[w][h] = live ? t : p[w][h];
          }
        }
      }
    }
  }
  // The 32 virtual lanes' xor tree: offsets 16 .. 2 as shuffles within the
  // row's LPR lanes, offset 1 in-lane where a lane holds two.
#pragma unroll
  for (int o = L::LPR / 2; o > 0; o >>= 1)
#pragma unroll
    for (int w = 0; w < PASSES; ++w)
#pragma unroll
      for (int h = 0; h < L::VL; ++h)
        p[w][h] += __shfl_xor_sync(FULL, p[w][h], o);
  if (j != 0) return;
  float* out = op.out + static_cast<size_t>(b) * op.m;
#pragma unroll
  for (int w = 0; w < PASSES; ++w) {
    const int row = r * op.TM + i0 + w * L::RPW;
    const float acc = L::VL == 2 ? p[w][0] + p[w][L::VL - 1] : p[w][0];
    if (row < op.m) out[row] = acc;
  }
}

// Block blockIdx.x belongs to the last product whose first block is at or
// before it (start[] of unused slots is the total, so never taken).
template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
bsr_matvec_kernel(const Group g) {
  const int blk = blockIdx.x;
  Operand op = g.op[0];
  int first = g.start[0];
#pragma unroll
  for (int i = 1; i < MAX_OPS; ++i)
    if (blk >= g.start[i]) { op = g.op[i]; first = g.start[i]; }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int item = (blk - first) * WARPS + warp;
  if (item >= op.B * op.R * (op.TM / ROWS)) return;
  if (op.vec)
    warp_rows<T, true>(op, item, lane);
  else
    warp_rows<T, false>(op, item, lane);
}

int launch(Group& g, int count, int is_bf16, cudaStream_t s) {
  int blocks = 0;
  for (int i = 0; i < MAX_OPS; ++i) {
    g.start[i] = blocks;
    if (i < count) {
      const Operand& o = g.op[i];
      const long long items =
          static_cast<long long>(o.B) * o.R * (o.TM / ROWS);
      blocks += static_cast<int>((items + WARPS - 1) / WARPS);
    }
  }
  if (blocks == 0) return 0;
  if (is_bf16)
    bsr_matvec_kernel<__nv_bfloat16><<<blocks, WARPS * 32, 0, s>>>(g);
  else
    bsr_matvec_kernel<float><<<blocks, WARPS * 32, 0, s>>>(g);
  return static_cast<int>(cudaGetLastError());
}

Operand operand(const void* vals, const void* cols, const void* v, void* out,
                int B, int R, int K, int TM, int m, int n) {
  Operand o;
  o.vals = vals;
  o.cols = static_cast<const int*>(cols);
  o.v = static_cast<const float*>(v);
  o.out = static_cast<float*>(out);
  o.B = B; o.R = R; o.K = K; o.TM = TM; o.m = m; o.n = n;
  o.vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0;
  return o;
}

}  // namespace

extern "C" {

// count (1 to 3) independent products in one launch, all of one tile
// dtype.  args: count x 10 int64, product i's vals, cols, v, out pointers
// then B, R, K, TM, m, n.  vals (B, R, K, TM, 128) bf16 (is_bf16 = 1) or
// float32, 16-byte aligned; cols (B, R, K) int32, each in
// [0, ceil(n/128)); v (B, n) float32; out (B, m) float32.  TM must be a
// multiple of ROWS = 8 (the wrapper allows 8 and 128).  args is read
// before the call returns.  Returns cudaGetLastError() after the launch.
int iadmm_bsr_matvec_group(const int64_t* args, int count, int is_bf16,
                           void* stream) {
  if (count < 1 || count > MAX_OPS)
    return static_cast<int>(cudaErrorInvalidValue);
  Group g = {};
  for (int i = 0; i < count; ++i) {
    const int64_t* a = args + 10 * i;
    g.op[i] = operand(reinterpret_cast<const void*>(a[0]),
                      reinterpret_cast<const void*>(a[1]),
                      reinterpret_cast<const void*>(a[2]),
                      reinterpret_cast<void*>(a[3]), static_cast<int>(a[4]),
                      static_cast<int>(a[5]), static_cast<int>(a[6]),
                      static_cast<int>(a[7]), static_cast<int>(a[8]),
                      static_cast<int>(a[9]));
  }
  return launch(g, count, is_bf16, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
